"""The one traffic generator: a closed loop of equal batches, read from a
traffic mix's parameters (``benchmark/traffic/<name>.json``).

Set-up draws ``distinct_tbs`` subframe rows of transport blocks from the
seed (``codewords`` blocks a row, ``benchmark/systems``), sends them
through the system's frozen transmitter on the host, places each row in
``batch / distinct_tbs`` rows of a batch of ``batch`` subframes (the rows
drawn from the seed, so that no shift of the rows maps the batch onto
itself) and makes ``noise_batches`` batches on the device, each under its
own complex AWGN of variance 10^(-snr/10) per sample (per resource
element: unit-power symbols, orthonormal transforms) from a
``torch.Generator`` on the device.  Every seed gets the same sizes and
the same SNR; only the bits and the noise differ.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from benchmark import spec


@dataclasses.dataclass
class Inputs:
    """A cell's inputs: the batches on the device (B subframe rows each),
    the bits they carry on the device (one row a transport block, (B n,
    TBS) b-major in (subframe, codeword), the same for every batch) and on
    the host."""
    batches: list
    sent: torch.Tensor
    sent_host: np.ndarray


def seeds(seed: int, n: int) -> list[int]:
    """``n`` independent 64-bit seeds from a run's ``--seed``."""
    state = np.random.SeedSequence(seed % 2 ** 64).generate_state(
        n, np.uint64)
    return [int(s) for s in state]


def make_inputs(system, cfg: dict, traffic: dict, seed: int,
                device: torch.device) -> Inputs:
    """The batches of one run, from its seed."""
    bits_seed, noise_seed = seeds(seed, 2)
    distinct, batch = traffic["distinct_tbs"], traffic["batch"]
    if batch % distinct:
        raise ValueError("the batch must be a multiple of distinct_tbs")
    n = spec.codewords(system)
    rng = np.random.default_rng(bits_seed)
    tb = rng.integers(0, 2, (distinct, n, cfg["tbs"]), dtype=np.int8)
    row_tb = rng.permutation(np.arange(batch) % distinct)
    clean = system.transmit(cfg, tb if n > 1 else tb[:, 0])
    base = torch.from_numpy(np.stack([clean.real, clean.imag], axis=-1)
                            .astype(np.float32)).to(device)
    base = base[torch.as_tensor(row_tb, device=device)]
    gen = torch.Generator(device=device)
    gen.manual_seed(noise_seed)
    sigma = float(np.sqrt(10 ** (-traffic["snr_db"] / 10) / 2))
    batches = [base + sigma * torch.randn(base.shape, generator=gen,
                                          device=device)
               for _ in range(traffic["noise_batches"])]
    sent_host = tb[row_tb].reshape(batch * n, cfg["tbs"])
    return Inputs(batches, torch.from_numpy(sent_host).to(device), sent_host)
