"""``sim.cell_gen.capture`` resamples on its device: the resampler kernel
on the card, its plain version on the CPU, and the capture comes home once
at the end.  On the CPU the samples equal those of the host resample it
replaced, bit for bit; on the card (marker ``cuda``) the capture launches
the kernel once and equals the CPU's capture within 1e-5 (absolute; the
kernel is bit-exact against its plain version, cuFFT's OFDM rounds
differently from the CPU's)."""

import numpy as np
import pytest
import torch

import lteax_torch.kernels.polyphase as poly
from lteax_torch.sim import cell_gen
from lteax_torch.sim.channel import awgn

CELL = cell_gen.Cell(n_rb_dl=6, n_cell_id=21)
ARGS = dict(sfn0=3, offset=123, cfo_hz=300.0, snr_db=20.0, rate_hz=2e6,
            seed=4)


def _host_resampled(duration_s: float) -> np.ndarray:
    """The capture as it was made before: generated and impaired as
    ``capture`` does, resampled 25/24 from a host tensor."""
    cfg = CELL.cfg
    nsf = cfg.n_samps_subframe
    n_native = int(np.ceil(duration_s * cfg.fs))
    n_sf = -(-(ARGS["offset"] + n_native) // nsf) + 2
    x = cell_gen.generate(CELL, n_sf, ARGS["sfn0"], "cpu")[
        ARGS["offset"]:ARGS["offset"] + n_native + 2 * nsf]
    n = np.arange(len(x))
    x = (x * np.exp(2j * np.pi * ARGS["cfo_hz"] * n / cfg.fs)
         ).astype(np.complex64)
    p = float(np.mean(np.abs(x) ** 2))
    x = awgn(np.random.default_rng(ARGS["seed"]), x,
             ARGS["snr_db"] + 10 * np.log10(p))
    y = poly.resample_poly(torch.from_numpy(x), 25, 24).numpy()
    return y[:int(np.ceil(duration_s * ARGS["rate_hz"]))]


def test_capture_resample_gives_the_same_samples():
    cap = cell_gen.capture(CELL, 0.004, device="cpu", **ARGS)
    assert cap.rate_hz == 2e6 and cap.iq.dtype == np.complex64
    assert np.array_equal(cap.iq, _host_resampled(0.004))


def test_capture_resamples_on_its_device(monkeypatch):
    """The resampler is handed a tensor on the capture's device."""
    seen = []

    def recorded(x, p, q, *a):
        seen.append((x.device, p, q))
        return poly.resample_poly(x, p, q, *a)

    monkeypatch.setattr(cell_gen, "resample_poly", recorded)
    cell_gen.capture(CELL, 0.002, device=torch.device("cpu"), **ARGS)
    assert seen == [(torch.device("cpu"), 25, 24)]
    cell_gen.capture(CELL, 0.002, device="cpu",
                     **{**ARGS, "rate_hz": None})
    assert len(seen) == 1                 # native rate: no resample


@pytest.mark.cuda
def test_capture_on_the_card_launches_the_kernel():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    before = poly.LAUNCHES
    cap = cell_gen.capture(CELL, 0.004, device="cuda", **ARGS)
    assert poly.LAUNCHES == before + 1
    cpu = cell_gen.capture(CELL, 0.004, device="cpu", **ARGS)
    assert np.max(np.abs(cap.iq - cpu.iq)) <= 1e-5
