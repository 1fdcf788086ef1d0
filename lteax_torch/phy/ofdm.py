"""OFDM modulation/demodulation with cyclic prefix (36.211 §6.12).

Counterpart of ``lteax.phy.ofdm``: a subframe's 14 symbols are cut by one
static gather and transformed together, by one batched ``torch.fft``
(cuFFT on the card; ``dft="fft"``) or by the reference's factored DFT
(``"factored"``, ``"factored_hi"``): the Cooley–Tukey N1·N2 split of
``lteax_torch.phy.dft`` as two complex matmuls and a twiddle, the
sub-carrier bins gathered straight from the second matmul's (k2, k1)
output.  ``"factored"`` rounds each matmul's operands to bf16 as the TPU's
single pass does (the reference's shipped default), ``"factored_hi"``
runs them in f32.  Normalisation is orthonormal (1/sqrt(N) both ways).
"""

from __future__ import annotations

import math
from functools import lru_cache

import numpy as np
import torch

from lteax_torch.phy import dft as dft_mod
from lteax_torch.phy.config import PhyConfig
from lteax_torch.phy.tuning import OFDM_DFTS


def _symbol_sample_idx(cfg: PhyConfig) -> np.ndarray:
    """(n_sym, n_fft) sample indices of each symbol's data part."""
    starts = np.asarray(cfg.symbol_starts_subframe)
    return starts[:, None] + np.arange(cfg.n_fft)[None, :]


@lru_cache(maxsize=64)
def _factored_bins(cfg: PhyConfig, device: torch.device) -> torch.Tensor:
    """The sub-carrier bins' positions in the factored DFT's flattened
    (k2, k1) output: bin = N2*k1 + k2 sits at k2*N1 + k1."""
    n1, n2 = dft_mod._split(cfg.n_fft)
    bins = cfg.sc_to_fft_bin.astype(np.int64)
    return torch.as_tensor((bins % n2) * n1 + bins // n2, device=device)


def _dft_factored_bins(blocks: torch.Tensor, cfg: PhyConfig,
                       bf16: bool) -> torch.Tensor:
    """(..., n_fft) blocks -> (..., n_sc) sub-carriers through the factored
    DFT (``lteax/phy/ofdm.py::_ofdm_dft_factored``)."""
    n = cfg.n_fft
    n1, n2, w1, w2, tw = dft_mod.plan(n, False, bf16, blocks.device)
    lead = blocks.shape[:-1]
    v = blocks.reshape(*lead, n2, n1)              # v[n2, n1] = x[n1 + N1*n2]
    a = dft_mod.cmatmul(w2, v, bf16) * tw          # (..., k2, n1), twiddled
    c = dft_mod.cmatmul(a, w1, bf16)               # (..., k2, k1)
    return (c.reshape(*lead, n)[..., _factored_bins(cfg, blocks.device)]
            * float(np.float32(1 / math.sqrt(n))))


def samples_to_subframe(samples: torch.Tensor, cfg: PhyConfig,
                        dft: str = "fft") -> torch.Tensor:
    """Time samples (..., n_samps_subframe) complex64 -> resource grid
    (..., n_sym, n_sc) complex64.  The subframe boundary is sample 0.

    ``dft``: one of :data:`OFDM_DFTS`.  A factored form asked for is never
    replaced by the FFT."""
    if dft not in OFDM_DFTS:
        raise ValueError(f"dft {dft!r}: one of {OFDM_DFTS}")
    dev = samples.device
    idx = torch.as_tensor(_symbol_sample_idx(cfg), device=dev)
    blocks = samples[..., idx]                       # (..., n_sym, n_fft)
    if dft != "fft":
        return _dft_factored_bins(blocks, cfg, bf16=dft == "factored")
    freq = torch.fft.fft(blocks, dim=-1) / math.sqrt(cfg.n_fft)
    bins = torch.as_tensor(cfg.sc_to_fft_bin.astype(np.int64), device=dev)
    return freq[..., bins]


def subframe_to_samples(grid: torch.Tensor, cfg: PhyConfig) -> torch.Tensor:
    """Resource grid (..., n_sym, n_sc) -> time samples (..., n_samps)."""
    dev = grid.device
    bins = torch.as_tensor(cfg.sc_to_fft_bin.astype(np.int64), device=dev)
    freq = torch.zeros((*grid.shape[:-1], cfg.n_fft), dtype=torch.complex64,
                       device=dev)
    freq[..., bins] = grid.to(torch.complex64)
    time = torch.fft.ifft(freq, dim=-1) * math.sqrt(cfg.n_fft)
    cps = list(cfg.cp_lengths_slot) * 2
    parts = []
    for s in range(cfg.n_sym_subframe):
        sym = time[..., s, :]
        parts.append(torch.cat([sym[..., -cps[s]:], sym], dim=-1))
    return torch.cat(parts, dim=-1)
