"""OFDM modulation/demodulation with cyclic prefix (36.211 §6.12).

Counterpart of the ``dft="fft"`` path of ``lteax.phy.ofdm``: a subframe's
14 symbols are cut by one static gather and transformed by one batched
``torch.fft`` (cuFFT on the card).  Normalisation is orthonormal
(1/sqrt(N) both ways).  The reference's factored matmul DFT was a TPU
precision trade and is not ported.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from lteax_torch.phy.config import PhyConfig


def _symbol_sample_idx(cfg: PhyConfig) -> np.ndarray:
    """(n_sym, n_fft) sample indices of each symbol's data part."""
    starts = np.asarray(cfg.symbol_starts_subframe)
    return starts[:, None] + np.arange(cfg.n_fft)[None, :]


def samples_to_subframe(samples: torch.Tensor, cfg: PhyConfig) -> torch.Tensor:
    """Time samples (..., n_samps_subframe) complex64 -> resource grid
    (..., n_sym, n_sc) complex64.  The subframe boundary is sample 0."""
    dev = samples.device
    idx = torch.as_tensor(_symbol_sample_idx(cfg), device=dev)
    blocks = samples[..., idx]                       # (..., n_sym, n_fft)
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
