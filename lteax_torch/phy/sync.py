"""Cell search: coarse timing/CFO, PSS, SSS (36.211 §6.11); counterpart
of ``lteax.phy.sync``.

- coarse timing and fractional CFO from the CP autocorrelation, a
  cumulative-sum difference (the running sum is taken in complex128, so a
  card's parallel scan and a CPU's sequential one agree closely);
- the PSS matched-filter bank :func:`pss_correlate`: the PSS correlator
  kernel (``lteax_torch.kernels.pss``) for CUDA tensors, its plain version
  for CPU tensors;
- SSS detection as one (2 x 168 x 62) hypothesis-bank product, coherent
  against the PSS symbol's channel.

Functions batch over leading axes and return device tensors; callers read
host scalars where they branch.
"""

from __future__ import annotations

import math
from functools import lru_cache

import numpy as np
import torch

from lteax_torch.phy.config import PhyConfig
from lteax_torch.phy.grid import sync_sc
from lteax_torch.kernels.pss import pss_corr_mag
from lteax_torch.phy import seq

SC_SPACING = 15000.0


def cp_autocorrelation(x: torch.Tensor, cfg: PhyConfig) -> torch.Tensor:
    """Sliding CP correlation corr[n] = sum_{i<cp} x[n+i] conj(x[n+i+N]),
    x (..., L) -> (..., L - n_fft - cp) complex64, with the slot-tail CP
    length."""
    n = cfg.n_fft
    cp = cfg.cp_lengths_slot[1]
    y = (x[..., :-n] * torch.conj(x[..., n:])).to(torch.complex128)
    c = torch.cumsum(y, dim=-1)
    c = torch.cat([torch.zeros_like(c[..., :1]), c], dim=-1)
    return (c[..., cp:] - c[..., :-cp]).to(torch.complex64)


def coarse_timing_and_cfo(x: torch.Tensor, cfg: PhyConfig):
    """Symbol timing (mod one slot) and fractional CFO in Hz, from the CP
    correlation folded over slot periods.  Returns (t0, cfo) tensors over
    the leading axes of x."""
    corr = cp_autocorrelation(x, cfg)
    slot = cfg.n_samps_slot
    n_slots = corr.shape[-1] // slot
    folded = corr[..., :n_slots * slot].reshape(*corr.shape[:-1], n_slots,
                                                slot)
    acc = folded.sum(dim=-2)
    t0 = torch.argmax(torch.abs(acc), dim=-1)
    peak = torch.gather(acc, -1, t0[..., None])[..., 0]
    cfo = -torch.angle(peak) / (2 * math.pi) * SC_SPACING
    return t0, cfo


def apply_cfo(x: torch.Tensor, cfo_hz, fs: float) -> torch.Tensor:
    """Mix x by -cfo (correct the offset).  The phase 2*pi*cfo*n/fs is
    formed in float32, as the reference forms it."""
    n = torch.arange(x.shape[-1], device=x.device, dtype=torch.float32)
    cfo = torch.as_tensor(cfo_hz, dtype=torch.float32, device=x.device)
    ang = (-2.0 * math.pi) * cfo[..., None] * n / fs
    return x * torch.complex(torch.cos(ang), torch.sin(ang))


@lru_cache(maxsize=None)
def pss_time_filters(cfg: PhyConfig) -> np.ndarray:
    """(3, n_fft) complex64 time-domain PSS replicas (unit energy)."""
    filt = np.zeros((3, cfg.n_fft), dtype=np.complex64)
    bins = cfg.sc_to_fft_bin[sync_sc(cfg)]
    for nid2 in range(3):
        f = np.zeros(cfg.n_fft, dtype=np.complex64)
        f[bins] = seq.pss_sequence(nid2)
        t = np.fft.ifft(f) * np.sqrt(cfg.n_fft)
        filt[nid2] = (t / np.linalg.norm(t)).astype(np.complex64)
    return filt


def pss_correlate(x: torch.Tensor, cfg: PhyConfig,
                  mdtype: str = "bf16") -> torch.Tensor:
    """|corr|^2 of x (..., L) with the 3 PSS replicas -> (..., 3, L)
    float32 (peak index = PSS start sample).  ``mdtype``: "bf16", the
    reference's production default (inputs rounded to bfloat16, float32
    accumulation), or "f32"."""
    return pss_corr_mag(x, pss_time_filters(cfg), mdtype)


def find_pss(x: torch.Tensor, cfg: PhyConfig, rel_threshold: float = 0.9,
             mdtype: str = "bf16"):
    """(n_id_2, pss_start_idx, peak_power) over the whole capture."""
    return pss_peak(pss_correlate(x, cfg, mdtype), rel_threshold)


def pss_peak(p: torch.Tensor, rel_threshold: float = 0.9):
    """(..., 3, L) |corr|^2 -> (n_id_2, idx, peak): the strongest root,
    then the EARLIEST sample within ``rel_threshold`` of that root's
    maximum (periodic PSS repeats tie in magnitude)."""
    n_id_2 = torch.argmax(p.amax(dim=-1), dim=-1)
    pick = n_id_2[..., None, None].expand(*n_id_2.shape, 1, p.shape[-1])
    pr = torch.gather(p, -2, pick)[..., 0, :]
    peak = pr.amax(dim=-1)
    near = (pr >= rel_threshold * peak[..., None]).to(torch.uint8)
    idx = torch.argmax(near, dim=-1)                 # first True
    return n_id_2, idx, peak


@lru_cache(maxsize=None)
def _sss_banks(n_id_2: int) -> np.ndarray:
    """(2, 168, 62): subframe-0 and subframe-5 hypothesis banks."""
    return np.stack([seq.sss_bank(n_id_2, False), seq.sss_bank(n_id_2, True)])


def sss_detect(sss_re: torch.Tensor, pss_re: torch.Tensor, n_id_2: int):
    """N_id_1 and frame half from the (62,) SSS and PSS symbol REs, the
    channel equalised coherently with the (adjacent) PSS.  Returns
    (n_id_1, subframe5, score) device tensors."""
    dev = sss_re.device
    h = pss_re * torch.conj(torch.as_tensor(seq.pss_sequence(n_id_2),
                                            device=dev))
    eq = sss_re * torch.conj(h)
    banks = torch.as_tensor(_sss_banks(n_id_2), device=dev)
    scores = torch.einsum("k,hnk->hn", eq.real.contiguous(), banks)
    flat = scores.reshape(-1)
    am = torch.argmax(flat)
    return am % 168, am >= 168, flat[am]
