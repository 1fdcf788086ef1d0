"""SRS — sounding reference signal (36.211 §5.5.3); counterpart of
``lteax.phy.channels.srs``.

An SRS occupies the LAST SC-FDMA symbol of the subframe on a comb-2
(every other subcarrier, transmissionComb k_TC in {0,1}) over m_srs PRBs,
using the same Zadoff-Chu base sequences as the PUSCH DM-RS with cyclic
shift alpha = 2*pi*n_cs/8 (n_cs in 0..7).  Up to 8 UEs sound the same
comb simultaneously, separated by cyclic shift; the eNB detector
correlates in the delay domain where each shift appears as an impulse at
delay offset (8 - n_cs)/8 of the window.

``m_srs`` is a parameter (a multiple of 4 PRBs), as in the reference.  The
sequence, the comb and the UE's ``srs_add`` are numpy copies of the
reference's; the eNB's ``srs_detect`` and ``srs_estimate_channel`` run in
torch on the grid's device.  ``tests/test_torch_srs.py`` holds them to the
reference.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from lteax_torch.phy.channels.pusch import base_sequence
from lteax_torch.pipeline import _resolve_device

SRS_SYM = 13          # last SC-FDMA symbol, normal CP


def srs_sequence(u: int, m_srs: int, n_cs: int = 0, v: int = 0) -> np.ndarray:
    """Frequency-domain SRS values on its comb: (m_srs*6,) complex64.

    r(n) = e^{j alpha n} r_{u,v}(n) with M_sc^RS = m_srs*12/2 (comb-2)."""
    m_sc = m_srs * 6
    base = base_sequence(u, m_sc, v)
    alpha = 2.0 * np.pi * n_cs / 8.0
    return (base * np.exp(1j * alpha * np.arange(m_sc))).astype(np.complex64)


def srs_subcarriers(n_rb_ul: int, m_srs: int, k_tc: int = 0,
                    rb_offset: int = 0) -> np.ndarray:
    """Subcarrier indices of the comb within the UL grid (m_srs*6,)."""
    if m_srs + rb_offset > n_rb_ul:
        raise ValueError("SRS exceeds UL bandwidth")
    k0 = rb_offset * 12 + k_tc
    return (k0 + 2 * np.arange(m_srs * 6)).astype(np.int32)


def srs_add(grid: np.ndarray, n_rb_ul: int, u: int, m_srs: int,
            n_cs: int = 0, k_tc: int = 0, rb_offset: int = 0,
            amp: float = 1.0) -> np.ndarray:
    """Host-side: add an SRS into the (14, n_rb_ul*12) UL grid."""
    g = np.asarray(grid).copy()
    sc = srs_subcarriers(n_rb_ul, m_srs, k_tc, rb_offset)
    g[SRS_SYM, sc] += amp * srs_sequence(u, m_srs, n_cs)
    return g


@lru_cache(maxsize=64)
def _plan(n_rb_ul: int, u: int, m_srs: int, n_cs: int, k_tc: int,
          rb_offset: int, device: torch.device):
    """The comb's subcarriers (m_srs*6,) int64 and conj(srs_sequence)
    (m_srs*6,) complex64 on ``device``."""
    sc = srs_subcarriers(n_rb_ul, m_srs, k_tc, rb_offset).astype(np.int64)
    return (torch.as_tensor(sc, device=device),
            torch.as_tensor(np.conj(srs_sequence(u, m_srs, n_cs)),
                            device=device))


def _comb_product(grid, n_rb_ul, u, m_srs, n_cs, k_tc, rb_offset, device):
    """rx * conj(srs_sequence) on the comb of the grid's SRS symbol.  A
    tensor keeps its device; an array goes to ``device`` (default: the
    current CUDA device; without one this raises unless ``device="cpu"``)."""
    g = grid if torch.is_tensor(grid) else torch.as_tensor(
        np.asarray(grid), device=_resolve_device(device))
    sc, ref_c = _plan(n_rb_ul, u, m_srs, n_cs, k_tc, rb_offset, g.device)
    return g[SRS_SYM, sc].to(torch.complex64) * ref_c


def srs_detect(grid, n_rb_ul: int, u: int, m_srs: int, k_tc: int = 0,
               rb_offset: int = 0, device=None):
    """Delay-domain SRS detector for all 8 cyclic shifts at once, on the
    grid's device (an array goes to ``device``, the card by default).

    Correlates the received comb against the base sequence and IFFTs to
    the delay domain; cyclic shift n_cs concentrates its energy around
    delay bin (8 - n_cs)*M/8 mod M, window (8 - n_cs) mod 8 (the IFFT of
    e^{+j alpha n}; the reference's docstring says n_cs*M/8, its code does
    this).  Returns (powers (8,), peak_delay (8,)) tensors:
    per-shift correlated power (normalized to sum to 1: noise-only input
    gives ~1/8 each) and the delay bin of each shift's peak within its window.
    """
    corr = _comb_product(grid, n_rb_ul, u, m_srs, 0, k_tc, rb_offset, device)
    cir = torch.fft.ifft(corr)                    # delay-domain impulse(s)
    p = cir.real ** 2 + cir.imag ** 2
    total = torch.clamp_min(torch.sum(p), 1e-24)
    pw = p.reshape(8, -1)
    return torch.sum(pw, dim=1) / total, torch.argmax(pw, dim=1)


def srs_estimate_channel(grid, n_rb_ul: int, u: int, m_srs: int,
                         n_cs: int = 0, k_tc: int = 0,
                         rb_offset: int = 0, device=None) -> torch.Tensor:
    """LS wideband channel estimate on the sounded comb for one UE:
    (m_srs*6,) complex64 on the grid's device (devices as in
    :func:`srs_detect`) — rx * conj(base * shift)."""
    return _comb_product(grid, n_rb_ul, u, m_srs, n_cs, k_tc, rb_offset,
                         device)
