"""PUSCH, data only: DM-RS, channel interleaver, allocation geometry, the
delay-domain channel-estimate denoiser and the SC-FDMA transform precoding
(36.211 §5.3 / §5.5, 36.212 §5.2.2).

Counterpart of ``lteax.phy.channels.pusch`` for the batched UL-SCH decoder
(``lteax_torch.pipeline.make_pusch_batch_decoder``) and the UL test signal
(``lteax_torch.sim.ul_gen``).  The DM-RS, the interleaver and the denoiser's
tap mask are numpy plans, held equal to the originals by the tests; the DFTs
are ``torch.fft`` (the reference's dense-matmul and factored DFT forms exist
for the TPU's matrix unit and are not carried over).  Not ported: UCI
multiplexing, the single-subframe ``pusch_decode`` and the length-12 base
sequences (1-PRB allocations).
"""

from __future__ import annotations

import dataclasses
import math
from functools import lru_cache

import numpy as np
import torch

from lteax_torch.phy import seq
from lteax_torch.phy.channels.pdsch import PdschGeometry, pdsch_geometry

N_DATA_SYMS = 12           # normal CP: 14 symbols minus 2 DM-RS (3, 10)
DMRS_SYMS = (3, 10)
DATA_SYMS = tuple(s for s in range(14) if s not in DMRS_SYMS)


def _largest_prime_below(n: int) -> int:
    for c in range(n - 1, 1, -1):
        if all(c % d for d in range(2, int(c ** 0.5) + 1)):
            return c
    raise ValueError(n)


@lru_cache(maxsize=None)
def base_sequence(u: int, m_sc: int, v: int = 0) -> np.ndarray:
    """r_{u,v}(n), length m_sc >= 36: Zadoff-Chu with cyclic extension
    (36.211 §5.5.1.1).  The QPSK phase tables of lengths 12 and 24 are not
    ported."""
    if m_sc < 36:
        raise NotImplementedError(f"base sequence length {m_sc}")
    n_zc = _largest_prime_below(m_sc)
    qbar = n_zc * (u + 1) / 31.0
    q = int(np.floor(qbar + 0.5)) + v * (-1) ** int(np.floor(2 * qbar))
    m = np.arange(n_zc)
    x = np.exp(-1j * np.pi * q * m * (m + 1) / n_zc)
    return x[np.arange(m_sc) % n_zc].astype(np.complex64)


def _slot_byte(c_init: int, ns: int) -> int:
    """Bits 8*ns .. 8*ns+7 of the Gold sequence, LSB first, as an int."""
    c = seq.gold_sequence_np(c_init, 8 * (ns + 1))
    return int(np.sum(c[8 * ns: 8 * ns + 8] * (1 << np.arange(8))))


def group_hopping_pattern(n_cell_id: int, ns: int) -> int:
    """f_gh(ns) (36.211 §5.5.1.3): 8 Gold bits per slot, mod 30."""
    return _slot_byte(n_cell_id // 30, ns) % 30


def dmrs_pusch(n_cell_id: int, ns: int, m_sc: int, delta_ss: int = 0,
               n_dmrs: int = 0, group_hopping: bool = False) -> np.ndarray:
    """DM-RS for slot ns (§5.5.2.1): base sequence (v = 0) with cyclic
    shift alpha, n_cs = (n_dmrs + n_pn(ns)) mod 12."""
    fss = (n_cell_id + delta_ss) % 30
    fgh = group_hopping_pattern(n_cell_id, ns) if group_hopping else 0
    u = (fgh + fss) % 30
    n_pn = _slot_byte((n_cell_id // 30) * 32 + fss, ns)
    alpha = 2 * np.pi * ((n_dmrs + n_pn) % 12) / 12
    return (np.exp(1j * alpha * np.arange(m_sc))
            * base_sequence(u, m_sc)).astype(np.complex64)


@lru_cache(maxsize=None)
def channel_interleaver_idx(g: int, qm: int) -> np.ndarray:
    """36.212 §5.2.2.8, data only: out[i] = in[idx[i]].  Qm-bit groups are
    written row-major into 12 columns and read column-major (time first)."""
    if g % (N_DATA_SYMS * qm):
        raise ValueError(f"G={g} is not a multiple of 12*Qm={12 * qm}")
    r_mux = g // (N_DATA_SYMS * qm)
    order = np.arange(r_mux * N_DATA_SYMS).reshape(r_mux, N_DATA_SYMS).T
    idx = order.reshape(-1)[:, None] * qm + np.arange(qm)[None, :]
    return idx.reshape(-1).astype(np.int32)


@dataclasses.dataclass(frozen=True)
class PuschAlloc:
    n_prb: int
    rb_start: int
    mcs_tbs: int          # TBS value
    qm: int               # 2/4/6
    rv: int = 0

    @property
    def m_sc(self) -> int:
        return 12 * self.n_prb

    @property
    def n_re(self) -> int:
        return self.m_sc * N_DATA_SYMS

    @property
    def geom(self) -> PdschGeometry:
        return pdsch_geometry(self.mcs_tbs, self.n_re, self.qm, self.rv)

    @property
    def scheme(self) -> str:
        return {2: "qpsk", 4: "16qam", 6: "64qam"}[self.qm]


def pusch_c_init(rnti: int, subframe: int, n_cell_id: int) -> int:
    """PUSCH scrambler init (36.211 §5.3.1)."""
    return int(rnti) * 2 ** 14 + int(subframe) * 512 + int(n_cell_id)


def chest_taps(m_sc: int) -> np.ndarray:
    """Delay-domain keep-mask of the DM-RS channel-estimate denoiser.

    The channel's delay spread fits inside the normal CP (144/2048 of a
    symbol), so the LS estimate's inverse DFT is supported on the first
    ~m_sc*144/2048 delay taps (plus a small negative-delay guard for timing
    backoff); everything else is estimation noise, and zeroing it cuts the
    estimate's noise by ~10*log10(m_sc/n_keep) dB."""
    n_keep = max(4, int(np.ceil(m_sc * 144 / 2048)) + 2)
    n_guard = max(2, m_sc // 128)
    mask = np.zeros(m_sc, np.float32)
    mask[:n_keep] = 1.0
    mask[-n_guard:] = 1.0
    return mask


def chest_denoise(h_ls: torch.Tensor, taps: torch.Tensor) -> torch.Tensor:
    """Project a per-subcarrier LS estimate (last axis = m_sc subcarriers)
    onto the delay taps kept by ``taps`` (:func:`chest_taps` on the
    estimate's device)."""
    return torch.fft.fft(torch.fft.ifft(h_ls, dim=-1) * taps, dim=-1)


def ul_dft(x: torch.Tensor, inverse: bool) -> torch.Tensor:
    """Unitary transform (de)precoding over the last axis."""
    n = x.shape[-1]
    if inverse:
        return torch.fft.ifft(x, dim=-1) * math.sqrt(n)
    return torch.fft.fft(x, dim=-1) / math.sqrt(n)
