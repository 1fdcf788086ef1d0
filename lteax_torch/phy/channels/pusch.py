"""PUSCH: DM-RS, channel interleaver, allocation geometry, the
delay-domain channel-estimate denoiser, the SC-FDMA transform precoding,
HARQ-ACK / RI multiplexing (UCI on PUSCH) and the single-subframe decodes
(36.211 §5.3 / §5.5, 36.212 §5.2.2).

Counterpart of ``lteax.phy.channels.pusch`` for the batched UL-SCH decoder
(``lteax_torch.pipeline.make_pusch_batch_decoder``), the UL test signal
(``lteax_torch.sim.ul_gen``) and the single-subframe :func:`pusch_decode`
and :func:`pusch_decode_uci`.  The DM-RS, the interleavers, the UCI layout
and the denoiser's tap mask are numpy plans, held equal to the originals by
the tests; the DFTs are ``torch.fft`` (the reference's dense-matmul and
factored DFT forms exist for the TPU's matrix unit and are not carried
over).  The single-subframe decodes run the reference's receiver (LS at the
DM-RS, linear time interpolation, MMSE, IDFT, ``demodulate_maxlog``) and
the turbo kernel at the reference's single-subframe settings
(``pdsch.decode_codeword``), all on the grid's device; only the UCI
hypotheses come home, in one read.  Base sequences: Zadoff-Chu for >= 3
PRB and the length-12 phase table for 1 PRB; length 24 (2 PRB) raises in
both packages.
"""

from __future__ import annotations

import dataclasses
import math
from functools import lru_cache

import numpy as np
import torch

from lteax_torch.host import read
from lteax_torch.phy import seq
from lteax_torch.phy.channels.pdsch import (PdschGeometry, decode_codeword,
                                            pdsch_geometry)
from lteax_torch.phy.channels.pucch import PHI_M12
from lteax_torch.phy.mod import demodulate_maxlog
from lteax_torch.phy.tuning import SINGLE_SUBFRAME

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
    """r_{u,v}(n), length m_sc: Zadoff-Chu with cyclic extension for
    m_sc >= 36 (36.211 §5.5.1.1), the QPSK phase table ``PHI_M12`` for 12
    (§5.5.1.2).  Length 24 is not transcribed, in the reference either."""
    if m_sc >= 36:
        n_zc = _largest_prime_below(m_sc)
        qbar = n_zc * (u + 1) / 31.0
        q = int(np.floor(qbar + 0.5)) + v * (-1) ** int(np.floor(2 * qbar))
        m = np.arange(n_zc)
        x = np.exp(-1j * np.pi * q * m * (m + 1) / n_zc)
        return x[np.arange(m_sc) % n_zc].astype(np.complex64)
    if m_sc == 12:
        phi = np.asarray(PHI_M12[u])
        return np.exp(1j * np.pi * phi / 4).astype(np.complex64)
    raise NotImplementedError(f"base sequence length {m_sc}")


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


@lru_cache(maxsize=None)
def _inv_interleaver(g: int, qm: int) -> np.ndarray:
    """Inverse of :func:`channel_interleaver_idx`: codeword bit j sits at
    interleaved position ``inv[j]``."""
    idx = channel_interleaver_idx(g, qm)
    inv = np.empty_like(idx)
    inv[idx] = np.arange(len(idx), dtype=np.int32)
    return inv


def _time_weights() -> np.ndarray:
    """(12, 1) linear-interpolation weights of the data symbols between
    the two DM-RS symbols (clamped outside them)."""
    d0, d1 = DMRS_SYMS
    return np.clip(np.asarray([(s - d0) / (d1 - d0) for s in DATA_SYMS],
                              dtype=np.float32), 0.0, 1.0)[:, None]


@lru_cache(maxsize=64)
def _rx_plan(m_sc: int, subframe: int, n_cell_id: int, n_dmrs: int,
             device: torch.device):
    """The receiver's constants on ``device``, made once per geometry:
    the conjugate DM-RS of both slots (2, m_sc) at cyclic shift
    ``n_dmrs``, the denoiser's taps (m_sc,) and the time weights (12, 1)."""
    dmrs = np.stack([np.conj(dmrs_pusch(n_cell_id, 2 * subframe + slot,
                                        m_sc, n_dmrs=n_dmrs))
                     for slot in range(2)])
    return (torch.as_tensor(dmrs, device=device),
            torch.as_tensor(chest_taps(m_sc), device=device),
            torch.as_tensor(_time_weights(), device=device))


def _equalize_llrs(grid: torch.Tensor, scheme: str, m_sc: int,
                   subframe: int, n_cell_id: int, noise_var,
                   denoise: bool, n_dmrs: int = 0) -> torch.Tensor:
    """The reference's single-subframe receiver: grid (..., 14, m_sc)
    complex -> max-log LLRs (..., 12 * m_sc * Qm) in interleaved
    (time-first) bit order, not yet descrambled.

    LS at the two DM-RS symbols (denoised in the delay domain when
    ``denoise``), linear time interpolation, MMSE, IDFT, the post-IDFT
    noise as the mean over each symbol's subcarriers.  ``noise_var=None``
    estimates it per subframe from the DM-RS residual.  ``n_dmrs`` is the
    DM-RS cyclic shift the UE was granted."""
    dev = grid.device
    grid = grid.to(torch.complex64)
    dmrs, taps, w = _rx_plan(m_sc, subframe, n_cell_id, n_dmrs, dev)
    ls = [grid[..., sym, :] * dmrs[slot] for slot, sym in enumerate(DMRS_SYMS)]
    if noise_var is None:
        nv = torch.clamp_min(torch.mean((ls[0] - ls[1]).abs() ** 2, dim=-1)
                             / 2.0, 1e-6)[..., None, None]
    else:
        nv = torch.as_tensor(noise_var, dtype=torch.float32, device=dev)
    if denoise:
        ls = [chest_denoise(h, taps) for h in ls]
    h = (1 - w) * ls[0][..., None, :] + w * ls[1][..., None, :]
    y = grid[..., list(DATA_SYMS), :]
    p = h.abs() ** 2
    x_f = y * torch.conj(h) / (p + nv)
    x_f = x_f / torch.clamp_min(p / (p + nv), 1e-12)
    x_t = ul_dft(x_f, inverse=True)
    eff = torch.mean(nv / torch.clamp_min(p, 1e-12), dim=-1,
                     keepdim=True).expand_as(p)
    lead = grid.shape[:-2]
    return demodulate_maxlog(x_t.reshape(*lead, -1), scheme,
                             eff.reshape(*lead, -1))


@lru_cache(maxsize=64)
def _scrambling_signs(rnti: int, subframe: int, n_cell_id: int, n: int,
                      device: torch.device) -> torch.Tensor:
    return torch.as_tensor(seq.scrambling_symbols_np(
        pusch_c_init(rnti, subframe, n_cell_id), n), device=device)


@lru_cache(maxsize=64)
def _deinterleave_idx(g: int, qm: int, device: torch.device) -> torch.Tensor:
    """:func:`_inv_interleaver` as int64 on ``device``."""
    return torch.as_tensor(_inv_interleaver(g, qm).astype(np.int64),
                           device=device)


def _descramble(llr: torch.Tensor, rnti: int, subframe: int,
                n_cell_id: int) -> torch.Tensor:
    return llr * _scrambling_signs(rnti, subframe, n_cell_id, llr.shape[-1],
                                   llr.device)


def pusch_decode(grid: torch.Tensor, alloc: PuschAlloc, rnti: int,
                 subframe: int, n_cell_id: int,
                 noise_var: float | None = None, n_dmrs: int = 0,
                 n_iter: int = SINGLE_SUBFRAME.n_iter, denoise: bool = True):
    """(..., 14, m_sc) received SC-FDMA grids -> (tb_bits (..., TBS) int8,
    tb_ok (...,) bool, cb_oks (..., C) bool), on the grid's device with no
    host read.

    LS channel estimate per slot from DM-RS (delay-domain denoised),
    linear time interpolation, MMSE equalization, IDFT de-precoding,
    max-log demap, descramble, de-interleave, de-match, turbo decode
    (``pdsch.decode_codeword``: the turbo kernel at win 32, ``n_iter``
    full iterations, no early stop).

    ``noise_var=None`` (default) estimates the noise per subframe from the
    DM-RS residual (the two pilot symbols' raw LS difference is noise-only
    under a subframe-static channel); a float pins a static prior.
    ``n_dmrs`` is the DM-RS cyclic shift of the grant."""
    geom = alloc.geom
    llr = _descramble(_equalize_llrs(grid, alloc.scheme, alloc.m_sc,
                                     subframe, n_cell_id, noise_var,
                                     denoise, n_dmrs), rnti, subframe,
                      n_cell_id)
    return decode_codeword(llr[..., _deinterleave_idx(geom.g, alloc.qm,
                                                      llr.device)],
                           geom, n_iter)


# ---------------------------------------------------------------------------
# UCI on PUSCH — HARQ-ACK / RI multiplexing (36.212 §5.2.2.6-§5.2.2.8)
# ---------------------------------------------------------------------------
#
# The channel-interleaver matrix has C_mux=12 columns (data SC-FDMA symbols,
# time order) and R'_mux = M_sc rows of Qm-bit groups.  RI groups are
# RESERVED bottom-up in columns {1,4,7,10} (data+CQI skip them); HARQ-ACK
# groups PUNCTURE bottom-up in columns {2,3,8,9} (the symbols adjacent to
# the DM-RS at l=3,10).  Q' coded symbols per UCI field:
#   Q' = min(ceil(O * M_sc * N_symb * beta_offset / sum_r K_r), 4*M_sc)
# Coded ACK/RI bits use hypothesis-decodable repetition/simplex words
# cycled over the Qm*Q' positions (the 36.211 x/y scrambling placeholders
# are not modeled, as in the reference — a self-consistent encode/decode
# pair).

RI_COLS = (1, 4, 7, 10)
ACK_COLS = (2, 3, 8, 9)


@dataclasses.dataclass(frozen=True)
class PuschUci:
    """UCI multiplexing config: numbers of ACK/RI bits and beta offsets."""
    n_ack: int = 0            # 0..2 HARQ-ACK bits
    n_ri: int = 0             # 0..2 RI bits
    beta_ack: float = 2.0     # beta_offset^HARQ-ACK (36.213 Table 8.6.3-1)
    beta_ri: float = 1.25


def uci_q_prime(n_bits: int, alloc: PuschAlloc, beta: float) -> int:
    """Number of coded UCI symbols (36.212 §5.2.2.6, same-TB grant)."""
    if n_bits == 0:
        return 0
    geom = alloc.geom
    k_sum = geom.info.c * geom.k
    qp = int(np.ceil(n_bits * alloc.m_sc * N_DATA_SYMS * beta / k_sum))
    return max(1, min(qp, 4 * alloc.m_sc))


def _bottom_up_groups(q: int, cols: tuple[int, ...], r_mux: int) -> np.ndarray:
    """Group indices (row*12+col) filled bottom-up cycling the column set."""
    i = np.arange(q)
    rows = r_mux - 1 - (i // len(cols))
    colv = np.asarray(cols)[i % len(cols)]
    return (rows * N_DATA_SYMS + colv).astype(np.int32)


@lru_cache(maxsize=None)
def uci_layout(m_sc: int, qm: int, q_ri: int, q_ack: int):
    """Interleaver layout with UCI.

    Returns (read_bit_idx, data_grp, ri_grp, ack_grp):
    - read_bit_idx (n_re*qm,): output bit i (column-major symbol stream) =
      matrix_bits[read_bit_idx[i]] where matrix_bits is group-major
      (n_grp, qm) flattened.
    - data_grp (n_data_grp,): matrix group index of each data/CQI group in
      fill order (row-major, skipping reserved RI groups).
    - ri_grp (q_ri,), ack_grp (q_ack,): matrix group indices (ACK groups
      puncture data groups in place).
    """
    r_mux = m_sc
    n_grp = r_mux * N_DATA_SYMS
    ri_grp = _bottom_up_groups(q_ri, RI_COLS, r_mux)
    ack_grp = _bottom_up_groups(q_ack, ACK_COLS, r_mux)
    reserved = np.zeros(n_grp, dtype=bool)
    reserved[ri_grp] = True
    data_grp = np.nonzero(~reserved)[0].astype(np.int32)   # row-major order
    # column-major read over the (r_mux, 12) group matrix
    grp = np.arange(n_grp, dtype=np.int64).reshape(r_mux, N_DATA_SYMS)
    order = grp.T.reshape(-1)
    read_bit_idx = (order[:, None] * qm
                    + np.arange(qm)[None, :]).reshape(-1).astype(np.int32)
    return read_bit_idx, data_grp, ri_grp, ack_grp


@lru_cache(maxsize=64)
def _uci_plan(m_sc: int, qm: int, q_ri: int, q_ack: int,
              device: torch.device):
    """:func:`uci_layout` for the receiver, as int64 on ``device``: the
    inverse of the column-major read (bit i of the matrix-order stream
    sits at position ``inv[i]`` of the received stream), then data_grp,
    ri_grp and ack_grp."""
    read_idx, data_grp, ri_grp, ack_grp = uci_layout(m_sc, qm, q_ri, q_ack)
    inv = np.empty(len(read_idx), dtype=np.int64)
    inv[read_idx] = np.arange(len(read_idx))
    return tuple(torch.as_tensor(np.asarray(x, np.int64), device=device)
                 for x in (inv, data_grp, ri_grp, ack_grp))


def _uci_word(bits: tuple[int, ...], n_coded: int) -> np.ndarray:
    """Hypothesis word: repetition (1 bit) / simplex (2 bits: o0,o1,o0^o1)
    cycled over n_coded positions."""
    if len(bits) == 1:
        base = [bits[0]]
    else:
        base = [bits[0], bits[1], bits[0] ^ bits[1]]
    return np.asarray([base[i % len(base)] for i in range(n_coded)],
                      dtype=np.int32)


def alloc_geom_uci(alloc: PuschAlloc, uci: PuschUci) -> PdschGeometry:
    """Data geometry with the RI-reserved symbols removed from G."""
    q_ri = uci_q_prime(uci.n_ri, alloc, uci.beta_ri)
    return pdsch_geometry(alloc.mcs_tbs, alloc.n_re - q_ri, alloc.qm,
                          alloc.rv)


def _hypothesis_bits(hyp: int, n_bits: int) -> tuple[int, ...]:
    """Hypothesis index -> its bits, bit i = (hyp >> i) & 1."""
    return tuple((hyp >> i) & 1 for i in range(n_bits))


@lru_cache(maxsize=None)
def _hypothesis_signs(n_bits: int, n_coded: int) -> np.ndarray:
    """(2^n_bits, n_coded) float32: 1 - 2 * each hypothesis' word."""
    return np.stack([1.0 - 2.0 * _uci_word(_hypothesis_bits(h, n_bits),
                                           n_coded)
                     for h in range(2 ** n_bits)]).astype(np.float32)


@lru_cache(maxsize=64)
def _hypothesis_signs_on(n_bits: int, n_coded: int,
                         device: torch.device) -> torch.Tensor:
    """:func:`_hypothesis_signs` on ``device``."""
    return torch.as_tensor(_hypothesis_signs(n_bits, n_coded), device=device)


def _uci_hypothesis(llrs: torch.Tensor, n_bits: int) -> torch.Tensor:
    """ML hypothesis index (...,) of the repetition/simplex word from
    descrambled LLRs (..., n) (positive LLR = bit 0), on their device: the
    first of the 2^n_bits correlations' maxima, as the reference's scan in
    hypothesis order keeps the first."""
    s = _hypothesis_signs_on(n_bits, llrs.shape[-1], llrs.device)
    return torch.argmax(llrs.to(torch.float32) @ s.T, dim=-1)


def _uci_ml_decode(llrs: torch.Tensor, n_bits: int) -> tuple[int, ...]:
    """ML decode of the repetition/simplex word from one field's
    descrambled LLRs (n,) (positive LLR = bit 0), in one read: the
    reference's API over :func:`_uci_hypothesis`, which the receiver
    calls itself so that one read serves both fields."""
    return _hypothesis_bits(read(_uci_hypothesis(llrs, n_bits)), n_bits)


def pusch_decode_uci(grid: torch.Tensor, alloc: PuschAlloc, rnti: int,
                     subframe: int, n_cell_id: int, uci: PuschUci,
                     noise_var: float = 1e-3, n_dmrs: int = 0,
                     n_iter: int = SINGLE_SUBFRAME.n_iter):
    """Receive one (14, m_sc) grid with UCI demultiplexing.

    Returns (tb (TBS,) int8, tb_ok () bool, cb_oks (C,) bool, ack_bits,
    ri_bits): the first three on the grid's device, the UCI bits as tuples
    of ints from one read.  The receiver is the reference's: raw LS at the
    DM-RS (not denoised) and the static ``noise_var`` prior.  Punctured ACK
    positions are excluded from the data LLRs (the turbo code recovers the
    punctured bits).  The turbo decoder runs at ``SINGLE_SUBFRAME`` with
    ``n_iter`` full iterations; ``n_dmrs`` is the DM-RS cyclic shift."""
    geom = alloc_geom_uci(alloc, uci)
    q_ri = uci_q_prime(uci.n_ri, alloc, uci.beta_ri)
    q_ack = uci_q_prime(uci.n_ack, alloc, uci.beta_ack)
    llr = _descramble(_equalize_llrs(grid, alloc.scheme, alloc.m_sc,
                                     subframe, n_cell_id, noise_var,
                                     False, n_dmrs), rnti, subframe,
                      n_cell_id)
    inv, data_grp, ri_grp, ack_grp = _uci_plan(alloc.m_sc, alloc.qm, q_ri,
                                               q_ack, llr.device)
    mat = llr[inv].reshape(-1, alloc.qm)       # matrix-order (n_grp, qm)
    hyps = [_uci_hypothesis(mat[g].reshape(-1), n)
            for g, q, n in ((ack_grp, q_ack, uci.n_ack),
                            (ri_grp, q_ri, uci.n_ri)) if q]
    # data LLRs: fill-order groups, with punctured ACK groups zeroed
    if q_ack:
        mat = mat.index_fill(0, ack_grp, 0.0)
    tb, ok, cb_oks = decode_codeword(mat[data_grp].reshape(-1), geom,
                                     n_iter)
    got = read(torch.stack(hyps)) if hyps else []
    ack_bits = _hypothesis_bits(got.pop(0), uci.n_ack) if q_ack else ()
    ri_bits = _hypothesis_bits(got.pop(0), uci.n_ri) if q_ri else ()
    return tb, ok, cb_oks, ack_bits, ri_bits
