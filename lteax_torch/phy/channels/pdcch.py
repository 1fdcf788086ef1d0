"""PDCCH: CCE/REG multiplexing, the quadruplet interleaver and the blind
decode of every DCI format of ``dci`` (36.212 §5.3.3, 36.211 §6.8, 36.213
§9.1.1), counterpart of ``lteax.phy.channels.pdcch``.

The search-space and interleaver plans and the encoder (for the cell
generator) are numpy copies of the reference's; the descramble and the
blind decode run in torch on the LLRs' device.  :func:`_blind_decode`
de-matches every candidate of the search space, decodes them all in ONE
batched Viterbi, checks each RNTI-masked CRC16 on the device and brings the
flags and payloads home in one read (``lteax_torch.host.read``).
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from lteax_torch.host import read
from lteax_torch.phy import seq
from lteax_torch.phy.channels import dci
from lteax_torch.phy.chest import precode_sfbc
from lteax_torch.phy.config import PhyConfig
from lteax_torch.phy.fec.conv import conv_encode
from lteax_torch.phy.fec.crc import attach_crc_np, check_crc
from lteax_torch.phy.fec.ratematch import (PERM_CONV, _subblock_col_read,
                                           conv_rm_indices, rate_match,
                                           rate_unmatch)
from lteax_torch.phy.fec.viterbi import viterbi_decode_tb_batch
from lteax_torch.phy.grid import pdcch_reg_list
from lteax_torch.phy.mod import modulate

REG_PER_CCE = 9
BITS_PER_REG = 8  # 4 REs x QPSK


def rnti_mask(rnti: int) -> np.ndarray:
    return np.array([(rnti >> (15 - i)) & 1 for i in range(16)], dtype=np.int32)


@lru_cache(maxsize=None)
def quad_permutation(m: int, n_cell_id: int) -> np.ndarray:
    """perm (m,): physical REG j carries logical quadruplet perm[j]
    (36.211 §6.8.5: §5.1.4.2.1 sub-block interleaver on quadruplets + cyclic
    shift by N_cell_ID)."""
    r = -(-m // 32)
    nd = r * 32 - m
    v = _subblock_col_read(m, PERM_CONV)
    order = np.asarray([x - nd for x in v if x >= nd], dtype=np.int64)
    assert len(order) == m
    j = np.arange(m)
    return order[(j + n_cell_id) % m].astype(np.int32)


def _c_init(n_cell_id: int, subframe: int) -> int:
    return subframe * 512 + n_cell_id


def _n_regs(cfg: PhyConfig, n_cell_id: int, cfi: int, ng: float) -> int:
    return len(pdcch_reg_list(cfg, n_cell_id, cfi, ng))


def n_cce(cfg: PhyConfig, n_cell_id: int, cfi: int, ng: float) -> int:
    """(reference capability: liblte_phy_get_n_cce)"""
    return _n_regs(cfg, n_cell_id, cfi, ng) // REG_PER_CCE


def common_search_candidates(n_cces: int) -> list[tuple[int, int]]:
    """(cce_start, L) pairs of the common search space (36.213 §9.1.1)."""
    cands = []
    for l_agg, n_cand in ((4, 4), (8, 2)):
        for i in range(n_cand):
            start = i * l_agg
            if start + l_agg <= n_cces:
                cands.append((start, l_agg))
    return cands


def ue_search_y(rnti: int, subframe: int) -> int:
    """Y_k of the UE-specific search space hash (36.213 §9.1.1):
    Y_-1 = n_RNTI, Y_k = (A * Y_{k-1}) mod D with A=39827, D=65537."""
    y = rnti
    for _ in range(subframe + 1):
        y = (39827 * y) % 65537
    return y


def ue_search_candidates(n_cces: int, rnti: int, subframe: int
                         ) -> list[tuple[int, int]]:
    """(cce_start, L) pairs of the UE-specific search space for this RNTI
    and subframe (36.213 §9.1.1 Table 9.1.1-1: M(L) = 6/6/2/2 candidates at
    L = 1/2/4/8)."""
    y = ue_search_y(rnti, subframe)
    cands = []
    for l_agg, n_cand in ((1, 6), (2, 6), (4, 2), (8, 2)):
        n_l = n_cces // l_agg
        if n_l == 0:
            continue
        for m in range(n_cand):
            start = l_agg * ((y + m) % n_l)
            if start + l_agg <= n_cces:
                cands.append((start, l_agg))
    return cands


def search_candidates(n_cces: int, rnti: int, subframe: int | None
                      ) -> list[tuple[int, int]]:
    """Deduped candidate set: common space, plus the UE-specific space when
    ``subframe`` is given (C-RNTI monitoring per 36.213 §9.1.1)."""
    cands = common_search_candidates(n_cces)
    if subframe is not None:
        seen = set(cands)
        for c in ue_search_candidates(n_cces, rnti, subframe):
            if c not in seen:
                seen.add(c)
                cands.append(c)
    return cands


def pdcch_encode_logical(dcis: list[tuple[np.ndarray, int, int, int]],
                         cfg: PhyConfig, n_cell_id: int, cfi: int, ng: float,
                         subframe: int) -> np.ndarray:
    """Encode DCIs into LOGICAL (CCE-order) QPSK symbols, pre-interleaving.

    dcis: list of (dci_bits, rnti, cce_start, L_aggregation).
    Unused CCEs carry zero energy (<NIL>)."""
    n_bits_total = _n_regs(cfg, n_cell_id, cfi, ng) * BITS_PER_REG
    bits = np.zeros(n_bits_total, dtype=np.int64)
    used = np.zeros(n_bits_total, dtype=bool)
    for dci_bits, rnti, cce_start, l_agg in dcis:
        b = attach_crc_np(np.asarray(dci_bits), "16",
                          mask_bits=rnti_mask(rnti))
        d = conv_encode(b)
        e_len = l_agg * REG_PER_CCE * BITS_PER_REG
        e = rate_match(d, conv_rm_indices(d.shape[-1], e_len))
        lo = cce_start * REG_PER_CCE * BITS_PER_REG
        if lo + e_len > n_bits_total:
            n = n_bits_total // (REG_PER_CCE * BITS_PER_REG)
            raise ValueError(f"CCEs {cce_start}..{cce_start + l_agg - 1} "
                             f"lie beyond the {n} CCEs of {cfi} control "
                             f"symbols")
        bits[lo:lo + e_len] = e
        used[lo:lo + e_len] = True
    c = seq.gold_sequence_np(_c_init(n_cell_id, subframe), n_bits_total)
    sym = modulate((bits + c) % 2, "qpsk")
    return np.where(used.reshape(-1, 2)[:, 0], sym, 0.0).astype(np.complex64)


def _inverse_quad_permutation(cfg: PhyConfig, n_cell_id: int, cfi: int,
                              ng: float) -> np.ndarray:
    perm = quad_permutation(_n_regs(cfg, n_cell_id, cfi, ng), n_cell_id)
    inv = np.empty_like(perm)
    inv[perm] = np.arange(len(perm), dtype=np.int32)
    return inv


def permute_to_phys(sym_logical: np.ndarray, cfg: PhyConfig, n_cell_id: int,
                    cfi: int, ng: float) -> np.ndarray:
    """Logical symbol sequence -> physical REG order (36.211 §6.8.5
    quadruplet interleave + cell-ID cyclic shift)."""
    m = _n_regs(cfg, n_cell_id, cfi, ng)
    perm = quad_permutation(m, n_cell_id)
    return sym_logical.reshape(m, 4)[perm].reshape(-1)


def unpermute_to_logical(vals_phys: torch.Tensor, cfg: PhyConfig,
                         n_cell_id: int, cfi: int, ng: float) -> torch.Tensor:
    """Physical REG order -> logical CCE order (values, not LLRs)."""
    inv = torch.as_tensor(_inverse_quad_permutation(cfg, n_cell_id, cfi, ng)
                          .astype(np.int64), device=vals_phys.device)
    lead = vals_phys.shape[:-1]
    return vals_phys.reshape(*lead, -1, 4)[..., inv, :].reshape(*lead, -1)


def pdcch_encode(dcis: list[tuple[np.ndarray, int, int, int]],
                 cfg: PhyConfig, n_cell_id: int, cfi: int, ng: float,
                 subframe: int, n_ant: int = 1) -> np.ndarray:
    """Encode DCIs to per-port physical-REG-order symbols.

    Returns (n_ports, n_regs*4) complex64 (n_ports = 1 for one antenna,
    else 2 with SFBC, as the reference's encoder does for 2 and 4)."""
    sym = pdcch_encode_logical(dcis, cfg, n_cell_id, cfi, ng, subframe)
    if n_ant == 1:
        ports = [sym]
    else:
        ports = [p.numpy() for p in precode_sfbc(torch.from_numpy(sym))]
    return np.stack([permute_to_phys(p, cfg, n_cell_id, cfi, ng)
                     for p in ports])


def pdcch_descramble_logical(llrs_logical: torch.Tensor, cfg: PhyConfig,
                             n_cell_id: int, cfi: int, ng: float,
                             subframe: int) -> torch.Tensor:
    m = _n_regs(cfg, n_cell_id, cfi, ng)
    sgn = torch.as_tensor(seq.scrambling_symbols_np(
        _c_init(n_cell_id, subframe), m * BITS_PER_REG),
        device=llrs_logical.device)
    return llrs_logical * sgn


def pdcch_llrs_to_logical(llrs_phys: torch.Tensor, cfg: PhyConfig,
                          n_cell_id: int, cfi: int, ng: float,
                          subframe: int) -> torch.Tensor:
    """(m*8,) physical-REG-order LLRs -> descrambled logical-CCE-order LLRs.

    (SISO path: LLRs can be deinterleaved directly.  The SFBC path must
    deinterleave SYMBOLS first — use unpermute_to_logical + equalize +
    demod + pdcch_descramble_logical.)"""
    inv = torch.as_tensor(_inverse_quad_permutation(cfg, n_cell_id, cfi, ng)
                          .astype(np.int64), device=llrs_phys.device)
    logical = llrs_phys.reshape(-1, 2 * 4)[inv].reshape(-1)
    return pdcch_descramble_logical(logical, cfg, n_cell_id, cfi, ng,
                                    subframe)


def candidate_llrs(logical_llrs: torch.Tensor, cands, d_len: int
                   ) -> torch.Tensor:
    """Every candidate's CCEs de-matched: (len(cands), 3, d_len), in the
    candidates' order; one gather and one de-match per aggregation
    level."""
    out = torch.empty((len(cands), 3, d_len), dtype=torch.float32,
                      device=logical_llrs.device)
    for l_agg in sorted({l for _, l in cands}):
        rows = [i for i, (_, l) in enumerate(cands) if l == l_agg]
        e_len = l_agg * REG_PER_CCE * BITS_PER_REG
        lo = np.asarray([cands[i][0] * REG_PER_CCE * BITS_PER_REG
                         for i in rows])
        pos = torch.as_tensor(lo[:, None] + np.arange(e_len)[None, :],
                              device=logical_llrs.device)
        out[rows] = rate_unmatch(logical_llrs.to(torch.float32)[pos],
                                 conv_rm_indices(d_len, e_len), d_len)
    return out


def _blind_decode(logical_llrs: torch.Tensor, payload_size: int, rnti: int,
                  n_cces: int, unpack, subframe: int | None = None) -> list:
    """Generic blind decode: one batched Viterbi over every candidate of
    the common search space (plus the UE-specific space when ``subframe``
    is given), CRC16 with the RNTI mask on the device, then one host read
    of the flags and decoded bits and ``unpack(payload)`` for each
    candidate whose CRC holds."""
    d_len = payload_size + 16
    cands = search_candidates(n_cces, rnti, subframe)
    if not cands:
        return []
    bits = viterbi_decode_tb_batch(candidate_llrs(logical_llrs, cands, d_len),
                                   d_len)
    _, ok = check_crc(bits, "16", mask_bits=rnti_mask(rnti))
    host = np.asarray(read(torch.cat([ok.to(torch.int64)[:, None], bits],
                                     dim=1)), dtype=np.int64)
    out = []
    for (start, l_agg), row in zip(cands, host):
        if row[0]:
            dci = unpack(row[1:1 + payload_size])
            if dci is not None:
                out.append((dci, start, l_agg))
    return out


def pdcch_blind_decode_1a(logical_llrs: torch.Tensor, n_rb: int, rnti: int,
                          n_cces: int, subframe: int | None = None) -> list:
    """Blind-decode DCI format 1A in the common search space.

    Returns list of (dci, cce_start, L) that passed CRC for ``rnti``."""
    return _blind_decode(logical_llrs, dci.dci_1a_size(n_rb), rnti, n_cces,
                         lambda b: dci.dci_1a_unpack(b, n_rb), subframe)


def pdcch_blind_decode_1c(logical_llrs: torch.Tensor, n_rb: int, rnti: int,
                          n_cces: int, subframe: int | None = None) -> list:
    """Blind-decode DCI format 1C (compact SI/paging/RA grants)."""
    return _blind_decode(logical_llrs, dci.dci_1c_size(n_rb), rnti, n_cces,
                         lambda b: dci.dci_1c_unpack(b, n_rb), subframe)


def pdcch_blind_decode_1(logical_llrs: torch.Tensor, n_rb: int, rnti: int,
                         n_cces: int, subframe: int | None = None) -> list:
    """Blind-decode DCI format 1 (type-0 RBG-bitmap grants)."""
    return _blind_decode(logical_llrs, dci.dci_1_size(n_rb), rnti, n_cces,
                         lambda b: dci.dci_1_unpack(b, n_rb), subframe)


def pdcch_blind_decode_2a(logical_llrs: torch.Tensor, n_rb: int, rnti: int,
                          n_cces: int, subframe: int | None = None) -> list:
    """Blind-decode DCI format 2A (TM3 two-codeword grants)."""
    return _blind_decode(logical_llrs, dci.dci_2a_size(n_rb), rnti, n_cces,
                         lambda b: dci.dci_2a_unpack(b, n_rb), subframe)


def pdcch_blind_decode_2(logical_llrs: torch.Tensor, n_rb: int, rnti: int,
                         n_cces: int, subframe: int | None = None) -> list:
    """Blind-decode DCI format 2 (TM4 two-codeword grants)."""
    return _blind_decode(logical_llrs, dci.dci_2_size(n_rb), rnti, n_cces,
                         lambda b: dci.dci_2_unpack(b, n_rb), subframe)


def pdcch_blind_decode_0(logical_llrs: torch.Tensor, n_rb: int, rnti: int,
                         n_cces: int, subframe: int | None = None) -> list:
    """Blind-decode DCI format 0 (UL grants; same padded size as 1A)."""
    return _blind_decode(logical_llrs, dci.dci_1a_size(n_rb), rnti, n_cces,
                         lambda b: dci.dci_0_unpack(b, n_rb), subframe)


def pdcch_blind_decode_1b(logical_llrs: torch.Tensor, n_rb: int, rnti: int,
                          n_cces: int, subframe: int | None = None,
                          n_ant: int = 2) -> list:
    """Blind-decode DCI format 1B (TM6 rank-1 closed-loop grants)."""
    return _blind_decode(logical_llrs, dci.dci_1b_size(n_rb, n_ant), rnti,
                         n_cces, lambda b: dci.dci_1b_unpack(b, n_rb, n_ant),
                         subframe)


def pdcch_blind_decode_1d(logical_llrs: torch.Tensor, n_rb: int, rnti: int,
                          n_cces: int, subframe: int | None = None,
                          n_ant: int = 2) -> list:
    """Blind-decode DCI format 1D (TM5 MU-MIMO grants)."""
    return _blind_decode(logical_llrs, dci.dci_1d_size(n_rb, n_ant), rnti,
                         n_cces, lambda b: dci.dci_1d_unpack(b, n_rb, n_ant),
                         subframe)


def pdcch_blind_decode_3(logical_llrs: torch.Tensor, n_rb: int, rnti: int,
                         n_cces: int, subframe: int | None = None) -> list:
    """Blind-decode DCI format 3 (2-bit group TPC on a TPC-RNTI)."""
    return _blind_decode(logical_llrs, dci.dci_1a_size(n_rb), rnti, n_cces,
                         lambda b: dci.dci_3_unpack(b, n_rb), subframe)


def pdcch_blind_decode_3a(logical_llrs: torch.Tensor, n_rb: int, rnti: int,
                          n_cces: int, subframe: int | None = None) -> list:
    """Blind-decode DCI format 3A (1-bit group TPC on a TPC-RNTI)."""
    return _blind_decode(logical_llrs, dci.dci_1a_size(n_rb), rnti, n_cces,
                         lambda b: dci.dci_3a_unpack(b, n_rb), subframe)
