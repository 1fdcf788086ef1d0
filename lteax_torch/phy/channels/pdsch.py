"""PDSCH: the downlink shared channel's codec (36.212 §5.3.2, 36.211
§6.4), counterpart of ``lteax.phy.channels.pdsch``.

``pdsch_geometry``, ``_global_rm_idx`` and ``_global_rm_cycles`` are numpy
copies of the reference's plan code; segmentation is the port's own copy
too (``lteax_torch.phy.fec.segmentation``).  The port imports nothing of
``lteax``; the tests hold each copy equal to its original.

The whole rate match of a transport block is one index vector
``e = d_flat[_global_rm_idx]``.  Its soft inverse, :func:`soft_dematch`,
is a sum of occurrence-rank gathers (``_global_rm_cycles``): one gather
when no bit is sent twice, one a cycle of the circular buffer when the
rate match wraps (G > 3(K+4)C: low MCS, SI, small transport blocks).
:func:`pdsch_decode_device` descrambles, then :func:`decode_codeword`
de-matches, turbo-decodes at the reference's single-subframe settings
(``phy.tuning.SINGLE_SUBFRAME``) and checks CRC24B / CRC24A, all on the
LLRs' device (the single-subframe PUSCH decodes share it); :func:`pdsch_decode_llrs`
brings one transport block home in one read.  The encoder (numpy) feeds
the signal generators.
"""

from __future__ import annotations

import dataclasses
from functools import lru_cache

import numpy as np
import torch

from lteax_torch.host import read
from lteax_torch.kernels.turbo_mlm import turbo_decode_batch
from lteax_torch.phy import seq
from lteax_torch.phy.fec.crc import attach_crc_np, check_crc
from lteax_torch.phy.fec.ratematch import (rate_unmatch, turbo_rm_indices,
                                           unmatch_inv_cycles)
from lteax_torch.phy.fec.segmentation import (SegmentInfo, segment_bits,
                                              segment_info)
from lteax_torch.phy.fec.turbo import turbo_encode
from lteax_torch.phy.mod import modulate
from lteax_torch.phy.tuning import SINGLE_SUBFRAME


@dataclasses.dataclass(frozen=True)
class PdschGeometry:
    """Static per-(TBS, n_re, Qm, rv) geometry."""
    tbs: int
    n_re: int
    qm: int
    rv: int
    info: SegmentInfo
    e_list: tuple[int, ...]

    @property
    def k(self) -> int:
        return self.info.k_plus

    @property
    def g(self) -> int:
        return self.n_re * self.qm


@lru_cache(maxsize=None)
def pdsch_geometry(tbs: int, n_re: int, qm: int, rv: int) -> PdschGeometry:
    info = segment_info(tbs + 24)
    if not info.uniform:
        raise NotImplementedError("non-uniform codeblock segmentation")
    g = n_re * qm
    c = info.c
    gp = g // qm
    gamma = gp % c
    e_small = qm * (gp // c)
    e_big = qm * (-(-gp // c))
    e_list = tuple([e_small] * (c - gamma) + [e_big] * gamma)
    assert sum(e_list) == g, (sum(e_list), g)
    return PdschGeometry(tbs=tbs, n_re=n_re, qm=qm, rv=rv, info=info,
                         e_list=e_list)


@lru_cache(maxsize=None)
def _global_rm_idx(geom: PdschGeometry) -> np.ndarray:
    """(G,) indices into flattened per-CB d streams (C * 3*(K+4))."""
    d_len = geom.k + 4
    parts = []
    for c, e in enumerate(geom.e_list):
        idx = turbo_rm_indices(d_len, e, geom.rv)
        parts.append(c * 3 * d_len + idx.astype(np.int64))
    return np.concatenate(parts).astype(np.int32)


# bounded: one (n_cycles, C*3D) int32 entry per live decode geometry
@lru_cache(maxsize=64)
def _global_rm_cycles(geom: PdschGeometry) -> np.ndarray:
    """(n_cycles, C*3*(K+4)) int32: row k holds, for each d-flat position,
    the codeword position of its (k+1)-th transmission, or G (a zero slot
    appended to the codeword) — one row when the rate match is injective."""
    return unmatch_inv_cycles(_global_rm_idx(geom),
                              geom.info.c * 3 * (geom.k + 4))


def soft_dematch(llrs_scr: torch.Tensor, geom: PdschGeometry) -> torch.Tensor:
    """Descrambled codeword LLRs (..., G) -> d-stream LLRs (..., C, 3, D):
    :func:`rate_unmatch` over the whole block's rate match, one gather per
    cycle of the circular buffer (one when the rate match is injective)."""
    c, d_len = geom.info.c, geom.k + 4
    d = rate_unmatch(llrs_scr, _global_rm_idx(geom), c * d_len)
    return d.reshape(*llrs_scr.shape[:-1], c, 3, d_len)


def soft_dematch_harq(llrs_by_tx, geoms) -> torch.Tensor:
    """HARQ incremental-redundancy soft combining across retransmissions.

    llrs_by_tx: descrambled codeword LLRs (..., G), one per
    (re)transmission; geoms: the matching :class:`PdschGeometry` each (same
    TBS / n_re / Qm, their own ``rv``).  Each transmission de-matches on
    its own; the d-domain LLRs add in transmission order."""
    out = None
    for llr, g in zip(llrs_by_tx, geoms):
        d = soft_dematch(llr, g)
        out = d if out is None else out + d
    return out


# -- encoder (numpy: the signal generators) ----------------------------------

def pdsch_prepare_cbs(tb_bits: np.ndarray, geom: PdschGeometry) -> np.ndarray:
    """TB payload (TBS,) -> codeblock payloads (C, K_payload)."""
    return segment_bits(attach_crc_np(np.asarray(tb_bits), "24A"), geom.info)


def rate_matched_bits(cbs: np.ndarray, geom: PdschGeometry) -> np.ndarray:
    """(..., C, K_payload) codeblock payloads -> (..., G) coded bits e:
    CRC24B where segmented, turbo encode, rate match at ``geom.rv``."""
    if geom.info.cb_crc:
        cbs = attach_crc_np(cbs, "24B")
    d = turbo_encode(cbs, geom.k)                   # (..., C, 3, K+4)
    return d.reshape(*d.shape[:-3], -1)[..., _global_rm_idx(geom)]


def pdsch_encode_cbs(cbs: np.ndarray, geom: PdschGeometry, rnti: int,
                     subframe: int, n_cell_id: int, scheme: str,
                     codeword: int = 0) -> np.ndarray:
    """(..., C, K_payload) codeblock payloads -> (..., n_re) complex64
    symbols in RE-mapping order, scrambled as codeword ``codeword``."""
    e = rate_matched_bits(cbs, geom)
    c = seq.gold_sequence_np(seq.pdsch_c_init(rnti, subframe, n_cell_id,
                                              codeword), geom.g)
    return modulate((e + c) % 2, scheme)


def pdsch_encode_bits(tb_bits: np.ndarray, geom: PdschGeometry) -> np.ndarray:
    """TB payload (TBS,) -> (G,) rate-matched codeword bits (pre-scrambling)."""
    return rate_matched_bits(pdsch_prepare_cbs(tb_bits, geom), geom)


def pdsch_encode(tb_bits: np.ndarray, geom: PdschGeometry, rnti: int,
                 subframe: int, n_cell_id: int, scheme: str,
                 codeword: int = 0) -> np.ndarray:
    """TB payload (TBS,) -> (n_re,) modulated symbols in RE-mapping order,
    scrambled as codeword ``codeword``."""
    return pdsch_encode_cbs(pdsch_prepare_cbs(tb_bits, geom), geom, rnti,
                            subframe, n_cell_id, scheme, codeword)


# -- decoder -------------------------------------------------------------------

def desegment_device(payload: torch.Tensor, info: SegmentInfo) -> torch.Tensor:
    """Desegmentation (uniform K): (..., C, K_payload) -> (..., B)."""
    parts = [payload[..., 0, info.f:]]
    for ci in range(1, info.c):
        parts.append(payload[..., ci, :])
    return torch.cat(parts, dim=-1)


def decode_codeword(llrs_scr: torch.Tensor, geom: PdschGeometry,
                    n_iter: int = SINGLE_SUBFRAME.n_iter):
    """De-match, turbo-decode and CRC-check descrambled codeword LLRs on
    their device, with no host read: llrs_scr (..., G) -> (tb_bits (...,
    TBS) int8, tb_ok (...,) bool — the CRC24A —, cb_oks (..., C) bool — the
    CRC24B, all True when unsegmented).  The turbo decoder runs at
    ``SINGLE_SUBFRAME`` with ``n_iter`` full iterations."""
    t = SINGLE_SUBFRAME
    info, lead = geom.info, llrs_scr.shape[:-1]
    d_llr = soft_dematch(llrs_scr.to(torch.float32), geom)
    bits, _ = turbo_decode_batch(d_llr.reshape(-1, 3, geom.k + 4), geom.k,
                                 n_iter=n_iter, win=t.win, acq=t.acq,
                                 ext_scale=t.ext_scale,
                                 early_crc=t.early_crc(info.cb_crc),
                                 retry_m=t.retry_m_dl)
    bits = bits.reshape(*lead, info.c, geom.k)
    if info.cb_crc:
        payload, cb_oks = check_crc(bits, "24B")
    else:
        payload = bits
        cb_oks = torch.ones((*lead, 1), dtype=torch.bool, device=bits.device)
    tb, ok = check_crc(desegment_device(payload, info), "24A")
    return tb, ok, cb_oks


def pdsch_decode_device(llrs: torch.Tensor, geom: PdschGeometry, rnti: int,
                        subframe: int, n_cell_id: int,
                        n_iter: int = SINGLE_SUBFRAME.n_iter,
                        codeword: int = 0):
    """Descramble codeword ``codeword``, then :func:`decode_codeword`, on
    the LLRs' device with no host read.  llrs (..., G) channel LLRs in
    codeword bit order -> (tb_bits (..., TBS) int8, tb_ok (...,) bool,
    cb_oks (..., C) bool)."""
    sgn = torch.as_tensor(seq.scrambling_symbols_np(
        seq.pdsch_c_init(rnti, subframe, n_cell_id, codeword), geom.g),
        device=llrs.device)
    return decode_codeword(llrs.to(torch.float32) * sgn, geom, n_iter)


def pdsch_decode_llrs(llrs: torch.Tensor, geom: PdschGeometry, rnti: int,
                      subframe: int, n_cell_id: int,
                      n_iter: int = SINGLE_SUBFRAME.n_iter,
                      codeword: int = 0):
    """:func:`pdsch_decode_device` of one transport block's (G,) LLRs, its
    bits and CRC flags brought home in one read.  Returns (tb_bits (TBS,)
    int np.ndarray, crc_ok bool, cb_crc_oks (C,) bool np.ndarray)."""
    tb, ok, cb_oks = pdsch_decode_device(llrs, geom, rnti, subframe,
                                         n_cell_id, n_iter, codeword)
    host = np.asarray(read(torch.cat([ok.reshape(1), cb_oks,
                                      tb.to(torch.bool)])), dtype=np.int64)
    c = cb_oks.shape[-1]
    return host[1 + c:], bool(host[0]), host[1:1 + c].astype(bool)
