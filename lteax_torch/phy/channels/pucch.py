"""PUCCH: uplink control channel, formats 1/1a/1b and 2/2a/2b (36.211
§5.4, 36.212 §5.2.3); counterpart of ``lteax.phy.channels.pucch``.

The tables (the length-12 base-sequence phases ``PHI_M12``, which the
1-PRB PUSCH DM-RS uses too, the RM(20, A) basis, the orthogonal covers),
the UE's encoders and the grid mapping are numpy copies of the
reference's, which reproduced the tables from spec memory ([U]-tagged
there; self-consistent encode / decode is its test oracle).  The eNB's
receivers run on a tensor's device (an array goes to ``device``, the card
unless the caller asks for the CPU): each decode is a few
reductions and, for RM(20, A), one (2^A, 20) matmul over every codeword,
with one host read of its decisions and metrics.  They return what the
reference's return.  ``tests/test_torch_pucch.py`` holds both sides to the
reference.
"""

from __future__ import annotations

import math
from functools import lru_cache

import numpy as np
import torch

from lteax_torch.host import read
from lteax_torch.phy import seq as seq_mod

# 36.211 Table 5.5.1.2-1: phi(n) for M_sc = 12, u = 0..29  [U]
PHI_M12 = (
    (-1, 1, 3, -3, 3, 3, 1, 1, 3, 1, -3, 3),
    (1, 1, 3, 3, 3, -1, 1, -3, -3, 1, -3, 3),
    (1, 1, -3, -3, -3, -1, -3, -3, 1, -3, 1, -1),
    (-1, 1, 1, 1, 1, -1, -3, -3, 1, -3, 3, -1),
    (-1, 3, 1, -1, 1, -1, -3, -1, 1, -1, 1, 3),
    (1, -3, 3, -1, -1, 1, 1, -1, -1, 3, -3, 1),
    (-1, 3, -3, -3, -3, 3, 1, -1, 3, 3, -3, 1),
    (-3, -1, -1, -1, 1, -3, 3, -1, 1, -3, 3, 1),
    (1, -3, 3, 1, -1, -1, -1, 1, 1, 3, -1, 1),
    (1, -3, -1, 3, 3, -1, -3, 1, 1, 1, 1, 1),
    (-1, 3, -1, 1, 1, -3, -3, -1, -3, -3, 3, -1),
    (3, 1, -1, -1, 3, 3, -3, 1, 3, 1, 3, 3),
    (1, -3, 1, 1, -3, 1, 1, 1, -3, -3, -3, 1),
    (3, 3, -3, 3, -3, 1, 1, 3, -1, -3, 3, 3),
    (-3, 1, -1, -3, -1, 3, 1, 3, 3, 3, -1, 1),
    (3, -1, 1, -3, -1, -1, 1, 1, 3, 1, -1, -3),
    (1, 3, 1, -1, 1, 3, 3, 3, -1, -1, 3, -1),
    (-3, 1, 1, 3, -3, 3, -3, -3, 3, 1, 3, -1),
    (-3, 3, 1, 1, -3, 1, -3, -3, -1, -1, 1, -3),
    (-1, 3, 1, 3, 1, -1, -1, 3, -3, -1, -3, -1),
    (-1, -3, 1, 1, 1, 1, 3, 1, -1, 1, -3, -1),
    (-1, 3, -1, 1, -3, -3, -3, -3, -3, 1, -1, -3),
    (1, 1, -3, -3, -3, -3, -1, 3, -3, 1, -3, 3),
    (1, 1, -1, -3, -1, -3, 1, -1, 1, 3, -1, 1),
    (1, 1, 3, 1, 3, 3, -1, 1, -1, -3, -3, 1),
    (1, -3, 3, 3, 1, 3, 3, 1, -3, -1, -1, 3),
    (1, 3, -3, -3, 3, -3, 1, -1, -1, 3, -1, -3),
    (-3, -1, -3, -1, -3, 3, 1, -1, 1, 3, -3, -3),
    (-1, 3, -3, 3, -1, 3, 3, -3, 3, 3, -1, -1),
    (3, -3, -3, -1, -1, -3, -1, 3, -3, 3, 1, -1),
)

# 36.212 Table 5.2.3.3-1: RM(20, A) basis sequences  [U]
RM_20_BASIS = np.array([
    [1, 1, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 0],
    [1, 1, 1, 0, 0, 0, 0, 0, 0, 1, 1, 1, 0],
    [1, 0, 0, 1, 0, 0, 1, 0, 1, 1, 1, 1, 1],
    [1, 0, 1, 1, 0, 0, 0, 0, 1, 0, 1, 1, 1],
    [1, 1, 1, 1, 0, 0, 0, 1, 0, 0, 1, 1, 1],
    [1, 1, 0, 0, 1, 0, 1, 1, 1, 0, 1, 1, 1],
    [1, 0, 1, 0, 1, 0, 1, 0, 1, 1, 1, 1, 1],
    [1, 0, 0, 1, 1, 0, 0, 1, 1, 0, 1, 1, 1],
    [1, 1, 0, 1, 1, 0, 0, 1, 0, 1, 1, 1, 1],
    [1, 0, 1, 1, 1, 0, 1, 0, 0, 1, 1, 1, 1],
    [1, 0, 1, 0, 0, 1, 1, 1, 0, 1, 1, 1, 1],
    [1, 1, 1, 0, 0, 1, 1, 0, 1, 0, 1, 1, 1],
    [1, 0, 0, 1, 0, 1, 0, 1, 1, 1, 1, 1, 1],
    [1, 1, 0, 1, 0, 1, 0, 1, 0, 1, 1, 1, 1],
    [1, 0, 0, 0, 1, 1, 0, 1, 0, 0, 1, 0, 1],
    [1, 1, 0, 0, 1, 1, 1, 1, 0, 1, 1, 0, 1],
    [1, 1, 1, 0, 1, 1, 1, 0, 0, 1, 0, 1, 1],
    [1, 0, 0, 1, 1, 1, 0, 0, 1, 0, 0, 1, 1],
    [1, 1, 0, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0],
    [1, 0, 0, 0, 0, 1, 1, 0, 0, 0, 0, 0, 0],
], dtype=np.int64)

# format 1 orthogonal covers (normal CP): data W4 (Walsh), RS W3 (DFT)
W4 = np.array([[1, 1, 1, 1], [1, -1, 1, -1], [1, -1, -1, 1]],
              dtype=np.complex64)
W3 = np.array([[1, 1, 1],
               [1, np.exp(2j * np.pi / 3), np.exp(4j * np.pi / 3)],
               [1, np.exp(4j * np.pi / 3), np.exp(2j * np.pi / 3)]],
              dtype=np.complex64)

DATA_SYMS_F1 = (0, 1, 5, 6)   # within a slot, normal CP
RS_SYMS_F1 = (2, 3, 4)
DATA_SYMS_F2 = (0, 2, 3, 4, 6)
RS_SYMS_F2 = (1, 5)


def _r_alpha(n_cell_id: int, ns: int, alpha_idx: int) -> np.ndarray:
    u = n_cell_id % 30
    phi = np.asarray(PHI_M12[u])
    r = np.exp(1j * np.pi * phi / 4)
    n = np.arange(12)
    return (np.exp(1j * 2 * np.pi * alpha_idx * n / 12) * r).astype(np.complex64)


def pucch_format1_encode(bits: tuple[int, ...], n_cell_id: int, subframe: int,
                         alpha_idx: int = 0, oc_idx: int = 0) -> np.ndarray:
    """Formats 1/1a/1b -> (2, 7, 12) per-slot symbols (normal CP).

    bits: () = format 1 (SR, d=1); (b,) = 1a BPSK; (b0, b1) = 1b QPSK.
    """
    if len(bits) == 0:
        d = 1.0 + 0j
    elif len(bits) == 1:
        d = 1.0 - 2.0 * bits[0] + 0j
    else:
        d = ((1 - 2 * bits[0]) + 1j * (1 - 2 * bits[1])) / np.sqrt(2)
    out = np.zeros((2, 7, 12), dtype=np.complex64)
    for slot in range(2):
        ns = 2 * subframe + slot
        r = _r_alpha(n_cell_id, ns, alpha_idx)
        for i, sym in enumerate(DATA_SYMS_F1):
            out[slot, sym] = d * W4[oc_idx, i] * r
        for i, sym in enumerate(RS_SYMS_F1):
            out[slot, sym] = W3[oc_idx % 3, i] * r
    return out


def _on_device(x, device) -> torch.Tensor:
    """A tensor keeps its device; an array goes to ``device`` (default:
    the current CUDA device; without one this raises unless
    ``device="cpu"``)."""
    if torch.is_tensor(x):
        return x
    from lteax_torch.pipeline import _resolve_device   # pipeline imports us
    return torch.as_tensor(np.asarray(x), device=_resolve_device(device))


def _rx(rx, device) -> torch.Tensor:
    """A received (2, 7, 12) resource as complex64 (see :func:`_on_device`)."""
    return _on_device(rx, device).to(torch.complex64)


@lru_cache(maxsize=256)
def _f1_refs(n_cell_id: int, alpha_idx: int, oc_idx: int,
             device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """The conjugate references of format 1's RS (3, 12) and data (4, 12)
    symbols: conj(W3[oc % 3, i] * r) and conj(W4[oc, i] * r) (the
    sequence does not depend on the slot)."""
    r = _r_alpha(n_cell_id, 0, alpha_idx)
    rs = np.conj(W3[oc_idx % 3][:, None] * r[None, :])
    data = np.conj(W4[oc_idx][:, None] * r[None, :])
    return (torch.as_tensor(rs.astype(np.complex64), device=device),
            torch.as_tensor(data.astype(np.complex64), device=device))


def pucch_format1_decode(rx, n_cell_id: int, subframe: int,
                         alpha_idx: int = 0, oc_idx: int = 0,
                         n_bits: int = 1, device=None):
    """rx (2, 7, 12) -> (bits tuple, soft metric).  Coherent: channel from
    the RS symbols, despread data symbols.  A tensor is decoded on its
    device, an array on ``device`` (the card by default)."""
    rx = _rx(rx, device)
    rs, data = _f1_refs(n_cell_id, alpha_idx, oc_idx, rx.device)
    h = torch.sum(rx[:, RS_SYMS_F1, :] * rs, dim=(1, 2)) / (3 * 12)
    z = torch.sum(rx[:, DATA_SYMS_F1, :] * data, dim=(1, 2))
    d_re, d_im = read(torch.view_as_real(torch.sum(z * torch.conj(h))))
    if n_bits == 0:
        return (), d_re
    if n_bits == 1:
        return (int(d_re < 0),), abs(d_re)
    return (int(d_re < 0), int(d_im < 0)), abs(complex(d_re, d_im))


# ---------------------------------------------------------------------------
# Format 2 (+ CQI on PUSCH): RM (20, A) block code
# ---------------------------------------------------------------------------

def rm20_encode(bits: np.ndarray) -> np.ndarray:
    """(A<=13,) -> (20,) per 36.212 §5.2.3.3."""
    a = len(bits)
    out = (RM_20_BASIS[:, :a] @ np.asarray(bits, dtype=np.int64)) % 2
    return out.astype(np.int32)


@lru_cache(maxsize=None)
def _rm20_codewords(a: int) -> np.ndarray:
    """(2^a, 20) float32: 1 - 2 * the codeword of each message, message m
    carrying bit i = (m >> i) & 1."""
    msgs = np.arange(2 ** a)
    bits = ((msgs[:, None] >> np.arange(a)[None, :]) & 1)
    cws = (bits @ RM_20_BASIS[:, :a].T) % 2
    return (1 - 2 * cws).astype(np.float32)


@lru_cache(maxsize=64)
def _rm20_signs(a: int, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(_rm20_codewords(a), device=device)


def _rm20_best(llrs: torch.Tensor, a: int) -> torch.Tensor:
    """ML message index and its metric, (2,) float64 on the LLRs' device:
    one (2^a, 20) x (20,) matmul, the first maximum as the reference's
    argmax."""
    metric = _rm20_signs(a, llrs.device) @ llrs.to(torch.float32)
    best = torch.argmax(metric)
    return torch.stack([best.to(torch.float64),
                        metric[best].to(torch.float64)])


def _rm20_bits(best: int, a: int) -> np.ndarray:
    return ((int(best) >> np.arange(a)) & 1).astype(np.int32)


def rm20_decode(llrs, a: int, device=None) -> tuple[np.ndarray, float]:
    """ML decode over 2^a codewords (a <= 13): llrs (20,) -> (bits (a,)
    int32, metric), on the tensor's device or, for an array, on ``device``
    (the card by default)."""
    best, metric = read(_rm20_best(_on_device(llrs, device), a))
    return _rm20_bits(best, a), metric


def _f2_cinit(n_cell_id: int, subframe: int, rnti: int) -> int:
    return (2 * subframe + 1) * (2 * n_cell_id + 1) * 65536 + rnti


def pucch_format2_encode(bits: np.ndarray, n_cell_id: int, subframe: int,
                         rnti: int, alpha_idx: int = 0) -> np.ndarray:
    """(A,) UCI bits -> (2, 7, 12) grid (normal CP: data on symbols
    0,2,3,4,6; RS on 1,5)."""
    coded = rm20_encode(bits)
    c = seq_mod.gold_sequence_np(_f2_cinit(n_cell_id, subframe, rnti), 20)
    scr = (coded + c) % 2
    d = ((1 - 2 * scr[0::2]) + 1j * (1 - 2 * scr[1::2])) / np.sqrt(2)  # (10,)
    out = np.zeros((2, 7, 12), dtype=np.complex64)
    k = 0
    for slot in range(2):
        ns = 2 * subframe + slot
        r = _r_alpha(n_cell_id, ns, alpha_idx)
        for sym in range(7):
            if sym in DATA_SYMS_F2:
                out[slot, sym] = d[k] * r
                k += 1
            else:
                out[slot, sym] = r
    return out


@lru_cache(maxsize=256)
def _f2_refs(n_cell_id: int, subframe: int, rnti: int, alpha_idx: int,
             device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """conj(r) (12,) complex64 and the descrambling signs (20,) float32
    on ``device``."""
    r = np.conj(_r_alpha(n_cell_id, 0, alpha_idx))
    return (torch.as_tensor(r, device=device),
            torch.as_tensor(seq_mod.scrambling_symbols_np(
                _f2_cinit(n_cell_id, subframe, rnti), 20), device=device))


def _f2_best(rx: torch.Tensor, n_cell_id: int, subframe: int, rnti: int,
             a: int, alpha_idx: int) -> torch.Tensor:
    """Format 2's receiver on rx's device, no host read: the channel as
    the mean of the two RS symbols' despread values per slot, the ten
    data symbols despread times its conjugate, QPSK LLRs descrambled, the
    RM(20, a) ML decode -> (best message, metric) as :func:`_rm20_best`."""
    r, sgn = _f2_refs(n_cell_id, subframe, rnti, alpha_idx, rx.device)
    z = rx @ r / 12                                        # (2, 7)
    h = torch.sum(z[:, RS_SYMS_F2], dim=1) / 2
    d = (z[:, DATA_SYMS_F2] * torch.conj(h)[:, None]).reshape(-1)
    llr = (torch.view_as_real(d) * math.sqrt(2)).reshape(-1) * sgn
    return _rm20_best(llr, a)


def pucch_format2_decode(rx, n_cell_id: int, subframe: int,
                         rnti: int, a: int, alpha_idx: int = 0,
                         device=None):
    """rx (2, 7, 12) -> (uci bits, metric); devices as in
    :func:`pucch_format1_decode`."""
    best, metric = read(_f2_best(_rx(rx, device), n_cell_id, subframe,
                                 rnti, a, alpha_idx))
    return _rm20_bits(best, a), metric


# ---------------------------------------------------------------------------
# Formats 2a/2b (36.211 §5.4.2 Table 5.4.2-1): CQI as in format 2 plus 1-2
# HARQ-ACK bits modulating the SECOND RS symbol of each slot (symbol 5,
# normal CP).
# ---------------------------------------------------------------------------

# d(10) constellations: (ack bits) -> symbol  [U exact 2b mapping]
_D10_2A = ((1.0 + 0j, (0,)), (-1.0 + 0j, (1,)))
_D10_2B = ((1.0 + 0j, (0, 0)), (-1j, (0, 1)), (1j, (1, 0)), (-1.0 + 0j, (1, 1)))


def pucch_format2ab_encode(cqi_bits: np.ndarray, ack_bits: tuple[int, ...],
                           n_cell_id: int, subframe: int, rnti: int,
                           alpha_idx: int = 0) -> np.ndarray:
    """Format 2a (1 ACK bit) / 2b (2 ACK bits): format-2 grid with the
    second RS symbol in each slot rotated by d(10)."""
    table = _D10_2A if len(ack_bits) == 1 else _D10_2B
    d10 = next(d for d, b in table if b == tuple(ack_bits))
    out = pucch_format2_encode(cqi_bits, n_cell_id, subframe, rnti,
                               alpha_idx).copy()
    out[:, 5] *= d10
    return out


@lru_cache(maxsize=16)
def _d10_conj(n_ack: int, device: torch.device) -> torch.Tensor:
    table = _D10_2A if n_ack == 1 else _D10_2B
    return torch.as_tensor(np.conj([d for d, _ in table]).astype(
        np.complex64), device=device)


def pucch_format2ab_decode(rx, n_cell_id: int, subframe: int,
                           rnti: int, a: int, n_ack: int,
                           alpha_idx: int = 0, device=None):
    """-> (cqi bits, ack bits, metric, ack_metric).  ACK is sliced from the
    second RS symbol against the first-RS channel estimate; the CQI decode
    then reuses both RS symbols with the ACK rotation removed.

    ``ack_metric`` = |acc| of the coherent RS correlation (≈2.0 at |h|=1);
    callers should treat a weak value as DTX (the UE sent plain format 2)
    rather than trust a noise-driven ACK slice.  The ACK slice, the CQI
    decode and both metrics come home in one read.  Devices as in
    :func:`pucch_format1_decode`."""
    rx = _rx(rx, device)
    r, _ = _f2_refs(n_cell_id, subframe, rnti, alpha_idx, rx.device)
    z = rx[:, (1, 5), :] @ r / 12                          # (2, 2)
    acc = torch.sum(z[:, 1] * torch.conj(z[:, 0]))
    d10c = _d10_conj(n_ack, rx.device)
    i = torch.argmax((acc * d10c).real)                    # the first max
    fixed = rx.clone()
    fixed[:, 5] = fixed[:, 5] * d10c[i]
    got = torch.cat([torch.stack([i.to(torch.float64),
                                  torch.abs(acc).to(torch.float64)]),
                     _f2_best(fixed, n_cell_id, subframe, rnti, a,
                              alpha_idx)])
    i, ack_metric, best, metric = read(got)
    table = _D10_2A if n_ack == 1 else _D10_2B
    return _rm20_bits(best, a), table[int(i)][1], metric, ack_metric


# ---------------------------------------------------------------------------
# Grid mapping (36.211 §5.4.3): PUCCH region at the band edges with slot
# hopping — resource m occupies PRB m//2 at one edge in one slot and the
# mirrored PRB in the other.
# ---------------------------------------------------------------------------

def pucch_prb(m: int, slot: int, n_rb_ul: int) -> int:
    """PRB index of PUCCH resource m in the given slot (0/1)."""
    if (m + slot) % 2 == 0:
        return m // 2
    return n_rb_ul - 1 - m // 2


def pucch_map_format1(grid: np.ndarray, syms: np.ndarray, m: int,
                      n_rb_ul: int) -> np.ndarray:
    """Superpose (2, 7, 12) PUCCH symbols into a (14, n_rb_ul*12) UL grid.

    Additive so code-multiplexed resources (same m, different orthogonal
    cover / cyclic shift) can share a PRB pair, 36.211 §5.4.1 style."""
    g = np.asarray(grid).copy()
    for slot in range(2):
        prb = pucch_prb(m, slot, n_rb_ul)
        g[slot * 7:(slot + 1) * 7, prb * 12:(prb + 1) * 12] += syms[slot]
    return g


def pucch_extract(grid, m: int, n_rb_ul: int, device=None) -> torch.Tensor:
    """Gather PUCCH resource m back out of a (14, n_rb_ul*12) grid, on
    its device (an array goes to ``device``, the card by default) ->
    (2, 7, 12) complex64."""
    g = _on_device(grid, device)
    prbs = [pucch_prb(m, slot, n_rb_ul) for slot in range(2)]
    return torch.stack([g[slot * 7:(slot + 1) * 7, prb * 12:(prb + 1) * 12]
                        for slot, prb in enumerate(prbs)]).to(torch.complex64)


def pucch_present(grid, m: int, n_rb_ul: int, thresh: float = 0.1,
                  device=None) -> bool:
    """Energy detector: mean per-RE power on resource m above thresh
    (one read; devices as in :func:`pucch_extract`)."""
    res = pucch_extract(grid, m, n_rb_ul, device)
    return read(torch.mean(res.real ** 2 + res.imag ** 2)) > thresh
