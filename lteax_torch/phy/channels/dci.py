"""DCI formats 1A and 1C: pack / unpack and RIV resource allocation
(36.212 §5.3.3.1.3-4, 36.213 §7.1.6.3), the two formats that SI and paging
grants use.

The port's own copy of those parts of ``lteax/phy/channels/dci.py`` (a
numpy host codec; the port imports nothing of the JAX package).  The
UE-specific formats (0, 1, 1B, 1D, 2, 2A, 3, 3A) are not ported yet.
``tests/test_torch_plans.py`` holds the copy equal to its original.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

# Sizes a DCI must not take (36.212 §5.3.3.1.2 padding rule)
AMBIGUOUS_SIZES = {12, 14, 16, 20, 24, 26, 32, 40, 44, 56}


def riv_encode(n_rb: int, rb_start: int, l_crb: int) -> int:
    if l_crb < 1 or rb_start + l_crb > n_rb:
        raise ValueError("invalid contiguous allocation")
    if (l_crb - 1) <= n_rb // 2:
        return n_rb * (l_crb - 1) + rb_start
    return n_rb * (n_rb - l_crb + 1) + (n_rb - 1 - rb_start)


def riv_decode(n_rb: int, riv: int) -> tuple[int, int]:
    a, b = riv // n_rb, riv % n_rb
    # reading A (used at encode when L-1 <= floor(N/2)): L = a+1, start = b
    if a <= n_rb // 2 and b + a + 1 <= n_rb:
        return b, a + 1
    # reading B: L = N - a + 1, start = N - 1 - b
    return n_rb - 1 - b, n_rb - a + 1


def riv_bits(n_rb: int) -> int:
    return math.ceil(math.log2(n_rb * (n_rb + 1) / 2))


@dataclasses.dataclass
class Dci1A:
    rb_start: int
    l_crb: int
    mcs: int
    rv: int
    harq: int = 0
    ndi: int = 0
    tpc: int = 0          # for SI/P/RA-RNTI: LSB selects N_PRB_1A (0→2, 1→3)
    distributed: bool = False

    @property
    def n_prb_1a(self) -> int:
        return 2 if (self.tpc & 1) == 0 else 3


def dci_1a_size(n_rb: int) -> int:
    n = 1 + 1 + riv_bits(n_rb) + 5 + 3 + 1 + 2 + 2
    while n in AMBIGUOUS_SIZES:
        n += 1
    return n


def _put(bits: list[int], value: int, width: int):
    for i in range(width - 1, -1, -1):
        bits.append((value >> i) & 1)


def _get(bits: np.ndarray, pos: int, width: int) -> tuple[int, int]:
    v = 0
    for i in range(width):
        v = (v << 1) | int(bits[pos + i])
    return v, pos + width


def dci_1a_pack(d: Dci1A, n_rb: int) -> np.ndarray:
    bits: list[int] = []
    _put(bits, 1, 1)                      # format flag: 1 = format 1A
    _put(bits, 1 if d.distributed else 0, 1)
    _put(bits, riv_encode(n_rb, d.rb_start, d.l_crb), riv_bits(n_rb))
    _put(bits, d.mcs, 5)
    _put(bits, d.harq, 3)
    _put(bits, d.ndi, 1)
    _put(bits, d.rv, 2)
    _put(bits, d.tpc, 2)
    while len(bits) < dci_1a_size(n_rb):
        bits.append(0)
    return np.asarray(bits, dtype=np.int32)


def dci_1a_unpack(bits: np.ndarray, n_rb: int) -> Dci1A | None:
    if len(bits) != dci_1a_size(n_rb):
        return None
    pos = 0
    flag, pos = _get(bits, pos, 1)
    if flag != 1:
        return None                       # format 0, not handled here
    dist, pos = _get(bits, pos, 1)
    riv, pos = _get(bits, pos, riv_bits(n_rb))
    mcs, pos = _get(bits, pos, 5)
    harq, pos = _get(bits, pos, 3)
    ndi, pos = _get(bits, pos, 1)
    rv, pos = _get(bits, pos, 2)
    tpc, pos = _get(bits, pos, 2)
    try:
        rb_start, l_crb = riv_decode(n_rb, riv)
    except Exception:
        return None
    if rb_start + l_crb > n_rb or l_crb < 1:
        return None
    return Dci1A(rb_start=rb_start, l_crb=l_crb, mcs=mcs, rv=rv, harq=harq,
                 ndi=ndi, tpc=tpc, distributed=bool(dist))


# ---------------------------------------------------------------------------
# DCI format 1C (36.212 §5.3.3.1.4) — compact SI/paging/RA grants
# ---------------------------------------------------------------------------

# 36.213 Table 7.1.7.2.3-1: TBS for DCI 1C (I_TBS 0..31)  [U: spec-from-memory]
TBS_1C = (40, 56, 72, 120, 136, 144, 176, 208, 224, 256, 280, 296, 328, 336,
          392, 488, 552, 600, 632, 696, 776, 840, 904, 1000, 1064, 1128,
          1224, 1288, 1384, 1480, 1608, 1736)


def _n_rb_step(n_rb: int) -> int:
    return 2 if n_rb < 50 else 4


def dci_1c_size(n_rb: int) -> int:
    ndl = n_rb // _n_rb_step(n_rb)
    riv = math.ceil(math.log2(ndl * (ndl + 1) / 2))
    gap = 1 if n_rb >= 50 else 0
    return gap + riv + 5


@dataclasses.dataclass
class Dci1C:
    rb_start: int          # in units of N_RB_step
    l_crb: int             # in units of N_RB_step
    i_tbs: int
    gap: int = 0

    def tbs(self) -> int:
        return TBS_1C[self.i_tbs]


def dci_1c_pack(d: Dci1C, n_rb: int) -> np.ndarray:
    step = _n_rb_step(n_rb)
    ndl = n_rb // step
    bits: list[int] = []
    if n_rb >= 50:
        _put(bits, d.gap, 1)
    _put(bits, riv_encode(ndl, d.rb_start, d.l_crb), riv_bits(ndl))
    _put(bits, d.i_tbs, 5)
    return np.asarray(bits, dtype=np.int32)


def dci_1c_unpack(bits: np.ndarray, n_rb: int) -> Dci1C | None:
    if len(bits) != dci_1c_size(n_rb):
        return None
    step = _n_rb_step(n_rb)
    ndl = n_rb // step
    pos = 0
    gap = 0
    if n_rb >= 50:
        gap, pos = _get(bits, pos, 1)
    riv, pos = _get(bits, pos, riv_bits(ndl))
    itbs, pos = _get(bits, pos, 5)
    start, l = riv_decode(ndl, riv)
    if start + l > ndl:
        return None
    return Dci1C(rb_start=start, l_crb=l, i_tbs=itbs, gap=gap)
