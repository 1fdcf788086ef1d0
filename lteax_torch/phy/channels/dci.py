"""DCI formats 0, 1, 1A, 1B, 1C, 1D, 2, 2A, 3 and 3A: pack / unpack, RIV
and type-0 RBG resource allocation (36.212 §5.3.3.1, 36.213 §7.1.6).

The port's own copy of ``lteax/phy/channels/dci.py`` (a numpy host codec;
the port imports nothing of the JAX package), with the reference's sizes:
the 0/1A shared size, the ``AMBIGUOUS_SIZES`` padding, and formats 3/3A at
the 0/1A size.  ``tests/test_torch_dci.py`` and ``test_torch_plans.py``
hold the copy equal to its original, packing and unpacking each other's
bits.
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


# ---------------------------------------------------------------------------
# DCI format 0 (36.212 §5.3.3.1.1) — UL grant; sized == format 1A
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Dci0:
    rb_start: int
    l_crb: int
    mcs: int
    ndi: int = 0
    tpc: int = 0
    dmrs_cs: int = 0
    hopping: bool = False
    cqi_request: bool = False


def dci_0_pack(d: Dci0, n_rb_ul: int, size: int) -> np.ndarray:
    """size must be dci_1a_size(n_rb_dl) — formats 0/1A are padded equal."""
    bits: list[int] = []
    _put(bits, 0, 1)                       # format flag: 0
    _put(bits, 1 if d.hopping else 0, 1)
    _put(bits, riv_encode(n_rb_ul, d.rb_start, d.l_crb), riv_bits(n_rb_ul))
    _put(bits, d.mcs, 5)
    _put(bits, d.ndi, 1)
    _put(bits, d.tpc, 2)
    _put(bits, d.dmrs_cs, 3)
    _put(bits, 1 if d.cqi_request else 0, 1)
    if len(bits) > size:
        raise ValueError("format 0 larger than target size")
    while len(bits) < size:
        bits.append(0)
    return np.asarray(bits, dtype=np.int32)


def dci_0_unpack(bits: np.ndarray, n_rb_ul: int) -> Dci0 | None:
    pos = 0
    flag, pos = _get(bits, pos, 1)
    if flag != 0:
        return None
    hop, pos = _get(bits, pos, 1)
    riv, pos = _get(bits, pos, riv_bits(n_rb_ul))
    mcs, pos = _get(bits, pos, 5)
    ndi, pos = _get(bits, pos, 1)
    tpc, pos = _get(bits, pos, 2)
    cs, pos = _get(bits, pos, 3)
    cqi, pos = _get(bits, pos, 1)
    start, l = riv_decode(n_rb_ul, riv)
    if start + l > n_rb_ul or l < 1:
        return None
    return Dci0(rb_start=start, l_crb=l, mcs=mcs, ndi=ndi, tpc=tpc,
                dmrs_cs=cs, hopping=bool(hop), cqi_request=bool(cqi))


# ---------------------------------------------------------------------------
# DCI format 1 (36.212 §5.3.3.1.2) — single-codeword grant, resource
# allocation type 0 (RBG bitmap, 36.213 §7.1.6.1)
# ---------------------------------------------------------------------------

def rbg_size(n_rb: int) -> int:
    """P from 36.213 Table 7.1.6.1-1."""
    if n_rb <= 10:
        return 1
    if n_rb <= 26:
        return 2
    if n_rb <= 63:
        return 3
    return 4


def n_rbg(n_rb: int) -> int:
    return math.ceil(n_rb / rbg_size(n_rb))


def rbg_bitmap_to_prbs(bitmap: int, n_rb: int) -> list[int]:
    """Expand a type-0 RBG bitmap (MSB = RBG 0) to sorted PRB indices.

    The last RBG may be short (``n_rb mod P`` PRBs, 36.213 §7.1.6.1)."""
    p = rbg_size(n_rb)
    nbg = n_rbg(n_rb)
    prbs: list[int] = []
    for g in range(nbg):
        if (bitmap >> (nbg - 1 - g)) & 1:
            prbs.extend(range(g * p, min((g + 1) * p, n_rb)))
    return prbs


def prbs_to_rbg_bitmap(prbs, n_rb: int) -> int:
    """Smallest type-0 bitmap covering ``prbs`` (whole-RBG granularity)."""
    p = rbg_size(n_rb)
    nbg = n_rbg(n_rb)
    bitmap = 0
    for prb in prbs:
        if not 0 <= prb < n_rb:
            raise ValueError(f"PRB {prb} out of range")
        bitmap |= 1 << (nbg - 1 - prb // p)
    return bitmap


@dataclasses.dataclass
class Dci1:
    rbg_bitmap: int        # type-0 bitmap, MSB = RBG 0
    mcs: int
    rv: int
    harq: int = 0
    ndi: int = 0
    tpc: int = 0

    def prbs(self, n_rb: int) -> list[int]:
        return rbg_bitmap_to_prbs(self.rbg_bitmap, n_rb)


def dci_1_size(n_rb: int) -> int:
    header = 1 if n_rb > 10 else 0         # RA type-0/1 selector bit
    n = header + n_rbg(n_rb) + 5 + 3 + 1 + 2 + 2
    # 36.212 §5.3.3.1.2: pad if equal to a format-0/1A size or an
    # ambiguous size
    while n == dci_1a_size(n_rb) or n in AMBIGUOUS_SIZES:
        n += 1
    return n


def dci_1_pack(d: Dci1, n_rb: int) -> np.ndarray:
    nbg = n_rbg(n_rb)
    if d.rbg_bitmap >> nbg:
        raise ValueError("bitmap wider than N_RBG")
    bits: list[int] = []
    if n_rb > 10:
        _put(bits, 0, 1)                   # RA type 0
    _put(bits, d.rbg_bitmap, nbg)
    _put(bits, d.mcs, 5)
    _put(bits, d.harq, 3)
    _put(bits, d.ndi, 1)
    _put(bits, d.rv, 2)
    _put(bits, d.tpc, 2)
    while len(bits) < dci_1_size(n_rb):
        bits.append(0)
    return np.asarray(bits, dtype=np.int32)


def dci_1_unpack(bits: np.ndarray, n_rb: int) -> Dci1 | None:
    if len(bits) != dci_1_size(n_rb):
        return None
    pos = 0
    if n_rb > 10:
        ra_type, pos = _get(bits, pos, 1)
        if ra_type != 0:
            return None                    # type-1 subset alloc not supported
    bitmap, pos = _get(bits, pos, n_rbg(n_rb))
    if bitmap == 0:
        return None
    mcs, pos = _get(bits, pos, 5)
    harq, pos = _get(bits, pos, 3)
    ndi, pos = _get(bits, pos, 1)
    rv, pos = _get(bits, pos, 2)
    tpc, pos = _get(bits, pos, 2)
    return Dci1(rbg_bitmap=bitmap, mcs=mcs, rv=rv, harq=harq, ndi=ndi,
                tpc=tpc)


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
# DCI formats 2 / 2A — two-codeword spatial multiplexing grants
# (36.212 §5.3.3.1.5 / §5.3.3.1.5A; FDD, 2 antenna ports, RA type 0)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Dci2A:
    """Format 2A (TM3, large-delay CDD).  Two transport blocks."""
    rbg_bitmap: int        # type-0 bitmap, MSB = RBG 0
    mcs0: int
    mcs1: int
    rv0: int = 0
    rv1: int = 0
    ndi0: int = 0
    ndi1: int = 0
    harq: int = 0
    tpc: int = 0
    swap: int = 0          # TB-to-codeword swap flag

    def prbs(self, n_rb: int) -> list[int]:
        return rbg_bitmap_to_prbs(self.rbg_bitmap, n_rb)


@dataclasses.dataclass
class Dci2(Dci2A):
    """Format 2 (TM4, closed loop): adds precoding information.

    ``precoding`` carries the 2-port 2-layer codebook index (0..2,
    36.211 Table 6.3.4.2.3-2) directly; the exact 36.212 Table
    5.3.3.1.5-4 bit-field semantics are [U] pending spec verification."""
    precoding: int = 1


def _dci_2x_size(n_rb: int, precoding_bits: int) -> int:
    header = 1 if n_rb > 10 else 0         # RA type-0/1 selector bit
    n = header + n_rbg(n_rb) + 2 + 3 + 1 + 2 * (5 + 1 + 2) + precoding_bits
    while n == dci_1a_size(n_rb) or n in AMBIGUOUS_SIZES:
        n += 1
    return n


def dci_2a_size(n_rb: int) -> int:
    return _dci_2x_size(n_rb, 0)           # 2 antenna ports: no precoding


def dci_2_size(n_rb: int) -> int:
    return _dci_2x_size(n_rb, 3)           # 2 antenna ports: 3 bits


def _dci_2x_pack(d, n_rb: int, precoding_bits: int, size: int) -> np.ndarray:
    nbg = n_rbg(n_rb)
    if d.rbg_bitmap >> nbg:
        raise ValueError("bitmap wider than N_RBG")
    bits: list[int] = []
    if n_rb > 10:
        _put(bits, 0, 1)                   # RA type 0
    _put(bits, d.rbg_bitmap, nbg)
    _put(bits, d.tpc, 2)
    _put(bits, d.harq, 3)
    _put(bits, d.swap, 1)
    _put(bits, d.mcs0, 5)
    _put(bits, d.ndi0, 1)
    _put(bits, d.rv0, 2)
    _put(bits, d.mcs1, 5)
    _put(bits, d.ndi1, 1)
    _put(bits, d.rv1, 2)
    if precoding_bits:
        _put(bits, d.precoding, precoding_bits)
    while len(bits) < size:
        bits.append(0)
    return np.asarray(bits, dtype=np.int32)


def dci_2a_pack(d: Dci2A, n_rb: int) -> np.ndarray:
    return _dci_2x_pack(d, n_rb, 0, dci_2a_size(n_rb))


def dci_2_pack(d: Dci2, n_rb: int) -> np.ndarray:
    return _dci_2x_pack(d, n_rb, 3, dci_2_size(n_rb))


def _dci_2x_unpack(bits: np.ndarray, n_rb: int, precoding_bits: int):
    pos = 0
    if n_rb > 10:
        ra_type, pos = _get(bits, pos, 1)
        if ra_type != 0:
            return None                    # type-1 subset alloc unsupported
    bitmap, pos = _get(bits, pos, n_rbg(n_rb))
    if bitmap == 0:
        return None
    tpc, pos = _get(bits, pos, 2)
    harq, pos = _get(bits, pos, 3)
    swap, pos = _get(bits, pos, 1)
    mcs0, pos = _get(bits, pos, 5)
    ndi0, pos = _get(bits, pos, 1)
    rv0, pos = _get(bits, pos, 2)
    mcs1, pos = _get(bits, pos, 5)
    ndi1, pos = _get(bits, pos, 1)
    rv1, pos = _get(bits, pos, 2)
    fields = dict(rbg_bitmap=bitmap, mcs0=mcs0, mcs1=mcs1, rv0=rv0, rv1=rv1,
                  ndi0=ndi0, ndi1=ndi1, harq=harq, tpc=tpc, swap=swap)
    if precoding_bits:
        pre, pos = _get(bits, pos, precoding_bits)
        if pre > 2:
            return None                    # only 2-layer codebook 0..2
        return Dci2(precoding=pre, **fields)
    return Dci2A(**fields)


def dci_2a_unpack(bits: np.ndarray, n_rb: int) -> Dci2A | None:
    if len(bits) != dci_2a_size(n_rb):
        return None
    return _dci_2x_unpack(bits, n_rb, 0)


def dci_2_unpack(bits: np.ndarray, n_rb: int) -> Dci2 | None:
    if len(bits) != dci_2_size(n_rb):
        return None
    return _dci_2x_unpack(bits, n_rb, 3)


# ---------------------------------------------------------------------------
# DCI formats 1B / 1D (36.212 §5.3.3.1.3A / §5.3.3.1.4A) — rank-1
# closed-loop precoding grants (TM6) and MU-MIMO grants (TM5)
# ---------------------------------------------------------------------------
#
# Same contiguous-RIV body as format 1A but without the 0/1A format flag,
# plus TPMI precoding information (2 bits for 2 antenna ports, 4 for 4)
# and one trailing bit: PMI confirmation (1B) or downlink power offset (1D).
# (reference capability: liblte_phy.cc carries only 1A — formats beyond are
# capability-plus; sizes follow the §5.3.3.1.2 padding rules: never an
# ambiguous size and never equal to the 0/1A size monitored alongside.)


@dataclasses.dataclass
class Dci1B:
    rb_start: int
    l_crb: int
    mcs: int
    rv: int
    harq: int = 0
    ndi: int = 0
    tpc: int = 0
    tpmi: int = 0          # codebook index for rank-1 precoding
    pmi_confirm: int = 0   # 1 = precoder follows the UE's PMI report
    distributed: bool = False


@dataclasses.dataclass
class Dci1D:
    rb_start: int
    l_crb: int
    mcs: int
    rv: int
    harq: int = 0
    ndi: int = 0
    tpc: int = 0
    tpmi: int = 0
    dl_power_offset: int = 0   # 1 = -10log10(2) dB (MU-MIMO power split)
    distributed: bool = False


def _tpmi_bits(n_ant: int) -> int:
    return 2 if n_ant == 2 else 4


def _dci_1bd_size(n_rb: int, n_ant: int) -> int:
    n = 1 + riv_bits(n_rb) + 5 + 3 + 1 + 2 + 2 + _tpmi_bits(n_ant) + 1
    while n == dci_1a_size(n_rb) or n in AMBIGUOUS_SIZES:
        n += 1
    return n


def dci_1b_size(n_rb: int, n_ant: int = 2) -> int:
    return _dci_1bd_size(n_rb, n_ant)


def dci_1d_size(n_rb: int, n_ant: int = 2) -> int:
    return _dci_1bd_size(n_rb, n_ant)


def _dci_1bd_pack(d, n_rb: int, n_ant: int, last_bit: int) -> np.ndarray:
    bits: list[int] = []
    _put(bits, 1 if d.distributed else 0, 1)
    _put(bits, riv_encode(n_rb, d.rb_start, d.l_crb), riv_bits(n_rb))
    _put(bits, d.mcs, 5)
    _put(bits, d.harq, 3)
    _put(bits, d.ndi, 1)
    _put(bits, d.rv, 2)
    _put(bits, d.tpc, 2)
    _put(bits, d.tpmi, _tpmi_bits(n_ant))
    _put(bits, last_bit, 1)
    while len(bits) < _dci_1bd_size(n_rb, n_ant):
        bits.append(0)
    return np.asarray(bits, dtype=np.int32)


def dci_1b_pack(d: Dci1B, n_rb: int, n_ant: int = 2) -> np.ndarray:
    return _dci_1bd_pack(d, n_rb, n_ant, d.pmi_confirm)


def dci_1d_pack(d: Dci1D, n_rb: int, n_ant: int = 2) -> np.ndarray:
    return _dci_1bd_pack(d, n_rb, n_ant, d.dl_power_offset)


def _dci_1bd_unpack(bits: np.ndarray, n_rb: int, n_ant: int):
    pos = 0
    dist, pos = _get(bits, pos, 1)
    riv, pos = _get(bits, pos, riv_bits(n_rb))
    mcs, pos = _get(bits, pos, 5)
    harq, pos = _get(bits, pos, 3)
    ndi, pos = _get(bits, pos, 1)
    rv, pos = _get(bits, pos, 2)
    tpc, pos = _get(bits, pos, 2)
    tpmi, pos = _get(bits, pos, _tpmi_bits(n_ant))
    last, pos = _get(bits, pos, 1)
    start, l = riv_decode(n_rb, riv)
    if start + l > n_rb or l < 1:
        return None
    return (dict(rb_start=start, l_crb=l, mcs=mcs, rv=rv, harq=harq,
                 ndi=ndi, tpc=tpc, tpmi=tpmi, distributed=bool(dist)), last)


def dci_1b_unpack(bits: np.ndarray, n_rb: int, n_ant: int = 2) -> Dci1B | None:
    if len(bits) != dci_1b_size(n_rb, n_ant):
        return None
    got = _dci_1bd_unpack(bits, n_rb, n_ant)
    if got is None:
        return None
    fields, last = got
    return Dci1B(pmi_confirm=last, **fields)


def dci_1d_unpack(bits: np.ndarray, n_rb: int, n_ant: int = 2) -> Dci1D | None:
    if len(bits) != dci_1d_size(n_rb, n_ant):
        return None
    got = _dci_1bd_unpack(bits, n_rb, n_ant)
    if got is None:
        return None
    fields, last = got
    return Dci1D(dl_power_offset=last, **fields)


# ---------------------------------------------------------------------------
# DCI formats 3 / 3A (36.212 §5.3.3.1.6 / §5.3.3.1.7) — group TPC commands
# on TPC-PUCCH-RNTI / TPC-PUSCH-RNTI; payload size equals format 0/1A
# ---------------------------------------------------------------------------


def dci_3_n_commands(n_rb: int) -> int:
    return dci_1a_size(n_rb) // 2


def dci_3a_n_commands(n_rb: int) -> int:
    return dci_1a_size(n_rb)


def dci_3_pack(tpc_commands, n_rb: int) -> np.ndarray:
    """N = floor(L_1A/2) two-bit TPC commands; missing commands pad as 0."""
    size = dci_1a_size(n_rb)
    n = dci_3_n_commands(n_rb)
    if len(tpc_commands) > n:
        raise ValueError("too many TPC commands")
    bits: list[int] = []
    for c in tpc_commands:
        if not 0 <= int(c) <= 3:
            raise ValueError(f"TPC command {c} out of range 0..3")
        _put(bits, c, 2)
    while len(bits) < size:
        bits.append(0)
    return np.asarray(bits, dtype=np.int32)


def dci_3_unpack(bits: np.ndarray, n_rb: int) -> tuple[int, ...] | None:
    if len(bits) != dci_1a_size(n_rb):
        return None
    n = dci_3_n_commands(n_rb)
    return tuple(int(bits[2 * i]) * 2 + int(bits[2 * i + 1])
                 for i in range(n))


def dci_3a_pack(tpc_commands, n_rb: int) -> np.ndarray:
    """M = L_1A one-bit TPC commands."""
    size = dci_1a_size(n_rb)
    if len(tpc_commands) > size:
        raise ValueError("too many TPC commands")
    for c in tpc_commands:
        if not 0 <= int(c) <= 1:
            raise ValueError(f"TPC command {c} out of range 0..1")
    bits = [int(c) for c in tpc_commands]
    while len(bits) < size:
        bits.append(0)
    return np.asarray(bits, dtype=np.int32)


def dci_3a_unpack(bits: np.ndarray, n_rb: int) -> tuple[int, ...] | None:
    if len(bits) != dci_1a_size(n_rb):
        return None
    return tuple(int(b) for b in bits)
