"""Rel-8 SystemInformationBlockType3..11 codecs in UNALIGNED PER (36.331
§6.3.1 / X.691).

(reference capability: ``liblte/src/liblte_rrc.cc`` per-SIB pack/unpack
pairs — ``liblte_rrc_pack_sys_info_block_type_3_ie`` .. ``_13_ie`` and the
SystemInformation message wrapper.  The reference hand-rolls the same
bit-level ASN.1; here each SIB is a dataclass + UperWriter/UperReader
field tree.)

The ASN.1 layouts are derived from 3GPP TS 36.331 (Rel-8).  The port's
own copy of ``lteax/stack/rrc_sibs.py``; ``tests/test_torch_plans.py``
holds the two equal by packing and unpacking the same messages.

Conventions:
- ENUM fields carry the root index unless a ``*_db``/named mapping exists.
- OPTIONAL fields are ``None`` when absent.
- BIT STRING fields carry ints (MSB-first, fixed width).
- OCTET STRING fields carry ``bytes``.
"""

from __future__ import annotations

import dataclasses

from lteax_torch.stack.uper import UperReader, UperWriter

# ---------------------------------------------------------------------------
# shared IEs
# ---------------------------------------------------------------------------

Q_HYST_DB = (0, 1, 2, 3, 4, 5, 6, 8, 10, 12, 14, 16, 18, 20, 22, 24)
# Q-OffsetRange ENUMERATED, 31 root values (dB-24..dB24)
Q_OFFSET_DB = (-24, -22, -20, -18, -16, -14, -12, -10, -8, -6, -5, -4, -3,
               -2, -1, 0, 1, 2, 3, 4, 5, 6, 8, 10, 12, 14, 16, 18, 20, 22, 24)
PCI_RANGE_N = (4, 8, 12, 16, 24, 32, 48, 64, 84, 96, 128, 168, 252, 504,
               None, None)  # n4..n504 + 2 spares


@dataclasses.dataclass
class SpeedStateScaleFactors:
    sf_medium: int = 3          # ENUM {oDot25, oDot5, oDot75, lDot0}
    sf_high: int = 3


def _pack_sssf(w: UperWriter, s: SpeedStateScaleFactors):
    w.enum(s.sf_medium, 4)
    w.enum(s.sf_high, 4)


def _unpack_sssf(r: UperReader) -> SpeedStateScaleFactors:
    return SpeedStateScaleFactors(r.enum(4), r.enum(4))


@dataclasses.dataclass
class MobilityStateParameters:
    t_evaluation: int = 0       # ENUM {s30, s60, s120, s180, s240, 3 spares}
    t_hyst_normal: int = 0      # same 8-value ENUM
    n_cell_change_medium: int = 1   # INTEGER (1..16)
    n_cell_change_high: int = 1


@dataclasses.dataclass
class SpeedStateReselectionPars:
    mobility: MobilityStateParameters = dataclasses.field(
        default_factory=MobilityStateParameters)
    q_hyst_sf_medium: int = 3   # ENUM {dB-6, dB-4, dB-2, dB0}
    q_hyst_sf_high: int = 3


@dataclasses.dataclass
class PhysCellIdRange:
    start: int = 0              # PhysCellId (0..503)
    range_n: int | None = None  # cell count: 4..504 (None = single cell)


def _pack_pci_range(w: UperWriter, p: PhysCellIdRange):
    w.opt(p.range_n is not None)
    w.cint(p.start, 0, 503)
    if p.range_n is not None:
        w.enum(PCI_RANGE_N.index(p.range_n), 16)


def _unpack_pci_range(r: UperReader) -> PhysCellIdRange:
    has_range = r.opt()
    start = r.cint(0, 503)
    rng = PCI_RANGE_N[r.enum(16)] if has_range else None
    return PhysCellIdRange(start, rng)


# ---------------------------------------------------------------------------
# SIB3 — common / intra-frequency cell reselection
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Sib3:
    q_hyst_db: int = 2                      # dB, one of Q_HYST_DB
    speed_state: SpeedStateReselectionPars | None = None
    s_non_intra_search: int | None = 6      # ReselectionThreshold (0..31)
    thresh_serving_low: int = 4             # (0..31)
    cell_resel_priority: int = 4            # (0..7)
    q_rx_lev_min: int = -70                 # (-70..-22), x2 dBm
    p_max: int | None = None                # (-30..33) dBm
    s_intra_search: int | None = None       # (0..31)
    allowed_meas_bandwidth: int | None = None   # ENUM idx {mbw6..mbw100}
    presence_antenna_port1: bool = False
    neigh_cell_config: int = 1              # BIT STRING (2)
    t_resel_eutra_s: int = 1                # T-Reselection (0..7) seconds
    t_resel_eutra_sf: SpeedStateScaleFactors | None = None


def pack_sib3_body(w: UperWriter, s: Sib3):
    w.bit(0)                                # extension bit
    # cellReselectionInfoCommon
    w.opt(s.speed_state is not None)
    w.enum(Q_HYST_DB.index(s.q_hyst_db), 16)
    if s.speed_state is not None:
        m = s.speed_state.mobility
        w.enum(m.t_evaluation, 8)
        w.enum(m.t_hyst_normal, 8)
        w.cint(m.n_cell_change_medium, 1, 16)
        w.cint(m.n_cell_change_high, 1, 16)
        w.enum(s.speed_state.q_hyst_sf_medium, 4)
        w.enum(s.speed_state.q_hyst_sf_high, 4)
    # cellReselectionServingFreqInfo
    w.opt(s.s_non_intra_search is not None)
    if s.s_non_intra_search is not None:
        w.cint(s.s_non_intra_search, 0, 31)
    w.cint(s.thresh_serving_low, 0, 31)
    w.cint(s.cell_resel_priority, 0, 7)
    # intraFreqCellReselectionInfo
    w.opt(s.p_max is not None)
    w.opt(s.s_intra_search is not None)
    w.opt(s.allowed_meas_bandwidth is not None)
    w.opt(s.t_resel_eutra_sf is not None)
    w.cint(s.q_rx_lev_min, -70, -22)
    if s.p_max is not None:
        w.cint(s.p_max, -30, 33)
    if s.s_intra_search is not None:
        w.cint(s.s_intra_search, 0, 31)
    if s.allowed_meas_bandwidth is not None:
        w.enum(s.allowed_meas_bandwidth, 6)
    w.bit(1 if s.presence_antenna_port1 else 0)
    w.bitstring(s.neigh_cell_config, 2)
    w.cint(s.t_resel_eutra_s, 0, 7)
    if s.t_resel_eutra_sf is not None:
        _pack_sssf(w, s.t_resel_eutra_sf)


def unpack_sib3_body(r: UperReader) -> Sib3:
    if r.bit():
        raise ValueError("extended SIB3")
    s = Sib3()
    has_speed = r.opt()
    s.q_hyst_db = Q_HYST_DB[r.enum(16)]
    if has_speed:
        m = MobilityStateParameters(r.enum(8), r.enum(8),
                                    r.cint(1, 16), r.cint(1, 16))
        s.speed_state = SpeedStateReselectionPars(m, r.enum(4), r.enum(4))
    else:
        s.speed_state = None
    has_snis = r.opt()
    s.s_non_intra_search = r.cint(0, 31) if has_snis else None
    s.thresh_serving_low = r.cint(0, 31)
    s.cell_resel_priority = r.cint(0, 7)
    has_pmax, has_sis, has_bw, has_sf = r.opt(), r.opt(), r.opt(), r.opt()
    s.q_rx_lev_min = r.cint(-70, -22)
    s.p_max = r.cint(-30, 33) if has_pmax else None
    s.s_intra_search = r.cint(0, 31) if has_sis else None
    s.allowed_meas_bandwidth = r.enum(6) if has_bw else None
    s.presence_antenna_port1 = bool(r.bit())
    s.neigh_cell_config = r.bitstring(2)
    s.t_resel_eutra_s = r.cint(0, 7)
    s.t_resel_eutra_sf = _unpack_sssf(r) if has_sf else None
    return s


# ---------------------------------------------------------------------------
# SIB4 — intra-frequency neighbours
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class IntraFreqNeighCell:
    phys_cell_id: int           # (0..503)
    q_offset_db: int = 0        # one of Q_OFFSET_DB


@dataclasses.dataclass
class Sib4:
    neigh_cells: tuple[IntraFreqNeighCell, ...] | None = None   # SIZE(1..16)
    black_cells: tuple[PhysCellIdRange, ...] | None = None      # SIZE(1..16)
    csg_pci_range: PhysCellIdRange | None = None


def pack_sib4_body(w: UperWriter, s: Sib4):
    w.bit(0)
    w.opt(s.neigh_cells is not None)
    w.opt(s.black_cells is not None)
    w.opt(s.csg_pci_range is not None)
    if s.neigh_cells is not None:
        w.length(len(s.neigh_cells), 1, 16)
        for c in s.neigh_cells:
            w.bit(0)            # IntraFreqNeighCellInfo extension bit
            w.cint(c.phys_cell_id, 0, 503)
            w.enum(Q_OFFSET_DB.index(c.q_offset_db), 31)
    if s.black_cells is not None:
        w.length(len(s.black_cells), 1, 16)
        for p in s.black_cells:
            _pack_pci_range(w, p)
    if s.csg_pci_range is not None:
        _pack_pci_range(w, s.csg_pci_range)


def unpack_sib4_body(r: UperReader) -> Sib4:
    if r.bit():
        raise ValueError("extended SIB4")
    has_n, has_b, has_c = r.opt(), r.opt(), r.opt()
    s = Sib4()
    if has_n:
        cells = []
        for _ in range(r.length(1, 16)):
            if r.bit():
                raise ValueError("extended neigh cell")
            cells.append(IntraFreqNeighCell(r.cint(0, 503),
                                            Q_OFFSET_DB[r.enum(31)]))
        s.neigh_cells = tuple(cells)
    if has_b:
        s.black_cells = tuple(_unpack_pci_range(r)
                              for _ in range(r.length(1, 16)))
    if has_c:
        s.csg_pci_range = _unpack_pci_range(r)
    return s


# ---------------------------------------------------------------------------
# SIB5 — inter-frequency carriers
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class InterFreqNeighCell:
    phys_cell_id: int
    q_offset_db: int = 0


@dataclasses.dataclass
class InterFreqCarrier:
    dl_earfcn: int                          # (0..65535)
    q_rx_lev_min: int = -70                 # (-70..-22)
    p_max: int | None = None                # (-30..33)
    t_resel_eutra_s: int = 1                # (0..7)
    t_resel_eutra_sf: SpeedStateScaleFactors | None = None
    thresh_x_high: int = 4                  # (0..31)
    thresh_x_low: int = 4
    allowed_meas_bandwidth: int = 0         # ENUM {mbw6..mbw100}
    presence_antenna_port1: bool = False
    cell_resel_priority: int | None = None  # (0..7)
    neigh_cell_config: int = 1              # BIT STRING (2)
    q_offset_freq_db: int | None = None     # DEFAULT dB0; None = absent
    neigh_cells: tuple[InterFreqNeighCell, ...] | None = None
    black_cells: tuple[PhysCellIdRange, ...] | None = None


@dataclasses.dataclass
class Sib5:
    carriers: tuple[InterFreqCarrier, ...] = ()     # SIZE (1..8)


def pack_sib5_body(w: UperWriter, s: Sib5):
    w.bit(0)
    w.length(len(s.carriers), 1, 8)
    for c in s.carriers:
        w.bit(0)                            # InterFreqCarrierFreqInfo ext
        w.opt(c.p_max is not None)
        w.opt(c.t_resel_eutra_sf is not None)
        w.opt(c.cell_resel_priority is not None)
        w.opt(c.q_offset_freq_db is not None)       # DEFAULT field
        w.opt(c.neigh_cells is not None)
        w.opt(c.black_cells is not None)
        w.cint(c.dl_earfcn, 0, 65535)
        w.cint(c.q_rx_lev_min, -70, -22)
        if c.p_max is not None:
            w.cint(c.p_max, -30, 33)
        w.cint(c.t_resel_eutra_s, 0, 7)
        if c.t_resel_eutra_sf is not None:
            _pack_sssf(w, c.t_resel_eutra_sf)
        w.cint(c.thresh_x_high, 0, 31)
        w.cint(c.thresh_x_low, 0, 31)
        w.enum(c.allowed_meas_bandwidth, 6)
        w.bit(1 if c.presence_antenna_port1 else 0)
        if c.cell_resel_priority is not None:
            w.cint(c.cell_resel_priority, 0, 7)
        w.bitstring(c.neigh_cell_config, 2)
        if c.q_offset_freq_db is not None:
            w.enum(Q_OFFSET_DB.index(c.q_offset_freq_db), 31)
        if c.neigh_cells is not None:
            w.length(len(c.neigh_cells), 1, 16)
            for n in c.neigh_cells:
                w.cint(n.phys_cell_id, 0, 503)
                w.enum(Q_OFFSET_DB.index(n.q_offset_db), 31)
        if c.black_cells is not None:
            w.length(len(c.black_cells), 1, 16)
            for p in c.black_cells:
                _pack_pci_range(w, p)


def unpack_sib5_body(r: UperReader) -> Sib5:
    if r.bit():
        raise ValueError("extended SIB5")
    carriers = []
    for _ in range(r.length(1, 8)):
        if r.bit():
            raise ValueError("extended carrier info")
        has_pmax, has_sf, has_pri = r.opt(), r.opt(), r.opt()
        has_qoff, has_n, has_b = r.opt(), r.opt(), r.opt()
        c = InterFreqCarrier(dl_earfcn=r.cint(0, 65535))
        c.q_rx_lev_min = r.cint(-70, -22)
        c.p_max = r.cint(-30, 33) if has_pmax else None
        c.t_resel_eutra_s = r.cint(0, 7)
        c.t_resel_eutra_sf = _unpack_sssf(r) if has_sf else None
        c.thresh_x_high = r.cint(0, 31)
        c.thresh_x_low = r.cint(0, 31)
        c.allowed_meas_bandwidth = r.enum(6)
        c.presence_antenna_port1 = bool(r.bit())
        c.cell_resel_priority = r.cint(0, 7) if has_pri else None
        c.neigh_cell_config = r.bitstring(2)
        c.q_offset_freq_db = Q_OFFSET_DB[r.enum(31)] if has_qoff else None
        if has_n:
            c.neigh_cells = tuple(
                InterFreqNeighCell(r.cint(0, 503), Q_OFFSET_DB[r.enum(31)])
                for _ in range(r.length(1, 16)))
        if has_b:
            c.black_cells = tuple(_unpack_pci_range(r)
                                  for _ in range(r.length(1, 16)))
        carriers.append(c)
    return Sib5(tuple(carriers))


# ---------------------------------------------------------------------------
# SIB6 — UTRA carriers
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class UtraCarrierFdd:
    arfcn: int                              # (0..16383)
    cell_resel_priority: int | None = None
    thresh_x_high: int = 4                  # (0..31)
    thresh_x_low: int = 4
    q_rx_lev_min: int = -60                 # (-60..-13), x2 dBm
    p_max_utra: int = 24                    # (-50..33)
    q_qual_min: int = -18                   # (-24..0) dB


@dataclasses.dataclass
class UtraCarrierTdd:
    arfcn: int
    cell_resel_priority: int | None = None
    thresh_x_high: int = 4
    thresh_x_low: int = 4
    q_rx_lev_min: int = -60
    p_max_utra: int = 24


@dataclasses.dataclass
class Sib6:
    carriers_fdd: tuple[UtraCarrierFdd, ...] | None = None  # SIZE (1..16)
    carriers_tdd: tuple[UtraCarrierTdd, ...] | None = None
    t_resel_utra_s: int = 1
    t_resel_utra_sf: SpeedStateScaleFactors | None = None


def pack_sib6_body(w: UperWriter, s: Sib6):
    w.bit(0)
    w.opt(s.carriers_fdd is not None)
    w.opt(s.carriers_tdd is not None)
    w.opt(s.t_resel_utra_sf is not None)
    if s.carriers_fdd is not None:
        w.length(len(s.carriers_fdd), 1, 16)
        for c in s.carriers_fdd:
            w.bit(0)                        # CarrierFreqUTRA-FDD ext
            w.opt(c.cell_resel_priority is not None)
            w.cint(c.arfcn, 0, 16383)
            if c.cell_resel_priority is not None:
                w.cint(c.cell_resel_priority, 0, 7)
            w.cint(c.thresh_x_high, 0, 31)
            w.cint(c.thresh_x_low, 0, 31)
            w.cint(c.q_rx_lev_min, -60, -13)
            w.cint(c.p_max_utra, -50, 33)
            w.cint(c.q_qual_min, -24, 0)
    if s.carriers_tdd is not None:
        w.length(len(s.carriers_tdd), 1, 16)
        for c in s.carriers_tdd:
            w.bit(0)
            w.opt(c.cell_resel_priority is not None)
            w.cint(c.arfcn, 0, 16383)
            if c.cell_resel_priority is not None:
                w.cint(c.cell_resel_priority, 0, 7)
            w.cint(c.thresh_x_high, 0, 31)
            w.cint(c.thresh_x_low, 0, 31)
            w.cint(c.q_rx_lev_min, -60, -13)
            w.cint(c.p_max_utra, -50, 33)
    w.cint(s.t_resel_utra_s, 0, 7)
    if s.t_resel_utra_sf is not None:
        _pack_sssf(w, s.t_resel_utra_sf)


def unpack_sib6_body(r: UperReader) -> Sib6:
    if r.bit():
        raise ValueError("extended SIB6")
    has_f, has_t, has_sf = r.opt(), r.opt(), r.opt()
    s = Sib6()
    if has_f:
        out = []
        for _ in range(r.length(1, 16)):
            if r.bit():
                raise ValueError("extended UTRA-FDD carrier")
            has_pri = r.opt()
            c = UtraCarrierFdd(arfcn=r.cint(0, 16383))
            c.cell_resel_priority = r.cint(0, 7) if has_pri else None
            c.thresh_x_high = r.cint(0, 31)
            c.thresh_x_low = r.cint(0, 31)
            c.q_rx_lev_min = r.cint(-60, -13)
            c.p_max_utra = r.cint(-50, 33)
            c.q_qual_min = r.cint(-24, 0)
            out.append(c)
        s.carriers_fdd = tuple(out)
    if has_t:
        out = []
        for _ in range(r.length(1, 16)):
            if r.bit():
                raise ValueError("extended UTRA-TDD carrier")
            has_pri = r.opt()
            c = UtraCarrierTdd(arfcn=r.cint(0, 16383))
            c.cell_resel_priority = r.cint(0, 7) if has_pri else None
            c.thresh_x_high = r.cint(0, 31)
            c.thresh_x_low = r.cint(0, 31)
            c.q_rx_lev_min = r.cint(-60, -13)
            c.p_max_utra = r.cint(-50, 33)
            out.append(c)
        s.carriers_tdd = tuple(out)
    s.t_resel_utra_s = r.cint(0, 7)
    s.t_resel_utra_sf = _unpack_sssf(r) if has_sf else None
    return s


# ---------------------------------------------------------------------------
# SIB7 — GERAN carriers
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class GeranCarrierFreqs:
    starting_arfcn: int                     # (0..1023)
    band_indicator: int = 0                 # ENUM {dcs1800, pcs1900}
    # followingARFCNs CHOICE — exactly one of:
    explicit_arfcns: tuple[int, ...] | None = None       # SIZE (0..31)
    equally_spaced: tuple[int, int] | None = None        # (spacing 1..8, n 0..31)
    bitmap: bytes | None = None                          # SIZE (1..16) octets


@dataclasses.dataclass
class GeranCarrierInfo:
    freqs: GeranCarrierFreqs
    cell_resel_priority: int | None = None
    ncc_permitted: int = 0xFF               # BIT STRING (8)
    q_rx_lev_min: int = 0                   # (0..45)
    p_max_geran: int | None = None          # (0..39)
    thresh_x_high: int = 4
    thresh_x_low: int = 4


@dataclasses.dataclass
class Sib7:
    t_resel_geran_s: int = 1
    t_resel_geran_sf: SpeedStateScaleFactors | None = None
    carriers: tuple[GeranCarrierInfo, ...] | None = None   # SIZE (1..16)


def _pack_geran_freqs(w: UperWriter, f: GeranCarrierFreqs):
    w.cint(f.starting_arfcn, 0, 1023)
    w.enum(f.band_indicator, 2)
    if f.explicit_arfcns is not None:
        w.cint(0, 0, 2)                     # CHOICE: explicitListOfARFCNs
        w.length(len(f.explicit_arfcns), 0, 31)
        for a in f.explicit_arfcns:
            w.cint(a, 0, 1023)
    elif f.equally_spaced is not None:
        w.cint(1, 0, 2)
        w.cint(f.equally_spaced[0], 1, 8)
        w.cint(f.equally_spaced[1], 0, 31)
    else:
        w.cint(2, 0, 2)
        w.octets(f.bitmap or b"\x00", 1, 16)


def _unpack_geran_freqs(r: UperReader) -> GeranCarrierFreqs:
    f = GeranCarrierFreqs(starting_arfcn=r.cint(0, 1023))
    f.band_indicator = r.enum(2)
    kind = r.cint(0, 2)
    if kind == 0:
        f.explicit_arfcns = tuple(r.cint(0, 1023)
                                  for _ in range(r.length(0, 31)))
    elif kind == 1:
        f.equally_spaced = (r.cint(1, 8), r.cint(0, 31))
    else:
        f.bitmap = r.octets(1, 16)
    return f


def pack_sib7_body(w: UperWriter, s: Sib7):
    w.bit(0)
    w.opt(s.t_resel_geran_sf is not None)
    w.opt(s.carriers is not None)
    w.cint(s.t_resel_geran_s, 0, 7)
    if s.t_resel_geran_sf is not None:
        _pack_sssf(w, s.t_resel_geran_sf)
    if s.carriers is not None:
        w.length(len(s.carriers), 1, 16)
        for c in s.carriers:
            w.bit(0)                        # CarrierFreqsInfoGERAN ext
            _pack_geran_freqs(w, c.freqs)
            # commonInfo
            w.opt(c.cell_resel_priority is not None)
            w.opt(c.p_max_geran is not None)
            if c.cell_resel_priority is not None:
                w.cint(c.cell_resel_priority, 0, 7)
            w.bitstring(c.ncc_permitted, 8)
            w.cint(c.q_rx_lev_min, 0, 45)
            if c.p_max_geran is not None:
                w.cint(c.p_max_geran, 0, 39)
            w.cint(c.thresh_x_high, 0, 31)
            w.cint(c.thresh_x_low, 0, 31)


def unpack_sib7_body(r: UperReader) -> Sib7:
    if r.bit():
        raise ValueError("extended SIB7")
    has_sf, has_list = r.opt(), r.opt()
    s = Sib7(t_resel_geran_s=r.cint(0, 7))
    if has_sf:
        s.t_resel_geran_sf = _unpack_sssf(r)
    if has_list:
        out = []
        for _ in range(r.length(1, 16)):
            if r.bit():
                raise ValueError("extended GERAN carrier")
            c = GeranCarrierInfo(freqs=_unpack_geran_freqs(r))
            has_pri, has_pmax = r.opt(), r.opt()
            c.cell_resel_priority = r.cint(0, 7) if has_pri else None
            c.ncc_permitted = r.bitstring(8)
            c.q_rx_lev_min = r.cint(0, 45)
            c.p_max_geran = r.cint(0, 39) if has_pmax else None
            c.thresh_x_high = r.cint(0, 31)
            c.thresh_x_low = r.cint(0, 31)
            out.append(c)
        s.carriers = tuple(out)
    return s


# ---------------------------------------------------------------------------
# SIB8 — CDMA2000
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class BandClassInfoCdma:
    band_class: int = 0                     # ENUM bc0..bc17 (+spares), 32 root
    cell_resel_priority: int | None = None
    thresh_x_high: int = 4                  # (0..63)
    thresh_x_low: int = 4


@dataclasses.dataclass
class NeighCellsPerBandclassCdma:
    arfcn: int = 0                          # (0..2047)
    phys_cell_ids: tuple[int, ...] = (0,)   # SIZE (1..16) of (0..511)


@dataclasses.dataclass
class NeighCellCdma:
    band_class: int = 0
    per_freq: tuple[NeighCellsPerBandclassCdma, ...] = ()   # SIZE (1..16)


@dataclasses.dataclass
class CellReselParamsCdma:
    band_class_list: tuple[BandClassInfoCdma, ...] = ()     # SIZE (1..32)
    neigh_cell_list: tuple[NeighCellCdma, ...] = ()         # SIZE (1..16)
    t_resel_s: int = 1
    t_resel_sf: SpeedStateScaleFactors | None = None


@dataclasses.dataclass
class PreRegistrationInfoHrpd:
    allowed: bool = False
    zone_id: int | None = None              # (0..255)
    secondary_zone_ids: tuple[int, ...] | None = None    # SIZE (1..2)


@dataclasses.dataclass
class CsfbRegistrationParam1xrtt:
    sid: int = 0                            # BIT STRING (15)
    nid: int = 0                            # BIT STRING (16)
    multiple_sid: bool = False
    multiple_nid: bool = False
    home_reg: bool = False
    foreign_sid_reg: bool = False
    foreign_nid_reg: bool = False
    parameter_reg: bool = False
    power_up_reg: bool = False
    registration_period: int = 0            # BIT STRING (7)
    registration_zone: int = 0              # BIT STRING (12)
    total_zone: int = 0                     # BIT STRING (3)
    zone_timer: int = 0                     # BIT STRING (3)


@dataclasses.dataclass
class Sib8:
    # systemTimeInfo
    cdma_eutra_sync: bool | None = None     # None = systemTimeInfo absent
    system_time: int = 0                    # 39-bit (sync) or 49-bit (async)
    system_time_async: bool = False
    search_window_size: int | None = None   # (0..15)
    # parametersHRPD
    pre_reg_hrpd: PreRegistrationInfoHrpd | None = None
    cell_resel_hrpd: CellReselParamsCdma | None = None
    # parameters1XRTT
    params_1xrtt: bool = False              # presence of the 1XRTT branch
    csfb_1xrtt: CsfbRegistrationParam1xrtt | None = None
    long_code_state_1xrtt: int | None = None    # BIT STRING (42)
    cell_resel_1xrtt: CellReselParamsCdma | None = None


def _pack_cdma_resel(w: UperWriter, c: CellReselParamsCdma):
    w.opt(c.t_resel_sf is not None)
    w.length(len(c.band_class_list), 1, 32)
    for b in c.band_class_list:
        w.bit(0)                            # BandClassInfoCDMA2000 ext
        w.opt(b.cell_resel_priority is not None)
        w.enum(b.band_class, 32, extensible=True)
        if b.cell_resel_priority is not None:
            w.cint(b.cell_resel_priority, 0, 7)
        w.cint(b.thresh_x_high, 0, 63)
        w.cint(b.thresh_x_low, 0, 63)
    w.length(len(c.neigh_cell_list), 1, 16)
    for n in c.neigh_cell_list:
        w.enum(n.band_class, 32, extensible=True)
        w.length(len(n.per_freq), 1, 16)
        for p in n.per_freq:
            w.cint(p.arfcn, 0, 2047)
            w.length(len(p.phys_cell_ids), 1, 16)
            for pci in p.phys_cell_ids:
                w.cint(pci, 0, 511)
    w.cint(c.t_resel_s, 0, 7)
    if c.t_resel_sf is not None:
        _pack_sssf(w, c.t_resel_sf)


def _unpack_cdma_resel(r: UperReader) -> CellReselParamsCdma:
    has_sf = r.opt()
    bcl = []
    for _ in range(r.length(1, 32)):
        if r.bit():
            raise ValueError("extended band class info")
        has_pri = r.opt()
        b = BandClassInfoCdma(band_class=r.enum(32, extensible=True))
        b.cell_resel_priority = r.cint(0, 7) if has_pri else None
        b.thresh_x_high = r.cint(0, 63)
        b.thresh_x_low = r.cint(0, 63)
        bcl.append(b)
    ncl = []
    for _ in range(r.length(1, 16)):
        n = NeighCellCdma(band_class=r.enum(32, extensible=True))
        pf = []
        for _ in range(r.length(1, 16)):
            arfcn = r.cint(0, 2047)
            pcis = tuple(r.cint(0, 511) for _ in range(r.length(1, 16)))
            pf.append(NeighCellsPerBandclassCdma(arfcn, pcis))
        n.per_freq = tuple(pf)
        ncl.append(n)
    c = CellReselParamsCdma(tuple(bcl), tuple(ncl), r.cint(0, 7))
    c.t_resel_sf = _unpack_sssf(r) if has_sf else None
    return c


def pack_sib8_body(w: UperWriter, s: Sib8):
    w.bit(0)
    w.opt(s.cdma_eutra_sync is not None)    # systemTimeInfo
    w.opt(s.search_window_size is not None)
    w.opt(s.pre_reg_hrpd is not None)       # parametersHRPD
    w.opt(s.params_1xrtt)                   # parameters1XRTT
    if s.cdma_eutra_sync is not None:
        w.bit(1 if s.cdma_eutra_sync else 0)
        w.bit(1 if s.system_time_async else 0)   # CHOICE sync/async
        w.bitstring(s.system_time, 49 if s.system_time_async else 39)
    if s.search_window_size is not None:
        w.cint(s.search_window_size, 0, 15)
    if s.pre_reg_hrpd is not None:
        w.opt(s.cell_resel_hrpd is not None)
        p = s.pre_reg_hrpd
        w.opt(p.zone_id is not None)
        w.opt(p.secondary_zone_ids is not None)
        w.bit(1 if p.allowed else 0)
        if p.zone_id is not None:
            w.cint(p.zone_id, 0, 255)
        if p.secondary_zone_ids is not None:
            w.length(len(p.secondary_zone_ids), 1, 2)
            for z in p.secondary_zone_ids:
                w.cint(z, 0, 255)
        if s.cell_resel_hrpd is not None:
            _pack_cdma_resel(w, s.cell_resel_hrpd)
    if s.params_1xrtt:
        w.opt(s.csfb_1xrtt is not None)
        w.opt(s.long_code_state_1xrtt is not None)
        w.opt(s.cell_resel_1xrtt is not None)
        if s.csfb_1xrtt is not None:
            c = s.csfb_1xrtt
            w.bitstring(c.sid, 15)
            w.bitstring(c.nid, 16)
            for b in (c.multiple_sid, c.multiple_nid, c.home_reg,
                      c.foreign_sid_reg, c.foreign_nid_reg, c.parameter_reg,
                      c.power_up_reg):
                w.bit(1 if b else 0)
            w.bitstring(c.registration_period, 7)
            w.bitstring(c.registration_zone, 12)
            w.bitstring(c.total_zone, 3)
            w.bitstring(c.zone_timer, 3)
        if s.long_code_state_1xrtt is not None:
            w.bitstring(s.long_code_state_1xrtt, 42)
        if s.cell_resel_1xrtt is not None:
            _pack_cdma_resel(w, s.cell_resel_1xrtt)


def unpack_sib8_body(r: UperReader) -> Sib8:
    if r.bit():
        raise ValueError("extended SIB8")
    has_time, has_win, has_hrpd, has_1x = r.opt(), r.opt(), r.opt(), r.opt()
    s = Sib8()
    if has_time:
        s.cdma_eutra_sync = bool(r.bit())
        s.system_time_async = bool(r.bit())
        s.system_time = r.bitstring(49 if s.system_time_async else 39)
    if has_win:
        s.search_window_size = r.cint(0, 15)
    if has_hrpd:
        has_resel = r.opt()
        has_zone, has_sec = r.opt(), r.opt()
        p = PreRegistrationInfoHrpd(allowed=bool(r.bit()))
        p.zone_id = r.cint(0, 255) if has_zone else None
        if has_sec:
            p.secondary_zone_ids = tuple(r.cint(0, 255)
                                         for _ in range(r.length(1, 2)))
        s.pre_reg_hrpd = p
        if has_resel:
            s.cell_resel_hrpd = _unpack_cdma_resel(r)
    if has_1x:
        s.params_1xrtt = True
        has_csfb, has_lcs, has_resel = r.opt(), r.opt(), r.opt()
        if has_csfb:
            c = CsfbRegistrationParam1xrtt(sid=r.bitstring(15),
                                           nid=r.bitstring(16))
            (c.multiple_sid, c.multiple_nid, c.home_reg, c.foreign_sid_reg,
             c.foreign_nid_reg, c.parameter_reg, c.power_up_reg) = (
                bool(r.bit()) for _ in range(7))
            c.registration_period = r.bitstring(7)
            c.registration_zone = r.bitstring(12)
            c.total_zone = r.bitstring(3)
            c.zone_timer = r.bitstring(3)
            s.csfb_1xrtt = c
        if has_lcs:
            s.long_code_state_1xrtt = r.bitstring(42)
        if has_resel:
            s.cell_resel_1xrtt = _unpack_cdma_resel(r)
    return s


# ---------------------------------------------------------------------------
# SIB9 / SIB10 / SIB11
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Sib9:
    hnb_name: bytes | None = None           # OCTET STRING SIZE (1..48), UTF-8


def pack_sib9_body(w: UperWriter, s: Sib9):
    w.bit(0)
    w.opt(s.hnb_name is not None)
    if s.hnb_name is not None:
        w.octets(s.hnb_name, 1, 48)


def unpack_sib9_body(r: UperReader) -> Sib9:
    if r.bit():
        raise ValueError("extended SIB9")
    has_name = r.opt()
    return Sib9(hnb_name=r.octets(1, 48) if has_name else None)


@dataclasses.dataclass
class Sib10:
    """ETWS primary notification."""
    message_identifier: int = 0             # BIT STRING (16)
    serial_number: int = 0                  # BIT STRING (16)
    warning_type: bytes = b"\x00\x00"       # OCTET STRING SIZE (2)
    warning_security_info: bytes | None = None  # OCTET STRING SIZE (50)


def pack_sib10_body(w: UperWriter, s: Sib10):
    w.bit(0)
    w.opt(s.warning_security_info is not None)
    w.bitstring(s.message_identifier, 16)
    w.bitstring(s.serial_number, 16)
    w.octets(s.warning_type, 2, 2)
    if s.warning_security_info is not None:
        w.octets(s.warning_security_info, 50, 50)


def unpack_sib10_body(r: UperReader) -> Sib10:
    if r.bit():
        raise ValueError("extended SIB10")
    has_sec = r.opt()
    s = Sib10(message_identifier=r.bitstring(16),
              serial_number=r.bitstring(16),
              warning_type=r.octets(2, 2))
    if has_sec:
        s.warning_security_info = r.octets(50, 50)
    return s


@dataclasses.dataclass
class Sib11:
    """ETWS secondary notification (segmented warning message)."""
    message_identifier: int = 0             # BIT STRING (16)
    serial_number: int = 0                  # BIT STRING (16)
    last_segment: bool = True               # ENUM {notLastSegment, lastSegment}
    segment_number: int = 0                 # (0..63)
    warning_segment: bytes = b""            # OCTET STRING (unbounded)
    data_coding_scheme: bytes | None = None  # OCTET STRING SIZE (1)


def pack_sib11_body(w: UperWriter, s: Sib11):
    w.bit(0)
    w.opt(s.data_coding_scheme is not None)
    w.bitstring(s.message_identifier, 16)
    w.bitstring(s.serial_number, 16)
    w.enum(1 if s.last_segment else 0, 2)
    w.cint(s.segment_number, 0, 63)
    w.octets(s.warning_segment)             # general length determinant
    if s.data_coding_scheme is not None:
        w.octets(s.data_coding_scheme, 1, 1)


def unpack_sib11_body(r: UperReader) -> Sib11:
    if r.bit():
        raise ValueError("extended SIB11")
    has_dcs = r.opt()
    s = Sib11(message_identifier=r.bitstring(16),
              serial_number=r.bitstring(16))
    s.last_segment = r.enum(2) == 1
    s.segment_number = r.cint(0, 63)
    s.warning_segment = r.octets()
    if has_dcs:
        s.data_coding_scheme = r.octets(1, 1)
    return s


# ---------------------------------------------------------------------------
# SIB12 (CMAS) / SIB13 (MBSFN) — Rel-9 extension alternatives
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Sib12:
    """CMAS warning notification (36.331 SystemInformationBlockType12-r9).

    (reference capability: ``liblte/src/liblte_rrc.cc ::
    liblte_rrc_pack_sys_info_block_type_12_ie`` — present in late openLTE
    versions for CMAS support.)"""
    message_identifier: int = 0             # BIT STRING (16)
    serial_number: int = 0                  # BIT STRING (16)
    last_segment: bool = True               # ENUM {notLastSegment, lastSegment}
    segment_number: int = 0                 # (0..63)
    warning_segment: bytes = b""            # OCTET STRING (unbounded)
    data_coding_scheme: bytes | None = None  # OCTET STRING SIZE (1)


def pack_sib12_body(w: UperWriter, s: Sib12):
    w.bit(0)                                # extension marker
    w.opt(s.data_coding_scheme is not None)
    w.opt(False)                            # lateNonCriticalExtension absent
    w.bitstring(s.message_identifier, 16)
    w.bitstring(s.serial_number, 16)
    w.enum(1 if s.last_segment else 0, 2)
    w.cint(s.segment_number, 0, 63)
    w.octets(s.warning_segment)
    if s.data_coding_scheme is not None:
        w.octets(s.data_coding_scheme, 1, 1)


def unpack_sib12_body(r: UperReader) -> Sib12:
    if r.bit():
        raise ValueError("extended SIB12")
    has_dcs = r.opt()
    has_late = r.opt()
    s = Sib12(message_identifier=r.bitstring(16),
              serial_number=r.bitstring(16))
    s.last_segment = r.enum(2) == 1
    s.segment_number = r.cint(0, 63)
    s.warning_segment = r.octets()
    if has_dcs:
        s.data_coding_scheme = r.octets(1, 1)
    if has_late:
        r.octets()
    return s


@dataclasses.dataclass
class MbsfnAreaInfo:
    """MBSFN-AreaInfo-r9 (36.331 §6.3.7)."""
    mbsfn_area_id: int = 0                  # (0..255)
    non_mbsfn_region_length: int = 1        # symbols: ENUM {s1, s2}
    notification_indicator: int = 0         # PDCCH bit (0..7)
    mcch_repetition_period_rf: int = 32     # ENUM {rf32, rf64, rf128, rf256}
    mcch_offset: int = 0                    # (0..10)
    mcch_modification_period_rf: int = 512  # ENUM {rf512, rf1024}
    sf_alloc_info: int = 0                  # BIT STRING (6)
    signalling_mcs: int = 2                 # ENUM {n2, n7, n13, n19}


_MCCH_REP_RF = (32, 64, 128, 256)
_MCCH_MOD_RF = (512, 1024)
_SIG_MCS = (2, 7, 13, 19)
_NON_MBSFN_LEN = (1, 2)


@dataclasses.dataclass
class MbmsNotificationConfig:
    """MBMS-NotificationConfig-r9."""
    repetition_coeff: int = 2               # ENUM {n2, n4}
    offset: int = 0                         # (0..10)
    sf_index: int = 1                       # (1..6)


@dataclasses.dataclass
class Sib13:
    """MBSFN area configuration (36.331 SystemInformationBlockType13-r9).

    (reference capability: ``liblte/src/liblte_rrc.cc ::
    liblte_rrc_pack_sys_info_block_type_13_ie`` — openLTE carries SIB13
    for MBSFN-subframe signalling.)"""
    areas: tuple = (MbsfnAreaInfo(),)       # SIZE (1..8)
    notification: MbmsNotificationConfig = dataclasses.field(
        default_factory=MbmsNotificationConfig)


def pack_sib13_body(w: UperWriter, s: Sib13):
    w.bit(0)                                # extension marker
    w.opt(False)                            # lateNonCriticalExtension absent
    w.length(len(s.areas), 1, 8)
    for a in s.areas:
        w.bit(0)                            # MBSFN-AreaInfo extension marker
        w.cint(a.mbsfn_area_id, 0, 255)
        w.enum(_NON_MBSFN_LEN.index(a.non_mbsfn_region_length), 2)
        w.cint(a.notification_indicator, 0, 7)
        w.enum(_MCCH_REP_RF.index(a.mcch_repetition_period_rf), 4)
        w.cint(a.mcch_offset, 0, 10)
        w.enum(_MCCH_MOD_RF.index(a.mcch_modification_period_rf), 2)
        w.bitstring(a.sf_alloc_info, 6)
        w.enum(_SIG_MCS.index(a.signalling_mcs), 4)
    w.enum((2, 4).index(s.notification.repetition_coeff), 2)
    w.cint(s.notification.offset, 0, 10)
    w.cint(s.notification.sf_index, 1, 6)


def unpack_sib13_body(r: UperReader) -> Sib13:
    if r.bit():
        raise ValueError("extended SIB13")
    has_late = r.opt()
    areas = []
    for _ in range(r.length(1, 8)):
        if r.bit():
            raise ValueError("extended MBSFN-AreaInfo")
        areas.append(MbsfnAreaInfo(
            mbsfn_area_id=r.cint(0, 255),
            non_mbsfn_region_length=_NON_MBSFN_LEN[r.enum(2)],
            notification_indicator=r.cint(0, 7),
            mcch_repetition_period_rf=_MCCH_REP_RF[r.enum(4)],
            mcch_offset=r.cint(0, 10),
            mcch_modification_period_rf=_MCCH_MOD_RF[r.enum(2)],
            sf_alloc_info=r.bitstring(6),
            signalling_mcs=_SIG_MCS[r.enum(4)]))
    notif = MbmsNotificationConfig(repetition_coeff=(2, 4)[r.enum(2)],
                                   offset=r.cint(0, 10),
                                   sf_index=r.cint(1, 6))
    if has_late:
        r.octets()
    return Sib13(areas=tuple(areas), notification=notif)


# ---------------------------------------------------------------------------
# sib-TypeAndInfo registry (root CHOICE index in SystemInformation-r8)
# ---------------------------------------------------------------------------

# index within the extensible root CHOICE {sib2..sib11} of sib-TypeAndInfo
SIB_REGISTRY: dict[int, tuple[str, object, object]] = {
    1: ("sib3", pack_sib3_body, unpack_sib3_body),
    2: ("sib4", pack_sib4_body, unpack_sib4_body),
    3: ("sib5", pack_sib5_body, unpack_sib5_body),
    4: ("sib6", pack_sib6_body, unpack_sib6_body),
    5: ("sib7", pack_sib7_body, unpack_sib7_body),
    6: ("sib8", pack_sib8_body, unpack_sib8_body),
    7: ("sib9", pack_sib9_body, unpack_sib9_body),
    8: ("sib10", pack_sib10_body, unpack_sib10_body),
    9: ("sib11", pack_sib11_body, unpack_sib11_body),
}

SIB_TYPE_INDEX: dict[type, int] = {
    Sib3: 1, Sib4: 2, Sib5: 3, Sib6: 4, Sib7: 5, Sib8: 6,
    Sib9: 7, Sib10: 8, Sib11: 9,
}

# extension alternatives of the sib-TypeAndInfo CHOICE (Rel-9+), keyed by
# the normally-small extension index; carried as open-type fields
SIB_EXT_REGISTRY: dict[int, tuple[str, object, object]] = {
    0: ("sib12", pack_sib12_body, unpack_sib12_body),
    1: ("sib13", pack_sib13_body, unpack_sib13_body),
}

SIB_EXT_TYPE_INDEX: dict[type, int] = {Sib12: 0, Sib13: 1}
