"""Measurement configuration and handover IEs in real UNALIGNED PER.

Rel-8 36.331 §6.3.5 (measurement IEs) and §6.3.4 (mobility IEs):
``MeasConfig`` (measurement objects / report configs / meas IDs /
quantity config / gaps / s-Measure / speed-state scaling),
``MobilityControlInfo`` (the intra-LTE handover command payload carried in
RRCConnectionReconfiguration, including the full target-cell
``RadioResourceConfigCommon``) and ``SecurityConfigHO`` (KeNB* keying).

(reference capability: ``liblte/src/liblte_rrc.cc`` measurement/handover IE
pack/unpack statics — ``liblte_rrc_pack_meas_config_ie``,
``liblte_rrc_pack_mobility_control_info_ie`` class of functions — used by
``liblte_rrc_pack_rrc_connection_reconfiguration_msg``.)

Field order and widths follow the Rel-8 ASN.1 grammar; optional IEs not
carried by the dataclasses are encoded absent, and unpack raises
``ValueError`` on extension bits / alternatives outside the modeled root
(message-level callers turn that into a ``None`` decode).

The port's own copy of ``lteax/stack/rrc_meas.py`` (it imports nothing of the
JAX package); ``tests/test_torch_stack.py`` holds the two equal.
"""

from __future__ import annotations

import dataclasses

from lteax_torch.stack.uper import UperReader, UperWriter
from lteax_torch.stack.rrc_sibs import (SpeedStateScaleFactors, PhysCellIdRange,
                                  _pack_sssf, _unpack_sssf,
                                  _pack_pci_range, _unpack_pci_range)

# ---------------------------------------------------------------------------
# Measurement objects (36.331 §6.3.5)
# ---------------------------------------------------------------------------

ALLOWED_MEAS_BW = ("mbw6", "mbw15", "mbw25", "mbw50", "mbw75", "mbw100")
# Q-OffsetRange: ENUMERATED dB-24..dB24 (31 values, index 15 = dB0)
Q_OFFSET_DB0 = 15
TIME_TO_TRIGGER = ("ms0", "ms40", "ms64", "ms80", "ms100", "ms128", "ms160",
                   "ms256", "ms320", "ms480", "ms512", "ms640", "ms1024",
                   "ms1280", "ms2560", "ms5120")
REPORT_INTERVAL = ("ms120", "ms240", "ms480", "ms640", "ms1024", "ms2048",
                   "ms5120", "ms10240", "min1", "min6", "min12", "min30",
                   "min60", "spare3", "spare2", "spare1")
REPORT_AMOUNT = ("r1", "r2", "r4", "r8", "r16", "r32", "r64", "infinity")
T304 = ("ms50", "ms100", "ms150", "ms200", "ms500", "ms1000", "ms2000",
        "spare1")


@dataclasses.dataclass
class CellsToAddMod:
    cell_index: int                 # 1..32
    phys_cell_id: int               # 0..503
    cell_individual_offset: int = Q_OFFSET_DB0   # Q-OffsetRange index 0..30


@dataclasses.dataclass
class BlackCellsToAddMod:
    cell_index: int                 # 1..32
    pci_range: PhysCellIdRange = dataclasses.field(
        default_factory=lambda: PhysCellIdRange(0))


@dataclasses.dataclass
class MeasObjectEutra:
    carrier_freq: int               # EARFCN 0..65535
    allowed_meas_bw: int = 5        # index into ALLOWED_MEAS_BW
    presence_antenna_port1: bool = False
    neigh_cell_config: int = 1      # BIT STRING (SIZE (2)) value
    offset_freq: int | None = None  # Q-OffsetRange index (absent = dB0)
    cells_to_remove: tuple[int, ...] = ()        # CellIndexList 1..32
    cells_to_add: tuple[CellsToAddMod, ...] = ()
    black_to_remove: tuple[int, ...] = ()
    black_to_add: tuple[BlackCellsToAddMod, ...] = ()
    report_cgi_cell: int | None = None           # PhysCellId


def _pack_cell_index_list(w: UperWriter, lst: tuple[int, ...]) -> None:
    w.length(len(lst), 1, 32)
    for ci in lst:
        w.cint(ci, 1, 32)


def _unpack_cell_index_list(r: UperReader) -> tuple[int, ...]:
    return tuple(r.cint(1, 32) for _ in range(r.length(1, 32)))


def pack_meas_object_eutra(w: UperWriter, o: MeasObjectEutra) -> None:
    w.bit(0)                        # extension
    w.opt(o.offset_freq is not None)
    w.opt(bool(o.cells_to_remove))
    w.opt(bool(o.cells_to_add))
    w.opt(bool(o.black_to_remove))
    w.opt(bool(o.black_to_add))
    w.opt(o.report_cgi_cell is not None)
    w.cint(o.carrier_freq, 0, 65535)
    w.enum(o.allowed_meas_bw, 6)
    w.bit(1 if o.presence_antenna_port1 else 0)
    w.bitstring(o.neigh_cell_config, 2)
    if o.offset_freq is not None:
        w.enum(o.offset_freq, 31)
    if o.cells_to_remove:
        _pack_cell_index_list(w, o.cells_to_remove)
    if o.cells_to_add:
        w.length(len(o.cells_to_add), 1, 32)
        for c in o.cells_to_add:
            w.cint(c.cell_index, 1, 32)
            w.cint(c.phys_cell_id, 0, 503)
            w.enum(c.cell_individual_offset, 31)
    if o.black_to_remove:
        _pack_cell_index_list(w, o.black_to_remove)
    if o.black_to_add:
        w.length(len(o.black_to_add), 1, 32)
        for b in o.black_to_add:
            w.cint(b.cell_index, 1, 32)
            _pack_pci_range(w, b.pci_range)
    if o.report_cgi_cell is not None:
        w.cint(o.report_cgi_cell, 0, 503)


def unpack_meas_object_eutra(r: UperReader) -> MeasObjectEutra:
    if r.bit():
        raise ValueError("extended MeasObjectEUTRA")
    has = [r.opt() for _ in range(6)]
    o = MeasObjectEutra(carrier_freq=r.cint(0, 65535),
                        allowed_meas_bw=r.enum(6),
                        presence_antenna_port1=bool(r.bit()),
                        neigh_cell_config=r.bitstring(2))
    if has[0]:
        o.offset_freq = r.enum(31)
    if has[1]:
        o.cells_to_remove = _unpack_cell_index_list(r)
    if has[2]:
        o.cells_to_add = tuple(
            CellsToAddMod(r.cint(1, 32), r.cint(0, 503), r.enum(31))
            for _ in range(r.length(1, 32)))
    if has[3]:
        o.black_to_remove = _unpack_cell_index_list(r)
    if has[4]:
        o.black_to_add = tuple(
            BlackCellsToAddMod(r.cint(1, 32), _unpack_pci_range(r))
            for _ in range(r.length(1, 32)))
    if has[5]:
        o.report_cgi_cell = r.cint(0, 503)
    return o


# ---------------------------------------------------------------------------
# Report configurations
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ThresholdEutra:
    """CHOICE threshold-RSRP (0..97) / threshold-RSRQ (0..34)."""
    value: int
    rsrq: bool = False


def _pack_thr(w: UperWriter, t: ThresholdEutra) -> None:
    w.bit(1 if t.rsrq else 0)
    if t.rsrq:
        w.cint(t.value, 0, 34)
    else:
        w.cint(t.value, 0, 97)


def _unpack_thr(r: UperReader) -> ThresholdEutra:
    rsrq = bool(r.bit())
    return ThresholdEutra(r.cint(0, 34) if rsrq else r.cint(0, 97), rsrq)


@dataclasses.dataclass
class ReportConfigEutra:
    """Event-triggered or periodical EUTRA report configuration.

    ``event`` is one of "a1".."a5" (with the matching threshold/offset
    fields) or None for periodical reporting."""
    event: str | None = "a3"
    a1_threshold: ThresholdEutra | None = None       # a1/a2/a4
    a3_offset: int = 0                               # -30..30 (0.5 dB units)
    report_on_leave: bool = False
    a5_threshold2: ThresholdEutra | None = None
    hysteresis: int = 0                              # 0..30
    time_to_trigger: int = 0                         # TIME_TO_TRIGGER index
    periodical_report_cgi: bool = False              # purpose when periodical
    trigger_quantity_rsrq: bool = False
    report_quantity_both: bool = False
    max_report_cells: int = 4                        # 1..8
    report_interval: int = 0                         # REPORT_INTERVAL index
    report_amount: int = 7                           # REPORT_AMOUNT index

EVENT_IDS = ("a1", "a2", "a3", "a4", "a5")


def pack_report_config_eutra(w: UperWriter, c: ReportConfigEutra) -> None:
    w.bit(0)                        # extension
    if c.event is not None:
        w.bit(0)                    # triggerType: event
        ev = EVENT_IDS.index(c.event)
        w.bit(0)                    # eventId extension
        w.cint(ev, 0, 4)
        if c.event in ("a1", "a2", "a4"):
            _pack_thr(w, c.a1_threshold or ThresholdEutra(0))
        elif c.event == "a3":
            w.cint(c.a3_offset, -30, 30)
            w.bit(1 if c.report_on_leave else 0)
        else:                       # a5
            _pack_thr(w, c.a1_threshold or ThresholdEutra(0))
            _pack_thr(w, c.a5_threshold2 or ThresholdEutra(0))
        w.cint(c.hysteresis, 0, 30)
        w.enum(c.time_to_trigger, 16)
    else:
        w.bit(1)                    # triggerType: periodical
        w.enum(1 if c.periodical_report_cgi else 0, 2)
    w.enum(1 if c.trigger_quantity_rsrq else 0, 2)
    w.enum(1 if c.report_quantity_both else 0, 2)
    w.cint(c.max_report_cells, 1, 8)
    w.enum(c.report_interval, 16)
    w.enum(c.report_amount, 8)


def unpack_report_config_eutra(r: UperReader) -> ReportConfigEutra:
    if r.bit():
        raise ValueError("extended ReportConfigEUTRA")
    c = ReportConfigEutra(event=None)
    if r.bit() == 0:                # event
        if r.bit():
            raise ValueError("extended eventId")
        ev = EVENT_IDS[r.cint(0, 4)]
        c.event = ev
        if ev in ("a1", "a2", "a4"):
            c.a1_threshold = _unpack_thr(r)
        elif ev == "a3":
            c.a3_offset = r.cint(-30, 30)
            c.report_on_leave = bool(r.bit())
        else:
            c.a1_threshold = _unpack_thr(r)
            c.a5_threshold2 = _unpack_thr(r)
        c.hysteresis = r.cint(0, 30)
        c.time_to_trigger = r.enum(16)
    else:                           # periodical
        c.periodical_report_cgi = bool(r.enum(2))
    c.trigger_quantity_rsrq = bool(r.enum(2))
    c.report_quantity_both = bool(r.enum(2))
    c.max_report_cells = r.cint(1, 8)
    c.report_interval = r.enum(16)
    c.report_amount = r.enum(8)
    return c


# ---------------------------------------------------------------------------
# MeasConfig
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class MeasIdToAddMod:
    meas_id: int                    # 1..32
    meas_object_id: int             # 1..32
    report_config_id: int           # 1..32


@dataclasses.dataclass
class QuantityConfigEutra:
    """filterCoefficient indices into the 16-value extensible root
    (fc0..fc9, fc11, fc13, fc15, fc17, fc19, spare1); None = DEFAULT fc4."""
    filter_coeff_rsrp: int | None = None
    filter_coeff_rsrq: int | None = None


@dataclasses.dataclass
class MeasGapConfig:
    """setup with gapOffset gp0 (0..39, 40 ms pattern) or gp1 (0..79)."""
    gap_offset: int = 0
    gp1: bool = False


@dataclasses.dataclass
class SpeedStatePars:
    t_evaluation: int = 0           # ENUM {s30,s60,s120,s180,s240,spare*} idx
    t_hyst_normal: int = 0
    n_cell_change_medium: int = 1   # 1..16
    n_cell_change_high: int = 1     # 1..16
    scale_factors: SpeedStateScaleFactors = dataclasses.field(
        default_factory=lambda: SpeedStateScaleFactors(0, 0))


@dataclasses.dataclass
class MeasConfig:
    obj_to_remove: tuple[int, ...] = ()
    objects: tuple[tuple[int, MeasObjectEutra], ...] = ()   # (measObjectId, obj)
    report_to_remove: tuple[int, ...] = ()
    reports: tuple[tuple[int, ReportConfigEutra], ...] = ()
    ids_to_remove: tuple[int, ...] = ()
    ids: tuple[MeasIdToAddMod, ...] = ()
    quantity: QuantityConfigEutra | None = None
    gaps: MeasGapConfig | None = None
    s_measure: int | None = None    # RSRP-Range 0..97
    speed_state: SpeedStatePars | None = None


def pack_meas_config(w: UperWriter, m: MeasConfig) -> None:
    w.bit(0)                        # extension
    w.opt(bool(m.obj_to_remove))
    w.opt(bool(m.objects))
    w.opt(bool(m.report_to_remove))
    w.opt(bool(m.reports))
    w.opt(bool(m.ids_to_remove))
    w.opt(bool(m.ids))
    w.opt(m.quantity is not None)
    w.opt(m.gaps is not None)
    w.opt(m.s_measure is not None)
    w.opt(False)                    # preRegistrationInfoHRPD
    w.opt(m.speed_state is not None)
    if m.obj_to_remove:
        _pack_cell_index_list(w, m.obj_to_remove)
    if m.objects:
        w.length(len(m.objects), 1, 32)
        for oid, obj in m.objects:
            w.cint(oid, 1, 32)
            w.bit(0)                # measObject CHOICE extension
            w.cint(0, 0, 3)         # measObjectEUTRA(0)
            pack_meas_object_eutra(w, obj)
    if m.report_to_remove:
        _pack_cell_index_list(w, m.report_to_remove)
    if m.reports:
        w.length(len(m.reports), 1, 32)
        for rid, rep in m.reports:
            w.cint(rid, 1, 32)
            w.bit(0)                # reportConfig CHOICE: reportConfigEUTRA
            pack_report_config_eutra(w, rep)
    if m.ids_to_remove:
        _pack_cell_index_list(w, m.ids_to_remove)
    if m.ids:
        w.length(len(m.ids), 1, 32)
        for i in m.ids:
            w.cint(i.meas_id, 1, 32)
            w.cint(i.meas_object_id, 1, 32)
            w.cint(i.report_config_id, 1, 32)
    if m.quantity is not None:
        q = m.quantity
        w.bit(0)                    # QuantityConfig extension
        w.opt(True)                 # quantityConfigEUTRA
        w.opt(False)                # UTRA
        w.opt(False)                # GERAN
        w.opt(False)                # CDMA2000
        w.opt(q.filter_coeff_rsrp is not None)
        w.opt(q.filter_coeff_rsrq is not None)
        if q.filter_coeff_rsrp is not None:
            w.enum(q.filter_coeff_rsrp, 16, extensible=True)
        if q.filter_coeff_rsrq is not None:
            w.enum(q.filter_coeff_rsrq, 16, extensible=True)
    if m.gaps is not None:
        w.bit(1)                    # MeasGapConfig CHOICE: setup
        w.bit(0)                    # gapOffset CHOICE extension
        w.bit(1 if m.gaps.gp1 else 0)
        if m.gaps.gp1:
            w.cint(m.gaps.gap_offset, 0, 79)
        else:
            w.cint(m.gaps.gap_offset, 0, 39)
    if m.s_measure is not None:
        w.cint(m.s_measure, 0, 97)
    if m.speed_state is not None:
        s = m.speed_state
        w.bit(1)                    # CHOICE: setup
        w.enum(s.t_evaluation, 8)
        w.enum(s.t_hyst_normal, 8)
        w.cint(s.n_cell_change_medium, 1, 16)
        w.cint(s.n_cell_change_high, 1, 16)
        _pack_sssf(w, s.scale_factors)


def unpack_meas_config(r: UperReader) -> MeasConfig:
    if r.bit():
        raise ValueError("extended MeasConfig")
    has = [r.opt() for _ in range(11)]
    m = MeasConfig()
    if has[0]:
        m.obj_to_remove = _unpack_cell_index_list(r)
    if has[1]:
        objs = []
        for _ in range(r.length(1, 32)):
            oid = r.cint(1, 32)
            if r.bit():
                raise ValueError("extended measObject CHOICE")
            if r.cint(0, 3) != 0:
                raise ValueError("non-EUTRA measObject")
            objs.append((oid, unpack_meas_object_eutra(r)))
        m.objects = tuple(objs)
    if has[2]:
        m.report_to_remove = _unpack_cell_index_list(r)
    if has[3]:
        reps = []
        for _ in range(r.length(1, 32)):
            rid = r.cint(1, 32)
            if r.bit():
                raise ValueError("reportConfigInterRAT")
            reps.append((rid, unpack_report_config_eutra(r)))
        m.reports = tuple(reps)
    if has[4]:
        m.ids_to_remove = _unpack_cell_index_list(r)
    if has[5]:
        m.ids = tuple(MeasIdToAddMod(r.cint(1, 32), r.cint(1, 32),
                                     r.cint(1, 32))
                      for _ in range(r.length(1, 32)))
    if has[6]:
        if r.bit():
            raise ValueError("extended QuantityConfig")
        qe, qu, qg, qc = r.opt(), r.opt(), r.opt(), r.opt()
        if qu or qg or qc:
            raise ValueError("non-EUTRA quantityConfig")
        q = QuantityConfigEutra()
        if qe:
            has_p, has_q = r.opt(), r.opt()
            if has_p:
                q.filter_coeff_rsrp = r.enum(16, extensible=True)
            if has_q:
                q.filter_coeff_rsrq = r.enum(16, extensible=True)
        m.quantity = q
    if has[7]:
        if r.bit():                 # setup
            if r.bit():
                raise ValueError("extended gapOffset")
            gp1 = bool(r.bit())
            m.gaps = MeasGapConfig(r.cint(0, 79) if gp1 else r.cint(0, 39),
                                   gp1)
        else:
            m.gaps = None           # release
    if has[8]:
        m.s_measure = r.cint(0, 97)
    if has[9]:
        raise ValueError("preRegistrationInfoHRPD")
    if has[10]:
        if r.bit():                 # setup
            m.speed_state = SpeedStatePars(
                r.enum(8), r.enum(8), r.cint(1, 16), r.cint(1, 16),
                _unpack_sssf(r))
    return m


# ---------------------------------------------------------------------------
# MobilityControlInfo (36.331 §6.3.4) — the intra-LTE handover command
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class RachConfigCommon:
    """RACH-ConfigCommon ENUM indices / integers (same encoding the SIB2
    body uses — see rrc._pack_sib2_body)."""
    number_of_ra_preambles: int = 12
    power_ramping_step: int = 1
    preamble_init_target_power: int = 8
    preamble_trans_max: int = 5
    ra_response_window_size: int = 7
    mac_contention_resolution_timer: int = 5
    max_harq_msg3_tx: int = 4


def _pack_rach_common(w: UperWriter, c: RachConfigCommon) -> None:
    w.bit(0)                        # extension
    w.opt(False)                    # preamblesGroupAConfig
    w.enum(c.number_of_ra_preambles, 16)
    w.enum(c.power_ramping_step, 4)
    w.enum(c.preamble_init_target_power, 16)
    w.enum(c.preamble_trans_max, 11)
    w.enum(c.ra_response_window_size, 8)
    w.enum(c.mac_contention_resolution_timer, 8)
    w.cint(c.max_harq_msg3_tx, 1, 8)


def _unpack_rach_common(r: UperReader) -> RachConfigCommon:
    if r.bit():
        raise ValueError("extended RACH-ConfigCommon")
    if r.opt():
        raise ValueError("preamblesGroupAConfig")
    return RachConfigCommon(r.enum(16), r.enum(4), r.enum(16), r.enum(11),
                            r.enum(8), r.enum(8), r.cint(1, 8))


@dataclasses.dataclass
class PrachConfigInfo:
    prach_config_index: int = 3     # 0..63
    high_speed_flag: bool = False
    zero_correlation_zone: int = 11  # 0..15
    prach_freq_offset: int = 2      # 0..94


@dataclasses.dataclass
class PuschConfigCommon:
    n_sb: int = 1
    hopping_mode: int = 0
    hopping_offset: int = 0
    enable_64qam: bool = False
    group_hopping_enabled: bool = False
    group_assignment_pusch: int = 0
    sequence_hopping_enabled: bool = False
    cyclic_shift: int = 0


def _pack_pusch_common(w: UperWriter, c: PuschConfigCommon) -> None:
    w.cint(c.n_sb, 1, 4)
    w.enum(c.hopping_mode, 2)
    w.cint(c.hopping_offset, 0, 98)
    w.bit(1 if c.enable_64qam else 0)
    w.bit(1 if c.group_hopping_enabled else 0)
    w.cint(c.group_assignment_pusch, 0, 29)
    w.bit(1 if c.sequence_hopping_enabled else 0)
    w.cint(c.cyclic_shift, 0, 7)


def _unpack_pusch_common(r: UperReader) -> PuschConfigCommon:
    return PuschConfigCommon(r.cint(1, 4), r.enum(2), r.cint(0, 98),
                             bool(r.bit()), bool(r.bit()), r.cint(0, 29),
                             bool(r.bit()), r.cint(0, 7))


@dataclasses.dataclass
class UplinkPowerControlCommon:
    p0_nominal_pusch: int = -70
    alpha: int = 7
    p0_nominal_pucch: int = -96
    delta_f_pucch: tuple[int, int, int, int, int] = (1, 1, 1, 1, 1)
    delta_preamble_msg3: int = 4


def _pack_ulpc(w: UperWriter, c: UplinkPowerControlCommon) -> None:
    w.cint(c.p0_nominal_pusch, -126, 24)
    w.enum(c.alpha, 8)
    w.cint(c.p0_nominal_pucch, -127, -96)
    for i, n in enumerate((3, 3, 4, 3, 3)):
        w.enum(c.delta_f_pucch[i], n)
    w.cint(c.delta_preamble_msg3, -1, 6)


def _unpack_ulpc(r: UperReader) -> UplinkPowerControlCommon:
    return UplinkPowerControlCommon(
        r.cint(-126, 24), r.enum(8), r.cint(-127, -96),
        tuple(r.enum(n) for n in (3, 3, 4, 3, 3)), r.cint(-1, 6))


@dataclasses.dataclass
class RadioResourceConfigCommonHO:
    """RadioResourceConfigCommon (the dedicated-mobility variant — distinct
    from the SIB flavor: no bcch/pcch, prach-ConfigInfo optional)."""
    prach_root_sequence_index: int = 0
    rach: RachConfigCommon | None = dataclasses.field(
        default_factory=RachConfigCommon)
    prach_info: PrachConfigInfo | None = dataclasses.field(
        default_factory=PrachConfigInfo)
    pdsch_rs_power: int | None = -60      # (-60..50)
    pdsch_p_b: int = 0
    pusch: PuschConfigCommon = dataclasses.field(
        default_factory=PuschConfigCommon)
    phich_duration_extended: bool | None = None   # (duration, resource)
    phich_resource: int = 0                       # ENUM idx {1/6,1/2,1,2}
    pucch_delta_shift: int | None = None
    pucch_n_rb_cqi: int = 0
    pucch_n_cs_an: int = 0
    pucch_n1_an: int = 0
    srs_setup: tuple[int, int, bool] | None = None  # (bw_config, sf_config, simul_an)
    ulpc: UplinkPowerControlCommon | None = dataclasses.field(
        default_factory=UplinkPowerControlCommon)
    antenna_ports_count: int | None = None        # ENUM idx {an1,an2,an4,spare}
    p_max: int | None = None                      # -30..33
    tdd_config: tuple[int, int] | None = None     # (subframeAssignment, ssp)
    ul_cp_extended: bool = False


def pack_rrc_common_ho(w: UperWriter, c: RadioResourceConfigCommonHO) -> None:
    w.bit(0)                        # extension
    w.opt(c.rach is not None)
    w.opt(c.pdsch_rs_power is not None)
    w.opt(c.phich_duration_extended is not None)
    w.opt(c.pucch_delta_shift is not None)
    w.opt(c.srs_setup is not None)
    w.opt(c.ulpc is not None)
    w.opt(c.antenna_ports_count is not None)
    w.opt(c.p_max is not None)
    w.opt(c.tdd_config is not None)
    if c.rach is not None:
        _pack_rach_common(w, c.rach)
    # prach-Config (HO variant): rootSequenceIndex + OPTIONAL configInfo
    w.opt(c.prach_info is not None)
    w.cint(c.prach_root_sequence_index, 0, 837)
    if c.prach_info is not None:
        i = c.prach_info
        w.cint(i.prach_config_index, 0, 63)
        w.bit(1 if i.high_speed_flag else 0)
        w.cint(i.zero_correlation_zone, 0, 15)
        w.cint(i.prach_freq_offset, 0, 94)
    if c.pdsch_rs_power is not None:
        w.cint(c.pdsch_rs_power, -60, 50)
        w.cint(c.pdsch_p_b, 0, 3)
    _pack_pusch_common(w, c.pusch)
    if c.phich_duration_extended is not None:
        w.enum(1 if c.phich_duration_extended else 0, 2)
        w.enum(c.phich_resource, 4)
    if c.pucch_delta_shift is not None:
        w.enum(c.pucch_delta_shift, 3)
        w.cint(c.pucch_n_rb_cqi, 0, 98)
        w.cint(c.pucch_n_cs_an, 0, 7)
        w.cint(c.pucch_n1_an, 0, 2047)
    if c.srs_setup is not None:
        w.bit(1)                    # CHOICE: setup
        bw, sf, simul = c.srs_setup
        w.opt(False)                # srs-MaxUpPts
        w.enum(bw, 8)
        w.enum(sf, 16)
        w.bit(1 if simul else 0)
    if c.ulpc is not None:
        _pack_ulpc(w, c.ulpc)
    if c.antenna_ports_count is not None:
        w.enum(c.antenna_ports_count, 4)
    if c.p_max is not None:
        w.cint(c.p_max, -30, 33)
    if c.tdd_config is not None:
        w.enum(c.tdd_config[0], 7)
        w.enum(c.tdd_config[1], 9)
    w.enum(1 if c.ul_cp_extended else 0, 2)


def unpack_rrc_common_ho(r: UperReader) -> RadioResourceConfigCommonHO:
    if r.bit():
        raise ValueError("extended RadioResourceConfigCommon")
    has = [r.opt() for _ in range(9)]
    c = RadioResourceConfigCommonHO(rach=None, prach_info=None,
                                    pdsch_rs_power=None, ulpc=None)
    if has[0]:
        c.rach = _unpack_rach_common(r)
    has_pi = r.opt()
    c.prach_root_sequence_index = r.cint(0, 837)
    if has_pi:
        c.prach_info = PrachConfigInfo(r.cint(0, 63), bool(r.bit()),
                                       r.cint(0, 15), r.cint(0, 94))
    if has[1]:
        c.pdsch_rs_power = r.cint(-60, 50)
        c.pdsch_p_b = r.cint(0, 3)
    c.pusch = _unpack_pusch_common(r)
    if has[2]:
        c.phich_duration_extended = bool(r.enum(2))
        c.phich_resource = r.enum(4)
    if has[3]:
        c.pucch_delta_shift = r.enum(3)
        c.pucch_n_rb_cqi = r.cint(0, 98)
        c.pucch_n_cs_an = r.cint(0, 7)
        c.pucch_n1_an = r.cint(0, 2047)
    if has[4]:
        if r.bit():                 # setup
            if r.opt():
                raise ValueError("srs-MaxUpPts")
            c.srs_setup = (r.enum(8), r.enum(16), bool(r.bit()))
    if has[5]:
        c.ulpc = _unpack_ulpc(r)
    if has[6]:
        c.antenna_ports_count = r.enum(4)
    if has[7]:
        c.p_max = r.cint(-30, 33)
    if has[8]:
        c.tdd_config = (r.enum(7), r.enum(9))
    c.ul_cp_extended = bool(r.enum(2))
    return c


@dataclasses.dataclass
class MobilityControlInfo:
    target_pci: int                 # 0..503
    t304: int = 1                   # T304 index (default ms100)
    new_ue_identity: int = 0        # C-RNTI, 16-bit
    rrc_common: RadioResourceConfigCommonHO = dataclasses.field(
        default_factory=RadioResourceConfigCommonHO)
    dl_carrier_freq: int | None = None
    ul_carrier_freq: int | None = None
    dl_bandwidth: int | None = None   # ENUM idx n6..n100 (of 16 w/ spares)
    ul_bandwidth: int | None = None
    additional_spectrum_emission: int | None = None   # 1..32
    rach_dedicated: tuple[int, int] | None = None     # (preambleIndex, maskIndex)


def pack_mobility_control_info(w: UperWriter, m: MobilityControlInfo) -> None:
    w.bit(0)                        # extension
    w.opt(m.dl_carrier_freq is not None)
    w.opt(m.dl_bandwidth is not None)
    w.opt(m.additional_spectrum_emission is not None)
    w.opt(m.rach_dedicated is not None)
    w.cint(m.target_pci, 0, 503)
    if m.dl_carrier_freq is not None:
        w.opt(m.ul_carrier_freq is not None)
        w.cint(m.dl_carrier_freq, 0, 65535)
        if m.ul_carrier_freq is not None:
            w.cint(m.ul_carrier_freq, 0, 65535)
    if m.dl_bandwidth is not None:
        w.opt(m.ul_bandwidth is not None)
        w.enum(m.dl_bandwidth, 16)
        if m.ul_bandwidth is not None:
            w.enum(m.ul_bandwidth, 16)
    if m.additional_spectrum_emission is not None:
        w.cint(m.additional_spectrum_emission, 1, 32)
    w.enum(m.t304, 8)
    w.bitstring(m.new_ue_identity, 16)
    pack_rrc_common_ho(w, m.rrc_common)
    if m.rach_dedicated is not None:
        w.cint(m.rach_dedicated[0], 0, 63)
        w.cint(m.rach_dedicated[1], 0, 15)


def unpack_mobility_control_info(r: UperReader) -> MobilityControlInfo:
    if r.bit():
        raise ValueError("extended MobilityControlInfo")
    has = [r.opt() for _ in range(4)]
    m = MobilityControlInfo(target_pci=r.cint(0, 503))
    if has[0]:
        has_ul = r.opt()
        m.dl_carrier_freq = r.cint(0, 65535)
        if has_ul:
            m.ul_carrier_freq = r.cint(0, 65535)
    if has[1]:
        has_ul = r.opt()
        m.dl_bandwidth = r.enum(16)
        if has_ul:
            m.ul_bandwidth = r.enum(16)
    if has[2]:
        m.additional_spectrum_emission = r.cint(1, 32)
    m.t304 = r.enum(8)
    m.new_ue_identity = r.bitstring(16)
    m.rrc_common = unpack_rrc_common_ho(r)
    if has[3]:
        m.rach_dedicated = (r.cint(0, 63), r.cint(0, 15))
    return m


# ---------------------------------------------------------------------------
# SecurityConfigHO
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class SecurityConfigHO:
    """intraLTE handover keying: KeNB* chaining (33.401 §7.2.8)."""
    key_change_indicator: bool = False
    next_hop_chaining_count: int = 0          # 0..7
    ciphering: str | None = None              # from CIPHERING_ALGS, or None
    integrity: str | None = None


def pack_security_config_ho(w: UperWriter, s: SecurityConfigHO) -> None:
    from lteax_torch.stack.rrc_dedicated import CIPHERING_ALGS, INTEGRITY_ALGS
    w.bit(0)                        # extension
    w.bit(0)                        # handoverType CHOICE: intraLTE
    w.opt(s.ciphering is not None)  # securityAlgorithmConfig
    if s.ciphering is not None:
        w.bit(0)                    # securityAlgorithmConfig extension
        w.bit(0)                    # cipheringAlgorithm enum ext
        w.cint(CIPHERING_ALGS.index(s.ciphering), 0, 7)
        w.bit(0)                    # integrityProtAlgorithm enum ext
        w.cint(INTEGRITY_ALGS.index(s.integrity), 0, 7)
    w.bit(1 if s.key_change_indicator else 0)
    w.cint(s.next_hop_chaining_count, 0, 7)


def unpack_security_config_ho(r: UperReader) -> SecurityConfigHO:
    from lteax_torch.stack.rrc_dedicated import CIPHERING_ALGS, INTEGRITY_ALGS
    if r.bit():
        raise ValueError("extended SecurityConfigHO")
    if r.bit():
        raise ValueError("interRAT handoverType")
    s = SecurityConfigHO()
    if r.opt():
        if r.bit():
            raise ValueError("extended SecurityAlgorithmConfig")
        if r.bit():
            raise ValueError("extended cipheringAlgorithm")
        s.ciphering = CIPHERING_ALGS[r.cint(0, 7)]
        if r.bit():
            raise ValueError("extended integrityProtAlgorithm")
        s.integrity = INTEGRITY_ALGS[r.cint(0, 7)]
    s.key_change_indicator = bool(r.bit())
    s.next_hop_chaining_count = r.cint(0, 7)
    return s
