"""RRC broadcast message codecs in real UNALIGNED PER (X.691): MIB (exact
36.331 §6.2.2 24-bit encoding), BCCH-DL-SCH-Message SIB1 and
SystemInformation (SIB2..SIB13 via :mod:`lteax_torch.stack.rrc_sibs`), and
PCCH Paging.

(reference capability: ``liblte/src/liblte_rrc.cc ::
liblte_rrc_pack_bcch_bch_msg`` / ``liblte_rrc_unpack_bcch_bch_msg`` /
``liblte_rrc_pack_bcch_dlsch_msg`` / ``liblte_rrc_unpack_bcch_dlsch_msg``.)

All packers emit the Rel-8 36.331 UPER bit layout (ASN.1 field order
documented per message below); the reference's
``tests/test_spec_vectors.py`` byte-checks a hand-derived SIB1 encoding
against an independent transcription of the grammar.  Optional IEs not carried by the dataclasses are encoded absent;
extended (post-Rel-8 critical-extension) inputs decode to ``None`` rather
than mis-parsing.

The port's own copy of ``lteax/stack/rrc.py`` (numpy only; the port
imports nothing of the JAX package): the packers feed the jax-free cell
generator, the unpackers the capture scanner's SI decode.
``tests/test_torch_plans.py`` holds the two equal.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from lteax_torch.stack.uper import UperReader, UperWriter

BW_ENUM = (6, 15, 25, 50, 75, 100)
PHICH_RES_ENUM = (1 / 6, 1 / 2, 1, 2)
PHICH_RES_NAMES = ("1/6", "1/2", "1", "2")


@dataclasses.dataclass
class Mib:
    n_rb_dl: int
    phich_duration_extended: bool
    phich_resource: float      # 1/6, 1/2, 1, 2
    sfn: int                   # full SFN; only sfn>>2 is carried


def pack_mib(m: Mib) -> np.ndarray:
    bits: list[int] = []
    bw = BW_ENUM.index(m.n_rb_dl)
    for i in (2, 1, 0):
        bits.append((bw >> i) & 1)
    bits.append(1 if m.phich_duration_extended else 0)
    res = PHICH_RES_ENUM.index(m.phich_resource)
    for i in (1, 0):
        bits.append((res >> i) & 1)
    sfn8 = (m.sfn >> 2) & 0xFF
    for i in range(7, -1, -1):
        bits.append((sfn8 >> i) & 1)
    bits.extend([0] * 10)
    return np.asarray(bits, dtype=np.int32)


def unpack_mib(bits: np.ndarray, sfn_mod4: int = 0) -> Mib:
    b = [int(x) for x in bits]
    bw = (b[0] << 2) | (b[1] << 1) | b[2]
    dur = bool(b[3])
    res = (b[4] << 1) | b[5]
    sfn8 = 0
    for i in range(8):
        sfn8 = (sfn8 << 1) | b[6 + i]
    return Mib(n_rb_dl=BW_ENUM[bw], phich_duration_extended=dur,
               phich_resource=PHICH_RES_ENUM[res],
               sfn=(sfn8 << 2) | (sfn_mod4 & 3))


# ---------------------------------------------------------------------------
# SIB1 / SIB2 subset
# ---------------------------------------------------------------------------

SI_WINDOW_MS = (1, 2, 5, 10, 15, 20, 40)
SI_PERIODICITY_RF = (8, 16, 32, 64, 128, 256, 512)


@dataclasses.dataclass
class SchedulingInfo:
    si_periodicity_rf: int          # radio frames
    sib_mapping: tuple[int, ...]    # SIB type numbers >= 3 mapped to this SI


@dataclasses.dataclass
class Sib1:
    mcc: tuple[int, int, int]
    mnc: tuple[int, ...]            # 2 or 3 digits
    tac: int                        # 16 bit
    cell_identity: int              # 28 bit
    cell_barred: bool = False
    intra_freq_reselection: bool = True
    q_rx_lev_min: int = -70         # * 2 dBm encoded (-70..-22)
    freq_band_indicator: int = 1
    si_window_ms: int = 20
    scheduling: tuple[SchedulingInfo, ...] = ()


def pack_sib1(s: Sib1) -> np.ndarray:
    """BCCH-DL-SCH-Message carrying SystemInformationBlockType1, encoded in
    UNALIGNED PER per 36.331 §6.2.2 / X.691.

    ASN.1 field order (Rel-8 SystemInformationBlockType1; optional fields
    p-Max / tdd-Config / csg-Identity / q-RxLevMinOffset /
    nonCriticalExtension absent):
      BCCH-DL-SCH-MessageType CHOICE: c1(0) -> CHOICE: sib1(1)
      SEQUENCE bitmap [p-Max, tdd-Config, nonCriticalExtension]
      cellAccessRelatedInfo: bitmap [csg-Identity];
        plmn-IdentityList SIZE(1..6); PLMN-Identity {mcc OPTIONAL present,
        3x digit(0..9), mnc SIZE(2..3) of digit},
        cellReservedForOperatorUse ENUM{reserved, notReserved};
        trackingAreaCode BIT STRING(16); cellIdentity BIT STRING(28);
        cellBarred ENUM{barred,notBarred};
        intraFreqReselection ENUM{allowed,notAllowed}; csg-Indication BOOLEAN
      cellSelectionInfo: bitmap [q-RxLevMinOffset]; q-RxLevMin INT(-70..-22)
      freqBandIndicator INT(1..64)
      schedulingInfoList SIZE(1..32) of SchedulingInfo {
        si-Periodicity ENUM(rf8..rf512), sib-MappingInfo SIZE(0..31) of
        SIB-Type ENUM(sibType3.., extensible, 16 root values) }
      si-WindowLength ENUM(ms1..ms40); systemInfoValueTag INT(0..31)
    """
    w = UperWriter()
    w.bit(0)                         # BCCH-DL-SCH-MessageType: c1
    w.bit(1)                         # c1: systemInformationBlockType1
    w.opt(False)                     # p-Max absent
    w.opt(False)                     # tdd-Config absent
    w.opt(False)                     # nonCriticalExtension absent
    # cellAccessRelatedInfo
    w.opt(False)                     # csg-Identity absent
    w.length(1, 1, 6)                # one PLMN
    w.opt(True)                      # mcc present
    for d in s.mcc:
        w.cint(d, 0, 9)
    w.length(len(s.mnc), 2, 3)
    for d in s.mnc:
        w.cint(d, 0, 9)
    w.enum(1, 2)                     # cellReservedForOperatorUse: notReserved
    w.bitstring(s.tac, 16)
    w.bitstring(s.cell_identity, 28)
    w.enum(0 if s.cell_barred else 1, 2)
    w.enum(0 if s.intra_freq_reselection else 1, 2)
    w.bit(0)                         # csg-Indication FALSE
    # cellSelectionInfo
    w.opt(False)                     # q-RxLevMinOffset absent
    w.cint(s.q_rx_lev_min, -70, -22)
    w.cint(s.freq_band_indicator, 1, 64)
    w.length(len(s.scheduling), 1, 32)
    for si in s.scheduling:
        w.enum(SI_PERIODICITY_RF.index(si.si_periodicity_rf), 7)
        w.length(len(si.sib_mapping), 0, 31)
        for t in si.sib_mapping:
            w.enum(t - 3, 16, extensible=True)   # SIB-Type
    w.enum(SI_WINDOW_MS.index(s.si_window_ms), 7)
    w.cint(0, 0, 31)                 # systemInfoValueTag
    return w.array()


def unpack_sib1(bits: np.ndarray) -> Sib1 | None:
    try:
        r = UperReader(bits)
        if r.bit() != 0 or r.bit() != 1:
            return None              # not c1/sib1
        opt_pmax, opt_tdd, opt_ext = r.opt(), r.opt(), r.opt()
        opt_csg_id = r.opt()
        n_plmn = r.length(1, 6)
        mcc = (0, 0, 0)
        mnc = ()
        for i in range(n_plmn):
            has_mcc = r.opt()
            m = tuple(r.cint(0, 9) for _ in range(3)) if has_mcc else (0, 0, 0)
            nm = r.length(2, 3)
            n = tuple(r.cint(0, 9) for _ in range(nm))
            r.enum(2)                # cellReservedForOperatorUse
            if i == 0:
                mcc, mnc = m, n
        tac = r.bitstring(16)
        cid = r.bitstring(28)
        barred = r.enum(2) == 0
        ifr = r.enum(2) == 0
        r.bit()                      # csg-Indication
        if opt_csg_id:
            r.bitstring(27)
        opt_qoff = r.opt()
        qrx = r.cint(-70, -22)
        if opt_qoff:
            r.cint(1, 8)
        if opt_pmax:
            r.cint(-30, 33)
        band = r.cint(1, 64)
        n_sched = r.length(1, 32)
        sched = []
        for _ in range(n_sched):
            per = SI_PERIODICITY_RF[r.enum(7)]
            n_map = r.length(0, 31)
            sched.append(SchedulingInfo(
                per, tuple(r.enum(16, extensible=True) + 3
                           for _ in range(n_map))))
        if opt_tdd:
            return None              # TDD not supported
        win = SI_WINDOW_MS[r.enum(7)]
        r.cint(0, 31)                # systemInfoValueTag
        return Sib1(mcc=mcc, mnc=mnc, tac=tac, cell_identity=cid,
                    cell_barred=barred, intra_freq_reselection=ifr,
                    q_rx_lev_min=qrx, freq_band_indicator=band,
                    si_window_ms=win, scheduling=tuple(sched))
    except (IndexError, ValueError):
        return None


@dataclasses.dataclass
class Sib2:
    """Rel-8 SystemInformationBlockType2 core fields (36.331 §6.3.1).

    Enumerated IEs carry the ENUM *index*; integer IEs carry the ASN.1
    integer value."""
    # rach-ConfigCommon
    number_of_ra_preambles: int = 12     # ENUM n4..n64 step4: 12 -> n52
    power_ramping_step: int = 1          # ENUM {dB0,dB2,dB4,dB6}
    preamble_init_target_power: int = 8  # ENUM dBm-120..-90 step2: 8 -> -104
    preamble_trans_max: int = 5          # ENUM {n3..n200}: 5 -> n8
    ra_response_window_size: int = 7     # ENUM sf2..sf10: 7 -> sf10
    mac_contention_resolution_timer: int = 5   # ENUM sf8..sf64: 5 -> sf48
    max_harq_msg3_tx: int = 4            # INTEGER (1..8)
    # bcch / pcch
    modification_period_coeff: int = 0   # ENUM {n2,n4,n8,n16}
    default_paging_cycle: int = 2        # ENUM {rf32,rf64,rf128,rf256}
    nb: int = 2                          # ENUM fourT..oneThirtySecondT
    # prach
    prach_root_sequence_index: int = 0   # INTEGER (0..837)
    prach_config_index: int = 3          # INTEGER (0..63)
    prach_high_speed_flag: bool = False
    prach_zero_correlation_zone: int = 11  # INTEGER (0..15)
    prach_freq_offset: int = 2           # INTEGER (0..94)
    # pdsch / pusch / pucch
    pdsch_reference_signal_power: int = -60  # INTEGER (-60..50)
    pdsch_p_b: int = 0                   # INTEGER (0..3)
    pusch_n_sb: int = 1                  # INTEGER (1..4)
    pusch_hopping_mode: int = 0          # ENUM {interSubFrame, intraAndInter}
    pusch_hopping_offset: int = 0        # INTEGER (0..98)
    pusch_enable_64qam: bool = False
    group_hopping_enabled: bool = False
    group_assignment_pusch: int = 0      # INTEGER (0..29)
    sequence_hopping_enabled: bool = False
    cyclic_shift: int = 0                # INTEGER (0..7)
    pucch_delta_shift: int = 0           # ENUM {ds1,ds2,ds3}
    pucch_n_rb_cqi: int = 0              # INTEGER (0..98)
    pucch_n_cs_an: int = 0               # INTEGER (0..7)
    pucch_n1_an: int = 0                 # INTEGER (0..2047)
    # uplink power control
    p0_nominal_pusch: int = -70          # INTEGER (-126..24)
    alpha: int = 7                       # ENUM {al0..al1}
    p0_nominal_pucch: int = -96          # INTEGER (-127..-96)
    delta_f_pucch: tuple[int, int, int, int, int] = (1, 1, 1, 1, 1)
    delta_preamble_msg3: int = 4         # INTEGER (-1..6)
    ul_cyclic_prefix_length: int = 0     # ENUM {len1, len2}
    # ue-TimersAndConstants
    t300: int = 5
    t301: int = 5
    t310: int = 4
    n310: int = 0
    t311: int = 0
    n311: int = 0
    # freqInfo
    ul_carrier_freq_earfcn: int | None = 18000   # INTEGER (0..65535) OPTIONAL
    ul_bandwidth: int | None = 0         # ENUM {n6..n100} OPTIONAL
    additional_spectrum_emission: int = 1  # INTEGER (1..32)
    time_alignment_timer: int = 7        # ENUM sf500..infinity


def _pack_sib2_body(w, s: Sib2) -> None:
    """SystemInformationBlockType2 UPER body (extensible SEQUENCE)."""
    w.bit(0)                            # extension bit
    w.opt(False)                        # ac-BarringInfo absent
    w.opt(False)                        # mbsfn-SubframeConfigList absent
    # radioResourceConfigCommon (RadioResourceConfigCommonSIB, extensible)
    w.bit(0)
    # rach-ConfigCommon (extensible)
    w.bit(0)
    w.opt(False)                        # preamblesGroupAConfig absent
    w.enum(s.number_of_ra_preambles, 16)
    w.enum(s.power_ramping_step, 4)
    w.enum(s.preamble_init_target_power, 16)
    w.enum(s.preamble_trans_max, 11)
    w.enum(s.ra_response_window_size, 8)
    w.enum(s.mac_contention_resolution_timer, 8)
    w.cint(s.max_harq_msg3_tx, 1, 8)
    # bcch-Config / pcch-Config
    w.enum(s.modification_period_coeff, 4)
    w.enum(s.default_paging_cycle, 4)
    w.enum(s.nb, 8)
    # prach-Config
    w.cint(s.prach_root_sequence_index, 0, 837)
    w.cint(s.prach_config_index, 0, 63)
    w.bit(1 if s.prach_high_speed_flag else 0)
    w.cint(s.prach_zero_correlation_zone, 0, 15)
    w.cint(s.prach_freq_offset, 0, 94)
    # pdsch-ConfigCommon
    w.cint(s.pdsch_reference_signal_power, -60, 50)
    w.cint(s.pdsch_p_b, 0, 3)
    # pusch-ConfigCommon
    w.cint(s.pusch_n_sb, 1, 4)
    w.enum(s.pusch_hopping_mode, 2)
    w.cint(s.pusch_hopping_offset, 0, 98)
    w.bit(1 if s.pusch_enable_64qam else 0)
    w.bit(1 if s.group_hopping_enabled else 0)
    w.cint(s.group_assignment_pusch, 0, 29)
    w.bit(1 if s.sequence_hopping_enabled else 0)
    w.cint(s.cyclic_shift, 0, 7)
    # pucch-ConfigCommon
    w.enum(s.pucch_delta_shift, 3)
    w.cint(s.pucch_n_rb_cqi, 0, 98)
    w.cint(s.pucch_n_cs_an, 0, 7)
    w.cint(s.pucch_n1_an, 0, 2047)
    # soundingRS-UL-ConfigCommon CHOICE: release
    w.bit(0)
    # uplinkPowerControlCommon
    w.cint(s.p0_nominal_pusch, -126, 24)
    w.enum(s.alpha, 8)
    w.cint(s.p0_nominal_pucch, -127, -96)
    w.enum(s.delta_f_pucch[0], 3)
    w.enum(s.delta_f_pucch[1], 3)
    w.enum(s.delta_f_pucch[2], 4)
    w.enum(s.delta_f_pucch[3], 3)
    w.enum(s.delta_f_pucch[4], 3)
    w.cint(s.delta_preamble_msg3, -1, 6)
    # ul-CyclicPrefixLength
    w.enum(s.ul_cyclic_prefix_length, 2)
    # ue-TimersAndConstants (extensible)
    w.bit(0)
    w.enum(s.t300, 8)
    w.enum(s.t301, 8)
    w.enum(s.t310, 7)
    w.enum(s.n310, 8)
    w.enum(s.t311, 7)
    w.enum(s.n311, 8)
    # freqInfo
    w.opt(s.ul_carrier_freq_earfcn is not None)
    w.opt(s.ul_bandwidth is not None)
    if s.ul_carrier_freq_earfcn is not None:
        w.cint(s.ul_carrier_freq_earfcn, 0, 65535)
    if s.ul_bandwidth is not None:
        w.enum(s.ul_bandwidth, 6)
    w.cint(s.additional_spectrum_emission, 1, 32)
    # timeAlignmentTimerCommon
    w.enum(s.time_alignment_timer, 8)


def _unpack_sib2_body(r) -> Sib2:
    if r.bit():
        raise ValueError("extended SIB2")
    has_acb = r.opt()
    has_mbsfn = r.opt()
    if has_acb or has_mbsfn:
        raise ValueError("unsupported optional SIB2 IEs")
    if r.bit():
        raise ValueError("extended RRCCommonSIB")
    if r.bit():
        raise ValueError("extended RACH-ConfigCommon")
    if r.opt():
        raise ValueError("preamblesGroupAConfig unsupported")
    s = Sib2(
        number_of_ra_preambles=r.enum(16),
        power_ramping_step=r.enum(4),
        preamble_init_target_power=r.enum(16),
        preamble_trans_max=r.enum(11),
        ra_response_window_size=r.enum(8),
        mac_contention_resolution_timer=r.enum(8),
        max_harq_msg3_tx=r.cint(1, 8),
        modification_period_coeff=r.enum(4),
        default_paging_cycle=r.enum(4),
        nb=r.enum(8),
        prach_root_sequence_index=r.cint(0, 837),
        prach_config_index=r.cint(0, 63),
        prach_high_speed_flag=bool(r.bit()),
        prach_zero_correlation_zone=r.cint(0, 15),
        prach_freq_offset=r.cint(0, 94),
        pdsch_reference_signal_power=r.cint(-60, 50),
        pdsch_p_b=r.cint(0, 3),
        pusch_n_sb=r.cint(1, 4),
        pusch_hopping_mode=r.enum(2),
        pusch_hopping_offset=r.cint(0, 98),
        pusch_enable_64qam=bool(r.bit()),
        group_hopping_enabled=bool(r.bit()),
        group_assignment_pusch=r.cint(0, 29),
        sequence_hopping_enabled=bool(r.bit()),
        cyclic_shift=r.cint(0, 7),
        pucch_delta_shift=r.enum(3),
        pucch_n_rb_cqi=r.cint(0, 98),
        pucch_n_cs_an=r.cint(0, 7),
        pucch_n1_an=r.cint(0, 2047),
    )
    if r.bit():
        raise ValueError("srs setup unsupported")
    s.p0_nominal_pusch = r.cint(-126, 24)
    s.alpha = r.enum(8)
    s.p0_nominal_pucch = r.cint(-127, -96)
    s.delta_f_pucch = (r.enum(3), r.enum(3), r.enum(4), r.enum(3), r.enum(3))
    s.delta_preamble_msg3 = r.cint(-1, 6)
    s.ul_cyclic_prefix_length = r.enum(2)
    if r.bit():
        raise ValueError("extended UE-TimersAndConstants")
    s.t300 = r.enum(8)
    s.t301 = r.enum(8)
    s.t310 = r.enum(7)
    s.n310 = r.enum(8)
    s.t311 = r.enum(7)
    s.n311 = r.enum(8)
    has_ul_freq = r.opt()
    has_ul_bw = r.opt()
    s.ul_carrier_freq_earfcn = r.cint(0, 65535) if has_ul_freq else None
    s.ul_bandwidth = r.enum(6) if has_ul_bw else None
    s.additional_spectrum_emission = r.cint(1, 32)
    s.time_alignment_timer = r.enum(8)
    return s


# re-export the Rel-8 SIB3..SIB11 UPER codecs (lteax_torch.stack.rrc_sibs)
from lteax_torch.stack.rrc_sibs import (  # noqa: E402,F401
    Sib3, Sib4, Sib5, Sib6, Sib7, Sib8, Sib9, Sib10, Sib11,
    IntraFreqNeighCell, InterFreqCarrier, InterFreqNeighCell,
    PhysCellIdRange, SpeedStateScaleFactors, SpeedStateReselectionPars,
    MobilityStateParameters, UtraCarrierFdd, UtraCarrierTdd,
    GeranCarrierFreqs, GeranCarrierInfo, BandClassInfoCdma, NeighCellCdma,
    NeighCellsPerBandclassCdma, CellReselParamsCdma, PreRegistrationInfoHrpd,
    CsfbRegistrationParam1xrtt, SIB_REGISTRY, SIB_TYPE_INDEX,
    Sib12, Sib13, MbsfnAreaInfo, MbmsNotificationConfig,
    SIB_EXT_REGISTRY, SIB_EXT_TYPE_INDEX,
)


def pack_si(*sibs) -> np.ndarray:
    """BCCH-DL-SCH-Message carrying SystemInformation with 1..32 SIBs,
    UNALIGNED PER.

    Wrapper: c1(0) -> systemInformation(0); criticalExtensions CHOICE
    systemInformation-r8(0); bitmap [nonCriticalExtension absent];
    sib-TypeAndInfo SIZE(1..32); each element a CHOICE (extensible, root
    sib2(0)..sib11(9)) followed by the SIB body."""
    w = UperWriter()
    w.bit(0)                            # c1
    w.bit(0)                            # systemInformation
    w.bit(0)                            # criticalExtensions: r8
    w.opt(False)                        # nonCriticalExtension absent
    w.length(len(sibs), 1, 32)
    for s in sibs:
        if type(s) in SIB_EXT_TYPE_INDEX:
            # Rel-9+ extension alternative: '1' + normally-small index +
            # the body as an octet-aligned open-type field
            idx = SIB_EXT_TYPE_INDEX[type(s)]
            w.bit(1)
            w.small_index(idx)
            bw = UperWriter()
            SIB_EXT_REGISTRY[idx][1](bw, s)
            w.open_type(bw.bits)
            continue
        w.bit(0)                        # sib-TypeAndInfo CHOICE: not extended
        if isinstance(s, Sib2):
            w.cint(0, 0, 9)
            _pack_sib2_body(w, s)
        else:
            idx = SIB_TYPE_INDEX[type(s)]
            w.cint(idx, 0, 9)
            SIB_REGISTRY[idx][1](w, s)
    return w.array()


def pack_sib2(s: Sib2) -> np.ndarray:
    return pack_si(s)


def pack_sib3(s: Sib3) -> np.ndarray:
    return pack_si(s)


def unpack_si_list(bits: np.ndarray) -> list[tuple[str, object]]:
    """Unpack a SystemInformation message -> [("sib2", Sib2), ...].

    Stops (returning what it has) at the first extended/unsupported entry,
    since UPER root alternatives carry no skip-length."""
    out: list[tuple[str, object]] = []
    try:
        r = UperReader(bits)
        if r.bit() != 0 or r.bit() != 0:
            return out                  # not c1/systemInformation
        if r.bit() != 0:
            return out                  # criticalExtensionsFuture
        r.opt()                         # nonCriticalExtension flag
        n = r.length(1, 32)
        for _ in range(n):
            if r.bit() != 0:
                # extension alternative: open-type length makes unknown
                # entries skippable
                idx = r.small_index()
                body = r.open_type()
                if idx in SIB_EXT_REGISTRY:
                    name, _, unpack = SIB_EXT_REGISTRY[idx]
                    out.append((name, unpack(UperReader(body))))
                continue
            t = r.cint(0, 9)
            if t == 0:
                out.append(("sib2", _unpack_sib2_body(r)))
            elif t in SIB_REGISTRY:
                name, _, unpack = SIB_REGISTRY[t]
                out.append((name, unpack(r)))
            else:
                break
    except (IndexError, ValueError):
        pass
    return out


def unpack_si(bits: np.ndarray):
    """Unpack a SystemInformation message -> first ("sibN", body) | None."""
    got = unpack_si_list(bits)
    return got[0] if got else None


def unpack_si_ext(bits: np.ndarray):
    """Back-compat alias of :func:`unpack_si` (SIB3+ now ride the standard
    SystemInformation wrapper)."""
    return unpack_si(bits)


@dataclasses.dataclass
class Paging:
    """PCCH Paging (36.331 §6.2.2), S-TMSI paging records.

    ``ue_identities`` carry 40-bit S-TMSI values (mmec << 32 | m-TMSI);
    values < 2^32 are m-TMSI with mmec 0."""
    ue_identities: tuple[int, ...] = ()
    system_info_modification: bool = False
    etws_indication: bool = False


def pack_paging(p: Paging) -> np.ndarray:
    """PCCH-Message in UNALIGNED PER.

    Layout: PCCH-MessageType CHOICE c1(0); c1 CHOICE {paging} (single
    alternative: 0 bits); Paging SEQUENCE bitmap [pagingRecordList,
    systemInfoModification, etws-Indication, nonCriticalExtension];
    PagingRecord = extensible SEQUENCE {ue-Identity CHOICE s-TMSI(0)
    {mmec BIT STRING(8), m-TMSI BIT STRING(32)}, cn-Domain ENUM{ps,cs}}."""
    w = UperWriter()
    w.bit(0)                            # PCCH-MessageType: c1
    w.opt(len(p.ue_identities) > 0)     # pagingRecordList
    w.opt(p.system_info_modification)   # systemInfoModification ENUM{true}
    w.opt(p.etws_indication)            # etws-Indication ENUM{true}
    w.opt(False)                        # nonCriticalExtension absent
    if p.ue_identities:
        w.length(len(p.ue_identities), 1, 16)
        for tmsi in p.ue_identities:
            w.bit(0)                    # PagingRecord extension bit
            w.bit(0)                    # ue-Identity CHOICE: s-TMSI (ext=0)
            w.bit(0)                    #   root index (s-TMSI=0 of 2)
            w.bitstring((tmsi >> 32) & 0xFF, 8)     # mmec
            w.bitstring(tmsi & 0xFFFFFFFF, 32)      # m-TMSI
            w.enum(0, 2)                # cn-Domain: ps
    return w.array()


def unpack_paging(bits: np.ndarray) -> Paging | None:
    """Decode a PCCH Paging message.  Returns None for empty pagings (no
    records and no indications) — a content-free Paging is never sent, and
    rejecting it keeps zero-padded non-PCCH payloads from false-decoding."""
    try:
        r = UperReader(bits)
        if r.bit() != 0:
            return None                 # messageClassExtension
        has_rec, has_sim, has_etws, has_ext = (r.opt(), r.opt(),
                                               r.opt(), r.opt())
        if has_ext or not (has_rec or has_sim or has_etws):
            return None
        ids: list[int] = []
        if has_rec:
            for _ in range(r.length(1, 16)):
                if r.bit():
                    return None         # extended PagingRecord
                if r.bit():
                    return None         # extended ue-Identity CHOICE
                if r.bit():
                    return None         # imsi paging unsupported
                mmec = r.bitstring(8)
                mtmsi = r.bitstring(32)
                ids.append((mmec << 32) | mtmsi)
                r.enum(2)               # cn-Domain
        return Paging(ue_identities=tuple(ids),
                      system_info_modification=has_sim,
                      etws_indication=has_etws)
    except (IndexError, ValueError):
        return None


def pad_to(bits: np.ndarray, n: int) -> np.ndarray:
    """Pad a message to transport block size with zeros."""
    if len(bits) > n:
        raise ValueError(f"message ({len(bits)}b) exceeds TBS {n}")
    return np.concatenate([bits, np.zeros(n - len(bits), dtype=bits.dtype)])
