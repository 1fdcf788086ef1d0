"""Dedicated-mode RRC message codecs in UNALIGNED PER (36.331 §6.2).

(reference capability: ``liblte/src/liblte_rrc.cc`` UL-CCCH / DL-CCCH /
UL-DCCH / DL-DCCH message pack/unpack — ``liblte_rrc_pack_ul_ccch_msg``,
``liblte_rrc_pack_dl_ccch_msg``, ``liblte_rrc_pack_ul_dcch_msg``,
``liblte_rrc_pack_dl_dcch_msg`` and their unpack pairs — the messages
``LTE_fdd_enb_rrc`` exchanges during connection setup, security activation,
DRB reconfiguration and release.)

Covered (Rel-8 field trees):
  UL-CCCH:  RRCConnectionRequest (S-TMSI / random identity),
            RRCConnectionReestablishmentRequest (C-RNTI/PCI/shortMAC-I)
  DL-CCCH:  RRCConnectionSetup (RadioResourceConfigDedicated),
            RRCConnectionReestablishment (+NCC),
            RRCConnectionReestablishmentReject, RRCConnectionReject
  UL-DCCH:  RRCConnectionSetupComplete (+NAS), ULInformationTransfer,
            SecurityModeComplete, SecurityModeFailure,
            RRCConnectionReconfigurationComplete,
            RRCConnectionReestablishmentComplete,
            MeasurementReport (MeasResults + EUTRA neighbour list)
  DL-DCCH:  DLInformationTransfer, SecurityModeCommand,
            RRCConnectionReconfiguration (+NAS list, DRB add),
            RRCConnectionRelease

PROVENANCE: encodings follow the 36.331 Rel-8 ASN.1 from spec memory (the
reference mount is empty); c1-CHOICE alternative orders and RLC/PDCP enum
root sizes are [U]-tagged for the citation pass.  Self-consistent
pack/unpack round-trip is the test oracle, as for the SIB codecs.

The port's own copy of ``lteax/stack/rrc_dedicated.py`` (it imports nothing of the
JAX package); ``tests/test_torch_stack.py`` holds the two equal.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from lteax_torch.stack.uper import UperWriter, UperReader


# ---------------------------------------------------------------------------
# IEs
# ---------------------------------------------------------------------------

ESTABLISHMENT_CAUSES = ("emergency", "highPriorityAccess", "mt-Access",
                        "mo-Signalling", "mo-Data", "spare3", "spare2",
                        "spare1")
RELEASE_CAUSES = ("loadBalancingTAUrequired", "other", "spare2", "spare1")
CIPHERING_ALGS = ("eea0", "eea1", "eea2")      # root has 8 slots (3 bits)
INTEGRITY_ALGS = ("eia0", "eia1", "eia2")      # eia0 reserved in Rel-8 [U]


@dataclasses.dataclass
class SrbToAddMod:
    """SRB-ToAddMod with the CHOICE defaultValue configs (the common case
    in the reference's connection setup)."""
    srb_identity: int              # 1..2


@dataclasses.dataclass
class DrbToAddMod:
    eps_bearer_identity: int       # 0..15
    drb_identity: int              # 1..32
    lcid: int                      # logicalChannelIdentity 3..10
    pdcp_sn_12bit: bool = True     # rlc-UM pdcp-SN-Size
    um_sn_10bit: bool = True       # UM sn-FieldLength (both directions)
    t_reordering_idx: int = 10     # T-Reordering enum index (ms50) [U]
    priority: int = 9              # logical channel priority 1..16
    lcg: int = 3                   # logicalChannelGroup 0..3


@dataclasses.dataclass
class RadioResourceConfigDedicated:
    srb_to_add: tuple[SrbToAddMod, ...] = ()
    drb_to_add: tuple[DrbToAddMod, ...] = ()
    drb_to_release: tuple[int, ...] = ()


def _pack_rrcd(w: UperWriter, c: RadioResourceConfigDedicated) -> None:
    # RadioResourceConfigDedicated ::= SEQUENCE (extensible): bitmap over
    # [srb-ToAddModList, drb-ToAddModList, drb-ToReleaseList,
    #  mac-MainConfig, sps-Config, physicalConfigDedicated]
    w.bit(0)                                    # extension
    w.opt(bool(c.srb_to_add))
    w.opt(bool(c.drb_to_add))
    w.opt(bool(c.drb_to_release))
    w.opt(False)                                # mac-MainConfig
    w.opt(False)                                # sps-Config
    w.opt(False)                                # physicalConfigDedicated
    if c.srb_to_add:
        w.length(len(c.srb_to_add), 1, 2)
        for s in c.srb_to_add:
            w.bit(0)                            # extension
            w.opt(True)                         # rlc-Config present
            w.opt(True)                         # logicalChannelConfig present
            w.cint(s.srb_identity, 1, 2)
            w.bit(1)                            # rlc-Config: defaultValue
            w.bit(1)                            # lcConfig: defaultValue
    if c.drb_to_add:
        w.length(len(c.drb_to_add), 1, 11)      # maxDRB = 11
        for d in c.drb_to_add:
            _pack_drb(w, d)
    if c.drb_to_release:
        w.length(len(c.drb_to_release), 1, 11)
        for drb_id in c.drb_to_release:
            w.cint(drb_id, 1, 32)


def _unpack_rrcd(r: UperReader) -> RadioResourceConfigDedicated:
    r.bit()
    has_srb, has_drb, has_rel = r.opt(), r.opt(), r.opt()
    has_mac, has_sps, has_phy = r.opt(), r.opt(), r.opt()
    if has_mac or has_sps or has_phy:
        raise ValueError("mac/sps/phy dedicated configs not supported")
    srbs: list[SrbToAddMod] = []
    drbs: list[DrbToAddMod] = []
    rels: list[int] = []
    if has_srb:
        for _ in range(r.length(1, 2)):
            r.bit()
            has_rlc, has_lc = r.opt(), r.opt()
            sid = r.cint(1, 2)
            if has_rlc and r.bit() != 1:
                raise ValueError("explicit SRB RLC-Config not supported")
            if has_lc and r.bit() != 1:
                raise ValueError("explicit SRB lcConfig not supported")
            srbs.append(SrbToAddMod(srb_identity=sid))
    if has_drb:
        for _ in range(r.length(1, 11)):
            drbs.append(_unpack_drb(r))
    if has_rel:
        for _ in range(r.length(1, 11)):
            rels.append(r.cint(1, 32))
    return RadioResourceConfigDedicated(tuple(srbs), tuple(drbs), tuple(rels))


def _pack_drb(w: UperWriter, d: DrbToAddMod) -> None:
    # DRB-ToAddMod ::= SEQUENCE (extensible): bitmap over [eps-BearerIdentity,
    # pdcp-Config, rlc-Config, logicalChannelIdentity, logicalChannelConfig]
    w.bit(0)
    w.opt(True); w.opt(True); w.opt(True); w.opt(True); w.opt(True)
    w.cint(d.eps_bearer_identity, 0, 15)
    w.cint(d.drb_identity, 1, 32)
    # PDCP-Config (extensible): bitmap [discardTimer, rlc-AM, rlc-UM]
    w.bit(0)
    w.opt(False)                                # discardTimer
    w.opt(False)                                # rlc-AM
    w.opt(True)                                 # rlc-UM
    w.cint(0 if d.pdcp_sn_12bit else 1, 0, 1)   # len12bits(0)/len7bits(1) [U]
    w.bit(0)                                    # headerCompression: notUsed
    # RLC-Config CHOICE (extensible): am(0) / um-Bi(1) / um-UL(2) / um-DL(3)
    w.bit(0)
    w.cint(1, 0, 3)                             # um-Bi-Directional
    w.cint(0 if d.um_sn_10bit else 1, 0, 1)     # UL sn: size10(0)/size5(1) [U]
    w.cint(0 if d.um_sn_10bit else 1, 0, 1)     # DL sn-FieldLength
    w.cint(d.t_reordering_idx, 0, 31)           # T-Reordering (32 values) [U]
    w.cint(d.lcid, 3, 10)
    # LogicalChannelConfig (extensible): bitmap [ul-SpecificParameters]
    w.bit(0)
    w.opt(True)
    w.cint(d.priority, 1, 16)
    w.cint(15, 0, 15)                           # prioritisedBitRate: infinity
    w.cint(0, 0, 7)                             # bucketSizeDuration: ms50
    w.opt(True)
    w.cint(d.lcg, 0, 3)


def _unpack_drb(r: UperReader) -> DrbToAddMod:
    r.bit()
    has_eps, has_pdcp, has_rlc, has_lcid, has_lc = (
        r.opt(), r.opt(), r.opt(), r.opt(), r.opt())
    if not (has_eps and has_pdcp and has_rlc and has_lcid and has_lc):
        raise ValueError("partial DRB-ToAddMod not supported")
    eps = r.cint(0, 15)
    drb_id = r.cint(1, 32)
    r.bit()
    if r.opt() or r.opt():
        raise ValueError("pdcp discardTimer / rlc-AM not supported")
    if not r.opt():
        raise ValueError("pdcp rlc-UM expected")
    sn12 = r.cint(0, 1) == 0
    if r.bit() != 0:
        raise ValueError("ROHC not supported")
    r.bit()
    if r.cint(0, 3) != 1:
        raise ValueError("only um-Bi-Directional RLC supported")
    ul_sn10 = r.cint(0, 1) == 0
    r.cint(0, 1)                                 # DL sn (mirrors UL here)
    t_reo = r.cint(0, 31)
    lcid = r.cint(3, 10)
    r.bit()
    if not r.opt():
        raise ValueError("ul-SpecificParameters expected")
    prio = r.cint(1, 16)
    r.cint(0, 15)
    r.cint(0, 7)
    lcg = r.cint(0, 3) if r.opt() else 0
    return DrbToAddMod(eps_bearer_identity=eps, drb_identity=drb_id,
                       lcid=lcid, pdcp_sn_12bit=sn12, um_sn_10bit=ul_sn10,
                       t_reordering_idx=t_reo, priority=prio, lcg=lcg)


# ---------------------------------------------------------------------------
# Messages
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class RrcConnectionRequest:
    cause: str = "mo-Signalling"
    # identity: ("stmsi", mmec, m_tmsi) or ("random", 40-bit value)
    identity: tuple = ("random", 0x12345678AB)


@dataclasses.dataclass
class RrcConnectionSetup:
    rrc_ti: int = 0
    rrcd: RadioResourceConfigDedicated = dataclasses.field(
        default_factory=lambda: RadioResourceConfigDedicated(
            srb_to_add=(SrbToAddMod(1),)))


@dataclasses.dataclass
class RrcConnectionSetupComplete:
    rrc_ti: int = 0
    selected_plmn: int = 1         # 1..6 into SIB1's plmn-IdentityList
    nas: bytes = b""


@dataclasses.dataclass
class UlInformationTransfer:
    nas: bytes = b""


@dataclasses.dataclass
class DlInformationTransfer:
    rrc_ti: int = 0
    nas: bytes = b""


@dataclasses.dataclass
class SecurityModeCommand:
    rrc_ti: int = 0
    ciphering: str = "eea2"
    integrity: str = "eia2"


@dataclasses.dataclass
class SecurityModeComplete:
    rrc_ti: int = 0


@dataclasses.dataclass
class RrcConnectionReconfiguration:
    """Optionally carries a measurement configuration and/or an intra-LTE
    handover command (mobilityControlInfo + securityConfigHO) — see
    :mod:`lteax_torch.stack.rrc_meas` for those IEs."""
    rrc_ti: int = 0
    nas_list: tuple[bytes, ...] = ()
    rrcd: RadioResourceConfigDedicated | None = None
    meas_config: object | None = None      # rrc_meas.MeasConfig
    mobility: object | None = None         # rrc_meas.MobilityControlInfo
    sec_ho: object | None = None           # rrc_meas.SecurityConfigHO


@dataclasses.dataclass
class RrcConnectionReconfigurationComplete:
    rrc_ti: int = 0


@dataclasses.dataclass
class RrcConnectionRelease:
    rrc_ti: int = 0
    cause: str = "other"


@dataclasses.dataclass
class RrcConnectionReject:
    wait_time: int = 10            # seconds, 1..16


@dataclasses.dataclass
class RrcConnectionReestablishmentRequest:
    """UL-CCCH reestablishment (36.331 §5.3.7): identifies the UE by
    (C-RNTI, physCellId, shortMAC-I)."""
    c_rnti: int = 0                # 16-bit
    phys_cell_id: int = 0          # 0..503
    short_mac_i: int = 0           # 16-bit
    cause: str = "otherFailure"


REESTABLISHMENT_CAUSES = ("reconfigurationFailure", "handoverFailure",
                          "otherFailure", "spare1")


@dataclasses.dataclass
class RrcConnectionReestablishment:
    rrc_ti: int = 0
    ncc: int = 0                   # nextHopChainingCount 0..7
    rrcd: RadioResourceConfigDedicated = dataclasses.field(
        default_factory=lambda: RadioResourceConfigDedicated(
            srb_to_add=(SrbToAddMod(1),)))


@dataclasses.dataclass
class RrcConnectionReestablishmentReject:
    pass


@dataclasses.dataclass
class RrcConnectionReestablishmentComplete:
    rrc_ti: int = 0


@dataclasses.dataclass
class SecurityModeFailure:
    rrc_ti: int = 0


@dataclasses.dataclass
class MeasResultEutra:
    phys_cell_id: int              # 0..503
    rsrp: int | None = None        # RSRP-Range 0..97
    rsrq: int | None = None        # RSRQ-Range 0..34


@dataclasses.dataclass
class MeasurementReport:
    """UL-DCCH MeasurementReport with the serving-cell result and an
    optional EUTRA neighbour list (36.331 §5.5.5 / MeasResults IE)."""
    meas_id: int = 1               # 1..32
    serv_rsrp: int = 0             # 0..97
    serv_rsrq: int = 0             # 0..34
    neigh: tuple[MeasResultEutra, ...] = ()


# ---------------------------------------------------------------------------
# UL-CCCH
# ---------------------------------------------------------------------------

def pack_ul_ccch(m) -> np.ndarray:
    w = UperWriter()
    w.bit(0)                       # UL-CCCH-MessageType: c1 (not msgClassExt)
    if isinstance(m, RrcConnectionReestablishmentRequest):
        w.cint(0, 0, 1)            # c1: rrcConnectionReestablishmentRequest(0)
        w.bit(0)                   # criticalExtensions: r8
        w.bitstring(m.c_rnti, 16)  # ReestabUE-Identity
        w.cint(m.phys_cell_id, 0, 503)
        w.bitstring(m.short_mac_i, 16)
        w.cint(REESTABLISHMENT_CAUSES.index(m.cause), 0, 3)
        w.bitstring(0, 2)          # spare BIT STRING (SIZE(2))
        return w.array()
    w.cint(1, 0, 1)                # c1: rrcConnectionRequest(1) [U order]
    w.bit(0)                       # criticalExtensions: r8
    kind = m.identity[0]
    if kind == "stmsi":
        w.bit(0)
        w.bitstring(m.identity[1], 8)      # mmec
        w.bitstring(m.identity[2], 32)     # m-TMSI
    else:
        w.bit(1)
        w.bitstring(m.identity[1], 40)     # randomValue
    w.cint(ESTABLISHMENT_CAUSES.index(m.cause), 0, 7)
    w.bit(0)                       # spare BIT STRING (SIZE(1))
    return w.array()


def unpack_ul_ccch(bits: np.ndarray):
    r = UperReader(bits)
    if r.bit() != 0:
        raise ValueError("messageClassExtension")
    alt = r.cint(0, 1)
    if alt == 0:                   # rrcConnectionReestablishmentRequest
        if r.bit() != 0:
            raise ValueError("not r8")
        c_rnti = r.bitstring(16)
        pci = r.cint(0, 503)
        smac = r.bitstring(16)
        cause = REESTABLISHMENT_CAUSES[r.cint(0, 3)]
        r.bitstring(2)
        return RrcConnectionReestablishmentRequest(
            c_rnti=c_rnti, phys_cell_id=pci, short_mac_i=smac, cause=cause)
    if r.bit() != 0:
        raise ValueError("not an r8 RRCConnectionRequest")
    if r.bit() == 0:
        ident = ("stmsi", r.bitstring(8), r.bitstring(32))
    else:
        ident = ("random", r.bitstring(40))
    cause = ESTABLISHMENT_CAUSES[r.cint(0, 7)]
    r.bit()
    return RrcConnectionRequest(cause=cause, identity=ident)


# ---------------------------------------------------------------------------
# DL-CCCH
# ---------------------------------------------------------------------------

def pack_dl_ccch(m) -> np.ndarray:
    # DL-CCCH c1 alternatives: rrcConnectionReestablishment(0),
    # rrcConnectionReestablishmentReject(1), rrcConnectionReject(2),
    # rrcConnectionSetup(3)  [U order]
    w = UperWriter()
    w.bit(0)                       # c1
    if isinstance(m, RrcConnectionReestablishment):
        w.cint(0, 0, 3)
        w.cint(m.rrc_ti, 0, 3)
        w.bit(0)                   # criticalExtensions: c1
        w.cint(0, 0, 7)            # rrcConnectionReestablishment-r8(0)
        w.opt(False)               # nonCriticalExtension
        _pack_rrcd(w, m.rrcd)
        w.cint(m.ncc, 0, 7)        # nextHopChainingCount
        return w.array()
    if isinstance(m, RrcConnectionReestablishmentReject):
        w.cint(1, 0, 3)
        w.bit(0)                   # criticalExtensions: r8
        w.opt(False)               # nonCriticalExtension
        return w.array()
    if isinstance(m, RrcConnectionReject):
        w.cint(2, 0, 3)
        w.bit(0)                   # criticalExtensions: c1
        w.cint(0, 0, 3)            # rrcConnectionReject-r8(0)
        w.opt(False)               # nonCriticalExtension
        w.cint(m.wait_time, 1, 16)
        return w.array()
    w.cint(3, 0, 3)                # rrcConnectionSetup(3) [U order]
    w.cint(m.rrc_ti, 0, 3)
    w.bit(0)                       # criticalExtensions: c1
    w.cint(0, 0, 7)                # rrcConnectionSetup-r8(0)
    w.opt(False)                   # nonCriticalExtension
    _pack_rrcd(w, m.rrcd)
    return w.array()


def unpack_dl_ccch(bits: np.ndarray):
    r = UperReader(bits)
    if r.bit() != 0:
        raise ValueError("messageClassExtension")
    alt = r.cint(0, 3)
    if alt == 0:                   # rrcConnectionReestablishment
        ti = r.cint(0, 3)
        if r.bit() != 0 or r.cint(0, 7) != 0:
            raise ValueError("not r8")
        r.opt()
        rrcd = _unpack_rrcd(r)
        return RrcConnectionReestablishment(rrc_ti=ti, ncc=r.cint(0, 7),
                                            rrcd=rrcd)
    if alt == 1:                   # rrcConnectionReestablishmentReject
        if r.bit() != 0:
            raise ValueError("not r8")
        r.opt()
        return RrcConnectionReestablishmentReject()
    if alt == 2:                   # rrcConnectionReject
        if r.bit() != 0 or r.cint(0, 3) != 0:
            raise ValueError("not r8")
        r.opt()
        return RrcConnectionReject(wait_time=r.cint(1, 16))
    ti = r.cint(0, 3)
    if r.bit() != 0 or r.cint(0, 7) != 0:
        raise ValueError("not r8")
    r.opt()
    return RrcConnectionSetup(rrc_ti=ti, rrcd=_unpack_rrcd(r))


# ---------------------------------------------------------------------------
# UL-DCCH — c1 CHOICE with 16 alternatives (4 bits) [U order]
# ---------------------------------------------------------------------------

_UL_DCCH_MEAS_REPORT = 1
_UL_DCCH_RECONF_COMPLETE = 2
_UL_DCCH_REESTAB_COMPLETE = 3
_UL_DCCH_SETUP_COMPLETE = 4
_UL_DCCH_SMC_COMPLETE = 5
_UL_DCCH_SMC_FAILURE = 6
_UL_DCCH_UL_INFO = 9


def _pack_meas_results(w: UperWriter, m: MeasurementReport) -> None:
    # MeasResults ::= SEQUENCE (extensible) { measId, measResultServCell
    # { rsrpResult, rsrqResult }, measResultNeighCells CHOICE OPTIONAL }
    w.bit(0)                       # extension
    w.opt(bool(m.neigh))           # measResultNeighCells
    w.cint(m.meas_id, 1, 32)
    w.cint(m.serv_rsrp, 0, 97)
    w.cint(m.serv_rsrq, 0, 34)
    if m.neigh:
        w.bit(0)                   # neighCells CHOICE: root
        w.cint(0, 0, 3)            # measResultListEUTRA(0) [U order]
        w.length(len(m.neigh), 1, 8)   # maxCellReport = 8
        for n in m.neigh:
            w.opt(False)           # cgi-Info absent
            w.cint(n.phys_cell_id, 0, 503)
            w.bit(0)               # measResult extension
            w.opt(n.rsrp is not None)
            w.opt(n.rsrq is not None)
            if n.rsrp is not None:
                w.cint(n.rsrp, 0, 97)
            if n.rsrq is not None:
                w.cint(n.rsrq, 0, 34)


def _unpack_meas_results(r: UperReader) -> MeasurementReport:
    r.bit()
    has_neigh = r.opt()
    mid = r.cint(1, 32)
    rsrp = r.cint(0, 97)
    rsrq = r.cint(0, 34)
    neigh: list[MeasResultEutra] = []
    if has_neigh:
        if r.bit() != 0 or r.cint(0, 3) != 0:
            raise ValueError("only measResultListEUTRA supported")
        for _ in range(r.length(1, 8)):
            if r.opt():
                raise ValueError("cgi-Info not supported")
            pci = r.cint(0, 503)
            r.bit()
            has_p, has_q = r.opt(), r.opt()
            neigh.append(MeasResultEutra(
                phys_cell_id=pci,
                rsrp=r.cint(0, 97) if has_p else None,
                rsrq=r.cint(0, 34) if has_q else None))
    return MeasurementReport(meas_id=mid, serv_rsrp=rsrp, serv_rsrq=rsrq,
                             neigh=tuple(neigh))


def pack_ul_dcch(m) -> np.ndarray:
    w = UperWriter()
    w.bit(0)                       # c1
    if isinstance(m, RrcConnectionSetupComplete):
        w.cint(_UL_DCCH_SETUP_COMPLETE, 0, 15)
        w.cint(m.rrc_ti, 0, 3)
        w.cint(0, 0, 3)            # criticalExtensions c1 -> r8(0) (2 bits)
        w.opt(False)               # registeredMME
        w.opt(False)               # nonCriticalExtension
        w.cint(m.selected_plmn, 1, 6)
        w.octets(m.nas)            # dedicatedInfoNAS
    elif isinstance(m, SecurityModeComplete):
        w.cint(_UL_DCCH_SMC_COMPLETE, 0, 15)
        w.cint(m.rrc_ti, 0, 3)
        w.bit(0)                   # criticalExtensions: r8
        w.opt(False)               # nonCriticalExtension
    elif isinstance(m, UlInformationTransfer):
        w.cint(_UL_DCCH_UL_INFO, 0, 15)
        w.bit(0)                   # criticalExtensions: c1
        w.cint(0, 0, 3)            # ulInformationTransfer-r8(0)
        w.opt(False)               # nonCriticalExtension
        w.cint(0, 0, 2)            # dedicatedInfoType: nas(0)
        w.octets(m.nas)
    elif isinstance(m, RrcConnectionReconfigurationComplete):
        w.cint(_UL_DCCH_RECONF_COMPLETE, 0, 15)
        w.cint(m.rrc_ti, 0, 3)
        w.bit(0)                   # criticalExtensions: r8
        w.opt(False)
    elif isinstance(m, RrcConnectionReestablishmentComplete):
        w.cint(_UL_DCCH_REESTAB_COMPLETE, 0, 15)
        w.cint(m.rrc_ti, 0, 3)
        w.bit(0)                   # criticalExtensions: r8
        w.opt(False)
    elif isinstance(m, SecurityModeFailure):
        w.cint(_UL_DCCH_SMC_FAILURE, 0, 15)
        w.cint(m.rrc_ti, 0, 3)
        w.bit(0)                   # criticalExtensions: r8
        w.opt(False)
    elif isinstance(m, MeasurementReport):
        w.cint(_UL_DCCH_MEAS_REPORT, 0, 15)
        w.bit(0)                   # criticalExtensions: c1
        w.cint(0, 0, 7)            # measurementReport-r8(0)
        w.opt(False)               # nonCriticalExtension
        _pack_meas_results(w, m)
    elif isinstance(m, UeCapabilityInformation):
        return pack_ue_capability_information(m)
    else:
        raise TypeError(type(m))
    return w.array()


def unpack_ul_dcch(bits: np.ndarray):
    r = UperReader(bits)
    if r.bit() != 0:
        raise ValueError("messageClassExtension")
    alt = r.cint(0, 15)
    if alt == _UL_DCCH_SETUP_COMPLETE:
        ti = r.cint(0, 3)
        if r.cint(0, 3) != 0:
            raise ValueError("not r8")
        has_mme, _ = r.opt(), r.opt()
        if has_mme:
            raise ValueError("registeredMME not supported")
        plmn = r.cint(1, 6)
        return RrcConnectionSetupComplete(rrc_ti=ti, selected_plmn=plmn,
                                          nas=r.octets())
    if alt == _UL_DCCH_SMC_COMPLETE:
        ti = r.cint(0, 3)
        r.bit(); r.opt()
        return SecurityModeComplete(rrc_ti=ti)
    if alt == _UL_DCCH_UL_INFO:
        r.bit()
        if r.cint(0, 3) != 0:
            raise ValueError("not r8")
        r.opt()
        if r.cint(0, 2) != 0:
            raise ValueError("non-NAS dedicatedInfoType")
        return UlInformationTransfer(nas=r.octets())
    if alt == _UL_DCCH_RECONF_COMPLETE:
        ti = r.cint(0, 3)
        r.bit(); r.opt()
        return RrcConnectionReconfigurationComplete(rrc_ti=ti)
    if alt == _UL_DCCH_REESTAB_COMPLETE:
        ti = r.cint(0, 3)
        r.bit(); r.opt()
        return RrcConnectionReestablishmentComplete(rrc_ti=ti)
    if alt == _UL_DCCH_SMC_FAILURE:
        ti = r.cint(0, 3)
        r.bit(); r.opt()
        return SecurityModeFailure(rrc_ti=ti)
    if alt == _UL_DCCH_MEAS_REPORT:
        if r.bit() != 0 or r.cint(0, 7) != 0:
            raise ValueError("not r8")
        r.opt()
        return _unpack_meas_results(r)
    if alt == _UL_DCCH_UE_CAP_INFO:
        ti = r.cint(0, 3)
        if r.bit() != 0 or r.cint(0, 7) != 0:
            raise ValueError("not r8")
        r.opt()
        containers = []
        for _ in range(r.length(0, 8)):
            rt = RAT_TYPES[r.enum(8, extensible=True)]
            containers.append((rt, r.octets()))
        return UeCapabilityInformation(rrc_ti=ti,
                                       containers=tuple(containers))
    raise ValueError(f"UL-DCCH alternative {alt} not supported")


# ---------------------------------------------------------------------------
# DL-DCCH — c1 CHOICE with 16 alternatives (4 bits) [U order]
# ---------------------------------------------------------------------------

_DL_DCCH_DL_INFO = 1
_DL_DCCH_RECONF = 4
_DL_DCCH_RELEASE = 5
_DL_DCCH_SMC = 6


def pack_dl_dcch(m) -> np.ndarray:
    w = UperWriter()
    w.bit(0)
    if isinstance(m, DlInformationTransfer):
        w.cint(_DL_DCCH_DL_INFO, 0, 15)
        w.cint(m.rrc_ti, 0, 3)
        w.bit(0)                   # criticalExtensions: c1
        w.cint(0, 0, 3)            # dlInformationTransfer-r8(0)
        w.opt(False)
        w.cint(0, 0, 2)            # dedicatedInfoType: nas(0)
        w.octets(m.nas)
    elif isinstance(m, SecurityModeCommand):
        w.cint(_DL_DCCH_SMC, 0, 15)
        w.cint(m.rrc_ti, 0, 3)
        w.bit(0)                   # criticalExtensions: c1
        w.cint(0, 0, 3)            # securityModeCommand-r8(0)
        w.opt(False)
        w.bit(0)                   # securityConfigSMC extension
        w.bit(0)                   # securityAlgorithmConfig extension
        w.bit(0)                   # cipheringAlgorithm: root
        w.cint(CIPHERING_ALGS.index(m.ciphering), 0, 7)
        w.bit(0)                   # integrityProtAlgorithm: root
        w.cint(INTEGRITY_ALGS.index(m.integrity), 0, 7)
    elif isinstance(m, RrcConnectionReconfiguration):
        from lteax_torch.stack import rrc_meas
        w.cint(_DL_DCCH_RECONF, 0, 15)
        w.cint(m.rrc_ti, 0, 3)
        w.bit(0)                   # criticalExtensions: c1
        w.cint(0, 0, 7)            # rrcConnectionReconfiguration-r8(0)
        w.opt(m.meas_config is not None)
        w.opt(m.mobility is not None)
        w.opt(bool(m.nas_list))    # dedicatedInfoNASList
        w.opt(m.rrcd is not None)  # radioResourceConfigDedicated
        w.opt(m.sec_ho is not None)
        w.opt(False)               # nonCriticalExtension
        if m.meas_config is not None:
            rrc_meas.pack_meas_config(w, m.meas_config)
        if m.mobility is not None:
            rrc_meas.pack_mobility_control_info(w, m.mobility)
        if m.nas_list:
            w.length(len(m.nas_list), 1, 11)
            for nas in m.nas_list:
                w.octets(nas)
        if m.rrcd is not None:
            _pack_rrcd(w, m.rrcd)
        if m.sec_ho is not None:
            rrc_meas.pack_security_config_ho(w, m.sec_ho)
    elif isinstance(m, RrcConnectionRelease):
        w.cint(_DL_DCCH_RELEASE, 0, 15)
        w.cint(m.rrc_ti, 0, 3)
        w.bit(0)                   # criticalExtensions: c1
        w.cint(0, 0, 3)            # rrcConnectionRelease-r8(0)
        w.opt(False)               # redirectedCarrierInfo
        w.opt(False)               # idleModeMobilityControlInfo
        w.opt(False)               # nonCriticalExtension
        w.cint(RELEASE_CAUSES.index(m.cause), 0, 3)
    elif isinstance(m, UeCapabilityEnquiry):
        return pack_ue_capability_enquiry(m)
    else:
        raise TypeError(type(m))
    return w.array()


def unpack_dl_dcch(bits: np.ndarray):
    r = UperReader(bits)
    if r.bit() != 0:
        raise ValueError("messageClassExtension")
    alt = r.cint(0, 15)
    if alt == _DL_DCCH_DL_INFO:
        ti = r.cint(0, 3)
        r.bit()
        if r.cint(0, 3) != 0:
            raise ValueError("not r8")
        r.opt()
        if r.cint(0, 2) != 0:
            raise ValueError("non-NAS dedicatedInfoType")
        return DlInformationTransfer(rrc_ti=ti, nas=r.octets())
    if alt == _DL_DCCH_SMC:
        ti = r.cint(0, 3)
        r.bit()
        if r.cint(0, 3) != 0:
            raise ValueError("not r8")
        r.opt()
        r.bit(); r.bit()
        if r.bit() != 0:
            raise ValueError("extended ciphering alg")
        ciph = CIPHERING_ALGS[r.cint(0, 7)]
        if r.bit() != 0:
            raise ValueError("extended integrity alg")
        integ = INTEGRITY_ALGS[r.cint(0, 7)]
        return SecurityModeCommand(rrc_ti=ti, ciphering=ciph, integrity=integ)
    if alt == _DL_DCCH_RECONF:
        ti = r.cint(0, 3)
        r.bit()
        if r.cint(0, 7) != 0:
            raise ValueError("not r8")
        from lteax_torch.stack import rrc_meas
        has_meas, has_mob = r.opt(), r.opt()
        has_nas, has_rrcd = r.opt(), r.opt()
        has_sec, _ = r.opt(), r.opt()
        meas = rrc_meas.unpack_meas_config(r) if has_meas else None
        mob = rrc_meas.unpack_mobility_control_info(r) if has_mob else None
        nas_list: tuple[bytes, ...] = ()
        if has_nas:
            nas_list = tuple(r.octets()
                             for _ in range(r.length(1, 11)))
        rrcd = _unpack_rrcd(r) if has_rrcd else None
        sec = rrc_meas.unpack_security_config_ho(r) if has_sec else None
        return RrcConnectionReconfiguration(rrc_ti=ti, nas_list=nas_list,
                                            rrcd=rrcd, meas_config=meas,
                                            mobility=mob, sec_ho=sec)
    if alt == _DL_DCCH_RELEASE:
        ti = r.cint(0, 3)
        r.bit()
        if r.cint(0, 3) != 0:
            raise ValueError("not r8")
        r.opt(); r.opt(); r.opt()
        return RrcConnectionRelease(rrc_ti=ti,
                                    cause=RELEASE_CAUSES[r.cint(0, 3)])
    if alt == _DL_DCCH_UE_CAP_ENQ:
        ti = r.cint(0, 3)
        if r.bit() != 0 or r.cint(0, 3) != 0:
            raise ValueError("not r8")
        r.opt()
        rats = tuple(RAT_TYPES[r.enum(8, extensible=True)]
                     for _ in range(r.length(1, 8)))
        return UeCapabilityEnquiry(rrc_ti=ti, rat_types=rats)
    raise ValueError(f"DL-DCCH alternative {alt} not supported")


# ---------------------------------------------------------------------------
# UE capability transfer (36.331 §5.6.3 + UE-EUTRA-Capability IE)
# ---------------------------------------------------------------------------

RAT_TYPES = ("eutra", "utra", "geran-cs", "geran-ps", "cdma2000-1XRTT")


@dataclasses.dataclass
class BandCapability:
    band: int                    # 1..64
    half_duplex: bool = False
    need_for_gaps: bool = True   # measParameters InterFreqBandInfo


@dataclasses.dataclass
class UeEutraCapability:
    """Rel-8 UE-EUTRA-Capability subset (category, RF bands, PHY flags)."""
    ue_category: int = 3                   # 1..5
    rohc_profiles: int = 0                 # 9-bit mask (0x0001..0x0104)
    tx_antenna_selection: bool = False
    ue_specific_ref_sigs: bool = False
    bands: tuple[BandCapability, ...] = (BandCapability(1),)
    feature_groups: int | None = 0xFFFFFFFF   # featureGroupIndicators


def pack_ue_eutra_capability(c: UeEutraCapability) -> np.ndarray:
    w = UperWriter()
    w.bit(0)                               # sequence extension
    w.opt(c.feature_groups is not None)    # featureGroupIndicators
    w.opt(False)                           # nonCriticalExtension
    w.enum(0, 8, extensible=True)          # accessStratumRelease: rel8 [U]
    w.cint(c.ue_category, 1, 5)
    # pdcp-Parameters (extensible): 9 supportedROHC-Profiles BOOLEANs,
    # maxNumberROHC-ContextSessions absent
    w.bit(0)
    w.opt(False)
    for i in range(9):
        w.bit((c.rohc_profiles >> i) & 1)
    # phyLayerParameters
    w.bit(1 if c.tx_antenna_selection else 0)
    w.bit(1 if c.ue_specific_ref_sigs else 0)
    # rf-Parameters: supportedBandListEUTRA
    w.length(len(c.bands), 1, 64)
    for b in c.bands:
        w.cint(b.band, 1, 64)
        w.bit(1 if b.half_duplex else 0)
    # measParameters: bandListEUTRA, one InterFreqBandInfo per band
    w.length(len(c.bands), 1, 64)
    for b in c.bands:
        w.opt(False)                       # interRAT-BandList absent
        w.length(1, 1, 64)
        w.bit(1 if b.need_for_gaps else 0)
    if c.feature_groups is not None:
        w.bitstring(c.feature_groups, 32)
    # interRAT-Parameters: all five groups absent [U count]
    for _ in range(5):
        w.opt(False)
    return w.array()


def unpack_ue_eutra_capability(bits: np.ndarray) -> UeEutraCapability:
    r = UperReader(bits)
    r.bit()
    has_fgi, _ = r.opt(), r.opt()
    r.enum(8, extensible=True)
    cat = r.cint(1, 5)
    r.bit()
    if r.opt():
        raise ValueError("maxNumberROHC-ContextSessions not supported")
    rohc = 0
    for i in range(9):
        rohc |= r.bit() << i
    tx_sel = bool(r.bit())
    ue_rs = bool(r.bit())
    bands = []
    for _ in range(r.length(1, 64)):
        band = r.cint(1, 64)
        bands.append(BandCapability(band=band, half_duplex=bool(r.bit())))
    n_meas = r.length(1, 64)
    for i in range(n_meas):
        if r.opt():
            raise ValueError("interRAT-BandList not supported")
        r.length(1, 64)
        gaps = bool(r.bit())
        if i < len(bands):
            bands[i].need_for_gaps = gaps
    fgi = r.bitstring(32) if has_fgi else None
    for _ in range(5):
        r.opt()
    return UeEutraCapability(ue_category=cat, rohc_profiles=rohc,
                             tx_antenna_selection=tx_sel,
                             ue_specific_ref_sigs=ue_rs,
                             bands=tuple(bands), feature_groups=fgi)


@dataclasses.dataclass
class UeCapabilityEnquiry:
    rrc_ti: int = 0
    rat_types: tuple[str, ...] = ("eutra",)


@dataclasses.dataclass
class UeCapabilityInformation:
    rrc_ti: int = 0
    # (rat_type, container bytes) pairs; for "eutra" the container is a
    # packed UE-EUTRA-Capability
    containers: tuple[tuple[str, bytes], ...] = ()


_DL_DCCH_UE_CAP_ENQ = 7
_UL_DCCH_UE_CAP_INFO = 7


def pack_ue_capability_enquiry(m: UeCapabilityEnquiry) -> np.ndarray:
    w = UperWriter()
    w.bit(0)
    w.cint(_DL_DCCH_UE_CAP_ENQ, 0, 15)
    w.cint(m.rrc_ti, 0, 3)
    w.bit(0)                               # criticalExtensions: c1
    w.cint(0, 0, 3)                        # ueCapabilityEnquiry-r8(0)
    w.opt(False)                           # nonCriticalExtension
    w.length(len(m.rat_types), 1, 8)
    for rt in m.rat_types:
        w.enum(RAT_TYPES.index(rt), 8, extensible=True)
    return w.array()


def pack_ue_capability_information(m: UeCapabilityInformation) -> np.ndarray:
    w = UperWriter()
    w.bit(0)
    w.cint(_UL_DCCH_UE_CAP_INFO, 0, 15)
    w.cint(m.rrc_ti, 0, 3)
    w.bit(0)                               # criticalExtensions: c1
    w.cint(0, 0, 7)                        # ueCapabilityInformation-r8(0)
    w.opt(False)
    w.length(len(m.containers), 0, 8)
    for rt, blob in m.containers:
        w.enum(RAT_TYPES.index(rt), 8, extensible=True)
        w.octets(blob)
    return w.array()

def bits_to_bytes(bits: np.ndarray) -> bytes:
    return np.packbits(np.asarray(bits, dtype=np.uint8)).tobytes()


def bytes_to_bits(data: bytes) -> np.ndarray:
    return np.unpackbits(np.frombuffer(data, dtype=np.uint8)).astype(np.int32)
