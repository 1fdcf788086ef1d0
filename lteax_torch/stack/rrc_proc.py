"""RRC connection + NAS attach procedure engines (eNB and UE sides).

(reference capability: ``LTE_fdd_enb_rrc.{h,cc}`` per-UE RRC state machines
— ``handle_ul_ccch`` / ``handle_ul_dcch``, connection setup, security mode,
reconfiguration (DRB setup), release — together with
``LTE_fdd_enb_mme.{h,cc}``'s builtin EPC-lite: attach procedure, Milenage
AKA against the HSS database, NAS security mode, default bearer activation.
The reference connects these through typed msgqs; here each engine is a pure
state machine over message *bytes* so any transport (direct call, enb_sim
TTI loop, PHY loopback) can carry them.)

Message sequence implemented (the standard EPS attach):

  UE                                eNB/MME
  RRCConnectionRequest       -->                       (CCCH)
                             <--    RRCConnectionSetup (CCCH, SRB1)
  RRCConnectionSetupComplete -->    + NAS AttachRequest(+ESM PDN req)
                             <--    DLInfoTransfer: NAS AuthRequest (AKA)
  ULInfoTransfer: AuthResp   -->
                             <--    DLInfoTransfer: NAS SecurityModeCommand
  ULInfoTransfer: NAS SMCmp  -->        (EIA2-protected, new ctx)
                             <--    RRC SecurityModeCommand (AS keys)
  SecurityModeComplete       -->
                             <--    RRCConnectionReconfiguration
                                        (+NAS AttachAccept w/ default bearer,
                                         +DRB-ToAddMod)
  ReconfigurationComplete    -->
  ULInfoTransfer: AttachCmp  -->    (+ESM ActDefaultBearerAccept)

The port's own copy of ``lteax/stack/rrc_proc.py`` (it imports nothing of the
JAX package); ``tests/test_torch_stack.py`` holds the two equal.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np

from lteax_torch.stack import nas, security
from lteax_torch.stack import rrc_dedicated as rd
from lteax_torch.stack.rrc_dedicated import bits_to_bytes, bytes_to_bits
from lteax_torch.stack.users import Hss, UserManager


def _imsi_str(imsi: tuple) -> str:
    return "".join(map(str, imsi))


def short_mac_i(k_rrc_int: bytes, cell_identity: int, pci: int,
                c_rnti: int) -> int:
    """shortMAC-I (36.331 §7.1.1): 16 LSBs of the EIA2 MAC over the
    UPER-encoded VarShortMAC-Input, with COUNT/BEARER/DIRECTION all ones."""
    from lteax_torch.stack.uper import UperWriter
    w = UperWriter()
    w.bitstring(cell_identity, 28)     # cellIdentity of the target cell
    w.cint(pci, 0, 503)                # physCellId of the source cell
    w.bitstring(c_rnti, 16)            # c-RNTI in the source cell
    msg = bits_to_bytes(w.array())
    mac = security.eia2(k_rrc_int, 0xFFFFFFFF, 0x1F, 1, msg)
    return int.from_bytes(mac[2:4], "big")


# ---------------------------------------------------------------------------
# eNB side (RRC + embedded MME-lite)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class _EnbUeProc:
    rnti: int
    state: str = "wait-setup-complete"
    imsi: tuple = ()
    rrc_ti: int = 0
    xres: bytes = b""
    k_asme: bytes = b""
    k_nas_enc: bytes = b""
    k_nas_int: bytes = b""
    k_enb: bytes = b""
    nas_dl: int = 0
    nas_ul: int = 0
    drb: rd.DrbToAddMod | None = None
    ip: tuple = (10, 0, 0, 2)
    ue_caps: "rd.UeEutraCapability | None" = None
    resume_state: str = ""
    resume_k_enb: bytes = b""    # pre-failure KeNB while reestablishing


class EnbRrc:
    """eNB RRC procedure engine + MME-lite over an HSS database.

    ``on_ul_ccch``/``on_ul_dcch`` consume uplink message bytes and return
    the downlink messages to send: (channel, bytes) with channel in
    {"ccch", "dcch"}.
    """

    def __init__(self, hss: Hss, users: UserManager | None = None,
                 mcc=(0, 0, 1), mnc=(0, 1), tac: int = 0x1234,
                 apn: str = "internet", network_name: str = "lteax",
                 pci: int = 214, cell_identity: int = 0x0000010,
                 earfcn: int = 0, seed: int | None = None):
        self.hss = hss
        self.users = users or UserManager()
        self.mcc, self.mnc, self.tac, self.apn = mcc, mnc, tac, apn
        self.network_name = network_name
        self.pci, self.cell_identity = pci, cell_identity
        self.earfcn = earfcn
        self._procs: dict[int, _EnbUeProc] = {}
        self._sqn: dict[str, int] = {}
        self._next_ip = 2
        self._rng = np.random.default_rng(seed)
        self.events: list[str] = []
        # handover neighbour map: target PCI -> target DL EARFCN (a
        # MeasurementReport naming one of these stronger than serving
        # triggers start_handover)
        self.neighbors: dict[int, int] = {}
        # inter-eNB neighbours: target PCI -> EnbRrc (X2 context transfer)
        self.neighbor_enb: dict[int, "EnbRrc"] = {}

    def proc(self, rnti: int) -> _EnbUeProc | None:
        return self._procs.get(rnti)

    # -- CCCH ---------------------------------------------------------------
    def on_ul_ccch(self, rnti: int, raw: bytes) -> list[tuple[str, bytes]]:
        req = rd.unpack_ul_ccch(bytes_to_bits(raw))
        if isinstance(req, rd.RrcConnectionReestablishmentRequest):
            return self._on_reestablishment_request(rnti, req)
        self._procs[rnti] = _EnbUeProc(rnti=rnti)
        self.events.append(f"conn-request cause={req.cause}")
        setup = rd.RrcConnectionSetup(
            rrc_ti=0, rrcd=rd.RadioResourceConfigDedicated(
                srb_to_add=(rd.SrbToAddMod(1),)))
        return [("ccch", bits_to_bytes(rd.pack_dl_ccch(setup)))]

    def _on_reestablishment_request(
            self, rnti: int, req: rd.RrcConnectionReestablishmentRequest
    ) -> list[tuple[str, bytes]]:
        """36.331 §5.3.7: resume SRB1 for a UE the eNB still has AS context
        for, authenticated by shortMAC-I; otherwise reject (the reference's
        ``LTE_fdd_enb_rrc`` rejects unconditionally — context lookup here is
        the capability superset)."""
        old = self._procs.get(req.c_rnti)
        if old is None:
            # retransmitted request: the context was already moved to the
            # new rnti by the first copy — find it there
            cand = self._procs.get(rnti)
            if cand is not None and cand.state == "wait-reestab-complete":
                old = cand
        if old is None or not old.k_enb or req.phys_cell_id != self.pci:
            self.events.append(f"reestab-reject c_rnti={req.c_rnti:#x}")
            rej = rd.RrcConnectionReestablishmentReject()
            return [("ccch", bits_to_bytes(rd.pack_dl_ccch(rej)))]
        # shortMAC-I is computed by the UE with its pre-failure keys; on a
        # retransmitted request (already re-keyed below) validate against
        # the saved pre-failure KeNB, not the refreshed one.
        reestablishing = old.state == "wait-reestab-complete"
        k_src = old.resume_k_enb if reestablishing else old.k_enb
        _, k_rrc_int, _ = security.generate_as_keys(k_src)
        expect = short_mac_i(k_rrc_int, self.cell_identity, self.pci,
                             req.c_rnti)
        if req.short_mac_i != expect:
            self.events.append("reestab-reject bad-short-mac")
            rej = rd.RrcConnectionReestablishmentReject()
            return [("ccch", bits_to_bytes(rd.pack_dl_ccch(rej)))]
        if rnti != old.rnti:
            self._procs[rnti] = old
            del self._procs[old.rnti]
            old.rnti = rnti
        if not reestablishing:
            # a retransmitted request must not clobber the true pre-failure
            # state with "wait-reestab-complete"
            old.resume_state = old.state
            old.resume_k_enb = old.k_enb
        # 36.331 §5.3.7 / 33.401 A.5: horizontal KeNB* refresh (NCC=0);
        # idempotent across retransmissions (always derived from the saved
        # pre-failure key).  PDCP COUNTs restart with the new keys.
        old.k_enb = security.generate_k_enb_star(
            old.resume_k_enb, self.pci, self.earfcn)
        old.state = "wait-reestab-complete"
        self.events.append(f"reestablishment cause={req.cause}")
        re = rd.RrcConnectionReestablishment(
            rrc_ti=0, ncc=0, rrcd=rd.RadioResourceConfigDedicated(
                srb_to_add=(rd.SrbToAddMod(1),)))
        return [("ccch", bits_to_bytes(rd.pack_dl_ccch(re)))]

    # -- DCCH ---------------------------------------------------------------
    def on_ul_dcch(self, rnti: int, raw: bytes) -> list[tuple[str, bytes]]:
        p = self._procs[rnti]
        msg = rd.unpack_ul_dcch(bytes_to_bits(raw))
        if isinstance(msg, rd.RrcConnectionSetupComplete):
            return self._on_setup_complete(p, msg)
        if isinstance(msg, rd.RrcConnectionReestablishmentComplete):
            p.state = p.resume_state or "attach-done"
            p.resume_state, p.resume_k_enb = "", b""
            self.events.append("reestablishment-complete")
            return []
        if isinstance(msg, rd.SecurityModeFailure):
            self.events.append("as-security-failure")
            rel = rd.RrcConnectionRelease(rrc_ti=msg.rrc_ti, cause="other")
            return [("dcch", bits_to_bytes(rd.pack_dl_dcch(rel)))]
        if isinstance(msg, rd.MeasurementReport):
            self.events.append(
                f"meas-report id={msg.meas_id} rsrp={msg.serv_rsrp} "
                f"neigh={[n.phys_cell_id for n in msg.neigh]}")
            # A3-style handover decision: any configured neighbour reported
            # stronger than serving triggers the handover command
            for n in msg.neigh:
                if (n.phys_cell_id in self.neighbors
                        and n.rsrp is not None
                        and n.rsrp > msg.serv_rsrp):
                    return self.start_handover(
                        rnti, n.phys_cell_id,
                        target=self.neighbor_enb.get(n.phys_cell_id))
            return []
        if isinstance(msg, rd.UlInformationTransfer):
            return self._on_nas(p, msg.nas)
        if isinstance(msg, rd.SecurityModeComplete):
            self.events.append("as-security-activated")
            p.state = "wait-ue-caps"
            enq = rd.UeCapabilityEnquiry(rrc_ti=1, rat_types=("eutra",))
            return [("dcch", bits_to_bytes(rd.pack_dl_dcch(enq)))]
        if isinstance(msg, rd.UeCapabilityInformation):
            for rt, blob in msg.containers:
                if rt == "eutra":
                    p.ue_caps = rd.unpack_ue_eutra_capability(
                        rd.bytes_to_bits(blob))
                    self.events.append(
                        f"ue-caps cat={p.ue_caps.ue_category} bands="
                        f"{[b.band for b in p.ue_caps.bands]}")
            return self._send_reconfiguration(p)
        if isinstance(msg, rd.RrcConnectionReconfigurationComplete):
            if p.state == "wait-ho-complete":
                # target-cell ReconfigurationComplete ends the handover
                p.state = p.resume_state or "attach-done"
                p.resume_state = ""
                self.events.append("handover-complete")
                return []
            # RRC connection is up; p.state stays wait-attach-complete
            # until the NAS AttachComplete lands
            u = self.users.find(rnti)
            if u is not None:
                u.state = "connected"
            self.events.append("reconfiguration-complete")
            return []
        raise ValueError(f"unexpected UL-DCCH {type(msg).__name__} "
                         f"in state {p.state}")

    def _on_setup_complete(self, p: _EnbUeProc,
                           msg: rd.RrcConnectionSetupComplete):
        att = nas.unpack_attach_request(msg.nas)
        if att is None:
            raise ValueError("setup complete without NAS attach request")
        p.imsi = att.imsi
        imsi = _imsi_str(att.imsi)
        u = self.users.find(p.rnti)
        if u is None:
            u = self.users.add_user(imsi)
        u.imsi, u.state = imsi, "attaching"
        creds = self.hss.get_user(imsi)
        if creds is None:
            self.events.append(f"attach-reject unknown-imsi {imsi}")
            rel = rd.RrcConnectionRelease(rrc_ti=0, cause="other")
            return [("dcch", bits_to_bytes(rd.pack_dl_dcch(rel)))]
        k, opc = creds
        sqn_i = self._sqn.get(imsi, 1)
        self._sqn[imsi] = sqn_i + 1
        rand = self._rng.bytes(16)
        sqn = sqn_i.to_bytes(6, "big")
        amf = b"\x80\x00"
        xres, ck, ik, ak = security.milenage_f2345(k, rand, op_c=opc)
        mac_a, _ = security.milenage_f1(k, rand, sqn, amf, op_c=opc)
        autn = bytes(a ^ b for a, b in zip(sqn, ak)) + amf + mac_a
        p.xres = xres
        p.k_asme = security.generate_k_asme(
            ck, ik, bytes(a ^ b for a, b in zip(sqn, ak)),
            nas._bcd([*self.mcc, *self.mnc]))
        p.state = "wait-auth-response"
        self.events.append(f"attach-request imsi={imsi}")
        auth = nas.pack_auth_request(nas.AuthRequest(ksi=0, rand=rand,
                                                     autn=autn))
        dl = rd.DlInformationTransfer(rrc_ti=0, nas=auth)
        return [("dcch", bits_to_bytes(rd.pack_dl_dcch(dl)))]

    def _on_nas(self, p: _EnbUeProc, wire: bytes):
        if p.state == "wait-auth-response":
            resp = nas.unpack_auth_response(wire)
            if resp is None or resp.res != p.xres:
                self.events.append("auth-failure")
                rel = rd.RrcConnectionRelease(rrc_ti=0, cause="other")
                return [("dcch", bits_to_bytes(rd.pack_dl_dcch(rel)))]
            p.k_nas_enc, p.k_nas_int = security.generate_nas_keys(p.k_asme)
            p.state = "wait-nas-smc-complete"
            self.events.append("aka-success")
            smc = nas.pack_security_mode_command(
                nas.SecurityModeCommand(2, 2, 0))
            wire_dl = nas.protect(
                smc, p.k_nas_int, count=p.nas_dl, downlink=True,
                k_nas_enc=p.k_nas_enc,
                sec_hdr=nas.SEC_HDR_INTEGRITY_CIPHERED_NEW_CTX)
            p.nas_dl += 1
            dl = rd.DlInformationTransfer(rrc_ti=0, nas=wire_dl)
            return [("dcch", bits_to_bytes(rd.pack_dl_dcch(dl)))]
        if p.state == "wait-nas-smc-complete":
            got = nas.unprotect(wire, p.k_nas_int, p.nas_ul, downlink=False,
                                k_nas_enc=p.k_nas_enc)
            if got is None or not got[1] or \
                    not nas.unpack_security_mode_complete(got[0]):
                raise ValueError("bad NAS security mode complete")
            p.nas_ul += 1
            p.k_enb = security.generate_k_enb(p.k_asme, p.nas_ul)
            p.state = "wait-as-smc-complete"
            self.events.append("nas-security-activated")
            smc = rd.SecurityModeCommand(rrc_ti=1, ciphering="eea2",
                                         integrity="eia2")
            return [("dcch", bits_to_bytes(rd.pack_dl_dcch(smc)))]
        if p.state == "wait-attach-complete":
            got = nas.unprotect(wire, p.k_nas_int, p.nas_ul, downlink=False,
                                k_nas_enc=p.k_nas_enc)
            if got is None or not got[1]:
                raise ValueError("bad protected NAS")
            comp = nas.unpack_attach_complete(got[0])
            if comp is None:
                raise ValueError("expected NAS attach complete")
            p.nas_ul += 1
            acc = nas.unpack_activate_default_bearer_accept(
                comp.esm_container)
            self.events.append(f"attach-complete ebi={acc.ebi}")
            p.state = "attach-done"
            # EMM INFORMATION push (network name), as the reference's MME
            # does after attach
            info = nas.pack_emm_information(
                nas.EmmInformation(network_name=self.network_name))
            wire_dl = nas.protect(info, p.k_nas_int, count=p.nas_dl,
                                  downlink=True, k_nas_enc=p.k_nas_enc,
                                  sec_hdr=nas.SEC_HDR_INTEGRITY_CIPHERED)
            p.nas_dl += 1
            dl = rd.DlInformationTransfer(rrc_ti=0, nas=wire_dl)
            return [("dcch", bits_to_bytes(rd.pack_dl_dcch(dl)))]
        if p.state == "attach-done":
            got = nas.unprotect(wire, p.k_nas_int, p.nas_ul, downlink=False,
                                k_nas_enc=p.k_nas_enc)
            if got is None or not got[1]:
                raise ValueError("bad protected NAS")
            p.nas_ul += 1
            det = nas.unpack_detach_request(got[0])
            if det is not None:
                self.events.append("detach-request")
                acc = nas.protect(nas.pack_detach_accept(), p.k_nas_int,
                                  count=p.nas_dl, downlink=True,
                                  k_nas_enc=p.k_nas_enc,
                                  sec_hdr=nas.SEC_HDR_INTEGRITY_CIPHERED)
                p.nas_dl += 1
                dl = rd.DlInformationTransfer(rrc_ti=0, nas=acc)
                p.state = "detached"
                u = self.users.find(p.rnti)
                if u is not None:
                    u.state = "idle"
                rel = rd.RrcConnectionRelease(rrc_ti=3, cause="other")
                return [("dcch", bits_to_bytes(rd.pack_dl_dcch(dl))),
                        ("dcch", bits_to_bytes(rd.pack_dl_dcch(rel)))]
            raise ValueError("unsupported NAS in attach-done state")
        raise ValueError(f"NAS in unexpected state {p.state}")

    def _send_reconfiguration(self, p: _EnbUeProc):
        bearer = nas.pack_activate_default_bearer_request(
            nas.ActivateDefaultBearerRequest(ebi=5, pti=1, apn=self.apn,
                                             ip=(10, 0, 0, self._next_ip)))
        p.ip = (10, 0, 0, self._next_ip)
        self._next_ip += 1
        accept = nas.pack_attach_accept(nas.AttachAccept(
            attach_result=1, t3412_s=3600, tac=self.tac, mcc=self.mcc,
            mnc=self.mnc, esm_container=bearer))
        wire = nas.protect(accept, p.k_nas_int, count=p.nas_dl,
                           downlink=True, k_nas_enc=p.k_nas_enc,
                           sec_hdr=nas.SEC_HDR_INTEGRITY_CIPHERED)
        p.nas_dl += 1
        p.drb = rd.DrbToAddMod(eps_bearer_identity=5, drb_identity=1, lcid=3)
        u = self.users.find(p.rnti)
        if u is not None:
            u.add_bearer(3, mode="um", lcid=3)
        p.state = "wait-attach-complete"
        rec = rd.RrcConnectionReconfiguration(
            rrc_ti=2, nas_list=(wire,),
            rrcd=rd.RadioResourceConfigDedicated(drb_to_add=(p.drb,)))
        return [("dcch", bits_to_bytes(rd.pack_dl_dcch(rec)))]

    def release(self, rnti: int) -> list[tuple[str, bytes]]:
        self._procs.pop(rnti, None)
        self.users.release(rnti)
        rel = rd.RrcConnectionRelease(rrc_ti=3, cause="other")
        return [("dcch", bits_to_bytes(rd.pack_dl_dcch(rel)))]

    # -- measurements + intra-LTE handover (36.331 §5.5 / §5.3.5.4) ---------
    def configure_measurements(self, rnti: int, a3_offset: int = 6,
                               earfcn: int | None = None
                               ) -> list[tuple[str, bytes]]:
        """Send an A3 (neighbour-better-than-serving) measurement config on
        the serving carrier.  (reference capability: liblte_rrc meas-config
        IEs; the reference eNB never sent them — capability beyond.)"""
        from lteax_torch.stack import rrc_meas as rmx
        assert rnti in self._procs
        mc = rmx.MeasConfig(
            objects=((1, rmx.MeasObjectEutra(
                carrier_freq=self.earfcn if earfcn is None else earfcn)),),
            reports=((1, rmx.ReportConfigEutra(
                event="a3", a3_offset=a3_offset, hysteresis=2,
                time_to_trigger=8)),),
            ids=(rmx.MeasIdToAddMod(1, 1, 1),))
        self.events.append("meas-config")
        rec = rd.RrcConnectionReconfiguration(rrc_ti=0, meas_config=mc)
        return [("dcch", bits_to_bytes(rd.pack_dl_dcch(rec)))]

    def _alloc_rnti(self) -> int:
        r = 0x60
        while r in self._procs:
            r += 1
        return r

    def start_handover(self, rnti: int, target_pci: int,
                       new_rnti: int | None = None,
                       target_earfcn: int | None = None,
                       preamble: int = 5,
                       target: "EnbRrc | None" = None
                       ) -> list[tuple[str, bytes]]:
        """Issue the intra-LTE handover command: a reconfiguration with
        mobilityControlInfo (target PCI/C-RNTI, dedicated RACH preamble)
        and securityConfigHO; the eNB-side context moves to the new C-RNTI
        with KeNB* keying (33.401 A.5, horizontal NCC=0).

        With ``target`` (another EnbRrc — the X2 HandoverRequest/ACK leg),
        the UE context TRANSFERS to the target eNB, which allocates the new
        C-RNTI and will see the ReconfigurationComplete on its own cell;
        without it the move is intra-eNB (same RRC instance)."""
        from lteax_torch.stack import rrc_meas as rmx
        p = self._procs[rnti]
        dest = target if target is not None else self
        if target is not None:
            target_pci = target.pci
            tearf = target.earfcn
        else:
            tearf = self.neighbors.get(
                target_pci, self.earfcn if target_earfcn is None
                else target_earfcn)
            if target_earfcn is not None:
                tearf = target_earfcn
        if new_rnti is None:
            new_rnti = dest._alloc_rnti()
        p.resume_state = p.state
        p.state = "wait-ho-complete"
        p.k_enb = security.generate_k_enb_star(p.k_enb, target_pci, tearf)
        del self._procs[rnti]
        p.rnti = new_rnti
        dest._procs[new_rnti] = p
        if target is not None:
            target.events.append(
                f"ho-admit new_rnti={new_rnti:#x} from_pci={self.pci}")
        mob = rmx.MobilityControlInfo(
            target_pci=target_pci, t304=3, new_ue_identity=new_rnti,
            dl_carrier_freq=tearf, rach_dedicated=(preamble, 0))
        rec = rd.RrcConnectionReconfiguration(
            rrc_ti=1, mobility=mob,
            sec_ho=rmx.SecurityConfigHO(next_hop_chaining_count=0))
        self.events.append(f"handover-command target_pci={target_pci} "
                           f"new_rnti={new_rnti:#x}")
        return [("dcch", bits_to_bytes(rd.pack_dl_dcch(rec)))]


# ---------------------------------------------------------------------------
# UE side
# ---------------------------------------------------------------------------

class UeRrc:
    """UE RRC + NAS attach state machine (the commercial-phone role of the
    reference's over-the-air interop)."""

    def __init__(self, imsi: tuple, k: bytes, opc: bytes,
                 mcc=(0, 0, 1), mnc=(0, 1),
                 capability: rd.UeEutraCapability | None = None):
        self.imsi, self.k, self.opc = imsi, k, opc
        self.mcc, self.mnc = mcc, mnc
        self.capability = capability or rd.UeEutraCapability()
        self.state = "idle"
        self.k_asme = b""
        self.k_nas_enc = self.k_nas_int = b""
        self.k_enb = b""
        self.nas_ul = self.nas_dl = 0
        self.drb: rd.DrbToAddMod | None = None
        self.ip: tuple | None = None
        self.network_name: str | None = None
        self.events: list[str] = []
        self.c_rnti: int | None = None     # set by handover commands
        self.meas_config = None            # rrc_meas.MeasConfig when set
        self.ho_target: tuple | None = None    # (pci, earfcn) from HO cmd
        self.ho_rach: tuple | None = None      # dedicated (preamble, mask)
        self.ho_count: int = 0                 # handover commands received
        # (monotonic: callers diff it around on_dl_dcch to detect an HO
        # command explicitly — ho_target alone can't distinguish a second
        # handover to the SAME (pci, earfcn))

    def detach(self) -> list[tuple[str, bytes]]:
        """UE-initiated detach (24.301 §5.5.2.2)."""
        det = nas.pack_detach_request(nas.DetachRequest())
        wire = nas.protect(det, self.k_nas_int, count=self.nas_ul,
                           downlink=False, k_nas_enc=self.k_nas_enc,
                           sec_hdr=nas.SEC_HDR_INTEGRITY_CIPHERED)
        self.nas_ul += 1
        self.state = "detaching"
        ul = rd.UlInformationTransfer(nas=wire)
        return [("dcch", bits_to_bytes(rd.pack_ul_dcch(ul)))]

    def connect(self, cause: str = "mo-Signalling") -> bytes:
        self.state = "wait-setup"
        req = rd.RrcConnectionRequest(
            cause=cause,
            identity=("random", int.from_bytes(os.urandom(5), "big")))
        return bits_to_bytes(rd.pack_ul_ccch(req))

    def reestablish(self, c_rnti: int, pci: int = 214,
                    cell_identity: int = 0x0000010,
                    cause: str = "otherFailure", earfcn: int = 0) -> bytes:
        """Reestablishment request after e.g. radio link failure
        (36.331 §5.3.7); requires activated AS security (k_enb)."""
        assert self.k_enb, "AS security not activated"
        _, k_rrc_int, _ = security.generate_as_keys(self.k_enb)
        req = rd.RrcConnectionReestablishmentRequest(
            c_rnti=c_rnti, phys_cell_id=pci,
            short_mac_i=short_mac_i(k_rrc_int, cell_identity, pci, c_rnti),
            cause=cause)
        self.state = "wait-reestablishment"
        self._reestab_target = (pci, earfcn)
        return bits_to_bytes(rd.pack_ul_ccch(req))

    def measurement_report(self, meas_id: int, serv_rsrp: int,
                           serv_rsrq: int,
                           neigh: tuple[rd.MeasResultEutra, ...] = ()
                           ) -> list[tuple[str, bytes]]:
        rep = rd.MeasurementReport(meas_id=meas_id, serv_rsrp=serv_rsrp,
                                   serv_rsrq=serv_rsrq, neigh=neigh)
        return [("dcch", bits_to_bytes(rd.pack_ul_dcch(rep)))]

    def on_dl_ccch(self, raw: bytes) -> list[tuple[str, bytes]]:
        setup = rd.unpack_dl_ccch(bytes_to_bits(raw))
        if isinstance(setup, rd.RrcConnectionReestablishment):
            assert self.state == "wait-reestablishment", self.state
            self.state = "connected"
            # mirror the eNB's horizontal KeNB* refresh (33.401 A.5)
            pci, earfcn = self._reestab_target
            self.k_enb = security.generate_k_enb_star(self.k_enb, pci,
                                                      earfcn)
            self.events.append(f"reestablished ncc={setup.ncc}")
            done = rd.RrcConnectionReestablishmentComplete(
                rrc_ti=setup.rrc_ti)
            return [("dcch", bits_to_bytes(rd.pack_ul_dcch(done)))]
        if isinstance(setup, rd.RrcConnectionReestablishmentReject):
            self.state = "idle"
            self.events.append("reestablishment-rejected")
            return []
        if isinstance(setup, rd.RrcConnectionReject):
            self.state = "idle"
            self.events.append(f"rejected wait={setup.wait_time}s")
            return []
        assert self.state == "wait-setup", self.state
        self.state = "wait-auth"
        self.events.append(
            f"setup srb={[s.srb_identity for s in setup.rrcd.srb_to_add]}")
        esm = nas.pack_pdn_connectivity_request(nas.PdnConnectivityRequest())
        att = nas.pack_attach_request(nas.AttachRequest(
            imsi=self.imsi, esm_container=esm))
        comp = rd.RrcConnectionSetupComplete(rrc_ti=setup.rrc_ti,
                                             selected_plmn=1, nas=att)
        return [("dcch", bits_to_bytes(rd.pack_ul_dcch(comp)))]

    def on_dl_dcch(self, raw: bytes) -> list[tuple[str, bytes]]:
        msg = rd.unpack_dl_dcch(bytes_to_bits(raw))
        if isinstance(msg, rd.DlInformationTransfer):
            return self._on_nas(msg.nas)
        if isinstance(msg, rd.SecurityModeCommand):
            assert self.state == "wait-as-smc", self.state
            self.k_enb = security.generate_k_enb(self.k_asme, self.nas_ul)
            self.state = "wait-reconfiguration"
            self.events.append(f"as-smc {msg.ciphering}/{msg.integrity}")
            done = rd.SecurityModeComplete(rrc_ti=msg.rrc_ti)
            return [("dcch", bits_to_bytes(rd.pack_ul_dcch(done)))]
        if isinstance(msg, rd.UeCapabilityEnquiry):
            blob = rd.bits_to_bytes(
                rd.pack_ue_eutra_capability(self.capability))
            containers = tuple(
                (rt, blob if rt == "eutra" else b"")
                for rt in msg.rat_types)
            self.events.append(f"caps-enquiry {list(msg.rat_types)}")
            info = rd.UeCapabilityInformation(rrc_ti=msg.rrc_ti,
                                              containers=containers)
            return [("dcch", bits_to_bytes(rd.pack_ul_dcch(info)))]
        if isinstance(msg, rd.RrcConnectionReconfiguration):
            return self._on_reconfiguration(msg)
        if isinstance(msg, rd.RrcConnectionRelease):
            self.state = "idle"
            self.events.append(f"released cause={msg.cause}")
            return []
        raise ValueError(f"unexpected DL-DCCH {type(msg).__name__}")

    def _on_nas(self, wire: bytes) -> list[tuple[str, bytes]]:
        if self.state == "wait-auth":
            ar = nas.unpack_auth_request(wire)
            if ar is None:
                raise ValueError("expected NAS auth request")
            res, ck, ik, ak = security.milenage_f2345(self.k, ar.rand,
                                                      op_c=self.opc)
            sqn = bytes(a ^ b for a, b in zip(ar.autn[:6], ak))
            mac_u, _ = security.milenage_f1(self.k, ar.rand, sqn,
                                            ar.autn[6:8], op_c=self.opc)
            if mac_u != ar.autn[8:16]:
                raise ValueError("AUTN MAC verification failed")
            self.k_asme = security.generate_k_asme(
                ck, ik, bytes(a ^ b for a, b in zip(sqn, ak)),
                nas._bcd([*self.mcc, *self.mnc]))
            self.state = "wait-nas-smc"
            self.events.append("aka-ok")
            resp = nas.pack_auth_response(nas.AuthResponse(res=res))
            ul = rd.UlInformationTransfer(nas=resp)
            return [("dcch", bits_to_bytes(rd.pack_ul_dcch(ul)))]
        if self.state == "wait-nas-smc":
            self.k_nas_enc, self.k_nas_int = security.generate_nas_keys(
                self.k_asme)
            got = nas.unprotect(wire, self.k_nas_int, self.nas_dl,
                                downlink=True, k_nas_enc=self.k_nas_enc)
            if got is None or not got[1] or \
                    nas.unpack_security_mode_command(got[0]) is None:
                raise ValueError("bad NAS security mode command")
            self.nas_dl += 1
            self.state = "wait-as-smc"
            self.events.append("nas-smc-ok")
            done = nas.protect(nas.pack_security_mode_complete(),
                               self.k_nas_int, count=self.nas_ul,
                               downlink=False, k_nas_enc=self.k_nas_enc,
                               sec_hdr=nas.SEC_HDR_INTEGRITY_CIPHERED)
            self.nas_ul += 1
            ul = rd.UlInformationTransfer(nas=done)
            return [("dcch", bits_to_bytes(rd.pack_ul_dcch(ul)))]
        if self.state in ("connected", "detaching"):
            got = nas.unprotect(wire, self.k_nas_int, self.nas_dl,
                                downlink=True, k_nas_enc=self.k_nas_enc)
            if got is None or not got[1]:
                raise ValueError("bad protected NAS")
            self.nas_dl += 1
            info = nas.unpack_emm_information(got[0])
            if info is not None:
                self.network_name = info.network_name
                self.events.append(f"emm-info name={info.network_name}")
                return []
            if got[0][1] == nas.MT_DETACH_ACCEPT:
                self.events.append("detach-accept")
                return []
            raise ValueError(f"unsupported NAS type 0x{got[0][1]:02X}")
        raise ValueError(f"NAS in unexpected state {self.state}")

    def _apply_reconfig_extras(self, msg: rd.RrcConnectionReconfiguration
                               ) -> None:
        """Apply the non-procedure-defining parts a reconfiguration may also
        carry (measConfig, radioResourceConfigDedicated, piggybacked NAS) —
        real HO commands routinely combine these (36.331 §5.3.5.4)."""
        if msg.meas_config is not None:
            self.meas_config = msg.meas_config
            self.events.append("meas-configured")
        if msg.rrcd is not None and msg.rrcd.drb_to_add:
            self.drb = msg.rrcd.drb_to_add[0]
        for wire in msg.nas_list:
            got = nas.unprotect(wire, self.k_nas_int, self.nas_dl,
                                downlink=True, k_nas_enc=self.k_nas_enc)
            if got is None or not got[1]:
                raise ValueError("bad protected NAS in reconfiguration")
            self.nas_dl += 1
            info = nas.unpack_emm_information(got[0])
            if info is not None:
                self.network_name = info.network_name
                self.events.append(f"emm-info name={info.network_name}")
            else:
                self.events.append(f"nas-in-reconfig type=0x{got[0][1]:02X}")

    def _on_reconfiguration(self, msg: rd.RrcConnectionReconfiguration
                            ) -> list[tuple[str, bytes]]:
        if msg.mobility is not None:
            # intra-LTE handover (36.331 §5.3.5.4): sync to the target cell,
            # take the new C-RNTI, refresh KeNB per securityConfigHO
            mob = msg.mobility
            ncc = msg.sec_ho.next_hop_chaining_count if msg.sec_ho else 0
            earf = (mob.dl_carrier_freq if mob.dl_carrier_freq is not None
                    else 0)
            self.k_enb = security.generate_k_enb_star(
                self.k_enb, mob.target_pci, earf)
            self.c_rnti = mob.new_ue_identity
            self.ho_target = (mob.target_pci, earf)
            self.ho_rach = mob.rach_dedicated      # dedicated preamble
            self.ho_count += 1
            self.events.append(
                f"handover target_pci={mob.target_pci} ncc={ncc} "
                f"preamble={mob.rach_dedicated}")
            self._apply_reconfig_extras(msg)       # rrcd/meas/NAS ride along
            done = rd.RrcConnectionReconfigurationComplete(
                rrc_ti=msg.rrc_ti)
            return [("dcch", bits_to_bytes(rd.pack_ul_dcch(done)))]
        if self.state == "connected":
            # reconfiguration while connected (measConfig and/or rrcd/NAS)
            self._apply_reconfig_extras(msg)
            done = rd.RrcConnectionReconfigurationComplete(
                rrc_ti=msg.rrc_ti)
            return [("dcch", bits_to_bytes(rd.pack_ul_dcch(done)))]
        assert self.state == "wait-reconfiguration", self.state
        out: list[tuple[str, bytes]] = []
        attach_esm = None
        for wire in msg.nas_list:
            got = nas.unprotect(wire, self.k_nas_int, self.nas_dl,
                                downlink=True, k_nas_enc=self.k_nas_enc)
            if got is None or not got[1]:
                raise ValueError("bad protected NAS in reconfiguration")
            self.nas_dl += 1
            acc = nas.unpack_attach_accept(got[0])
            if acc is not None:
                b = nas.unpack_activate_default_bearer_request(
                    acc.esm_container)
                self.ip = b.ip
                attach_esm = b
                self.events.append(f"attach-accept apn={b.apn} "
                                   f"ip={'.'.join(map(str, b.ip))}")
        if msg.rrcd is not None and msg.rrcd.drb_to_add:
            self.drb = msg.rrcd.drb_to_add[0]
        self.state = "connected"
        done = rd.RrcConnectionReconfigurationComplete(rrc_ti=msg.rrc_ti)
        out.append(("dcch", bits_to_bytes(rd.pack_ul_dcch(done))))
        if attach_esm is not None:
            esm_acc = nas.pack_activate_default_bearer_accept(
                nas.ActivateDefaultBearerAccept(ebi=attach_esm.ebi))
            comp = nas.pack_attach_complete(
                nas.AttachComplete(esm_container=esm_acc))
            wire = nas.protect(comp, self.k_nas_int, count=self.nas_ul,
                               downlink=False, k_nas_enc=self.k_nas_enc,
                               sec_hdr=nas.SEC_HDR_INTEGRITY_CIPHERED)
            self.nas_ul += 1
            ul = rd.UlInformationTransfer(nas=wire)
            out.append(("dcch", bits_to_bytes(rd.pack_ul_dcch(ul))))
        return out
