"""Software eNodeB TTI loop (no RF): full DL user-plane over the port's PHY;
counterpart of ``lteax.apps.enb_sim``.

(reference capability: the DL half of ``LTE_fdd_enb`` — ``LTE_fdd_enb_phy``'s
TTI callback driving MAC scheduling, RLC/PDCP bearers, and resource-grid
construction; UHD radio replaced by an IQ sample sink, UL feedback by a
direct return channel.)

Per TTI: `DlScheduler` grants (SI + round-robin user data), each data grant
carries a MAC PDU of RLC PDUs from the UE's bearers (SRB1 = RLC AM under
PDCP integrity+ciphering; DRB = RLC UM under PDCP ciphering), encoded on
PDSCH with a C-RNTI DCI 1A in the UE-specific search space.  `UeSim`
decodes the same subframe grids blindly (PDCCH blind decode at its C-RNTI)
and pushes payloads back up through RLC/PDCP; RLC AM STATUS PDUs flow back
over the direct return channel.  The UE answers on the UL grid: HARQ
ACK/NACK and SR on PUCCH format 1, the periodic CQI on format 2 / 2a, data
on PUSCH; the eNB answers a PUSCH on the next DL subframe's PHICH.

Where the work runs.  The transmitters build their grids on the host, as
the reference's do: ``EnbSim.tti_grid`` returns the (n_sym, n_sc)
complex64 numpy grid, ``UeSim.ul_tti_grid`` the (14, n_rb * 12) UL grid
(numpy encoders: PBCH, PHICH, PDCCH, PDSCH, PUCCH, PUSCH).  The receivers
run on the sim's ``device``: ``UeSim.handle_grid`` and
``EnbSim.handle_pusch`` each upload their grid once, and everything after
that — the CQI's channel estimate, the PDCCH demap and blind decodes, the
PDSCH decode (the turbo kernel), PUCCH, the DM-RS presence test, the PUSCH
decode — stays on it; each decision comes home through one counted read
(``lteax_torch.host.READS``).  ``device`` defaults to the current CUDA
device; without one the constructors raise unless the caller passes
``device="cpu"``.  ``STAGE_SECONDS`` accumulates host-clock seconds per
stage of a TTI ("dl_grid", "cqi", "pdcch", "pdsch", "phich", "ul_grid",
"pucch", "pusch").
"""

from __future__ import annotations

import dataclasses
from collections import defaultdict
from functools import lru_cache

import numpy as np
import torch

from lteax_torch.apps.file_gen import GenConfig, build_subframe_grid
from lteax_torch.host import read
from lteax_torch.phy import chest
from lteax_torch.phy.channels import pbch, pucch
from lteax_torch.phy.channels import pdcch as pdcch_mod
from lteax_torch.phy.channels import pdsch as pdsch_mod
from lteax_torch.phy.channels import phich as phich_mod
from lteax_torch.phy.channels import pusch as pusch_mod
from lteax_torch.phy.channels.dci import (Dci0, Dci1A, dci_0_pack,
                                          dci_1a_pack, dci_1a_size)
from lteax_torch.phy.channels.pdsch import pdsch_prepare_cbs
from lteax_torch.phy.config import PhyConfig
from lteax_torch.phy.grid import (pdcch_flat_idx, pdsch_flat_idx,
                                  phich_flat_idx)
from lteax_torch.phy.mod import demodulate_maxlog
from lteax_torch.phy.tables.tbs import get_tbs_for_mcs, tbs_1a
from lteax_torch.pipeline import _resolve_device
from lteax_torch.sim import ul_gen
from lteax_torch.stack import mac_pdu, rlc_pdu
from lteax_torch.stack import rrc as rrc_msgs
from lteax_torch.stack.gw import ipv4_icmp_echo_reply
from lteax_torch.stack.mac_sched import DlScheduler
from lteax_torch.stack.pdcp import PdcpEntity
from lteax_torch.stack.rlc_am import AmReceiver, AmTransmitter
from lteax_torch.stack.rlc_um import UmReceiver, UmTransmitter
from lteax_torch.stack.security import generate_as_keys, generate_k_enb
from lteax_torch.utils.trace import timed_stage

# fixed UL grant: PRBs 1..4 carry PUSCH; edge PRBs 0 and 5 are the PUCCH
# region.  Resource m=0 carries format 1 with code multiplexing (HARQ
# ACK/NACK on orthogonal cover 0, SR on cover 1 — 36.211 §5.4.1 style);
# resource m=1 (the complementary slot-hop pattern on the same edge PRBs)
# carries the periodic wideband CQI on format 2.
UL_ALLOC = dict(n_prb=4, rb_start=1, mcs_tbs=1032, qm=4)
PUCCH_M_F1 = 0
PUCCH_OC_ACK = 0
PUCCH_OC_SR = 1
PUCCH_M_CQI = 1
PUCCH_F1_DETECT = 12.0     # despread-metric presence threshold (~96 at |h|=1)
PUCCH_F2_ACK_DETECT = 0.5  # format-2a RS |acc| gate (~2.0 at |h|=1); below
                           # this the ACK slice is noise -> treat as DTX
SRB_LCID = 0x01
DRB_LCID = 0x03
_QM = {"qpsk": 2, "16qam": 4, "64qam": 6}

STAGE_SECONDS: dict[str, float] = defaultdict(float)


def _stage(name: str, device: torch.device):
    """Host seconds of a TTI stage into ``STAGE_SECONDS``, and its
    ``utils.trace.stage`` range in a profiler's trace."""
    return timed_stage(name, device, STAGE_SECONDS)


def cqi_from_snr_db(snr_db: float) -> int:
    """Wideband SNR -> CQI index 1..15.

    Thresholds follow the ~1.9 dB/step spectral-efficiency ladder of
    36.213 Table 7.2.3-1 (CQI 1 usable from about -6.7 dB AWGN)."""
    return int(np.clip(np.floor((snr_db + 6.7) / 1.9) + 1, 1, 15))


def _upload(grid, device: torch.device) -> torch.Tensor:
    """A received grid on ``device`` as complex64: the receiver's one
    host -> device copy."""
    x = grid if torch.is_tensor(grid) else torch.as_tensor(np.asarray(grid))
    return x.to(device=device, dtype=torch.complex64)


def _on(idx: np.ndarray, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(idx).reshape(-1).astype(np.int64),
                           device=device)


@lru_cache(maxsize=64)
def _pdcch_idx(cfg: PhyConfig, cid: int, cfi: int, ng: float,
               device: torch.device) -> torch.Tensor:
    return _on(pdcch_flat_idx(cfg, cid, cfi, ng), device)


@lru_cache(maxsize=1024)
def _pdsch_idx(cfg: PhyConfig, cid: int, cfi: int, prbs: tuple[int, ...],
               sf: int, device: torch.device) -> torch.Tensor:
    return _on(pdsch_flat_idx(cfg, cid, cfi, prbs, sf), device)


@lru_cache(maxsize=64)
def _phich_idx(cfg: PhyConfig, cid: int, ng: float, group: int,
               device: torch.device) -> torch.Tensor:
    return _on(phich_flat_idx(cfg, cid, ng, group), device)


def _requeue(sched: DlScheduler, rnti: int, payload: bytes) -> None:
    """Put a MAC PDU's SRB / DRB SDUs back at the head of the UE's queue,
    in their order."""
    subs = [s for s in mac_pdu.unpack_mac_pdu(payload)
            if s.lcid in (SRB_LCID, DRB_LCID)]
    for s_ in reversed(subs):
        sched.ues[rnti].queue.appendleft((s_.lcid, s_.payload))


@dataclasses.dataclass
class _EnbUe:
    rnti: int
    srb_pdcp: PdcpEntity
    drb_pdcp: PdcpEntity | None
    srb_tx: AmTransmitter
    drb_tx: UmTransmitter
    n_phich_seq: int = 0
    ul_rlc: UmReceiver = dataclasses.field(default_factory=UmReceiver)
    ul_sdus: list = dataclasses.field(default_factory=list)
    srb_rx: AmReceiver = dataclasses.field(default_factory=AmReceiver)
    sec_on: bool = False


class EnbSim:
    """DL TTI loop: bearers -> scheduler -> PDSCH grids (host); UL
    receivers on ``device``."""

    def __init__(self, gc: GenConfig, pcap_path: str | None = None,
                 rrc=None, device=None):
        self.device = _resolve_device(device)
        self.gc = gc
        self.cfg: PhyConfig = gc.phy
        self.sched = DlScheduler(gc.n_rb_dl)
        self.rrc = rrc                         # stack.rrc_proc.EnbRrc | None
        self.ues: dict[int, _EnbUe] = {}
        self._pending_hi: dict[int, int] = {}
        self._last_dl: dict[int, bytes] = {}   # last MAC PDU per rnti
        self._sr_pending: set[int] = set()     # SRs awaiting a DCI-0 grant
        self.pcap = None
        if pcap_path:
            from lteax_torch.io.pcap import MacPcapWriter
            self.pcap = MacPcapWriter(pcap_path)
        self._mib = rrc_msgs.Mib(n_rb_dl=gc.n_rb_dl,
                                 phich_duration_extended=False,
                                 phich_resource=gc.phich_resource, sfn=0)
        self._pbch_quarters = None
        sib1 = rrc_msgs.Sib1(mcc=gc.mcc, mnc=gc.mnc, tac=gc.tac,
                             cell_identity=gc.cell_identity,
                             freq_band_indicator=gc.band,
                             scheduling=(rrc_msgs.SchedulingInfo(8, (3,)),))
        self._sib1_bits = rrc_msgs.pack_sib1(sib1)
        self._sib2_bits = rrc_msgs.pack_sib2(rrc_msgs.Sib2())
        need = max(len(self._sib1_bits), len(self._sib2_bits))
        while tbs_1a(self.gc.sib1_mcs, 2) < need:
            self.gc = dataclasses.replace(self.gc,
                                          sib1_mcs=self.gc.sib1_mcs + 1)

    def add_ue(self, rnti: int, k_enb: bytes, cqi_mcs: int = 9) -> _EnbUe:
        ke, ki, ku = generate_as_keys(k_enb)
        ue = _EnbUe(
            rnti=rnti,
            srb_pdcp=PdcpEntity(srb=True, rb_id=1, direction_tx=1,
                                k_enc=ke, k_int=ki),
            drb_pdcp=PdcpEntity(srb=False, rb_id=3, direction_tx=1,
                                k_enc=ku),
            srb_tx=AmTransmitter(),
            drb_tx=UmTransmitter())
        ue.n_phich_seq = len(self.ues) % 8
        self.ues[rnti] = ue
        self.sched.add_ue(rnti, cqi_mcs=cqi_mcs)
        return ue

    def handle_prach(self, rapid: int) -> int:
        """PRACH detection -> C-RNTI + pre-security UE context (SRB1 runs
        with zero MAC-I until the AS SecurityModeCommand).  Returns the
        allocated TC-RNTI (the RAR PDSCH leg is exercised separately in
        rrc_attach_sim; here the TTI loop carries the RRC exchange)."""
        tc = self.sched.on_prach(rapid)
        ue = _EnbUe(rnti=tc,
                    srb_pdcp=PdcpEntity(srb=True, rb_id=1, direction_tx=1),
                    drb_pdcp=None,
                    srb_tx=AmTransmitter(),
                    drb_tx=UmTransmitter())
        ue.n_phich_seq = len(self.ues) % 8
        self.ues[tc] = ue
        self.sched.add_ue(tc)
        return tc

    def admit_handover_ue(self, rnti: int, cqi_mcs: int = 9) -> _EnbUe:
        """Target-cell side of an inter-eNB handover: create the eNB UE
        context for a C-RNTI whose RRC procedure arrived via X2
        (``EnbRrc.start_handover(target=...)``), keyed from the transferred
        KeNB* (PDCP COUNTs restart per 36.331 §5.3.5.4)."""
        p = self.rrc.proc(rnti)
        assert p is not None and p.k_enb, "no transferred RRC context"
        ue = self.add_ue(rnti, p.k_enb, cqi_mcs=cqi_mcs)
        ue.sec_on = True
        return ue

    def _activate_security(self, rnti: int) -> None:
        """Derive AS keys from the RRC procedure's K_eNB once available;
        SRB1 upgrades in place, the DRB entity is created keyed."""
        ue = self.ues[rnti]
        p = self.rrc.proc(rnti) if self.rrc else None
        if ue.sec_on or p is None or not p.k_enb:
            return
        ke, ki, ku = generate_as_keys(p.k_enb)
        ue.srb_pdcp.set_keys(ke, ki)
        ue.drb_pdcp = PdcpEntity(srb=False, rb_id=3, direction_tx=1,
                                 k_enc=ku)
        ue.sec_on = True

    def _rrc_out(self, rnti: int, msgs) -> None:
        """Queue downlink RRC messages: CCCH raw in MAC, DCCH on SRB1."""
        for chan, raw in msgs:
            if chan == "ccch":
                self.sched.enqueue(rnti, raw, lcid=mac_pdu.LCID_CCCH)
            else:
                self._activate_security(rnti)
                ue = self.ues[rnti]
                ue.srb_tx.submit(ue.srb_pdcp.encode(raw))

    # -- user-plane inputs -------------------------------------------------
    def send_rrc(self, rnti: int, sdu: bytes) -> None:
        ue = self.ues[rnti]
        ue.srb_tx.submit(ue.srb_pdcp.encode(sdu))

    def send_data(self, rnti: int, sdu: bytes) -> None:
        ue = self.ues[rnti]
        self.sched.enqueue(rnti, ue.drb_tx.send(ue.drb_pdcp.encode(sdu)),
                           lcid=DRB_LCID)

    def _apply_harq_ack(self, rnti: int, bit: int) -> None:
        """HARQ-ACK bit 1 = ACK (drop the copy), 0 = NACK (requeue SDUs)."""
        payload = self._last_dl.pop(rnti, None)
        if bit != 1 and payload is not None:
            _requeue(self.sched, rnti, payload)

    def handle_pusch(self, rnti: int, ul_grid, sf: int) -> None:
        """Process one UE UL subframe on the sim's device: PUCCH (ACK/NACK
        + SR, CQI) and, when present, the PUSCH data region -> DRB UL SDUs.

        Accepts either a full-band (14, n_rb*12) grid with the PUCCH
        region at the edge PRBs, or the legacy PUSCH-only subgrid; it is
        uploaded once."""
        dev = self.device
        alloc = pusch_mod.PuschAlloc(**UL_ALLOC)
        g = _upload(ul_grid, dev)
        if g.shape[-1] == self.gc.n_rb_dl * 12:
            n_rb, cid = self.gc.n_rb_dl, self.gc.n_cell_id
            with _stage("pucch", dev):
                # format-1 resource m=0: ACK/NACK and SR are code-multiplexed
                # on different orthogonal covers; despread each and detect
                # by metric (energy can't separate covers sharing the PRB
                # pair)
                res1 = pucch.pucch_extract(g, PUCCH_M_F1, n_rb, device=dev)
                (bit,), met = pucch.pucch_format1_decode(
                    res1, cid, sf, oc_idx=PUCCH_OC_ACK, n_bits=1, device=dev)
                if met > PUCCH_F1_DETECT:      # HARQ ACK/NACK present
                    self._apply_harq_ack(rnti, bit)
                # scheduling request -> UL grant (DCI 0) on the next DL TTI
                _, sr_met = pucch.pucch_format1_decode(
                    res1, cid, sf, oc_idx=PUCCH_OC_SR, n_bits=0, device=dev)
                if sr_met > PUCCH_F1_DETECT:
                    self._sr_pending.add(rnti)
                # periodic wideband CQI -> link adaptation.  When the eNB
                # is awaiting a HARQ ACK in this TTI the UE multiplexes it
                # on format 2a (36.213 §10.1 simultaneous ACK/NACK and CQI);
                # otherwise plain format 2.
                if pucch.pucch_present(g, PUCCH_M_CQI, n_rb, device=dev):
                    res = pucch.pucch_extract(g, PUCCH_M_CQI, n_rb,
                                              device=dev)
                    if rnti in self._last_dl:
                        bits, (ack_bit,), _, ack_met = \
                            pucch.pucch_format2ab_decode(res, cid, sf, rnti,
                                                         a=4, n_ack=1,
                                                         device=dev)
                        # weak RS correlation = the UE missed the DL
                        # assignment and sent plain format 2 (DTX) — don't
                        # let a noise-driven slice ACK away a needed
                        # retransmission
                        if ack_met > PUCCH_F2_ACK_DETECT:
                            self._apply_harq_ack(rnti, ack_bit)
                    else:
                        bits, _ = pucch.pucch_format2_decode(
                            res, cid, sf, rnti, a=4, device=dev)
                    cqi = int(sum(int(b) << i for i, b in enumerate(bits)))
                    if 1 <= cqi <= 15:
                        self.sched.update_cqi(rnti, cqi)
                g = g[:, 12 * alloc.rb_start:
                      12 * (alloc.rb_start + alloc.n_prb)]
                # PUSCH presence: DM-RS symbol energy in the data region
                present = read(torch.mean(g[3].real ** 2 + g[3].imag ** 2)
                               ) >= 0.1
            if not present:
                return
        with _stage("pusch", dev):
            bits, ok, _ = pusch_mod.pusch_decode(g, alloc, rnti, sf,
                                                 self.gc.n_cell_id)
            host = read(torch.cat([ok.reshape(1), bits.to(torch.bool)]))
        ok = bool(host[0])
        # HARQ indicator on the next DL subframe's PHICH (group 0)
        self._pending_hi[self.ues[rnti].n_phich_seq] = 1 if ok else 0
        if not ok:
            return
        payload = np.packbits(np.asarray(host[1:], np.uint8)).tobytes()
        ue = self.ues[rnti]
        for sub in mac_pdu.unpack_mac_pdu(payload):
            if sub.lcid == mac_pdu.LCID_CCCH and self.rrc is not None:
                self._rrc_out(rnti, self.rrc.on_ul_ccch(rnti, sub.payload))
            elif sub.lcid == SRB_LCID and self.rrc is not None:
                ue.srb_rx.handle_pdu(sub.payload)
                for raw in ue.srb_rx.take_delivered():
                    sdu = ue.srb_pdcp.decode(raw)
                    if sdu is not None:
                        self._rrc_out(rnti, self.rrc.on_ul_dcch(rnti, sdu))
                        self._activate_security(rnti)
            elif sub.lcid == DRB_LCID and ue.drb_pdcp is not None:
                ue.ul_rlc.handle_pdu(sub.payload)
                for raw in ue.ul_rlc.take_delivered():
                    sdu = ue.drb_pdcp.decode(raw)
                    if sdu is not None:
                        ue.ul_sdus.append(sdu)

    def handle_status(self, rnti: int, status_raw: bytes) -> None:
        """RLC AM STATUS from the UE (direct return channel)."""
        st = rlc_pdu.unpack_status(status_raw)
        if st is not None:
            self.ues[rnti].srb_tx.handle_status(st)

    def _pump_srb(self) -> None:
        for rnti, ue in self.ues.items():
            while True:
                pdu = ue.srb_tx.pull()
                if pdu is None:
                    break
                self.sched.enqueue(rnti, pdu, lcid=SRB_LCID)

    # -- TTI ---------------------------------------------------------------
    def tti_grid(self, sfn: int, sf: int) -> np.ndarray:
        """One subframe resource grid (n_sym, n_sc) complex64 with SI + user
        data, built on the host."""
        with _stage("dl_grid", torch.device("cpu")):
            return self._tti_grid(sfn, sf)

    def _tti_grid(self, sfn: int, sf: int) -> np.ndarray:
        gc, cfg, cid = self.gc, self.cfg, self.gc.n_cell_id
        self._pump_srb()
        if sfn % 4 == 0 or self._pbch_quarters is None:
            self._mib.sfn = sfn - (sfn % 4)
            self._pbch_quarters = pbch.pbch_encode_40ms(
                rrc_msgs.pack_mib(self._mib), gc.n_ant, cid,
                extended_cp=cfg.extended_cp)
        grid = build_subframe_grid(gc, sfn, sf, self._pbch_quarters,
                                   self._sib1_bits, self._sib2_bits)
        grid = np.asarray(grid).reshape(-1)
        if self._pending_hi:
            grid[phich_flat_idx(cfg, cid, gc.phich_resource, 0)] = \
                phich_mod.phich_group_encode(self._pending_hi, cid, sf)
            self._pending_hi = {}

        if sf in (0, 5, 9):            # PBCH/sync/SI/paging subframes: no data
            return grid.reshape(cfg.n_sym_subframe, cfg.n_sc)
        grants_all = [g for g in self.sched.schedule(sfn, sf)
                      if g.kind == "data"]
        # C-RNTI DCIs go in the UE-specific search space (36.213 §9.1.1):
        # per grant, the first Y_k-hashed candidate whose CCEs are free
        # (L=4 preferred, then any L); grants with no free candidate are
        # deferred (round-robin serves them next TTI)
        n_cces = pdcch_mod.n_cce(cfg, cid, gc.ctrl_syms, gc.phich_resource)
        cce_used = np.zeros(n_cces, dtype=bool)

        def alloc_ue_cand(rnti: int) -> tuple[int, int] | None:
            cands = pdcch_mod.ue_search_candidates(n_cces, rnti, sf)
            for want_l4 in (True, False):
                for start, l_agg in cands:
                    if (l_agg == 4) != want_l4:
                        continue
                    if not cce_used[start:start + l_agg].any():
                        cce_used[start:start + l_agg] = True
                        return start, l_agg
            return None

        grants, deferred = [], []
        placements: list[tuple[int, int]] = []
        for g in grants_all:
            c = alloc_ue_cand(g.rnti)
            if c is None:
                deferred.append(g)
            else:
                grants.append(g)
                placements.append(c)
        for g in deferred:                    # requeue the original SDUs
            _requeue(self.sched, g.rnti, g.payload)
        if not grants and not self._sr_pending:
            return grid.reshape(cfg.n_sym_subframe, cfg.n_sc)
        if self.pcap is not None:
            for g in grants:
                self.pcap.write(g.payload, rnti=g.rnti,
                                subframe=10 * (sfn % 1024) + sf)
        dcis = []
        for g, (cce_start, l_agg) in zip(grants, placements):
            bits = dci_1a_pack(Dci1A(rb_start=g.rb_start, l_crb=g.n_prb,
                                     mcs=g.mcs, rv=0, tpc=1), cfg.n_rb_dl)
            dcis.append((bits, g.rnti, cce_start, l_agg))
            self._last_dl[g.rnti] = g.payload
        # answer pending SRs with UL grants (DCI 0), also UE-specific space
        for rnti in sorted(self._sr_pending):
            c = alloc_ue_cand(rnti)
            if c is None:
                continue
            b0 = dci_0_pack(Dci0(rb_start=UL_ALLOC["rb_start"],
                                 l_crb=UL_ALLOC["n_prb"], mcs=0),
                            cfg.n_rb_dl, dci_1a_size(cfg.n_rb_dl))
            dcis.append((b0, rnti, c[0], c[1]))
            self._sr_pending.discard(rnti)
        pd_syms = pdcch_mod.pdcch_encode(dcis, gc.phy, cid, gc.ctrl_syms,
                                         gc.phich_resource, sf,
                                         n_ant=gc.n_ant)
        pd_idx = pdcch_flat_idx(cfg, cid, gc.ctrl_syms,
                                gc.phich_resource).reshape(-1)
        grid[pd_idx] = pd_syms[0]
        # PDSCH per grant
        for g in grants:
            prbs = tuple(range(g.rb_start, g.rb_start + g.n_prb))
            re_idx = pdsch_flat_idx(cfg, cid, gc.ctrl_syms, prbs, sf)
            _, scheme = get_tbs_for_mcs(g.mcs, g.n_prb, interp=True)
            geom = pdsch_mod.pdsch_geometry(g.tbs, len(re_idx), _QM[scheme],
                                            0)
            tb = np.unpackbits(
                np.frombuffer(g.payload, dtype=np.uint8)).astype(np.int64)
            grid[re_idx] = pdsch_mod.pdsch_encode(tb, geom, g.rnti, sf, cid,
                                                  scheme)
        return grid.reshape(cfg.n_sym_subframe, cfg.n_sc)


class UeSim:
    """Blind DL decode at one C-RNTI on ``device`` + RLC/PDCP receive
    entities; the UL grid built on the host."""

    def __init__(self, gc: GenConfig, rnti: int, k_enb: bytes | None = None,
                 standing_grant: bool = True, cqi_period: int = 0,
                 rrc_ue=None, device=None):
        self.device = _resolve_device(device)
        self.gc, self.cfg, self.rnti = gc, gc.phy, rnti
        # UL control state: standing_grant=False requires an SR -> DCI-0
        # grant handshake before PUSCH; pending_ack carries HARQ feedback
        # for the last DL TB (1 = ACK) onto the next PUCCH
        self.granted = standing_grant
        self.pending_ack: int | None = None
        # periodic wideband CQI: measure every cqi_period data subframes
        # (0 = reporting off), carry it on the next PUCCH (format 2, m=1)
        self.cqi_period = cqi_period
        self.meas_cqi: int | None = None
        self._cqi_ctr = 0
        self._cqi_due = False
        # rrc_ue (stack.rrc_proc.UeRrc): attach mode — SRB1 starts
        # pre-security, keys activate when the RRC procedure derives K_eNB
        self.rrc_ue = rrc_ue
        self.sec_on = False
        if k_enb is not None:
            ke, ki, ku = generate_as_keys(k_enb)
            self.srb_pdcp = PdcpEntity(srb=True, rb_id=1, direction_tx=0,
                                       k_enc=ke, k_int=ki)
            self.drb_pdcp = PdcpEntity(srb=False, rb_id=3, direction_tx=0,
                                       k_enc=ku)
            self.sec_on = True
        else:
            self.srb_pdcp = PdcpEntity(srb=True, rb_id=1, direction_tx=0)
            self.drb_pdcp = None
        self.srb_rx = AmReceiver()
        self.srb_tx = AmTransmitter()          # UL SRB1 (RRC responses)
        self.drb_rx = UmReceiver()
        self.rrc_sdus: list[bytes] = []
        self.data_sdus: list[bytes] = []
        self.ul_tx = UmTransmitter()
        self._ul_queue: list[bytes] = []
        self._ccch_queue: list[bytes] = []
        # answer IPv4 ICMP echo requests arriving on the DRB (the simulated
        # UE's IP stack — lets a real host `ping` the UE through the GW TUN)
        self.auto_icmp = True
        # RRC messages held back by a handover command, to be sent on the
        # target cell (see handover_retune)
        self.ho_pending: list | None = None

    def handover_retune(self, gc_target: GenConfig) -> "UeSim":
        """36.331 §5.3.5.4 UE actions after a mobilityControlInfo: retune
        to the target cell, take the new C-RNTI, re-key SRB/DRB from the
        chained KeNB* (PDCP COUNTs restart), and queue the held-back
        ReconfigurationComplete on the TARGET cell's SRB1.  Returns the
        UE bound to the target cell (same UeRrc state machine, same
        device)."""
        assert self.rrc_ue is not None and self.rrc_ue.ho_target is not None
        assert self.ho_pending is not None, "no held-back HO complete"
        ue = UeSim(gc_target, self.rrc_ue.c_rnti, rrc_ue=self.rrc_ue,
                   standing_grant=self.granted, cqi_period=self.cqi_period,
                   device=self.device)
        ke, ki, ku = generate_as_keys(self.rrc_ue.k_enb)
        ue.srb_pdcp.set_keys(ke, ki)
        ue.drb_pdcp = PdcpEntity(srb=False, rb_id=3, direction_tx=0,
                                 k_enc=ku)
        ue.sec_on = True
        for chan, raw in self.ho_pending:
            assert chan == "dcch"
            ue.srb_tx.submit(ue.srb_pdcp.encode(raw))
        self.ho_pending = None
        return ue

    # -- RRC attach mode -----------------------------------------------------
    def start_attach(self, cause: str = "mo-Signalling") -> None:
        """Queue the RRCConnectionRequest for the next UL TTI."""
        self._ccch_queue.append(self.rrc_ue.connect(cause))

    def _activate_security_ue(self) -> None:
        """Mirror of the eNB side: K_eNB = KDF(K_ASME, NAS UL COUNT) is
        derivable as soon as the NAS security mode completes, so SRB1 rx
        keys are on before the (protected) AS SecurityModeCommand lands."""
        if self.sec_on or self.rrc_ue is None or not self.rrc_ue.k_asme \
                or self.rrc_ue.nas_ul == 0:
            return
        k_enb = self.rrc_ue.k_enb or generate_k_enb(self.rrc_ue.k_asme,
                                                    self.rrc_ue.nas_ul)
        ke, ki, ku = generate_as_keys(k_enb)
        self.srb_pdcp.set_keys(ke, ki)
        self.drb_pdcp = PdcpEntity(srb=False, rb_id=3, direction_tx=0,
                                   k_enc=ku)
        self.sec_on = True

    def _rrc_reply(self, msgs) -> None:
        for chan, raw in msgs:
            if chan == "ccch":
                self._ccch_queue.append(raw)
            else:
                self.srb_tx.submit(self.srb_pdcp.encode(raw))
                # activation point: right AFTER the (unprotected) NAS
                # security-mode-complete goes out, so the protected AS
                # SecurityModeCommand that follows verifies
                self._activate_security_ue()

    def send_ul(self, sdu: bytes) -> None:
        self._ul_queue.append(self.ul_tx.send(self.drb_pdcp.encode(sdu)))

    def ul_tti_grid(self, sf: int) -> np.ndarray | None:
        """Full-band (14, n_rb*12) UL grid for this TTI, built on the host:
        PUSCH in the granted PRBs, HARQ ACK/NACK and SR on PUCCH m=0, the
        CQI on PUCCH m=1.  None when there is nothing to send."""
        with _stage("ul_grid", torch.device("cpu")):
            return self._ul_tti_grid(sf)

    def _ul_tti_grid(self, sf: int) -> np.ndarray | None:
        n_rb, cid = self.gc.n_rb_dl, self.gc.n_cell_id
        alloc = pusch_mod.PuschAlloc(**UL_ALLOC)
        # RRC control (CCCH / SRB1) bypasses the SR handshake: msg3 onward
        # ride the RAR/configured grant in this sim
        ctrl = [(mac_pdu.LCID_CCCH, raw) for raw in self._ccch_queue]
        self._ccch_queue = []
        while True:
            pdu = self.srb_tx.pull()
            if pdu is None:
                break
            ctrl.append((SRB_LCID, pdu))
        want_data = bool(self._ul_queue)
        want_sr = want_data and not self.granted
        want_ack = self.pending_ack is not None
        want_cqi = self._cqi_due and self.meas_cqi is not None
        if not (want_ack or want_sr or want_cqi or ctrl
                or (want_data and self.granted)):
            return None
        full = np.zeros((14, n_rb * 12), np.complex64)
        if want_ack and not want_cqi:
            syms = pucch.pucch_format1_encode((self.pending_ack,), cid, sf,
                                              oc_idx=PUCCH_OC_ACK)
            full = pucch.pucch_map_format1(full, syms, PUCCH_M_F1, n_rb)
            self.pending_ack = None
        if want_cqi:
            bits = np.asarray([(self.meas_cqi >> i) & 1 for i in range(4)])
            if want_ack:
                # ACK/NACK collides with the periodic CQI: multiplex both
                # on format 2a (36.213 §10.1) instead of a separate
                # format-1 transmission
                syms = pucch.pucch_format2ab_encode(
                    bits, (self.pending_ack,), cid, sf, self.rnti)
                self.pending_ack = None
            else:
                syms = pucch.pucch_format2_encode(bits, cid, sf, self.rnti)
            full = pucch.pucch_map_format1(full, syms, PUCCH_M_CQI, n_rb)
            self._cqi_due = False
        if want_sr:
            syms = pucch.pucch_format1_encode((), cid, sf,
                                              oc_idx=PUCCH_OC_SR)
            return pucch.pucch_map_format1(full, syms, PUCCH_M_F1, n_rb)
        if not ctrl and (not want_data or not self.granted):
            return full
        nbytes = alloc.mcs_tbs // 8
        subs = []
        used = 0
        for lcid, pdu in ctrl:
            subs.append(mac_pdu.MacSubPdu(lcid, pdu))
            used += len(pdu) + 3
        while self.granted and self._ul_queue and \
                used + len(self._ul_queue[0]) + 3 <= nbytes:
            pdu = self._ul_queue.pop(0)
            subs.append(mac_pdu.MacSubPdu(DRB_LCID, pdu))
            used += len(pdu) + 3
        if not subs:
            return full if (want_ack or want_sr or want_cqi) else None
        payload = mac_pdu.pack_mac_pdu(subs, pad_to=nbytes)
        tb = np.unpackbits(np.frombuffer(payload, np.uint8)).astype(np.int64)
        grid = ul_gen.pusch_encode_cbs(pdsch_prepare_cbs(tb, alloc.geom),
                                       alloc, self.rnti, sf, cid)
        full[:, 12 * alloc.rb_start:12 * (alloc.rb_start + alloc.n_prb)] = \
            ul_gen.pusch_add_dmrs(grid, alloc, cid, sf)
        return full

    def _measure_cqi(self, g: torch.Tensor, sf: int) -> None:
        """Wideband CQI from the CRS of the grid on the device: mean |H|^2
        over the grid vs the symbol-pair noise-variance estimate (36.213
        §7.2 UE procedure); one read."""
        cid = self.gc.n_cell_id
        h = chest.estimate_channel(g, self.cfg, cid, sf, 0)
        nv = chest.estimate_noise_var(g, self.cfg, cid, sf)
        snr = read(torch.mean(torch.abs(h) ** 2) / nv)
        self.meas_cqi = cqi_from_snr_db(10.0 * np.log10(max(snr, 1e-9)))
        self._cqi_due = True

    def read_phich(self, grid, sf: int, n_seq: int = 0,
                   group: int = 0) -> bool:
        """True if the eNB ACKed on this subframe's PHICH (despread on the
        device, one read)."""
        gc, dev = self.gc, self.device
        with _stage("phich", dev):
            flat = _upload(grid, dev).reshape(-1)
            vals = flat[_phich_idx(self.cfg, gc.n_cell_id, gc.phich_resource,
                                   group, dev)]
            m = read(phich_mod.phich_decode(vals, gc.n_cell_id, sf)[n_seq])
        return m < 0                       # negative metric = HI bit 1 = ACK

    def handle_grid(self, grid, sf: int) -> bytes | None:
        """Decode one subframe grid on the device; returns a STATUS PDU to
        send back (direct return channel) when the AM receiver was
        polled."""
        gc, cfg, cid, dev = self.gc, self.cfg, self.gc.n_cell_id, self.device
        if sf in (0, 5, 9):
            return None
        g = _upload(grid, dev).reshape(cfg.n_sym_subframe, cfg.n_sc)
        if self.cqi_period:
            self._cqi_ctr += 1
            if self._cqi_ctr % self.cqi_period == 0:
                with _stage("cqi", dev):
                    self._measure_cqi(g, sf)
        flat = g.reshape(-1)
        with _stage("pdcch", dev):
            llr = demodulate_maxlog(flat[_pdcch_idx(
                cfg, cid, gc.ctrl_syms, gc.phich_resource, dev)], "qpsk")
            logical = pdcch_mod.pdcch_llrs_to_logical(
                llr, cfg, cid, gc.ctrl_syms, gc.phich_resource, sf)
            n_cce = pdcch_mod.n_cce(cfg, cid, gc.ctrl_syms,
                                    gc.phich_resource)
            # UL grant (DCI 0) answering our SR; C-RNTI monitoring covers
            # both the common and the Y_k-hashed UE-specific search space
            if pdcch_mod.pdcch_blind_decode_0(logical, cfg.n_rb_dl,
                                              self.rnti, n_cce, subframe=sf):
                self.granted = True
            found = pdcch_mod.pdcch_blind_decode_1a(logical, cfg.n_rb_dl,
                                                    self.rnti, n_cce,
                                                    subframe=sf)
        if not found:
            return None
        dci = found[0][0]
        tbs, scheme = get_tbs_for_mcs(dci.mcs, dci.l_crb, interp=True)
        prbs = tuple(range(dci.rb_start, dci.rb_start + dci.l_crb))
        with _stage("pdsch", dev):
            re_idx = _pdsch_idx(cfg, cid, gc.ctrl_syms, prbs, sf, dev)
            geom = pdsch_mod.pdsch_geometry(tbs, re_idx.numel(), _QM[scheme],
                                            0)
            bits, ok, _ = pdsch_mod.pdsch_decode_llrs(
                demodulate_maxlog(flat[re_idx], scheme), geom, self.rnti, sf,
                cid)
        if not ok:
            self.pending_ack = 0           # NACK on the next PUCCH
            return None
        self.pending_ack = 1               # ACK
        payload = np.packbits(np.asarray(bits).astype(np.uint8)).tobytes()
        status = None
        for sub in mac_pdu.unpack_mac_pdu(payload):
            if sub.lcid == mac_pdu.LCID_CCCH and self.rrc_ue is not None:
                self._rrc_reply(self.rrc_ue.on_dl_ccch(sub.payload))
            elif sub.lcid == SRB_LCID:
                self.srb_rx.handle_pdu(sub.payload)
                for pdcp_raw in self.srb_rx.take_delivered():
                    sdu = self.srb_pdcp.decode(pdcp_raw)
                    if sdu is None:
                        continue
                    if self.rrc_ue is not None:
                        # diff the monotonic HO counter, not ho_target: a
                        # second HO command to the SAME (pci, earfcn) must
                        # also hold the ReconfigurationComplete for the
                        # target cell
                        before = self.rrc_ue.ho_count
                        msgs = self.rrc_ue.on_dl_dcch(sdu)
                        if self.rrc_ue.ho_count != before:
                            # handover command: the ReconfigurationComplete
                            # must go out on the TARGET cell's SRB1 after
                            # the retune (handover_retune), not here
                            self.ho_pending = msgs
                        else:
                            self._rrc_reply(msgs)
                    else:
                        self.rrc_sdus.append(sdu)
                status = self.srb_rx.make_status() or status
            elif sub.lcid == DRB_LCID and self.drb_pdcp is not None:
                self.drb_rx.handle_pdu(sub.payload)
                for pdcp_raw in self.drb_rx.take_delivered():
                    sdu = self.drb_pdcp.decode(pdcp_raw)
                    if sdu is not None:
                        self.data_sdus.append(sdu)
                        if self.auto_icmp:
                            # simulated UE IP stack: answer pings arriving
                            # over the DRB (GW TUN path end-to-end)
                            rep = ipv4_icmp_echo_reply(sdu)
                            if rep is not None:
                                self.send_ul(rep)
        return status
