"""MAC downlink scheduler: SIB windows, RAR, round-robin UE grants
(36.321-shaped; reference capability: ``LTE_fdd_enb_mac.{h,cc}`` —
``handle_ready_to_send`` / ``handle_prach_decode`` and its simple
round-robin-class scheduler with TBS fitting).

The port's own copy of ``lteax.stack.mac_sched``, over the port's
``phy.tables.tbs`` and ``stack.mac_pdu``.
"""

from __future__ import annotations

import dataclasses
from collections import deque

from lteax_torch.phy.tables.tbs import get_tbs_for_mcs, pick_mcs_for_size
from lteax_torch.stack import mac_pdu

# wideband CQI (36.213 Table 7.2.3-1 efficiency classes) -> highest MCS the
# scheduler will pick; the exact mapping is implementation-defined in the
# spec — this one tracks the CQI table's spectral-efficiency ladder
CQI_TO_MCS = {1: 0, 2: 0, 3: 2, 4: 4, 5: 6, 6: 8, 7: 11, 8: 13, 9: 15,
              10: 18, 11: 20, 12: 22, 13: 24, 14: 26, 15: 28}

SI_RNTI = 0xFFFF
RA_RNTI_BASE = 0x0001


@dataclasses.dataclass
class Grant:
    rnti: int
    rb_start: int
    n_prb: int
    mcs: int
    tbs: int
    payload: bytes = b""
    kind: str = "data"        # "sib1" | "si" | "rar" | "data"


@dataclasses.dataclass
class UeCtx:
    rnti: int
    cqi_mcs: int = 9                  # max MCS this UE supports right now
    queue: deque = dataclasses.field(default_factory=deque)

    @property
    def buffered(self) -> int:
        return sum(len(s) for _, s in self.queue)


class DlScheduler:
    """Per-TTI downlink scheduler.

    Reserved resources: subframe 5 carries SI (SIB1 on even SFN, SI window
    on odd) on the first PRBs; RAR goes out within the response window after
    a PRACH detection; the rest is shared round-robin among active UEs.
    """

    def __init__(self, n_rb_dl: int, si_prbs: int = 6):
        self.n_rb = n_rb_dl
        self.si_prbs = min(si_prbs, n_rb_dl)
        self.ues: dict[int, UeCtx] = {}
        self._rr: deque[int] = deque()
        self._pending_rar: deque[tuple[int, int]] = deque()  # (rapid, tc_rnti)
        self._next_tc_rnti = 0x003D

    # -- control inputs ----------------------------------------------------
    def add_ue(self, rnti: int, cqi_mcs: int = 9) -> UeCtx:
        ue = UeCtx(rnti=rnti, cqi_mcs=cqi_mcs)
        self.ues[rnti] = ue
        self._rr.append(rnti)
        return ue

    def enqueue(self, rnti: int, sdu: bytes, lcid: int = 0x03) -> None:
        self.ues[rnti].queue.append((lcid, sdu))

    def update_cqi(self, rnti: int, cqi: int) -> None:
        """Wideband CQI report (1..15) -> per-UE MCS cap (link adaptation)."""
        self.ues[rnti].cqi_mcs = CQI_TO_MCS[max(1, min(15, cqi))]

    def on_prach(self, rapid: int) -> int:
        tc = self._next_tc_rnti
        self._next_tc_rnti += 1
        self._pending_rar.append((rapid, tc))
        return tc

    # -- per-TTI -----------------------------------------------------------
    def schedule(self, sfn: int, subframe: int,
                 sib1: bytes = b"", si: bytes = b"") -> list[Grant]:
        grants: list[Grant] = []
        free_lo = 0
        free_hi = self.n_rb

        if subframe == 5:
            msg = sib1 if sfn % 2 == 0 else si
            if msg:
                mcs, tbs = pick_mcs_for_size(8 * len(msg), self.si_prbs,
                                             max_mcs=9)
                grants.append(Grant(SI_RNTI, 0, self.si_prbs, mcs, tbs, msg,
                                    "sib1" if sfn % 2 == 0 else "si"))
                free_lo = self.si_prbs

        if self._pending_rar and free_hi - free_lo >= 2:
            rapid, tc = self._pending_rar.popleft()
            rar = mac_pdu.pack_rar_pdu([mac_pdu.Rar(
                rapid=rapid, timing_advance=0, ul_grant=0, tc_rnti=tc)])
            mcs, tbs = pick_mcs_for_size(8 * len(rar), 2, max_mcs=9)
            grants.append(Grant(RA_RNTI_BASE + subframe, free_lo, 2, mcs,
                                tbs, rar, "rar"))
            free_lo += 2

        # round-robin data grants over the remaining PRBs
        n_active = sum(1 for u in self.ues.values() if u.buffered)
        if n_active == 0 or free_hi - free_lo <= 0:
            return grants
        share = max(1, (free_hi - free_lo) // n_active)
        tried = 0
        order = list(self._rr)
        while free_hi - free_lo > 0 and tried < len(order):
            rnti = self._rr[0]
            self._rr.rotate(-1)
            tried += 1
            ue = self.ues[rnti]
            if not ue.buffered:
                continue
            n_prb = min(share, free_hi - free_lo)
            # smallest MCS (within CQI) whose TBS carries at least the
            # head-of-line SDU; fall back to the CQI max for big buffers
            need = 8 * (len(ue.queue[0][1]) + 3)
            mcs = None
            for m in range(0, ue.cqi_mcs + 1):
                try:
                    tbs, _ = get_tbs_for_mcs(m, n_prb)
                except ValueError:
                    continue
                mcs = m
                if tbs >= need:
                    break
            if mcs is None:
                continue
            tbs, _ = get_tbs_for_mcs(mcs, n_prb)
            if tbs < need:
                continue              # SDU can't fit even at CQI max
            # fill a MAC PDU with whole SDUs up to TBS
            subs = []
            nbytes = tbs // 8
            used = 0
            while ue.queue and used + len(ue.queue[0][1]) + 3 <= nbytes:
                lcid, sdu = ue.queue.popleft()
                subs.append(mac_pdu.MacSubPdu(lcid, sdu))
                used += len(sdu) + 3
            if not subs:          # SDU bigger than grant: skip this round
                continue
            payload = mac_pdu.pack_mac_pdu(subs, pad_to=nbytes)
            grants.append(Grant(rnti, free_lo, n_prb, mcs, tbs, payload))
            free_lo += n_prb
        return grants
