"""RLC UM entity: unacknowledged mode with reordering (36.322 §5.1.2).

(reference capability: the UM arm of ``LTE_fdd_enb_rlc.{h,cc}`` —
``handle_um_pdu`` reordering-window receive and UM transmit SN assignment.)

Single-segment PDUs (one SDU per PDU) over the ``rlc_pdu`` UMD codec, same
modeling choice as `lteax_torch.stack.rlc_am`.  The receive side implements the
spec's reordering window state: VR(UR) (earliest still-awaited SN),
VR(UH) (highest received + 1), VR(UX) (SN following the PDU that started
t-Reordering), with the window size 2^(snLen-1).  Timers are tick-driven
(caller advances time, e.g. from `stack.timers.TimerManager`).

The port's own copy of ``lteax/stack/rlc_um.py`` (it imports nothing of the
JAX package); ``tests/test_torch_stack.py`` holds the two equal.
"""

from __future__ import annotations

from lteax_torch.stack import rlc_pdu


class UmTransmitter:
    def __init__(self, sn_bits: int = 10):
        self.sn_bits = sn_bits
        self.vt_us = 0                       # next SN to assign

    def send(self, sdu: bytes) -> bytes:
        pdu = rlc_pdu.pack_umd(rlc_pdu.UmdPdu(sn=self.vt_us, data=sdu,
                                              sn_bits=self.sn_bits))
        self.vt_us = (self.vt_us + 1) % (1 << self.sn_bits)
        return pdu


class UmReceiver:
    def __init__(self, sn_bits: int = 10, t_reordering_ticks: int = 35):
        self.sn_bits = sn_bits
        self.mod = 1 << sn_bits
        self.window = 1 << (sn_bits - 1)
        self.t_reordering = t_reordering_ticks
        self.vr_ur = 0                       # earliest SN still awaited
        self.vr_uh = 0                       # highest received SN + 1
        self.vr_ux: int | None = None        # reordering target (timer armed)
        self._timer = 0
        self._buffer: dict[int, bytes] = {}
        self._delivered: list[bytes] = []

    def _lt(self, a: int, b: int) -> bool:
        """a < b relative to the lower window edge VR(UH) - window."""
        base = (self.vr_uh - self.window) % self.mod
        return ((a - base) % self.mod) < ((b - base) % self.mod)

    def _deliver_through(self, edge: int) -> None:
        while self.vr_ur != edge:
            if self.vr_ur in self._buffer:
                self._delivered.append(self._buffer.pop(self.vr_ur))
            self.vr_ur = (self.vr_ur + 1) % self.mod

    def handle_pdu(self, raw: bytes) -> None:
        pdu = rlc_pdu.unpack_umd(raw, sn_bits=self.sn_bits)
        sn = pdu.sn
        # discard: outside the reordering window below VR(UR), or duplicate
        if self._lt(sn, self.vr_ur) or sn in self._buffer:
            return
        self._buffer[sn] = pdu.data
        # window advance: if sn is outside [VR(UH)-window, VR(UH)), pull
        # VR(UH) up and drop SNs that fell below the new lower edge
        if not self._lt(sn, self.vr_uh):
            self.vr_uh = (sn + 1) % self.mod
            lower = (self.vr_uh - self.window) % self.mod
            if self._lt(self.vr_ur, lower):
                self._deliver_through(lower)
        # in-order delivery from VR(UR)
        while self.vr_ur in self._buffer:
            self._delivered.append(self._buffer.pop(self.vr_ur))
            self.vr_ur = (self.vr_ur + 1) % self.mod
        # t-Reordering management (§5.1.2.2.3)
        if self.vr_ux is not None and (
                self.vr_ux == self.vr_ur or
                (self._lt(self.vr_ux, self.vr_ur))):
            self.vr_ux = None
        if self.vr_ux is None and self.vr_uh != self.vr_ur:
            self.vr_ux = self.vr_uh
            self._timer = 0

    def tick(self, n: int = 1) -> None:
        """Advance time; on t-Reordering expiry skip the gap: deliver all
        buffered SNs up to VR(UX) and move VR(UR) there."""
        if self.vr_ux is None:
            return
        self._timer += n
        if self._timer < self.t_reordering:
            return
        self._deliver_through(self.vr_ux)
        # VR(UR) := first not-yet-received SN >= VR(UX): keep draining
        # consecutive buffered SNs past the skipped gap
        while self.vr_ur in self._buffer:
            self._delivered.append(self._buffer.pop(self.vr_ur))
            self.vr_ur = (self.vr_ur + 1) % self.mod
        self.vr_ux = None
        self._timer = 0
        if self.vr_uh != self.vr_ur:
            self.vr_ux = self.vr_uh
            self._timer = 0

    def take_delivered(self) -> list[bytes]:
        out, self._delivered = self._delivered, []
        return out
