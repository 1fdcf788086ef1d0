"""RLC AM entity: ARQ state machines over the AMD/STATUS codecs (36.322 §5).

(reference capability: ``LTE_fdd_enb_rlc.{h,cc}`` — TM/UM/AM state machines
with segmentation/reassembly, AM ARQ with status PDUs and t-Reordering.
Here: the AM transmit/receive entities with retransmission on NACK,
in-order delivery, status generation on poll, and window handling.
Single-segment PDUs (one SDU per PDU), matching the codec module.)

The port's own copy of ``lteax/stack/rlc_am.py`` (it imports nothing of the
JAX package); ``tests/test_torch_stack.py`` holds the two equal.
"""

from __future__ import annotations

import dataclasses
from collections import deque

from lteax_torch.stack import rlc_pdu

SN_MOD = 1024
WINDOW = 512


def _sn_lt(a: int, b: int, base: int) -> bool:
    """a < b in modular order relative to window base."""
    return ((a - base) % SN_MOD) < ((b - base) % SN_MOD)


@dataclasses.dataclass
class AmTxState:
    vt_a: int = 0          # lowest unacked SN
    vt_s: int = 0          # next SN to use
    poll_every: int = 4    # poll bit cadence


class AmTransmitter:
    def __init__(self, poll_every: int = 4):
        self.st = AmTxState(poll_every=poll_every)
        self._pending: deque[bytes] = deque()      # SDUs not yet sent
        self._sent: dict[int, bytes] = {}          # SN -> SDU (unacked)
        self._retx: deque[int] = deque()
        self._n_since_poll = 0

    def submit(self, sdu: bytes) -> None:
        self._pending.append(sdu)

    def window_full(self) -> bool:
        return ((self.st.vt_s - self.st.vt_a) % SN_MOD) >= WINDOW

    def pull(self) -> bytes | None:
        """Next AMD PDU to transmit (retransmissions first), or None."""
        if self._retx:
            sn = self._retx.popleft()
            if sn in self._sent:
                return rlc_pdu.pack_amd(rlc_pdu.AmdPdu(
                    sn=sn, data=self._sent[sn], poll=True, resegment=False))
            return self.pull()
        if not self._pending or self.window_full():
            return None
        sn = self.st.vt_s
        sdu = self._pending.popleft()
        self._sent[sn] = sdu
        self.st.vt_s = (sn + 1) % SN_MOD
        self._n_since_poll += 1
        poll = self._n_since_poll >= self.st.poll_every or not self._pending
        if poll:
            self._n_since_poll = 0
        return rlc_pdu.pack_amd(rlc_pdu.AmdPdu(sn=sn, data=sdu, poll=poll))

    def handle_status(self, status: rlc_pdu.StatusPdu) -> None:
        """ACK everything < ack_sn except the NACKed SNs (queued for retx)."""
        nacked = set(status.nack_sns)
        for sn in list(self._sent):
            if _sn_lt(sn, status.ack_sn, self.st.vt_a) and sn not in nacked:
                del self._sent[sn]
        for sn in status.nack_sns:
            if sn in self._sent and sn not in self._retx:
                self._retx.append(sn)
        # advance vt_a to the lowest still-unacked SN
        while self.st.vt_a != self.st.vt_s and self.st.vt_a not in self._sent:
            self.st.vt_a = (self.st.vt_a + 1) % SN_MOD

    def poll_retransmit(self) -> None:
        """t-PollRetransmit expiry (36.322 §5.2.2.3): when un-acked data
        remains and nothing is in flight, retransmit the lowest un-acked PDU
        with the poll bit set so the receiver emits a STATUS."""
        if self._sent and not self._retx and not self._pending:
            lowest = min(self._sent, key=lambda s: (s - self.st.vt_a) % SN_MOD)
            self._retx.append(lowest)

    @property
    def all_acked(self) -> bool:
        return not self._sent and not self._pending


class AmReceiver:
    def __init__(self):
        self.vr_r = 0                       # next expected in-order SN
        self._buffer: dict[int, bytes] = {}
        self._delivered: list[bytes] = []
        self._poll_seen = False

    def handle_pdu(self, raw: bytes) -> None:
        pdu = rlc_pdu.unpack_amd(raw)
        if pdu is None:
            return
        fresh = ((pdu.sn - self.vr_r) % SN_MOD) < WINDOW
        if fresh and pdu.sn not in self._buffer:
            self._buffer[pdu.sn] = pdu.data
        if pdu.poll:
            self._poll_seen = True
        while self.vr_r in self._buffer:
            self._delivered.append(self._buffer.pop(self.vr_r))
            self.vr_r = (self.vr_r + 1) % SN_MOD

    def take_delivered(self) -> list[bytes]:
        out, self._delivered = self._delivered, []
        return out

    def make_status(self) -> bytes | None:
        """STATUS PDU when a poll was seen: ACK_SN = highest contiguous+1
        ... per 36.322, ACK_SN = VR(MS)-class upper edge; NACK all gaps."""
        if not self._poll_seen:
            return None
        self._poll_seen = False
        if self._buffer:
            top = max(self._buffer, key=lambda s: (s - self.vr_r) % SN_MOD)
            ack = (top + 1) % SN_MOD
            nacks = tuple(sn for sn in
                          ((self.vr_r + i) % SN_MOD
                           for i in range((top - self.vr_r) % SN_MOD))
                          if sn not in self._buffer)
        else:
            ack = self.vr_r
            nacks = ()
        return rlc_pdu.pack_status(rlc_pdu.StatusPdu(ack_sn=ack,
                                                     nack_sns=nacks))
