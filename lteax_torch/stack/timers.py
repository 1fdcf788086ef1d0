"""Tick-driven one-shot timer manager.
The port's own copy of ``lteax.stack.timers``.

(reference capability: ``LTE_fdd_enb_timer.{h,cc}`` /
``LTE_fdd_enb_timer_mgr.{h,cc}`` — the tick timers RLC/RRC/MME procedures
run on (t-Reordering, t300, t-PollRetransmit, ...).)
"""

from __future__ import annotations

import dataclasses
import heapq
from typing import Callable


@dataclasses.dataclass(order=True)
class _Entry:
    expiry: int
    seq: int
    timer_id: int = dataclasses.field(compare=False)
    cb: Callable = dataclasses.field(compare=False)
    cancelled: bool = dataclasses.field(default=False, compare=False)


class TimerManager:
    """start()/stop() one-shot timers; advance time with tick()."""

    def __init__(self):
        self.now = 0
        self._heap: list[_Entry] = []
        self._by_id: dict[int, _Entry] = {}
        self._next_id = 1
        self._seq = 0

    def start(self, n_ticks: int, callback: Callable) -> int:
        tid = self._next_id
        self._next_id += 1
        self._seq += 1
        e = _Entry(self.now + n_ticks, self._seq, tid, callback)
        heapq.heappush(self._heap, e)
        self._by_id[tid] = e
        return tid

    def stop(self, timer_id: int) -> bool:
        e = self._by_id.pop(timer_id, None)
        if e is None:
            return False
        e.cancelled = True
        return True

    def restart(self, timer_id: int, n_ticks: int) -> int:
        e = self._by_id.get(timer_id)
        cb = e.cb if e else None
        self.stop(timer_id)
        return self.start(n_ticks, cb) if cb else -1

    def running(self, timer_id: int) -> bool:
        return timer_id in self._by_id

    def tick(self, n: int = 1) -> int:
        """Advance time; fires expired callbacks.  Returns #fired."""
        fired = 0
        self.now += n
        while self._heap and self._heap[0].expiry <= self.now:
            e = heapq.heappop(self._heap)
            if e.cancelled:
                continue
            self._by_id.pop(e.timer_id, None)
            e.cb()
            fired += 1
        return fired
