"""Metrics / observability (SURVEY.md §5).

(reference capability: the debug message stream of
``LTE_fdd_enb_interface::send_debug_msg`` with ``LTE_FDD_ENB_DEBUG_TYPE_*``
/ ``LTE_FDD_ENB_DEBUG_LEVEL_*`` masks on debug TCP port 20001, plus the
ctrl-socket cell reports.  Here: structured counters and gauges + a
JSON-lines event log with the same type/level masking, fan-out to
subscribers (the debug TCP stream in ``apps/ctrl.py::DebugStreamServer``) —
host-side, zero dataplane cost.)

Process-wide singletons: ``METRICS`` (counters/gauges) and ``EVENTS`` (the
event log).  Apps route decoded-cell reports, per-stage counters, and
errors through ``EVENTS.emit(...)``; a file sink is attached with
``EVENTS.open(path)`` and live consumers with ``EVENTS.subscribe(fn)``.

The port's own copy of ``lteax/utils/metrics.py``, less its
``Metrics.rate`` and ``throughput_meter``, which nothing here reads: the
port imports nothing of the JAX package, and ``tests/test_torch_plans.py``
holds the rest of the two equal.
"""

from __future__ import annotations

import json
import sys
import threading
import time
from collections import defaultdict


class Metrics:
    """Process-wide counter/gauge registry."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: dict[str, float] = defaultdict(float)
        self._gauges: dict[str, float] = {}
        self._t0 = time.monotonic()

    def inc(self, name: str, value: float = 1.0) -> None:
        with self._lock:
            self._counters[name] += value

    def gauge(self, name: str, value: float) -> None:
        with self._lock:
            self._gauges[name] = value

    def snapshot(self) -> dict:
        with self._lock:
            return {"counters": dict(self._counters),
                    "gauges": dict(self._gauges),
                    "uptime_s": time.monotonic() - self._t0}

    def dump(self, stream=None) -> None:
        print(json.dumps(self.snapshot()), file=stream or sys.stderr)


METRICS = Metrics()

# debug levels, reference LTE_FDD_ENB_DEBUG_LEVEL_* style (lower = louder
# severity; a sink at level L passes events with level <= L)
LEVELS = {"error": 0, "warn": 1, "info": 2, "debug": 3}


class EventLog:
    """JSON-lines structured event log with type/level masking + fan-out.

    ``emit`` is cheap when nothing is attached (one lock-free check).
    ``types``: None = all event types pass; else a set of type prefixes
    (an event ``scan.cell`` passes a mask containing ``scan``)."""

    def __init__(self, path: str | None = None, level: str = "info",
                 types: set[str] | None = None):
        self._lock = threading.Lock()
        self._f = None
        self._own = False
        self._subs: list = []
        self.level = level
        self.types = types
        if path:
            self.open(path)

    # -- sinks --------------------------------------------------------------
    def open(self, path: str) -> None:
        """Attach (or replace) the file sink.  '-' = stdout."""
        with self._lock:
            if self._own and self._f:
                self._f.close()
            self._f = sys.stdout if path == "-" else open(path, "a")
            self._own = path != "-"

    def subscribe(self, fn) -> None:
        """fn(line: str) called for every passing event (debug stream)."""
        with self._lock:
            self._subs.append(fn)

    def unsubscribe(self, fn) -> None:
        with self._lock:
            if fn in self._subs:
                self._subs.remove(fn)

    # -- masks (ctrl-socket verbs write these) ------------------------------
    def set_level(self, level: str) -> None:
        if level not in LEVELS:
            raise ValueError(f"unknown level {level!r} "
                             f"(use {'/'.join(LEVELS)})")
        self.level = level

    def set_types(self, types: set[str] | None) -> None:
        self.types = set(types) if types else None

    def _passes(self, event: str, level: str) -> bool:
        if LEVELS.get(level, 2) > LEVELS.get(self.level, 2):
            return False
        if self.types is not None:
            return event.split(".", 1)[0] in self.types
        return True

    # -- emit ---------------------------------------------------------------
    def emit(self, event: str, level: str = "info", **fields) -> None:
        if self._f is None and not self._subs:
            return
        if not self._passes(event, level):
            return
        rec = {"ts": time.time(), "event": event, "level": level, **fields}
        line = json.dumps(rec)
        with self._lock:
            if self._f is not None:
                self._f.write(line + "\n")
                self._f.flush()
            subs = list(self._subs)
        for fn in subs:
            try:
                fn(line)
            except Exception:       # a dead subscriber must not kill the app
                self.unsubscribe(fn)

    def close(self) -> None:
        with self._lock:
            if self._own and self._f:
                self._f.close()
            self._f = None


EVENTS = EventLog()


def ctrl_debug_verbs(events: EventLog | None = None) -> dict:
    """Ctrl-socket verbs for debug-stream parity: ``debug_level [lvl]`` and
    ``debug_types [t1,t2|all]`` read/write the event masks (the reference's
    type/level masks on the debug socket)."""
    ev = events or EVENTS

    def _level(args):
        if args:
            ev.set_level(args[0])
        return f"debug_level = {ev.level}"

    def _types(args):
        if args:
            ev.set_types(None if args[0] == "all"
                         else set(args[0].split(",")))
        return "debug_types = " + (",".join(sorted(ev.types))
                                   if ev.types else "all")

    return {"debug_level": _level, "debug_types": _types}
