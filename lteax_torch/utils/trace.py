"""Profiling and tracing of the decoder's stages; counterpart of
``lteax.utils.trace`` (``jax.profiler`` and named scopes there,
``torch.profiler`` here).

A stage is a named section of the decode path: ``decode`` (a decoder's
call), ``front`` and ``turbo`` inside it, and their parts (``front.dft``,
``turbo.iter``, ...).  :func:`stage` marks one.  It is on only while a
``torch.profiler`` profiler records or a :func:`recording` is active;
otherwise it costs one check and opens nothing.  When on:

- under a profiler it opens a ``record_function`` range named
  ``lteax.<name>``, which lands in the profiler's trace on the kernels'
  clock (``torch.autograd.profiler.emit_nvtx`` turns such ranges into
  NVTX ranges for Nsight);
- under a recorder it keeps a :class:`Span` in memory: its batch, its
  name, its parent, its host ``perf_counter_ns`` start and end and, when
  the recorder takes ``events``, a CUDA event pair on the current stream.
  A top span (no parent: ``decode`` in a decoder's call) starts a new
  batch, and every span inside it shares that batch's number.

Usage:
    with stage("decode_batch"):       # a range in a profiler's trace
        ...

    with recording(events=True) as rec:
        dec(x)
    spans = rec.spans()               # synchronises once: device ms

    with profile_to("traces/"):       # a Chrome trace (chrome://tracing,
        run()                         # Perfetto) of CPU ops and CUDA kernels
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import os
import time
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile, record_function

_profiling = torch._C._autograd._profiler_enabled
"""Whether a profiler records on this thread: the check ``record_function``
itself makes, without building a range."""
_RECORDER: contextvars.ContextVar = contextvars.ContextVar(
    "lteax_torch.trace.recorder", default=None)


@dataclasses.dataclass
class Span:
    """One stage of one batch: ``parent`` is the index of the enclosing
    span in the recorder's list (None for a top span); ``device_ms`` the
    time between its CUDA events, where the recorder took them."""
    batch: int
    name: str
    parent: int | None
    start_ns: int
    end_ns: int = 0
    device_ms: float | None = None


class Recorder:
    """The spans of the stages run while it is active (:func:`recording`)."""

    def __init__(self, events: bool):
        self.events = events and torch.cuda.is_available()
        self._spans: list[Span] = []
        self._events: list = []
        self._open: list[int] = []
        self._batch = 0

    def _enter(self, name: str) -> None:
        parent = self._open[-1] if self._open else None
        if parent is None:
            self._batch += 1
        pair = None
        if self.events:
            pair = (torch.cuda.Event(enable_timing=True),
                    torch.cuda.Event(enable_timing=True))
            pair[0].record()
        self._open.append(len(self._spans))
        self._events.append(pair)
        self._spans.append(Span(self._batch, name, parent,
                                time.perf_counter_ns()))

    def _exit(self) -> None:
        i = self._open.pop()
        if self._events[i] is not None:
            self._events[i][1].record()
        self._spans[i].end_ns = time.perf_counter_ns()

    def spans(self) -> list[Span]:
        """Every closed span, in the order they opened; the device is
        synchronised once, where events were taken, for their ms."""
        if any(p is not None for p in self._events):
            torch.cuda.synchronize()
        for s, p in zip(self._spans, self._events):
            if p is not None and s.device_ms is None and s.end_ns:
                s.device_ms = p[0].elapsed_time(p[1])
        return [s for s in self._spans if s.end_ns]


@contextlib.contextmanager
def recording(events: bool = False):
    """Keep the spans of the block's stages in a :class:`Recorder`, with
    CUDA events around each where ``events`` (a decode on the card)."""
    rec = Recorder(events)
    token = _RECORDER.set(rec)
    try:
        yield rec
    finally:
        _RECORDER.reset(token)


class stage:
    """A named stage of the program (see the module's note): a
    ``record_function`` range ``lteax.<name>`` while a profiler records, a
    :class:`Span` while a recorder is active, nothing otherwise."""

    __slots__ = ("name", "_range", "_rec")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self._range = self._rec = None
        if _profiling():
            self._range = record_function(f"lteax.{self.name}")
            self._range.__enter__()
        rec = _RECORDER.get()
        if rec is not None:
            rec._enter(self.name)
            self._rec = rec
        return self

    def __exit__(self, *exc):
        if self._rec is not None:
            self._rec._exit()
        if self._range is not None:
            self._range.__exit__(*exc)
        return False


@contextlib.contextmanager
def timed_stage(name: str, device: torch.device, seconds: dict):
    """A :func:`stage` range whose host seconds, ``device`` synchronised
    at its end (so the split is attributable), add to ``seconds[name]``
    (a ``defaultdict(float)``)."""
    t0 = time.perf_counter()
    with stage(name):
        yield
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    seconds[name] += time.perf_counter() - t0


@contextlib.contextmanager
def profile_to(logdir: str):
    """Profile the block (CPU operations and, on the card, CUDA kernels)
    and write a Chrome trace into ``logdir``.  Yields the profiler; its
    ``trace_path`` attribute names the file once the block has ended."""
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    Path(logdir).mkdir(parents=True, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
    prof.trace_path = os.path.join(
        logdir, f"lteax_torch.{os.getpid()}.{time.time_ns()}.trace.json")
    prof.export_chrome_trace(prof.trace_path)
