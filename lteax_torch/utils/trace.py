"""Profiling / tracing helpers; counterpart of ``lteax.utils.trace``
(``jax.profiler`` and named scopes there, ``torch.profiler`` and NVTX
here).

Usage:
    with stage("decode_batch"):     # a range in the profiler's trace and,
        ...                         # on the card, an NVTX range

    with profile_to("traces/"):     # a Chrome trace (chrome://tracing,
        run()                       # Perfetto) of CPU ops and CUDA kernels
"""

from __future__ import annotations

import contextlib
import os
import time
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile, record_function


@contextlib.contextmanager
def stage(name: str):
    """A named range: ``torch.profiler.record_function`` (seen when a
    profiler records, near free otherwise) plus an NVTX range when CUDA is
    present (seen by Nsight)."""
    nvtx = torch.cuda.is_available()
    if nvtx:
        torch.cuda.nvtx.range_push(name)
    try:
        with record_function(name):
            yield
    finally:
        if nvtx:
            torch.cuda.nvtx.range_pop()


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


@contextlib.contextmanager
def wall_timer(record: dict, key: str):
    """Accumulate wall-clock into record[key] (blocks on device results only
    if the caller does)."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        record[key] = record.get(key, 0.0) + time.perf_counter() - t0
