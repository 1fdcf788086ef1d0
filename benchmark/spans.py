"""The decode path's own stages and counters, read for the per-layer
metrics of a traced run.

The program marks its stages (``lteax_torch.utils.trace.stage``:
``decode``; ``front`` with ``front.dft``, ``front.chest``, ``front.demap``
and ``front.dematch``; ``turbo`` with ``turbo.layout``, ``turbo.iter``,
``turbo.compact``, ``turbo.earlystop`` and ``turbo.crc``) and counts its
turbo schedule (``TurboStats.full``, ``TurboStats.wait_s``). The first
reader that asks (:func:`measure`) builds the cell's decoder and inputs
again, from the run's configuration, traffic and ``--seed``, decodes two
batches to warm them, and then runs ``trace_batches`` batches of the closed
loop (``window.Loop``) three times, after the window and the harness's
traces:

1. as the window runs them: each batch's ``TurboStats`` counters;
2. under ``trace.recording(events=True)``: each stage's CUDA events,
   summed by name, a batch;
3. under ``torch.profiler`` (host and device): :func:`reduce` of its trace.

The result is kept for the run's other readers and logged to standard
error as one ``{"spans": ...}`` line.  A program without the recorder gives
nothing to read; a decode on the CPU gives the counters alone.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import tempfile
from collections import defaultdict

from benchmark import devtrace

OUTSIDE = "outside"
"""The name of the time and work outside every ``lteax.*`` range: the
loop's own (the copy home, the tally)."""

_MEASURED: dict = {}


def _seed() -> int:
    """The run's ``--seed``, from its command line."""
    ap = argparse.ArgumentParser(add_help=False)
    ap.add_argument("--seed", type=int, required=True)
    return ap.parse_known_args(sys.argv[1:])[0].seed


def _stacks(ranges: list, times: list) -> list[tuple]:
    """The names of the ``ranges`` (nested, sorted by start, outer first)
    that hold each of the increasing ``times``, outermost first; a range
    holds [its start, its end)."""
    out, stack, j = [], [], 0
    end = lambda e: e["ts"] + e["dur"]
    for t in times:
        while j < len(ranges) and ranges[j]["ts"] <= t:
            e = ranges[j]
            j += 1
            while stack and end(stack[-1]) <= e["ts"]:
                stack.pop()
            stack.append(e)
        while stack and end(stack[-1]) <= t:
            stack.pop()
        out.append(tuple(e["name"] for e in stack))
    return out


def reduce(path: str) -> dict:
    """A ``torch.profiler`` Chrome trace of host and device over
    ``benchmark.batch`` ranges -> {"batches", "window_s", "by_span":
    {span: {"kernels", "device_s", "idle_s"}}, "turbo_glue_s"}.

    Each kernel, copy and set is attributed, by its ``correlation``, to the
    runtime call that launched it on the loop's thread, and so to the
    innermost ``lteax.*`` range that held the call (``kernels`` counts the
    kernels, ``device_s`` sums their durations with the copies' and
    sets').  The device is idle in the window (the first batch's start to
    the last one's end) where none runs; each idle interval is split over
    the innermost ``lteax.*`` range the loop's thread was in (``idle_s``).
    ``turbo_glue_s`` is the device time of what was launched inside
    ``lteax.turbo``, the turbo kernel (``turbo_half*``) left out."""
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X"]
    batches = [e for e in events if e.get("cat") == "user_annotation"
               and e["name"] == "benchmark.batch"]
    if not batches:
        return {"batches": 0, "window_s": 0.0, "by_span": {},
                "turbo_glue_s": 0.0}
    tid = batches[0]["tid"]
    w0 = min(e["ts"] for e in batches)
    w1 = max(e["ts"] + e["dur"] for e in batches)
    ranges = sorted((e for e in events if e.get("cat") == "user_annotation"
                     and e["tid"] == tid and e["name"].startswith("lteax.")),
                    key=lambda e: (e["ts"], -e["dur"]))
    calls = sorted((e for e in events
                    if e.get("cat") in ("cuda_runtime", "cuda_driver")
                    and e["tid"] == tid
                    and "correlation" in e.get("args", {})),
                   key=lambda e: e["ts"])
    held = dict(zip((c["args"]["correlation"] for c in calls),
                    _stacks(ranges, [c["ts"] for c in calls])))
    dev = [e for e in events if e.get("cat") in devtrace.DEVICE_CATS
           and e["ts"] < w1 and e["ts"] + e["dur"] > w0]

    by_span = defaultdict(lambda: {"kernels": 0, "device_s": 0.0,
                                   "idle_s": 0.0})
    glue = 0.0
    for e in dev:
        stack = held.get(e.get("args", {}).get("correlation"), ())
        span = by_span[stack[-1] if stack else OUTSIDE]
        span["device_s"] += e["dur"] * 1e-6
        span["kernels"] += e["cat"] == "kernel"
        if "lteax.turbo" in stack and not devtrace.short_name(
                e["name"]).startswith("turbo_half"):
            glue += e["dur"] * 1e-6

    busy = devtrace._merged((max(e["ts"], w0), min(e["ts"] + e["dur"], w1))
                            for e in dev)
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    idle = [(s, e) for s, e in zip(edges[0::2], edges[1::2]) if e > s]
    cuts = sorted({w0, w1} | {t for r in ranges
                              for t in (r["ts"], r["ts"] + r["dur"])
                              if w0 < t < w1})
    pieces = list(zip(cuts, cuts[1:]))
    labels = _stacks(ranges, [(a + b) / 2 for a, b in pieces])
    i = 0
    for (a, b), stack in zip(pieces, labels):
        while i < len(idle) and idle[i][1] <= a:
            i += 1
        k = i
        while k < len(idle) and idle[k][0] < b:
            overlap = min(b, idle[k][1]) - max(a, idle[k][0])
            by_span[stack[-1] if stack else OUTSIDE]["idle_s"] += (
                overlap * 1e-6)
            k += 1
    return {"batches": len(batches), "window_s": (w1 - w0) * 1e-6,
            "by_span": dict(by_span), "turbo_glue_s": glue}


def _passes(run, seed: int) -> dict:
    import torch
    from torch.profiler import ProfilerActivity, profile

    from benchmark import window
    from benchmark.traffic import make_inputs
    from lteax_torch.utils import trace

    device = run.record.kept["llr"].device
    on_card = device.type == "cuda"
    n = run.traffic["trace_batches"]
    dec = run.system.decoder(run.cfg, run.cfg["tuning"], device)
    loop = window.Loop(dec, make_inputs(run.system, run.cfg, run.traffic,
                                        seed, device), device)
    for i in range(2):
        loop.batch(i)
    ms = lambda first: statistics.fmean(
        loop.batch(i)[0] * 1e3 for i in range(first, first + n))

    full, wait_s, lat = [], [], []
    for i in range(2, 2 + n):
        lat.append(loop.batch(i)[0] * 1e3)
        full.append(dec.last_stats.full)
        wait_s.append(dec.last_stats.wait_s)
    out = {"batches": n, "full": full, "wait_s": wait_s,
           "batch_ms": {"plain": statistics.fmean(lat)}}
    if not on_card:
        return out

    with trace.recording(events=True) as rec:
        out["batch_ms"]["recording"] = ms(2 + n)
    stage_ms = defaultdict(float)
    for s in rec.spans():
        stage_ms[s.name] += s.device_ms / n
    out["stage_ms"] = dict(stage_ms)

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        out["batch_ms"]["profiler"] = ms(2 + 2 * n)
    fd, path = tempfile.mkstemp(suffix=".trace.json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        out["trace"] = reduce(path)
    finally:
        os.unlink(path)
    return out


def measure(run) -> dict:
    """The stages and counters of the run's cell (the module's note), once
    a run; {} where the program has no recorder."""
    if id(run) not in _MEASURED:
        from lteax_torch.utils import trace
        out = {}
        if hasattr(trace, "recording"):
            out = _passes(run, _seed())
            print(json.dumps({"spans": out}), file=sys.stderr)
        _MEASURED[id(run)] = out
    return _MEASURED[id(run)]


def stage_ms(run, *names: str) -> float | None:
    """The device ms a batch of the stages ``names``, summed; None where
    none of them ran or no events were taken."""
    got = measure(run).get("stage_ms", {})
    if not any(name in got for name in names):
        return None
    return sum(got.get(name, 0.0) for name in names)


def counter_mean(run, name: str) -> float | None:
    """The mean a batch of a ``TurboStats`` counter; None without it."""
    values = measure(run).get(name)
    return statistics.fmean(values) if values else None
