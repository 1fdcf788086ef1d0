"""Reduction of a ``torch.profiler`` Chrome trace of the loop to what the
per-layer readers and the result's ``breakdown`` need.

The traced window runs from the first ``benchmark.batch`` range's start to
the last one's end, on the trace's own clock; in a trace of the device's
activity alone, which holds no host ranges, from its first operation's
start to its last one's end.  The device is busy where a
kernel, copy or set runs (their union, clipped to the window); the rest of
the window is idle, and each idle gap is named by what the host was doing
at its midpoint: the benchmark's span (front, turbo, or the batch's copy
out) and the innermost operation of the thread that runs the loop.
"""

from __future__ import annotations

import json
from collections import defaultdict

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
TOP = 10


def short_name(name: str) -> str:
    """A kernel's name without its return type, namespace and argument
    list: ``demap_kernel<3, __nv_bfloat16, __nv_bfloat16>``."""
    if name.endswith(")"):
        depth = 0
        for i in range(len(name) - 1, -1, -1):
            depth += {")": 1, "(": -1}.get(name[i], 0)
            if depth == 0:
                name = name[:i]
                break
    name = name.removeprefix("void ")
    return name.replace("(anonymous namespace)::", "")


def _merged(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def summarize(path: str) -> dict:
    """-> {"window_s", "busy_s", "kernels": [(name, grid, seconds)],
    "device_ops": [[name, s]], "idle_gaps": [[name, s]]}, each list of the
    breakdown the ``TOP`` largest; the window is empty (0 s) when the
    trace holds no batch."""
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X"]
    batches = [e for e in events if e.get("cat") == "user_annotation"
               and e["name"] == "benchmark.batch"]
    dev = [e for e in events if e.get("cat") in DEVICE_CATS]
    spans = batches or dev
    if not spans:
        return {"window_s": 0.0, "busy_s": 0.0, "kernels": [],
                "device_ops": [], "idle_gaps": []}
    w0 = min(e["ts"] for e in spans)
    w1 = max(e["ts"] + e["dur"] for e in spans)
    dev = [e for e in dev if e["ts"] < w1 and e["ts"] + e["dur"] > w0]
    busy = _merged((max(e["ts"], w0), min(e["ts"] + e["dur"], w1))
                   for e in dev)
    by_name = defaultdict(float)
    for e in dev:
        name = e["name"]
        by_name[short_name(name) if e["cat"] == "kernel" else name] += (
            e["dur"] * 1e-6)

    tid = batches[0]["tid"] if batches else None
    host = sorted((e for e in events if e.get("cat") in HOST_CATS
                   and e["tid"] == tid), key=lambda e: e["ts"])
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    idle = [(s, e) for s, e in zip(edges[0::2], edges[1::2]) if e > s]
    gaps = defaultdict(float)
    for (s, e), doing in zip(idle, _doing(host, [(s + e) / 2
                                                 for s, e in idle])):
        gaps[doing] += (e - s) * 1e-6
    top = lambda d: sorted(([k, v] for k, v in d.items()),
                           key=lambda kv: -kv[1])[:TOP]
    return {"window_s": (w1 - w0) * 1e-6,
            "busy_s": sum(e - s for s, e in busy) * 1e-6,
            "kernels": [(short_name(e["name"]),
                         tuple(e.get("args", {}).get("grid", ())),
                         e["dur"] * 1e-6)
                        for e in dev if e.get("cat") == "kernel"],
            "device_ops": top(by_name), "idle_gaps": top(gaps)}


def _doing(host: list, times: list) -> list[str]:
    """What the loop's thread was doing at each of the increasing
    ``times``: its benchmark span and its innermost operation ("python"
    where none runs), by a sweep over its nested ranges."""
    out, stack, j = [], [], 0
    for t in times:
        while j < len(host) and host[j]["ts"] <= t:
            e = host[j]
            j += 1
            while stack and stack[-1]["ts"] + stack[-1]["dur"] < e["ts"]:
                stack.pop()
            stack.append(e)
        while stack and stack[-1]["ts"] + stack[-1]["dur"] < t:
            stack.pop()
        spans = [e["name"] for e in stack if e["name"].startswith(
            "benchmark.") and e["name"] != "benchmark.batch"]
        inner = [e["name"] for e in stack
                 if not e["name"].startswith("benchmark.")]
        span = spans[-1][len("benchmark."):] if spans else "copy out"
        out.append(f"{span}: {inner[-1] if inner else 'python'}")
    return out
