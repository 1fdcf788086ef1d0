"""The measured window: a closed loop of batches through the decoder's
``__call__``, each batch timed on the host's clock from the call until its
bits and CRC flags are in host memory; spans from the benchmark's own
code around the calls into the decoder's two layers, the front and the
turbo tail; and, for a traced run, the profiler's traces of a few more
batches of the same loop."""

from __future__ import annotations

import dataclasses
import os
import tempfile
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from benchmark import devtrace


class Probe:
    """Spans around the calls into the front (``dec.front``) and the tail
    (``dec.turbo``), which ``dec.__call__`` makes: a profiler range each
    and, with ``events``, CUDA events on both sides; the front's output of
    call number ``keep`` is kept for the check.  Installed on the decoder
    object itself, so ``__call__`` stays the program's own."""

    def __init__(self, dec, keep: int | None, events: bool):
        self.dec, self.keep, self.events = dec, keep, events
        self.calls, self.kept = 0, None
        self.spans = {"front": [], "turbo": []}
        self._inner = {"front": dec.front, "turbo": dec.turbo}
        self._own = {k: k in vars(dec) for k in self._inner}
        dec.front, dec.turbo = self.front, self.turbo

    def _span(self, name: str, x):
        if self.events:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
        with record_function(f"benchmark.{name}"):
            out = self._inner[name](x)
        if self.events:
            end.record()
            self.spans[name].append((start, end))
        return out

    def front(self, x):
        out = self._span("front", x)
        if self.calls == self.keep:
            self.kept = out
        self.calls += 1
        return out

    def turbo(self, llr):
        return self._span("turbo", llr)

    def span_ms(self, name: str) -> list[float]:
        """Each call's span in ms (the device synchronised first)."""
        torch.cuda.synchronize()
        return [s.elapsed_time(e) for s, e in self.spans[name]]

    def remove(self) -> None:
        """Put back what the decoder object held before."""
        for name, inner in self._inner.items():
            if self._own[name]:
                setattr(self.dec, name, inner)
            else:
                delattr(self.dec, name)


@dataclasses.dataclass
class Record:
    """What a window measured."""
    latencies: list            # s, each batch
    wall_s: float              # window start to the last batch's end
    attempted: int             # transport blocks
    good: int                  # of them CRC-passed and equal to the sent
    crc_false_pass: int        # CRC-passed, yet not equal to the sent
    syncs: list                # host syncs, each batch (TurboStats)
    iters: list                # turbo iterations, each batch
    front_ms: list
    turbo_ms: list
    kept: dict                 # the checked batch's outputs


def summary(rec: Record) -> dict:
    """The window's batches, its blocks and those whose CRC failed, its
    latency quantiles (ms), and the mean latency of each of its seconds,
    for the run's log."""
    lat = np.asarray(rec.latencies) * 1e3
    second = (np.cumsum(lat) / 1e3).astype(int)
    per_s = [round(float(lat[second == t].mean()), 4)
             for t in np.unique(second)]
    return {"batches": len(lat), "wall_s": rec.wall_s,
            "blocks": rec.attempted,
            "crc_failed": rec.attempted - rec.good - rec.crc_false_pass,
            "p5_ms": float(np.percentile(lat, 5)),
            "median_ms": float(np.median(lat)),
            "mean_ms": float(lat.mean()), "mean_ms_by_second": per_s}


class Loop:
    """The closed loop over a cell's batches, with its host buffers."""

    def __init__(self, dec, inputs, device: torch.device):
        self.dec, self.inputs, self.device = dec, inputs, device
        b, tbs = inputs.sent.shape
        pin = device.type == "cuda"
        buf = lambda *s, dt: torch.empty(s, dtype=dt, pin_memory=pin)
        self.host = [(buf(b, tbs, dt=torch.int8), buf(b, dt=torch.bool))
                     for _ in range(2)]
        self.tally = torch.zeros(2, dtype=torch.int64, device=device)

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()

    def batch(self, i: int, keep: bool = False) -> tuple[float, float]:
        """Batch number ``i`` -> (latency s, host clock at its end); with
        ``keep`` its outputs go to the kept buffers."""
        x = self.inputs.batches[i % len(self.inputs.batches)]
        host_bits, host_ok = self.host[int(keep)]
        t0 = time.perf_counter()
        with record_function("benchmark.batch"):
            bits, ok, _ = self.dec(x)
            host_bits.copy_(bits, non_blocking=True)
            host_ok.copy_(ok, non_blocking=True)
            self.sync()
        t1 = time.perf_counter()
        eq = torch.all(bits == self.inputs.sent, dim=1)
        self.tally += torch.stack([(ok & eq).sum(), (ok & ~eq).sum()])
        return t1 - t0, t1

    def window(self, seconds: float, keep: int, spans: bool) -> Record:
        """Batches back to back until ``seconds`` have passed; the outputs
        of batch number ``keep`` are kept."""
        self.tally.zero_()
        probe = Probe(self.dec, keep, spans and self.device.type == "cuda")
        lat, syncs, iters = [], [], []
        start = time.perf_counter()
        try:
            while True:
                dt, end = self.batch(len(lat), keep=len(lat) == keep)
                lat.append(dt)
                stats = self.dec.last_stats
                syncs.append(stats.syncs)
                iters.append(stats.n_iter)
                if end - start >= seconds and len(lat) > keep:
                    break
            front_ms = probe.span_ms("front") if probe.events else []
            turbo_ms = probe.span_ms("turbo") if probe.events else []
        finally:
            probe.remove()
        good, false_pass = (int(v) for v in self.tally.tolist())
        bits, ok = self.host[1]
        return Record(lat, end - start, len(lat) * len(self.inputs.sent),
                      good, false_pass, syncs, iters, front_ms, turbo_ms,
                      {"batch": keep, "llr": probe.kept,
                       "bits": bits.numpy(), "ok": ok.numpy()})

    def traced(self, n_batches: int, first: int, host: bool) -> dict:
        """The profiler's summary (``devtrace.summarize``) of ``n_batches``
        more batches of the loop, from batch number ``first``: the
        device's activity alone, or with ``host`` the host's operations
        too (which slow the host, so only the idle gaps' names are read
        from such a trace)."""
        acts = [ProfilerActivity.CUDA] if self.device.type == "cuda" else []
        if host or not acts:
            acts.append(ProfilerActivity.CPU)
        probe = Probe(self.dec, None, False)
        try:
            with profile(activities=acts) as prof:
                for i in range(first, first + n_batches):
                    self.batch(i)
        finally:
            probe.remove()
        fd, path = tempfile.mkstemp(suffix=".trace.json")
        os.close(fd)
        try:
            prof.export_chrome_trace(path)
            return devtrace.summarize(path)
        finally:
            os.unlink(path)
