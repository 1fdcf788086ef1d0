"""Multi-carrier cell scanner: N channels -> per-channel cell reports;
counterpart of ``lteax.apps.scanner`` (single process, one device).

Captures at other rates are polyphase-resampled to the native LTE rate
(the resampler kernel), an optional batched PSS prescan (the correlator
kernel) skips dead channels, and each live channel runs the capture
scanner :func:`lteax_torch.apps.file_scan.scan`: cell search, MIB, SIBs
and paging.

    python -m lteax_torch.apps.scanner LABEL=PATH[:FMT[:RATE_HZ]] ... \\
        [--n-rb 100] [--prescan] [--checkpoint FILE] [--device cuda] \\
        [--multihost N [--port P]]

``--multihost N`` runs the scan as N worker processes joined in one gloo
process group on this host (config #5's shape, the channel axis across
processes): channel ``ci`` belongs to worker ``ci % N``, each worker scans
its channels on its own device (``cuda:{i % device_count}``, or the CPU
when asked) with its own checkpoint ``{checkpoint}.w{i}`` and, with
``--prescan``, its own prescan, and all workers meet in one SUM of the
decoded cells (MIB present).  A worker that dies leaves its peers waiting
at that SUM, so the job is relaunched whole, and the checkpoints make a
relaunch re-scan only the unfinished channels.

``STAGE_SECONDS`` accumulates host-clock seconds per stage ("resample",
"prescan", "scan"); each stage ends with its results on the host or, for
the resampler, with a device synchronise, so the split is attributable.
Each stage is also a named range (``utils.trace.stage``) in a profiler's
trace.
"""

from __future__ import annotations

import argparse
import dataclasses
import datetime
import json
import subprocess
import sys
from collections import defaultdict
from fractions import Fraction

import torch
import torch.distributed as dist

from lteax_torch.io.iq import read_iq
from lteax_torch.phy.config import PhyConfig
from lteax_torch.stack import bands
from lteax_torch.utils.checkpoint import ScanCheckpoint
from lteax_torch.utils.metrics import EVENTS, METRICS
from lteax_torch.utils.trace import timed_stage
from lteax_torch.apps.file_scan import ScanResult, scan
from lteax_torch.kernels import launch_counts
from lteax_torch.kernels.polyphase import resample_poly
from lteax_torch.pipeline import _resolve_device
from lteax_torch.shard.mesh import RANK_TIMEOUT_S, device_type
from lteax_torch.shard.scanner import batched_prescan

STAGE_SECONDS: dict[str, float] = defaultdict(float)


def _stage(name: str, device: torch.device):
    """Host seconds of the stage into ``STAGE_SECONDS``, and its
    ``utils.trace.stage`` range in a profiler's trace."""
    return timed_stage(name, device, STAGE_SECONDS)


@dataclasses.dataclass
class Channel:
    label: str                  # e.g. EARFCN or filename
    path: str
    fmt: str = "fc32"
    rate_hz: float | None = None   # capture rate; None == native


def _native(ch: Channel, cfg: PhyConfig, device) -> torch.Tensor:
    """Read a capture onto the device and resample it to the native rate."""
    dev = torch.device(device)
    x = torch.from_numpy(read_iq(ch.path, ch.fmt)).to(dev)
    METRICS.inc("scanner.samples_in", x.shape[-1])
    if ch.rate_hz is not None and abs(ch.rate_hz - cfg.fs) > 1.0:
        frac = Fraction(int(round(cfg.fs)), int(round(ch.rate_hz))) \
            .limit_denominator(1024)
        with _stage("resample", dev):
            x = resample_poly(x, frac.numerator, frac.denominator)
    return x


def scan_channel(ch: Channel, cfg: PhyConfig, device="cuda") -> ScanResult:
    x = _native(ch, cfg, device)
    with _stage("scan", torch.device(device)):
        return scan(x, cfg)


def prescan_channels(chans: list[Channel], cfg: PhyConfig,
                     device="cuda") -> list[dict]:
    """Batched stage 1: PSS detection for every channel at once, after
    resampling to the native rate and trimming to a common length."""
    caps = [_native(ch, cfg, device) for ch in chans]
    l = min(c.shape[-1] for c in caps)
    with _stage("prescan", torch.device(device)):
        return batched_prescan(torch.stack([c[:l] for c in caps]), cfg)


def scan_channels(chans: list[Channel], cfg: PhyConfig,
                  checkpoint_path: str | None = None,
                  prescan: bool = False, device="cuda") -> list[dict]:
    """Scan every channel; returns JSON-able report dicts.  With
    ``checkpoint_path``, finished channels are persisted and skipped on
    restart."""
    ckpt = ScanCheckpoint(checkpoint_path) if checkpoint_path else None
    pre = prescan_channels(chans, cfg, device) if prescan else None
    reports = []
    for ci, ch in enumerate(chans):
        if ckpt is not None and ckpt.done(ch.label):
            EVENTS.emit("scan.skip", level="debug", channel=ch.label,
                        reason="checkpointed")
            reports.append(ckpt.result(ch.label))
            continue
        if pre is not None and not pre[ci]["detected"]:
            d = {"channel": ch.label, "mib": None, "n_cell_id": -1,
                 "prescan": pre[ci]}
            EVENTS.emit("scan.dead", level="debug", channel=ch.label)
            METRICS.inc("scanner.channels_dead")
            if ckpt is not None:
                ckpt.record(ch.label, d)
            reports.append(d)
            continue
        EVENTS.emit("scan.start", level="debug", channel=ch.label)
        try:
            d = json.loads(scan_channel(ch, cfg, device).to_json())
        except Exception as e:  # pragma: no cover - robustness path
            d = {"error": f"{type(e).__name__}: {e}"}
            EVENTS.emit("scan.error", level="error", channel=ch.label, **d)
            METRICS.inc("scanner.errors")
        d["channel"] = ch.label
        if ch.label.isdigit():
            try:
                d["freq_mhz"] = bands.dl_earfcn_to_freq_mhz(int(ch.label))
                d["band"] = bands.band_of_dl_earfcn(int(ch.label))
            except ValueError:
                pass
        METRICS.inc("scanner.channels_scanned")
        if d.get("n_cell_id", -1) >= 0:
            METRICS.inc("scanner.cells_found")
            EVENTS.emit("scan.cell", channel=ch.label,
                        n_cell_id=d.get("n_cell_id"),
                        sfn=(d.get("mib") or {}).get("sfn"),
                        freq_mhz=d.get("freq_mhz"))
        if ckpt is not None:
            ckpt.record(ch.label, d)
        reports.append(d)
    return reports


def _parse_channels(specs) -> list[Channel]:
    chans = []
    for spec in specs:
        label, rest = spec.split("=", 1)
        parts = rest.split(":")
        chans.append(Channel(
            label=label, path=parts[0],
            fmt=parts[1] if len(parts) > 1 else "fc32",
            rate_hz=float(parts[2]) if len(parts) > 2 else None))
    return chans


def _emit(stream, d: dict) -> None:
    """One JSON line in one write: the workers share their parent's
    output, and a line written in pieces can interleave with a peer's."""
    stream.write(json.dumps(d) + "\n")
    stream.flush()


def _total(n: int) -> int:
    """``n`` summed over the workers' group."""
    t = torch.tensor([n], dtype=torch.int64)
    dist.all_reduce(t)
    return int(t)


def run_multihost_worker(a, chans: list[Channel], cfg: PhyConfig) -> int:
    """Worker ``a.worker_idx`` of an ``a.multihost``-process scan: join the
    gloo group at 127.0.0.1:``a.port``, scan this worker's channels on its
    device, and print its reports and the global count of decoded cells,
    the same JSON lines as the reference's worker; its kernel launch
    counts go to standard error as one JSON line."""
    kind = device_type(a.device)
    dev = (torch.device("cuda", a.worker_idx % torch.cuda.device_count())
           if kind == "cuda" else torch.device("cpu"))
    dist.init_process_group(
        "gloo", init_method=f"tcp://127.0.0.1:{a.port}",
        world_size=a.multihost, rank=a.worker_idx,
        timeout=datetime.timedelta(seconds=RANK_TIMEOUT_S))
    # open the group's connections while the workers are in step: a scan
    # can outlast the connect timeout, and connections persist once made
    _total(0)
    mine = [ch for ci, ch in enumerate(chans)
            if ci % a.multihost == a.worker_idx]
    ckpt = f"{a.checkpoint}.w{a.worker_idx}" if a.checkpoint else None
    reports = scan_channels(mine, cfg, checkpoint_path=ckpt,
                            prescan=a.prescan, device=dev)
    # count DECODED cells (MIB present): raw PSS peaks fire on noise
    total = _total(sum(1 for d in reports if d.get("mib") is not None))
    for d in [*reports, {"multihost_total_cells": total}]:
        _emit(sys.stdout, {**d, "worker": a.worker_idx})
    _emit(sys.stderr, {"worker": a.worker_idx, "launches": launch_counts()})
    dist.destroy_process_group()
    return 0


def run_multihost_coordinator(a, argv: list[str]) -> int:
    """Start the ``a.multihost`` workers, ``python -m
    lteax_torch.apps.scanner ... --worker-idx i``, and wait for them.  A
    worker that fails fails the job: relaunch it, and the checkpoints
    resume it.  On cards the kernel library is built here first, so the
    workers load it instead of each running nvcc."""
    if device_type(a.device) == "cuda":   # no card, no --device cpu: raise
        from lteax_torch.kernels._build import library
        library()
    procs = [subprocess.Popen([sys.executable, "-m", "lteax_torch.apps.scanner",
                               *argv, "--worker-idx", str(i)])
             for i in range(a.multihost)]
    rcs = [p.wait() for p in procs]
    if any(rc != 0 for rc in rcs):
        print(json.dumps({"multihost_error": f"worker rcs {rcs}; relaunch "
                          "to resume from checkpoints"}), flush=True)
        return 1
    return 0


def main(argv=None):
    argv = list(argv) if argv is not None else sys.argv[1:]
    p = argparse.ArgumentParser(
        description="multi-carrier LTE cell scanner over IQ captures "
                    "(cell search, MIB, SIBs, paging)")
    p.add_argument("captures", nargs="+",
                   help="LABEL=PATH[:FMT[:RATE_HZ]] per channel")
    p.add_argument("--n-rb", type=int, default=6)
    p.add_argument("--prescan", action="store_true",
                   help="batched PSS prescan; skip dead channels")
    p.add_argument("--checkpoint", default=None,
                   help="resume file (skip finished channels)")
    p.add_argument("--eventlog", default=None,
                   help="JSON-lines event log path ('-' = stdout)")
    p.add_argument("--debug-level", default="info",
                   choices=("error", "warn", "info", "debug"))
    p.add_argument("--device", default=None,
                   help="torch device to scan on (default: the current CUDA "
                        "device; cuda:1, cpu); with --multihost, cuda "
                        "(a card a worker, in turn) or cpu")
    p.add_argument("--multihost", type=int, default=0, metavar="N",
                   help="scan as N worker processes in one gloo group "
                        "(the channel axis across processes)")
    p.add_argument("--port", type=int, default=36911,
                   help="the multihost group's TCP port on 127.0.0.1")
    p.add_argument("--worker-idx", type=int, default=None,
                   help=argparse.SUPPRESS)   # internal: the worker's index
    a = p.parse_args(argv)
    if a.multihost and a.worker_idx is None:
        raise SystemExit(run_multihost_coordinator(a, argv))
    cfg = PhyConfig(n_rb_dl=a.n_rb)
    if a.multihost:
        raise SystemExit(run_multihost_worker(a, _parse_channels(a.captures),
                                              cfg))
    if a.eventlog:
        EVENTS.open(a.eventlog)
        EVENTS.set_level(a.debug_level)
    for rep in scan_channels(_parse_channels(a.captures), cfg,
                             checkpoint_path=a.checkpoint,
                             prescan=a.prescan,
                             device=_resolve_device(a.device)):
        print(json.dumps(rep))
    if a.eventlog:
        METRICS.dump()


if __name__ == "__main__":
    main()
