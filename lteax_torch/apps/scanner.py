"""Multi-carrier cell scanner: N channels -> per-channel cell reports;
counterpart of ``lteax.apps.scanner`` (single process, one device).

Captures at other rates are polyphase-resampled to the native LTE rate
(the resampler kernel), an optional batched PSS prescan (the correlator
kernel) skips dead channels, and each live channel runs the capture
scanner :func:`lteax_torch.apps.file_scan.scan` up to the MIB.  The
reference's multi-host worker (``--multihost``) is not ported.

    python -m lteax_torch.apps.scanner LABEL=PATH[:FMT[:RATE_HZ]] ... \\
        [--n-rb 100] [--prescan] [--checkpoint FILE] [--device cuda]

``STAGE_SECONDS`` accumulates host-clock seconds per stage ("resample",
"prescan", "scan"); each stage ends with its results on the host or, for
the resampler, with a device synchronise, so the split is attributable.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time
from collections import defaultdict
from contextlib import contextmanager
from fractions import Fraction

import torch

from lteax.io.iq import read_iq
from lteax.phy.config import PhyConfig
from lteax.stack import bands
from lteax.utils.checkpoint import ScanCheckpoint
from lteax.utils.metrics import EVENTS, METRICS
from lteax_torch.apps.file_scan import ScanResult, scan
from lteax_torch.kernels.polyphase import resample_poly
from lteax_torch.shard.scanner import batched_prescan

STAGE_SECONDS: dict[str, float] = defaultdict(float)


@contextmanager
def _stage(name: str, device: torch.device):
    t0 = time.perf_counter()
    yield
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    STAGE_SECONDS[name] += time.perf_counter() - t0


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
        return scan(x, cfg, max_si_subframes=0)


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


def main(argv=None):
    p = argparse.ArgumentParser(
        description="multi-carrier LTE cell scanner over IQ captures "
                    "(cell search + MIB)")
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
    p.add_argument("--device", default="cuda",
                   help="torch device to scan on (cuda, cuda:1, cpu)")
    a = p.parse_args(argv)
    if a.eventlog:
        EVENTS.open(a.eventlog)
        EVENTS.set_level(a.debug_level)
    cfg = PhyConfig(n_rb_dl=a.n_rb)
    for rep in scan_channels(_parse_channels(a.captures), cfg,
                             checkpoint_path=a.checkpoint,
                             prescan=a.prescan, device=a.device):
        print(json.dumps(rep))
    if a.eventlog:
        METRICS.dump()


if __name__ == "__main__":
    main()
