"""Where a DL decode's time goes on the card: device time by kernel and the
device's busy share of the wall.

    python -m lteax_torch.bench.decode_profile [--batch 256] [--reps 10]

Decodes ``--batch`` subframes of the headline configuration (20 MHz, MCS 28,
25 dB, seed 0) ``--reps`` times under ``torch.profiler`` (CPU and CUDA
activities) after a warm-up, and prints the wall per decode (host clock
around synchronised calls, profiler on), the sum of device kernel time per
decode, their ratio (the device's busy share) and the kernels by device
time.  One JSON object on the last line.  The profiler slows the host side,
so the wall here is above ``chip_smoke.py``'s; the device times are the
kernels' own.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time

import torch
from torch.profiler import ProfilerActivity, profile

from lteax_torch.pipeline import make_batch_decoder
from lteax_torch.sim.dl_gen import DlCell, dl_subframes


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--top", type=int, default=12)
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("decode_profile: needs a CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    cell = DlCell()
    iq, _ = dl_subframes(cell, a.batch, 25.0, seed=0)
    dec = make_batch_decoder(*cell.decoder_args())
    x = torch.from_numpy(iq).cuda()
    for _ in range(3):
        _, ok, _ = dec(x)
    if not bool(ok.all()):
        raise AssertionError("decode_profile: a transport block failed")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(a.reps):
            dec(x)
            torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / a.reps
    # device-side events only: an operator's entry repeats its kernels' time
    rows = [(e.key, e.self_device_time_total / 1e3 / a.reps, e.count / a.reps)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.self_device_time_total > 0]
    rows.sort(key=lambda r: -r[1])
    device_ms = sum(r[1] for r in rows)
    if device_ms <= 0:
        raise AssertionError("decode_profile: the profiler saw no device time")
    for name, ms, cnt in rows[:a.top]:
        print(f"{ms:8.4f} ms  {100 * ms / device_ms:5.1f}%  x{cnt:6.1f}  "
              f"{name[:90]}")
    print(json.dumps({
        "card": card, "batch": a.batch, "reps": a.reps, "wall_ms": wall_ms,
        "device_ms": device_ms, "device_busy_share": device_ms / wall_ms,
        "launches_per_decode": sum(r[2] for r in rows),
        "top": [{"name": n[:60], "ms": ms, "per_decode": c}
                for n, ms, c in rows[:a.top]]}))


if __name__ == "__main__":
    main()
