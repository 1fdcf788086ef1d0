"""Turbo half-iteration kernel: time against windows per block.

    python -m lteax_torch.bench.turbo_variants [--c 3328] [--k 5824]
        [--wpb 4 8 12 16 24] [--reps 10]

Every timing is CUDA events around ``--reps`` back-to-back launches at
(C, K+3), win 128, acq 16, after the result was held equal to
``half_iteration_plain`` bit for bit.  ``turbo_mlm.WINDOWS_PER_BLOCK`` is
what the decoders run.  One JSON object on the last line, with what
``ptxas -v`` said of the kernel (registers, stack, spills).
"""

from __future__ import annotations

import argparse
import json
import subprocess

import numpy as np
import torch

import lteax_torch.kernels.turbo_mlm as tm
from lteax_torch.kernels._build import library


def _time_ms(fn, reps: int) -> float:
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _inputs(c: int, n: int, win: int, dev):
    n_w = -(-n // win)
    rng = np.random.default_rng(1)
    t = lambda x: torch.as_tensor(x.astype(np.float32), device=dev)
    u = t(rng.standard_normal((c, n)) * 8.0)
    v = t(rng.standard_normal((c, n)) * 8.0)
    a0 = t(-np.abs(rng.standard_normal((c, n_w, 8))) * 4.0)
    b0 = t(-np.abs(rng.standard_normal((c, n_w, 8))) * 4.0)
    return (u, v, *tm._pin_boundaries(a0, b0))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--c", type=int, default=3328)
    ap.add_argument("--k", type=int, default=5824)
    ap.add_argument("--wpb", type=int, nargs="+", default=[4, 8, 12, 16, 24],
                    help="windows per block, multiples of 4")
    ap.add_argument("--reps", type=int, default=10)
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("turbo_variants: needs a CUDA device")
    dev = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    win, acq = 128, 16
    args = _inputs(a.c, a.k + 3, win, dev)
    ref = tm.half_iteration_plain(*args, win, acq)
    out = {"card": card, "shape": [a.c, a.k + 3, win, acq],
           "shipped_wpb": tm.WINDOWS_PER_BLOCK, "wpb_ms": {}}
    for wpb in a.wpb:
        got = tm.half_iteration_kernel(*args, win, acq, wpb)
        torch.cuda.synchronize()
        if not all(torch.equal(g, r) for g, r in zip(got, ref)):
            raise AssertionError(f"kernel != plain at {wpb} windows a block")
        out["wpb_ms"][wpb] = _time_ms(
            lambda: tm.half_iteration_kernel(*args, win, acq, wpb), a.reps)
    log = library().ptxas_log.splitlines()
    out["ptxas"] = [ln.strip() for i, ln in enumerate(log) if any(
        "turbo_half" in prev and "Compiling" in prev
        for prev in log[max(0, i - 3):i])]
    print(json.dumps(out))


if __name__ == "__main__":
    main()
