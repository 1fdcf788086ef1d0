"""Timing and reporting shared by the decode benches and ``chip_smoke.py``:
the card's name and power limit, and decode times on the host's clock
around synchronised calls (a decode syncs on device flags itself, so the
host clock is what a caller waits)."""

from __future__ import annotations

import subprocess
import time

import numpy as np
import torch


def card_line() -> str:
    """``nvidia-smi``'s name and power limit of the first card."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def time_decode(dec, x: torch.Tensor, reps: int) -> tuple[float, float]:
    """(median, p90) seconds of ``dec(x)`` over ``reps`` synchronised
    calls."""
    times = []
    for _ in range(reps):
        _sync(x.device)
        t0 = time.perf_counter()
        dec(x)
        _sync(x.device)
        times.append(time.perf_counter() - t0)
    return float(np.median(times)), float(np.percentile(times, 90))


def bench_decode(dec, x: torch.Tensor, rows: np.ndarray, reps: int) -> dict:
    """One warm-up decode, checked against the sent transport blocks
    ``rows`` (n_tb, TBS), then ``reps`` timed ones.  -> {"crc_ok",
    "bits_equal" (of the blocks that pass their CRC), "n_iter",
    "median_ms", "p90_ms", "mbit_per_s", "unit", "card"}: the rate counts
    the bits of the blocks that pass their CRC; a run on the CPU is a dry
    run and says so in its unit and card."""
    bits, ok, n_iter = dec(x)
    ok = ok.cpu().numpy()
    crc_ok = int(ok.sum())
    bits_equal = bool(np.array_equal(bits.cpu().numpy()[ok], rows[ok]))
    t_med, t_p90 = time_decode(dec, x, reps)
    on_card = x.device.type == "cuda"
    return {"crc_ok": crc_ok, "bits_equal": bits_equal, "n_iter": n_iter,
            "median_ms": t_med * 1e3, "p90_ms": t_p90 * 1e3,
            "mbit_per_s": crc_ok * rows.shape[1] / t_med / 1e6,
            "unit": "Mbit/s/GPU" if on_card else "Mbit/s/CPU (dry run)",
            "card": card_line() if on_card else "cpu"}
