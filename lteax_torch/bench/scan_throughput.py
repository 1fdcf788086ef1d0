"""PSS band-scan sweep rate: complex Msps of raw 20 MHz capture that one
GPU sweeps for PSS (3 roots); counterpart of ``bench/scan_throughput.py``.

Every carrier goes through the fused detect kernel (correlate and reduce
per tile on chip, ``lteax_torch.kernels.pss.pss_detect``) and
``pss_reduce_combine``, as the reference's fused path does.  The signal is
the reference's: complex noise of amplitude 0.1 plus one root-1 PSS
subframe per carrier at sample 3000 + 977*c.

    python -m lteax_torch.bench.scan_throughput [--carriers 16] [--len-sf 20]
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from lteax_torch.phy.config import PhyConfig
from lteax_torch.kernels.pss import pss_detect, pss_reduce_combine
from lteax_torch.phy import seq
from lteax_torch.phy.ofdm import subframe_to_samples
from lteax_torch.phy.sync import pss_time_filters


def sweep_signal(cfg: PhyConfig, carriers: int, length: int,
                 seed: int = 0) -> tuple[np.ndarray, np.ndarray]:
    """-> ((carriers, length) complex64 captures, (carriers,) expected PSS
    start index)."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((carriers, length))
         + 1j * rng.standard_normal((carriers, length))).astype(np.complex64)
    x *= 0.1
    grid = np.zeros((cfg.n_sym_subframe, cfg.n_sc), np.complex64)
    k0 = cfg.n_sc // 2 - 31
    grid[6, k0:k0 + 62] = seq.pss_sequence(1)
    sf = subframe_to_samples(torch.from_numpy(grid), cfg).numpy()
    offs = 3000 + 977 * np.arange(carriers)
    for c, off in enumerate(offs):
        x[c, off:off + len(sf)] += sf
    return x, offs + cfg.symbol_starts_subframe[6]


def detect(x: torch.Tensor, cfg: PhyConfig, mdtype: str = "bf16"):
    """(carriers, L) complex64 -> (n_id_2, idx, peak/mean) per carrier."""
    nid2, idx, peak, mean = pss_reduce_combine(
        *pss_detect(x, pss_time_filters(cfg), mdtype))
    return nid2, idx, peak / torch.clamp_min(mean, 1e-20)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--carriers", type=int, default=16)
    ap.add_argument("--len-sf", type=int, default=20,
                    help="capture length per carrier, subframes")
    ap.add_argument("--reps", type=int, default=8)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    dev = torch.device(a.device)
    cfg = PhyConfig(n_rb_dl=100)
    length = a.len_sf * cfg.n_samps_subframe
    x_np, want = sweep_signal(cfg, a.carriers, length)
    x = torch.from_numpy(x_np).to(dev)
    sync = (lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda" \
        else (lambda: None)
    t0 = time.perf_counter()
    nid2, idx, _ = detect(x, cfg)
    nid2_h, idx_h = nid2.cpu().numpy(), idx.cpu().numpy()
    print(f"first sweep {time.perf_counter() - t0:.1f} s; n_id_2="
          f"{nid2_h[:4]}... idx={idx_h[:4]}...", file=sys.stderr)
    assert (nid2_h == 1).all(), "PSS root misdetected"
    # the correlation's main lobe is ~33 samples wide and flat at its top
    # to well below the noise: the peak sample sits within a few of `want`
    assert (np.abs(idx_h - want) <= 8).all(), "PSS index misdetected"
    ts = []
    for _ in range(a.reps):
        sync()
        t0 = time.perf_counter()
        detect(x, cfg)[2].cpu()
        ts.append(time.perf_counter() - t0)
    t = float(np.median(ts))
    msps = a.carriers * length / t / 1e6
    print(json.dumps({
        "metric": "PSS cell-search sweep rate, 20 MHz carriers (3 roots)",
        "value": msps, "unit": "Msps", "median_s": t,
        "device": torch.cuda.get_device_name(dev) if dev.type == "cuda"
        else "cpu", "vs_line_rate": msps / 30.72}))


if __name__ == "__main__":
    main()
