"""The PSS correlator and detect kernels (K4, K5) on the card, in both
arithmetics, at ``chip_smoke.py``'s check shape.

    python -m lteax_torch.bench.pss_bench [--reps 20] [--label TEXT]

It uses only ``pss_corr_mag`` and ``pss_detect`` of
``lteax_torch.kernels.pss`` and ``pss_time_filters``, so it also runs
against an older checkout of the package: ``PYTHONPATH=OLD python3
lteax_torch/bench/pss_bench.py`` times that checkout's kernels.  Run two
checkouts in one job, in turns (old, new, new, old), to compare them on
one card.

Shape: 4 carriers x 20 subframes of 20 MHz (614 400 samples, 2048 taps),
noise with a PSS at 30x the noise's amplitude in each carrier.  Each entry
is timed warm, ``--reps`` back-to-back calls between CUDA events behind a
spin kernel (``torch.cuda._sleep``), so the events time the device and not
the host's launches.  The last line is one JSON object: ms per call of
each (entry, mdtype), the card, and which package ran.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

import lteax_torch.kernels.pss as pss
from lteax_torch.bench.timing import card_line
from lteax_torch.phy.config import PhyConfig
from lteax_torch.phy.sync import pss_time_filters

SHAPE = (4, 614_400)
SPIN_CYCLES_PER_REP = 2_000_000


def warm_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` back-to-back calls."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(SPIN_CYCLES_PER_REP * reps)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--label", default="")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("pss_bench: needs a CUDA device")
    dev = torch.device("cuda", 0)
    filt = pss_time_filters(PhyConfig(n_rb_dl=100))
    rng = np.random.default_rng(3)
    x = (rng.standard_normal(SHAPE)
         + 1j * rng.standard_normal(SHAPE)).astype(np.complex64)
    for c in range(SHAPE[0]):
        o = 5000 + 7919 * c
        x[c, o:o + filt.shape[1]] += 30.0 * filt[c % 3]
    x = torch.from_numpy(x).to(dev)
    out = {"label": args.label, "package": pss.__file__,
           "shape": list(SHAPE), "taps": filt.shape[1], "reps": args.reps}
    for mdtype in ("bf16", "f32"):
        out[f"corr_{mdtype}_ms"] = warm_ms(
            lambda: pss.pss_corr_mag(x, filt, mdtype), args.reps)
        out[f"detect_{mdtype}_ms"] = warm_ms(
            lambda: pss.pss_detect(x, filt, mdtype), args.reps)
    out["card"] = card_line()
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
