"""Turbo half-iteration kernel: every decoder form timed in turns.

    python -m lteax_torch.bench.turbo_forms [--c 3328] [--k 5824]
        [--reps 20] [--rounds 3] [--unfused-and-unroll]

Each of the half-iteration kernel's decoder forms (``FORMS``: the f32 and
bf16 trellis with pinned, frozen and free padding, the bf16 combine) is
timed at (C, K+3), win 128, acq 16, on u, v in its metric dtype: CUDA
events around ``--reps`` back-to-back launches, ``--rounds`` rounds, the
forms in turns (forwards, then backwards, ...), the median of each.  It
calls only what every checkout with these forms has
(``turbo_mlm.half_iteration_raw`` with positional flags), so an older
checkout times the same forms:

    PYTHONPATH=OLD python3 lteax_torch/bench/turbo_forms.py

With ``--unfused-and-unroll`` the unfused forms (f32, bf16,
bf16_f32store: the reference's ``fused=False`` body) and the bf16
kernel's renormalisation at the layout kernel's unroll 1 and 2 are timed
in the same turns.  One JSON object on
the last line, with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

import lteax_torch.kernels.turbo_mlm as tm
from lteax_torch.bench.timing import card_line

FORMS = {
    "f32": ("f32", True, False, False),
    "f32_freeze": ("f32", False, False, False),
    "f32_nofreeze": ("f32", True, True, False),
    "bf16": ("bf16", True, False, False),
    "bf16_freeze": ("bf16", False, False, False),
    "bf16_nofreeze": ("bf16", True, True, False),
    "bf16_combine": ("bf16", True, False, True),
    "bf16_combine_freeze": ("bf16", False, False, True),
    "bf16_combine_nofreeze": ("bf16", True, True, True)}
"""The decoder forms by their launch-count name: (mdtype, pinpad,
nofreeze, combine_bf16)."""

NEW_FORMS = {
    "f32_unfused": ("f32", {"fused": False}),
    "bf16_unfused": ("bf16", {"fused": False}),
    "bf16_f32store_unfused": ("bf16_f32store", {"fused": False}),
    "bf16_u1": ("bf16", {"unroll": 1}),
    "bf16_u2": ("bf16", {"unroll": 2})}
"""The unfused kernel and the moved bf16 renormalisation (mdtype, keyword
flags of ``half_iteration_raw``)."""


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
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--unfused-and-unroll", action="store_true")
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    dev = torch.device("cuda", 0)
    win, acq, n = 128, 16, a.k + 3
    u, v, a0, b0 = _inputs(a.c, n, win, dev)
    ub, vb = u.to(torch.bfloat16), v.to(torch.bfloat16)
    args = lambda md: (u, v, a0, b0) if md == "f32" else (ub, vb, a0, b0)
    runs = {name: (lambda f=f: tm.half_iteration_raw(*args(f[0]), win, acq,
                                                      *f))
            for name, f in FORMS.items()}
    if a.unfused_and_unroll:
        runs.update({name: (lambda md=md, kw=kw: tm.half_iteration_raw(
            *args(md), win, acq, md, **kw))
            for name, (md, kw) in NEW_FORMS.items()})
    times = {k: [] for k in runs}
    for r in range(a.rounds):
        for k in (list(runs) if r % 2 == 0 else list(runs)[::-1]):
            times[k].append(_time_ms(runs[k], a.reps))
    print(json.dumps({"shape": [a.c, n, win, acq], "reps": a.reps,
                      "rounds": a.rounds,
                      "ms": {k: float(np.median(t)) for k, t in times.items()},
                      "ms_by_round": times, "card": card_line()}))


if __name__ == "__main__":
    main()
