"""The resampler kernel on the card at the scanner's shapes: device time
warm and cold, against its bound and the one-call ``conv1d`` yardstick.

    python -m lteax_torch.bench.resample_bench [--reps 50] [--label TEXT]
    python -m lteax_torch.bench.resample_bench --spans 1024,2048,4096

It uses only ``resample_poly``, ``resample_poly_plain``, ``_frame_weight``
and ``n_frames_out`` of ``lteax_torch.kernels.polyphase``, so it also runs
against an older checkout of the package: ``PYTHONPATH=OLD python3
lteax_torch/bench/resample_bench.py`` times that checkout's kernel.  Run two
checkouts in one job, in turns (old, new, new, old), to compare them on
one card.

Shapes (C, L, P, Q): 16 x 400 000 at 192/125 (chip_smoke.py's check), the
scanner's launch (1, 400 000) at 192/125 (one channel of 20 ms at 20 Msps),
and (1, 500 000) at 768/625 (20 ms at 25 Msps to 30.72 Msps).  For each:
the kernel against the plain version (``torch.equal``), the launches of one
call, the plain version's time, the kernel's device time with its input
warm in L2 (back-to-back launches) and cold (64 MB written between launches, each launch timed by
its own events), its bound, and ``torch.nn.functional.conv1d`` of the
(2C, 1, L) real planes with the reference's dense (P, 1, K_in) frame weight
at stride Q, TF32 off and on (a yardstick; the port never calls it).  A
spin kernel (``torch.cuda._sleep``) holds the stream while the host
enqueues each timed run, so the events time the device, not the host's
launch overhead.  ``--spans`` instead times the kernel at the first two
shapes under each given ``SPAN_TARGET`` of the launch plan.  The last line
is one JSON object.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

import lteax_torch.kernels.polyphase as poly
from lteax_torch.bench.timing import card_line

SHAPES = ((16, 400_000, 192, 125), (1, 400_000, 192, 125),
          (1, 500_000, 768, 625))
HBM_BYTES_PER_S = 3.35e12     # H100 SXM data sheet
F32_OPS_PER_S = 33.5e12       # f32 adds and multiplies that do not fuse
FLUSH_BYTES = 64 << 20        # more than the 50 MB L2
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


def cold_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` with ``FLUSH_BYTES`` written before each
    call; only the call lies between its two events."""
    flush = torch.empty(FLUSH_BYTES // 4, dtype=torch.float32, device="cuda")
    fn()
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    torch.cuda.synchronize()
    torch.cuda._sleep(SPIN_CYCLES_PER_REP * reps)
    for i, (a, b) in enumerate(events):
        flush.fill_(float(i))
        a.record()
        fn()
        b.record()
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in events) / reps


def conv1d_yardstick(x: torch.Tensor, p: int, q: int, nf: int, reps: int,
                     ref: torch.Tensor) -> dict:
    """``conv1d`` of the real planes with the dense frame weight: the
    reference's XLA formulation as one PyTorch call, TF32 off and on."""
    c, l = x.shape
    planes = torch.view_as_real(x).permute(0, 2, 1).reshape(2 * c, 1, l) \
        .contiguous()
    w = torch.as_tensor(poly._frame_weight(p, q, 12).T.copy(),
                        device=x.device)[:, None, :]              # (P, 1, K_in)
    want = torch.view_as_real(ref.reshape(c, nf, p)).permute(0, 3, 2, 1) \
        .reshape(2 * c, p, nf)
    out = {}
    before = torch.backends.cudnn.allow_tf32
    try:
        for tf32 in (False, True):
            torch.backends.cudnn.allow_tf32 = tf32
            fn = lambda: torch.nn.functional.conv1d(planes, w, stride=q)
            y = fn()[..., :nf]
            key = "tf32" if tf32 else "f32"
            out[key + "_max_abs_err"] = float((y - want).abs().max())
            del y
            out[key + "_ms"] = warm_ms(fn, max(2, reps // 10))
    finally:
        torch.backends.cudnn.allow_tf32 = before
    return out


def run_shape(c: int, l: int, p: int, q: int, reps: int, seed: int) -> dict:
    rng = np.random.default_rng(seed)
    x = torch.as_tensor((rng.standard_normal((c, l)) + 1j
                         * rng.standard_normal((c, l))).astype(np.complex64),
                        device="cuda")
    before = poly.LAUNCHES
    got = poly.resample_poly(x, p, q)
    launches = poly.LAUNCHES - before
    ref = poly.resample_poly_plain(x, p, q)
    torch.cuda.synchronize()
    equal = bool(torch.equal(got, ref))
    err = float((torch.view_as_real(got).double()
                 - torch.view_as_real(ref).double()).abs().max())
    nf = poly.n_frames_out(l, p, q)
    n_out = c * nf * p
    n_bytes = 8 * (c * l + n_out) + 4 * p * 12
    n_ops = 46 * n_out           # 24 multiplies and 22 adds per output
    res = {"shape": [c, l, p, q], "equal_plain": equal, "max_abs_err": err,
           "launches": launches,
           "warm_ms": warm_ms(lambda: poly.resample_poly(x, p, q), reps),
           "cold_ms": cold_ms(lambda: poly.resample_poly(x, p, q), reps),
           "plain_ms": warm_ms(lambda: poly.resample_poly_plain(x, p, q),
                               max(2, reps // 10)),
           "bound_ms": max(n_bytes / HBM_BYTES_PER_S, n_ops / F32_OPS_PER_S)
           * 1e3,
           "bound_by": ("bytes" if n_bytes / HBM_BYTES_PER_S
                        >= n_ops / F32_OPS_PER_S else "operations"),
           "bytes": n_bytes, "ops": n_ops,
           "conv1d": conv1d_yardstick(x, p, q, nf, reps, ref)}
    del got, ref
    return res


def span_sweep(spans: list[int], reps: int) -> list[dict]:
    """The current package's kernel at the first two shapes with each
    ``SPAN_TARGET`` (input samples a tile stages) of its launch plan."""
    before = poly.SPAN_TARGET
    out = []
    try:
        for span in spans:
            poly.SPAN_TARGET = span
            poly.launch_plan.cache_clear()
            for c, l, p, q in SHAPES[:2]:
                rng = np.random.default_rng(span)
                x = torch.as_tensor(
                    (rng.standard_normal((c, l)) + 1j
                     * rng.standard_normal((c, l))).astype(np.complex64),
                    device="cuda")
                fn = lambda: poly.resample_poly(x, p, q)
                plan = poly.launch_plan(c, l, p, q, poly._sm_count(
                    str(x.device)))
                out.append({"span": span, "shape": [c, l, p, q],
                            "plan": plan._asdict(),
                            "equal_plain": bool(torch.equal(
                                fn(), poly.resample_poly_plain(x, p, q))),
                            "warm_ms": warm_ms(fn, reps),
                            "cold_ms": cold_ms(fn, reps)})
    finally:
        poly.SPAN_TARGET = before
        poly.launch_plan.cache_clear()
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--spans", default=None,
                    help="comma-separated SPAN_TARGETs to sweep instead")
    ap.add_argument("--label", default="")
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("resample_bench: needs a CUDA device")
    card = card_line()
    if a.spans:
        rows = span_sweep([int(v) for v in a.spans.split(",")], a.reps)
        for r in rows:
            pl = r["plan"]
            print(f"[resample span {r['span']}] {r['shape']}: equal to plain "
                  f"{r['equal_plain']}; {pl['frames']} frames a tile, "
                  f"{pl['blocks']} blocks; warm {r['warm_ms']:.4f} ms, cold "
                  f"{r['cold_ms']:.4f} ms ({card})")
        print(json.dumps({"card": card, "span_sweep": rows}))
        return
    rows = [run_shape(*s, a.reps, seed=k) for k, s in enumerate(SHAPES)]
    for r in rows:
        cv = r["conv1d"]
        print(f"[resample{' ' + a.label if a.label else ''}] {r['shape']}: "
              f"equal to plain {r['equal_plain']}, launches {r['launches']}; "
              f"warm {r['warm_ms']:.4f} ms, cold {r['cold_ms']:.4f} ms, bound "
              f"{r['bound_ms']:.4f} ms by {r['bound_by']}; conv1d f32 "
              f"{cv['f32_ms']:.4f} ms, TF32 {cv['tf32_ms']:.4f} ms ({card})")
    out = {"label": a.label, "card": card, "torch": torch.__version__,
           "rows": rows}
    if not all(r["equal_plain"] for r in rows):
        raise SystemExit("resample_bench: the kernel differs from plain")
    print(json.dumps(out))


if __name__ == "__main__":
    main()
