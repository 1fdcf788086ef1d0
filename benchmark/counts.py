"""The yardstick's table of peaks and its counts of each kernel's
operations and bytes, frozen from ``chip_smoke.py`` (``bound``,
``check_demap``, ``check_turbo`` and ``check_turbo_forms``'s
``counted_at``), where PERF.md §6 "Counting" explains them.

A kernel's bound is the least time one H100 SXM could take for its work:
its bytes (each input read once, each output written once) over the memory
rate, or its operations over the peak rate of their type, whichever is
larger.  The peaks are the published ones at the full power limit.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 33.5e12      # adds, maxes, mins: one per lane and clock
BF16X2_OPS_PER_S = 67e12     # the same on packed bf16 pairs

ACS_OPS = 60                 # a trellis position's alpha and beta steps
COMBINE_OPS = 39             # its combine (L), in f32 in every fused form


def bound_s(work: tuple) -> float:
    """Seconds for ``work`` = (bytes, f32 operations, bf16 operations):
    the bytes over the memory rate, or the operations over their peak
    rates, whichever is larger."""
    n_bytes, f32_ops, bf16_ops = work
    return max(n_bytes / HBM_BYTES_PER_S,
               f32_ops / F32_OPS_PER_S + bf16_ops / BF16X2_OPS_PER_S)


def turbo_half_work(c: int, n: int, win: int, acq: int,
                    trellis: str) -> tuple:
    """One fused half-iteration launch (K1/K2) over ``c`` codeblocks of
    ``n`` trellis steps in windows of ``win`` with ``acq`` acquisition
    steps: u, v in and L out in the trellis dtype, the window boundary
    metrics in and out in f32; 60 ACS operations a position and a window's
    2 acq acquisition steps in the trellis dtype, the 39 of the combine in
    f32.  -> (bytes, f32 operations, bf16 operations)."""
    n_w = -(-n // win)
    acs = c * n * ACS_OPS + c * n_w * acq * ACS_OPS
    comb = c * n * COMBINE_OPS
    if trellis == "f32":
        return 4 * (3 * c * n + 4 * c * n_w * 8), acs + comb, 0
    return 2 * 3 * c * n + 4 * 4 * c * n_w * 8, comb, acs


def demap_work(bsz: int, n: int, npad: int, m: int, in_bytes: int,
               out_bytes: int) -> tuple:
    """One demap launch (K3) over ``bsz`` subframes of ``n`` symbols
    (``npad`` planar columns, ``m`` bits a symbol): xr, xi and 1/nv in,
    the sign planes in f32, the planes out; per column and axis L
    distances (a subtract and a multiply each), m/2 bits of L - 2 minima
    and a subtract and two multiplies per LLR, in f32.  -> (bytes, f32
    operations, 0)."""
    lv = 2 ** (m // 2)
    ops = bsz * npad * 2 * (2 * lv + (m // 2) * (lv - 2 + 3))
    return (in_bytes * 3 * bsz * n + 4 * m * npad
            + out_bytes * bsz * m * npad, ops, 0)
