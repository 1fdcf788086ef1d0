"""Turbo half-iteration kernel: time against windows per block, and the bf16
kernel's variants.

    python -m lteax_torch.bench.turbo_variants [--c 3328] [--k 5824]
        [--mdtype f32|bf16] [--pinpad | --no-pinpad]
        [--wpb 4 8 12 16 24] [--reps 10] [--sass]

Every timing is CUDA events around ``--reps`` back-to-back launches at
(C, K+3), win 128, acq 16, after the result was held equal to
``half_iteration_plain`` bit for bit; a bf16 form is timed on bf16 u, v.
``turbo_mlm.WINDOWS_PER_BLOCK`` is what the decoders run.  With
``--mdtype bf16`` each of ``turbo_mlm.BF16_VARIANTS`` (lever by lever) is
also timed at the decoders' windows per block, and
the f32 form beside them.  One JSON object on the last line, with what
``ptxas -v`` said of the kernels (registers, stack, spills).

``--sass`` reads the built library's SASS (``cuobjdump -sass``) and sets
each timed kernel's instructions against its time (``issue_model``): the
instructions a trellis step of each phase executes, counted in the loops
that run it, times the steps and the warps of the launch, is the work the
card's warp schedulers must issue; at one instruction a clock per
scheduler (4 an SM, at the card's highest SM clock) that takes
``issue_ms``, and ``issue_share`` = ``issue_ms`` / measured ms.  A share
that stays the same across kernels of different instruction counts says
that the time follows the instructions issued.  The count leaves out what
runs outside the trellis loops (staging, set-up, the write-out).
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess
from pathlib import Path

import numpy as np
import torch

import lteax_torch.kernels.turbo_mlm as tm
from lteax_torch.bench.timing import card_line
from lteax_torch.kernels._build import _nvcc, library

_INSTR = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;")
_BACK = re.compile(r"\bBRA (?:[^,]+, )?0x([0-9a-f]+)")
# the exchange's shuffle takes its lane mask in a register, the combine's
# fold an immediate one
_FOLD = re.compile(r"SHFL\.BFLY .*, 0x[0-9a-f]+, 0x1f$")
_STS = re.compile(r"\bSTS(\.|\b)")


def sass_functions(text: str) -> dict[str, list[tuple[int, str]]]:
    """``cuobjdump -sass`` output -> {mangled name: [(address,
    instruction)]}."""
    out, body = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            body = out.setdefault(m.group(1), [])
            continue
        m = _INSTR.search(line)
        if m and body is not None:
            body.append((int(m.group(1), 16), m.group(2)))
    return out


def trellis_loops(body: list[tuple[int, str]]) -> dict[str, list[list[int]]]:
    """The innermost loops of a turbo kernel that run trellis steps, by
    phase, each as [instructions, steps]: a loop is a backward branch and
    its target, its steps are its exchange shuffles; "combine" loops also
    fold (immediate-mask shuffles), "store" loops store to shared memory,
    "acq" loops do neither."""
    spans = [(int(m.group(1), 16), a) for a, ins in body
             if (m := _BACK.search(ins)) and int(m.group(1), 16) <= a]
    out = {"acq": [], "store": [], "combine": []}
    for lo, hi in spans:
        if any((o_lo, o_hi) != (lo, hi) and lo <= o_lo and o_hi <= hi
               for o_lo, o_hi in spans):
            continue
        ins = [i for a, i in body if lo <= a <= hi and not i.startswith("NOP")]
        bfly = [i for i in ins if "SHFL.BFLY" in i]
        folds = sum(bool(_FOLD.search(i)) for i in bfly)
        steps = len(bfly) - folds
        if steps == 0:
            continue
        phase = ("combine" if folds else
                 "store" if any(_STS.search(i) for i in ins) else "acq")
        out[phase].append([len(ins), steps])
    return out


def issue_model(loops: dict[str, list[list[int]]], c: int, n: int, win: int,
                acq: int, wpb: int, codeblocks_per_lane: int) -> dict:
    """Warp instructions a launch of the trellis at (c, n), win, acq, wpb
    windows a block, from its loops: a phase's instructions a step are
    those of its loops with the most steps a body (a range where several
    versions of it were compiled), times the phase's steps (acq, win / 2,
    win / 2 + 2), times the warps."""
    half = win // 2
    steps = {"acq": acq, "store": half, "combine": win + 2 - half}
    per_step = {}
    for phase, ls in loops.items():
        if not ls:
            raise ValueError(f"no {phase} loop found")
        most = max(s for _, s in ls)
        per = [n_ins / s for n_ins, s in ls if s == most]
        per_step[phase] = [min(per), max(per)]
    n_w = -(-n // win)
    warps = (-(-c // codeblocks_per_lane) * -(-n_w // wpb) * wpb * 8) // 32
    warp_instr = [warps * sum(steps[p] * per_step[p][i] for p in steps)
                  for i in (0, 1)]
    return {"instr_per_step": per_step, "warps": warps,
            "warp_instr": warp_instr}


# the kernels' template instances: the f32 form, and the bf16 variants'
# <kFold, kAsync> (kFreeze follows --pinpad)
_KERNELS = {"f32": "17turbo_half_kernel",
            1: "22turbo_half_bf16_kernelILb0ELb0ELb{f}E",
            2: "22turbo_half_bf16_kernelILb1ELb0ELb{f}E",
            3: "22turbo_half_bf16_kernelILb1ELb1ELb{f}E"}


def sass_report(shape, pinpad: bool, wpb: int,
                measured: dict) -> dict:
    """The issue model of each kernel in ``measured`` ({"f32" or variant:
    ms}) from the built library's SASS, against its measured time."""
    text = subprocess.run(
        [str(Path(_nvcc()).with_name("cuobjdump")), "-sass",
         str(library().path)], capture_output=True, text=True, check=True,
        timeout=300).stdout
    funcs = sass_functions(text)
    clock = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True, timeout=60).stdout.split()[0]
    issue_per_ms = (torch.cuda.get_device_properties(0).multi_processor_count
                    * 4 * float(clock) * 1e3)
    c, n, win, acq = shape
    out = {"max_sm_clock_mhz": float(clock), "kernels": {}}
    for key, ms in measured.items():
        tag = _KERNELS[key].format(f=int(not pinpad))
        (name,) = [f for f in funcs if tag in f]
        loops = trellis_loops(funcs[name])
        m = issue_model(loops, c, n, win, acq, wpb, 1 if key == "f32" else 2)
        issue_ms = [w / issue_per_ms for w in m["warp_instr"]]
        out["kernels"][key] = {"loops": loops, **m, "issue_ms": issue_ms,
                               "ms": ms,
                               "issue_share": [t / ms for t in issue_ms]}
    return out


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


def _equal(got, ref, what: str) -> None:
    torch.cuda.synchronize()
    if not all(torch.equal(g, r) for g, r in zip(got, ref)):
        raise AssertionError(f"kernel != plain: {what}")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--c", type=int, default=3328)
    ap.add_argument("--k", type=int, default=5824)
    ap.add_argument("--mdtype", choices=("f32", "bf16"), default="f32")
    ap.add_argument("--pinpad", action=argparse.BooleanOptionalAction,
                    default=True, help="pinned (default) or frozen padding")
    ap.add_argument("--wpb", type=int, nargs="+", default=[4, 8, 12, 16, 24],
                    help="windows per block, multiples of 4")
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--sass", action="store_true",
                    help="set the kernels' SASS instruction counts "
                         "against their times")
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("turbo_variants: needs a CUDA device")
    dev = torch.device("cuda", 0)
    card = card_line()
    win, acq = 128, 16
    u, v, a0, b0 = _inputs(a.c, a.k + 3, win, dev)
    bf16 = a.mdtype == "bf16"
    if bf16:
        u, v = u.to(torch.bfloat16), v.to(torch.bfloat16)
    args = (u, v, a0, b0)
    form = (a.mdtype, a.pinpad)
    ref = tm.half_iteration_plain(*args, win, acq, *form)
    out = {"card": card, "shape": [a.c, a.k + 3, win, acq],
           "mdtype": a.mdtype, "pinpad": a.pinpad,
           "shipped_wpb": tm.WINDOWS_PER_BLOCK, "wpb_ms": {}}
    for wpb in a.wpb:
        _equal(tm.half_iteration_kernel(*args, win, acq, wpb, *form), ref,
               f"{form} at {wpb} windows a block")
        out["wpb_ms"][wpb] = _time_ms(
            lambda: tm.half_iteration_kernel(*args, win, acq, wpb, *form),
            a.reps)
    if bf16:
        out["variant_ms"] = {}
        for var in tm.BF16_VARIANTS:
            _equal(tm.half_iteration_bf16_variant(*args, win, acq, var,
                                                  a.pinpad),
                   ref, f"variant {var}")
            out["variant_ms"][var] = _time_ms(
                lambda: tm.half_iteration_bf16_variant(*args, win, acq, var,
                                                       a.pinpad), a.reps)
        uf, vf = u.float(), v.float()
        out["f32_ms"] = _time_ms(lambda: tm.half_iteration_raw(
            uf, vf, a0, b0, win, acq), a.reps)
    log = library().ptxas_log.splitlines()
    out["ptxas"] = [ln.strip() for i, ln in enumerate(log) if any(
        "turbo_half" in prev and "Compiling" in prev
        for prev in log[max(0, i - 3):i])]
    if a.sass:
        wpb = tm.WINDOWS_PER_BLOCK
        measured = ({"f32": out["f32_ms"], **out["variant_ms"]} if bf16 else
                    {"f32": out["wpb_ms"].get(wpb) or _time_ms(
                        lambda: tm.half_iteration_kernel(
                            *args, win, acq, wpb, *form), a.reps)})
        out["sass"] = sass_report(out["shape"], a.pinpad, wpb, measured)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
