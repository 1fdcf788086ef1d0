"""Does the card run the packed 16-bit add/max at twice the f32 rate?

Counterpart of ``bench/vpu_bf16_probe.py``: the ACS op-mix chain
(``lteax_torch.kernels.acs_probe``) over a tensor large enough to fill the
card, timed with CUDA events in f32 and in bf16.  The reference ran 64
programs of a (256, 128) block; the function is elementwise, so the same
2 097 152 elements run here as one (64*256, 128) tensor (``--programs``
scales it).  Prints the card, then per dtype the time and the rate in
T add/max per second (4 operations per element and round), then the
bf16/f32 rate ratio.  If the ratio is near 2 a bf16 trellis is worth
building; if near 1 it is not.

    python -m lteax_torch.bench.acs_probe [--rounds 512] [--reps 5]

``--scaling`` also times rounds/8 .. 2*rounds per dtype: the time must grow
in proportion to the rounds, or the rate printed is not the chain's.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from lteax_torch.bench.timing import card_line
from lteax_torch.kernels.acs_probe import acs_chain

BLOCK = (256, 128)          # the reference's block per program
DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}


def probe_input(programs: int, dtype: torch.dtype, device) -> torch.Tensor:
    """The reference's input: standard normal from numpy seed 0."""
    x = np.random.default_rng(0).standard_normal(
        (programs * BLOCK[0], BLOCK[1]))
    return torch.as_tensor(x, dtype=torch.float32).to(dtype).to(device)


def time_ms(fn, reps: int, device: torch.device) -> float:
    """Median time of ``fn`` over ``reps`` calls: CUDA events on the card,
    the host clock on the CPU."""
    fn()                                                     # warm
    if device.type != "cuda":
        ts = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            ts.append((time.perf_counter() - t0) * 1e3)
        return float(np.median(ts))
    ts = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        ts.append(start.elapsed_time(end))
    return float(np.median(ts))


def run(rounds: int = 512, reps: int = 5, programs: int = 64,
        device=None) -> dict:
    """-> {"f32": {"ms", "tops"}, "bf16": {...}, "ratio", "elements",
    "rounds"}; ``tops`` is T add/max per second, ``ratio`` bf16 over f32.
    ``device=None`` is the current CUDA device (raises without one)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: the probe measures the card "
                               "(pass device=\"cpu\" for a dry run)")
        device = torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    out = {"rounds": rounds, "device": torch.cuda.get_device_name(device)
           if device.type == "cuda" else "cpu"}
    for name, dt in DTYPES.items():
        x = probe_input(programs, dt, device)
        ms = time_ms(lambda: acs_chain(x, rounds), reps, device)
        out[name] = {"ms": ms,
                     "tops": 4 * rounds * x.numel() / (ms * 1e-3) / 1e12}
        out["elements"] = x.numel()
    out["ratio"] = out["bf16"]["tops"] / out["f32"]["tops"]
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=512)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--programs", type=int, default=64,
                    help="(256, 128) blocks in the tensor")
    ap.add_argument("--device", default=None,
                    help="default: the current CUDA device")
    ap.add_argument("--scaling", action="store_true",
                    help="also time rounds/8 .. 2*rounds")
    a = ap.parse_args(argv)
    res = run(a.rounds, a.reps, a.programs, a.device)
    if a.scaling:
        res["scaling"] = {
            r: {n: v["ms"] for n, v in
                run(r, a.reps, a.programs, a.device).items() if n in DTYPES}
            for r in (a.rounds // 8, a.rounds // 4, a.rounds // 2, a.rounds,
                      2 * a.rounds)}
    if res["device"] == "cpu":
        print("cpu (a dry run of the plain version: no measure of the card)")
    else:
        print(card_line())
    for name in DTYPES:
        print(f"{name}: {res[name]['ms']:8.3f} ms   "
              f"{res[name]['tops']:6.2f} T add/max per s")
    print(f"bf16/f32 rate ratio {res['ratio']:.3f} "
          f"({res['elements']} elements, {a.rounds} rounds)")
    for r, ms in res.get("scaling", {}).items():
        print(f"rounds {r:5d}: " + ", ".join(
            f"{n} {t:.4f} ms ({t / r * 1e3:.4f} us per round)"
            for n, t in ms.items()))
    print(json.dumps(res))


if __name__ == "__main__":
    main()
