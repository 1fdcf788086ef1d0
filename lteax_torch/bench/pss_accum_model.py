"""A CPU model of how the PSS kernel's accumulation order sets its error.

    python -m lteax_torch.bench.pss_accum_model [--seed 3]

No device runs here: the script emulates, in numpy, the kernel's Toeplitz
GEMM on the card's tensor cores as a float32 accumulator that takes one
``wgmma`` k-step (the exact sum of 8 complex taps) at a time and rounds
each sum toward zero, as the tensor cores do.  It compares four orders at
the outputs around each carrier's peak (20 MHz, 2048 taps, 4 carriers of
unit noise with a PSS at 30x its amplitude, as ``chip_smoke.py``'s check):

- ``bf16``: the bf16 routine, one pass of bf16 inputs into one register,
  against the float64 correlation of the bf16-rounded inputs;
- ``one_register``: the f32 routine's six plane passes of
  ``PSS_F32_PASSES`` into one register;
- ``small_first``: the same passes, the smallest plane products first;
- ``chunk_sums``: what the kernel does, each chunk's 8 k-steps summed from
  zero and added to the accumulator in float32 (round to nearest),

the f32 forms against the float64 correlation of the unrounded inputs.
Each error is the largest |model - exact| of a carrier's magnitudes over
its peak magnitude.  The last line is one JSON object.
"""

from __future__ import annotations

import argparse
import json
import re
from pathlib import Path

import numpy as np
import torch

import lteax_torch.kernels.pss as pss
from lteax_torch.phy.config import PhyConfig
from lteax_torch.phy.sync import pss_time_filters

CARRIERS, LENGTH, HALF = 4, 6000, 32
PASSES = tuple(
    (int(i), int(j)) for i, j in re.findall(r"\{(\d+), (\d+)\}", re.search(
        r"#define PSS_F32_PASSES (\{.*\})",
        (Path(pss.__file__).parent / "csrc" / "pss.cu").read_text()).group(1)))
K_STEP = 8                          # complex taps a k-step (K = 16 reals)


def _rz(v: np.ndarray) -> np.ndarray:
    """float64 -> float32, rounded toward zero."""
    f = v.astype(np.float32)
    over = np.abs(f.astype(np.float64)) > np.abs(v)
    f[over] = np.nextafter(f[over], np.float32(0))
    return f


def _planes(v: np.ndarray) -> list[np.ndarray]:
    return [p.double().numpy() for p in pss.split_bf16(torch.from_numpy(v))]


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=3)
    args = ap.parse_args(argv)
    filt = pss_time_filters(PhyConfig(n_rb_dl=100))
    nf, f = filt.shape[1], pss.FRAME
    rng = np.random.default_rng(args.seed)
    x = (rng.standard_normal((CARRIERS, LENGTH))
         + 1j * rng.standard_normal((CARRIERS, LENGTH))).astype(np.complex64)
    pos = [1000 + 97 * c for c in range(CARRIERS)]
    for c, p in enumerate(pos):
        x[c, p:p + nf] += 30 * filt[c % 3]
    xs = _planes(np.stack([x.real, x.imag], -1))           # (C, L, 2) each
    hs = _planes(np.stack([filt.real, filt.imag], -1))      # (3, nf, 2) each
    xf = np.stack([x.real, x.imag], -1).astype(np.float64)
    hf = np.stack([filt.real, filt.imag], -1).astype(np.float64)
    cs = np.repeat(np.arange(CARRIERS), 2 * HALF)
    ns = np.concatenate([np.arange(p - HALF, p + HALF) for p in pos])
    win = ns[:, None] + np.arange(nf)[None, :]              # (N, nf)

    def terms(xp, hp):
        """(N, nf) real and imaginary product terms of x conj(h)."""
        a, h = xp[cs[:, None], win], hp[cs % 3]
        return (a[..., 0] * h[..., 0] + a[..., 1] * h[..., 1],
                a[..., 1] * h[..., 0] - a[..., 0] * h[..., 1])

    def steps(t):
        """(N, nf) terms -> (N, nf/8 + 8) k-step sums: output i = n % 64
        meets tap k in k-step (k + i) // 8 of the Toeplitz GEMM."""
        i = ns % f
        pad = np.zeros((len(ns), nf + f))
        pad[np.arange(len(ns))[:, None], i[:, None] + np.arange(nf)] = t
        return pad.reshape(len(ns), -1, K_STEP).sum(-1)

    def mag(re, im):
        return re.astype(np.float64) ** 2 + im.astype(np.float64) ** 2

    def err(got, want):
        rel = [np.abs(got - want)[cs == c].max() / want[cs == c].max()
               for c in range(CARRIERS)]
        return float(max(rel))

    exact = mag(*(t.sum(-1) for t in terms(xf, hf)))
    exact_bf16 = mag(*(t.sum(-1) for t in terms(xs[0], hs[0])))
    by_pass = {(i, j): [steps(t) for t in terms(xs[i], hs[j])]
               for i, j in PASSES}

    def one_register(passes):
        acc = [np.zeros(len(ns), np.float32) for _ in range(2)]
        for p in passes:
            for q in range(2):
                for s in by_pass[p][q].T:
                    acc[q] = _rz(acc[q].astype(np.float64) + s)
        return mag(*acc)

    def chunk_sums(passes):
        acc = [np.zeros(len(ns), np.float32) for _ in range(2)]
        for p in passes:
            for q in range(2):
                st = by_pass[p][q]
                for c0 in range(0, st.shape[1], K_STEP):
                    part = np.zeros(len(ns), np.float32)
                    for s in st[:, c0:c0 + K_STEP].T:
                        part = _rz(part.astype(np.float64) + s)
                    acc[q] = acc[q] + part
        return mag(*acc)

    out = {"bf16": err(one_register([(0, 0)]), exact_bf16),
           "one_register": err(one_register(PASSES), exact),
           "small_first": err(one_register(PASSES[::-1]), exact),
           "chunk_sums": err(chunk_sums(PASSES), exact),
           "outputs": len(ns), "taps": nf, "seed": args.seed,
           "device": "none (a CPU model)"}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
