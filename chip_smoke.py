#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``lteax_torch/kernels/csrc`` with nvcc
(sm_90a, one nvcc per source, in parallel), holds each kernel against its
plain torch version on the card at the main paths' shapes, then drives
six paths, each with the launch counters set to 0 just before it and
read just after:

1. DL-SCH decode through ``lteax_torch.pipeline.make_batch_decoder`` at the
   ``bench.py`` headline configuration (20 MHz, 100 PRB, MCS 28, TBS 75376,
   C=13 x K=5824) on 256 subframes at 25 dB from ``lteax_torch.sim.dl_gen``
   (seed 0): every transport block must decode to the bits sent, and the
   card's decode of a small slice must equal the CPU's.
2. The multi-carrier cell scanner through
   ``lteax_torch.apps.scanner.scan_channels(..., prescan=True)`` at 20 MHz:
   16 captures of 20 ms at 20 Msps from ``lteax_torch.sim.cell_gen``
   (seed 0), 12 live cells and 4 dead channels, resampled 192/125 to
   30.72 Msps; every live cell must report the cell id, antenna count and
   MIB it was made with, every dead channel none; one capture's scan on
   the card must match its scan on the CPU.
   The PSS correlator runs its default, the bf16 tensor-core kernel;
   ``lteax_torch.phy.sync.find_pss(..., mdtype="f32")`` on one capture
   drives the direct f32 kernel and must give the same root within one
   sample of the default's index.
3. The PSS band sweep (``lteax_torch.bench.scan_throughput.detect``, the
   fused detect kernel) over 128 carriers x 20 subframes of 20 MHz: every
   carrier must give root 1 at the plain version's index, within 8 samples
   of the inserted PSS, in bf16 (the default) and in f32.
4. UL-SCH decode through ``lteax_torch.pipeline.make_pusch_batch_decoder``
   at the ``bench/ul_throughput.py`` configuration (100 PRB, TBS 75376,
   64QAM, cell 214, subframe 4, RNTI 0x3D) on 256 gridded subframes at
   25 dB from ``lteax_torch.sim.ul_gen`` (seed 0): every transport block
   must decode to the bits sent, and a small slice as on the CPU.
5. HARQ incremental redundancy through
   ``lteax_torch.pipeline.make_batch_harq_decoder`` at the
   ``bench/harq_throughput.py`` configuration (20 MHz, MCS 28, subframes
   (1, 2), rv (0, 2)) on 64 transport blocks at ``HARQ_SNR_DB``, where the
   rv 0 transmission alone must decode none of them and the combination all
   of them; then both decoders are timed at 25 dB.
6. The ACS op-mix probe through ``lteax_torch.bench.acs_probe.run`` (f32 and
   packed bf16, 2 097 152 elements, 512 rounds).

Any failure raises (exit code != 0).  Every timing line carries the card's
name and power limit.  The last line is one JSON object naming the
device; the one before it lists the kernels with their launch counts,
errors, times and bounds.  A kernel's bound is the least time the card
could take for the same work: the larger of its bytes (each input read
once, each output written once) over the memory rate and its operations
over the peak rate of their type, from the published peaks of the H100 SXM
below.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

import lteax_torch.apps.file_scan as file_scan
import lteax_torch.apps.scanner as scanner
import lteax_torch.kernels.acs_probe as acs_mod
import lteax_torch.kernels.demap as demap_mod
import lteax_torch.kernels.polyphase as poly_mod
import lteax_torch.kernels.pss as pss_mod
import lteax_torch.kernels.turbo_mlm as turbo_mod
import lteax_torch.phy.sync as sync
from lteax_torch import host
from lteax_torch.bench import acs_probe, scan_throughput
from lteax_torch.io.iq import read_iq, write_iq
from lteax_torch.kernels._build import library
from lteax_torch.phy import seq
from lteax_torch.phy.config import PhyConfig
from lteax_torch.pipeline import (dl_demap_plans, make_batch_decoder,
                                  make_batch_harq_decoder,
                                  make_pusch_batch_decoder)
from lteax_torch.sim import cell_gen
from lteax_torch.sim.dl_gen import (DlCell, dl_subframes, harq_decoder_args,
                                    harq_transmissions)
from lteax_torch.sim.ul_gen import UlCell, ul_subframes

BATCH = 256
SNR_DB = 25.0
SEED = 0
DECODE_REPS = 110     # median and p90 each with >= 10 samples beyond
UL_REPS = 20
HARQ_BATCH = 64
HARQ_SUBFRAMES, HARQ_RVS = (1, 2), (0, 2)
HARQ_SNR_DB = 15.0    # rv 0 alone decodes 0/64 here, rv 0 + rv 2 64/64
HARQ_REPS = 30
PROBE_ROUNDS = (8, 64, 512)

# Published peaks of one H100 SXM (NVIDIA's data sheet and the Hopper
# white paper): device memory, f32 outside the tensor cores counted as
# NVIDIA does (a fused multiply-add is 2), and the same pipes' instruction
# rate for adds, maxes and mins, which cannot fuse: one per lane and clock,
# half the flop figure.  Packed bf16 pairs run two lanes per instruction
# (the white paper's 133.8 TFLOP/s outside the tensor cores).
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
F32_OPS_PER_S = 33.5e12
BF16X2_OPS_PER_S = 67e12
BF16_TENSOR_FLOP_PER_S = 989e12

SCAN_CFG = PhyConfig(n_rb_dl=100)
SDR_RATE = 20e6       # the captures' rate; the scanner resamples 192/125
SCAN_S = 0.02         # 20 ms per capture
N_LIVE, N_DEAD = 12, 4
SWEEP_CARRIERS, SWEEP_SF, SWEEP_REPS = 128, 20, 5
PSS_CHECK_SHAPE = (4, 20 * SCAN_CFG.n_samps_subframe)   # K4/K5 vs plain
# (C, n, win, acq) that exercise the turbo kernel's masks and halos: a C that
# is no multiple of anything, K = 40 in one window, a last window with 3
# live positions (K = 1152), a block grid with dead windows (K = 5824)
TURBO_RAGGED = ((37, 43, 128, 16), (37, 1155, 128, 16), (131, 5827, 128, 16),
                (5, 43, 32, 8))
RESAMPLE_CHECK_SHAPE = (16, 400_000)                    # K6 vs plain, 192/125
WORK = Path(__file__).resolve().parent / "build" / "chip_smoke"

SOURCES = {
    "demap": ("lteax_torch/kernels/csrc/demap.cu",
              "lteax/kernels/demap.py:68"),
    "demap (UL shape)": ("lteax_torch/kernels/csrc/demap.cu",
                         "lteax/kernels/demap.py:68"),
    "turbo_half_iteration": ("lteax_torch/kernels/csrc/turbo.cu",
                             "lteax/kernels/turbo_mlm.py:536"),
    "pss_corr_mag": ("lteax_torch/kernels/csrc/pss.cu",
                     "lteax/kernels/pss.py:55"),
    "pss_detect": ("lteax_torch/kernels/csrc/pss.cu",
                   "lteax/kernels/pss.py:134"),
    "pss_corr_mag_bf16": ("lteax_torch/kernels/csrc/pss.cu",
                          "lteax/kernels/pss.py:55"),
    "pss_detect_bf16": ("lteax_torch/kernels/csrc/pss.cu",
                        "lteax/kernels/pss.py:134"),
    "resample_poly": ("lteax_torch/kernels/csrc/polyphase.cu",
                      "lteax/kernels/polyphase.py:60"),
    "acs_probe": ("lteax_torch/kernels/csrc/acs_probe.cu",
                  "bench/vpu_bf16_probe.py:39"),
}


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def cuda_time_ms(fn, reps: int, warmup: int = 1) -> float:
    """Mean device time of ``fn`` over ``reps`` calls (CUDA events)."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.double() - b.double()).abs().max())


def bound(n_bytes: float, n_ops: float, ops_per_s: float) -> dict:
    """The least time the card could take: bytes over the memory rate or
    operations over their peak rate, whichever is larger."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / ops_per_s * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": n_bytes, "ops": n_ops}


def check_demap(name: str, sgn: np.ndarray, n: int, scheme: str, dev) -> dict:
    """Demap kernel vs plain on (256, n) columns with the sign planes
    ``sgn`` (m, npad) of a main path."""
    m, npad = sgn.shape
    rng = np.random.default_rng(SEED)
    t = lambda x: torch.as_tensor(x.astype(np.float32), device=dev)
    xr = t(rng.standard_normal((BATCH, n)) * 0.7)
    xi = t(rng.standard_normal((BATCH, n)) * 0.7)
    inv_nv = t(rng.uniform(10.0, 1000.0, (BATCH, n)))
    sgn = t(sgn)
    got = demap_mod.demap_planar(xr, xi, inv_nv, sgn, scheme)
    ref = demap_mod.demap_planar_plain(xr, xi, inv_nv, sgn, scheme)
    torch.cuda.synchronize()
    if got.shape != (BATCH, m, npad) or not torch.equal(got, ref):
        raise AssertionError(f"{name} kernel != plain: max |err| "
                             f"{max_abs_err(got, ref)}")
    ms = cuda_time_ms(lambda: demap_mod.demap_planar(xr, xi, inv_nv, sgn,
                                                     scheme), 50)
    plain_ms = cuda_time_ms(lambda: demap_mod.demap_planar_plain(
        xr, xi, inv_nv, sgn, scheme), 10)
    # per column and axis: L distances (sub, mul), m/2 bits of L-2 mins,
    # and sub, mul, mul per LLR
    lv = 2 ** (m // 2)
    ops = BATCH * npad * 2 * (2 * lv + (m // 2) * (lv - 2 + 3))
    return {"name": name, "shape": [BATCH, n, m, npad],
            "max_abs_err": max_abs_err(got, ref), "ms": ms,
            "plain_ms": plain_ms, "library_ms": None,
            **bound(4 * (3 * BATCH * n + m * npad + BATCH * m * npad), ops,
                    F32_OPS_PER_S)}


def check_acs_probe(dev) -> dict:
    """ACS chain kernel vs plain, f32 and packed bf16, at the probe's
    2 097 152 elements and 8, 64 and 512 rounds, ``torch.equal``; times and
    rates at 512 rounds."""
    out = {"name": "acs_probe", "library_ms": None, "max_abs_err": 0.0}
    for name, dt in acs_probe.DTYPES.items():
        x = acs_probe.probe_input(64, dt, dev)
        for rounds in PROBE_ROUNDS:
            got = acs_mod.acs_chain(x, rounds)
            ref = acs_mod.acs_chain_plain(x, rounds)
            torch.cuda.synchronize()
            if not torch.equal(got, ref):
                bad = got != ref
                raise AssertionError(
                    f"acs_probe {name} kernel != plain at {rounds} rounds: "
                    f"{int(bad.sum())} elements differ")
        n, rounds = x.numel(), PROBE_ROUNDS[-1]
        ms = cuda_time_ms(lambda: acs_mod.acs_chain(x, rounds), 20)
        plain_ms = cuda_time_ms(lambda: acs_mod.acs_chain_plain(x, rounds), 2)
        b = bound(2 * n * x.element_size(), 4 * rounds * n,
                  F32_OPS_PER_S if name == "f32" else BF16X2_OPS_PER_S)
        tops = 4 * rounds * n / (ms * 1e-3) / 1e12
        pre = "" if name == "f32" else "bf16_"
        out.update({pre + "ms": ms, pre + "plain_ms": plain_ms,
                    pre + "tops": tops,
                    **{pre + k: v for k, v in b.items()}})
        out["shape"] = [n, rounds]
    out["bf16_over_f32"] = out["bf16_tops"] / out["tops"]
    return out


def turbo_inputs(c: int, n: int, win: int, seed: int, dev):
    """(u, v, a_init, b_init) of a half-iteration, boundaries pinned."""
    n_w = -(-n // win)
    rng = np.random.default_rng(seed)
    t = lambda x: torch.as_tensor(x.astype(np.float32), device=dev)
    u = t(rng.standard_normal((c, n)) * 8.0)
    v = t(rng.standard_normal((c, n)) * 8.0)
    a0 = t(-np.abs(rng.standard_normal((c, n_w, 8))) * 4.0)
    b0 = t(-np.abs(rng.standard_normal((c, n_w, 8))) * 4.0)
    return (u, v, *turbo_mod._pin_boundaries(a0, b0))


def turbo_equal_plain(args, win: int, acq: int) -> list[float]:
    """Kernel vs plain on (L, a_nii, b_nii), ``torch.equal``."""
    got = turbo_mod.half_iteration_raw(*args, win, acq)
    ref = turbo_mod.half_iteration_plain(*args, win, acq)
    torch.cuda.synchronize()
    errs = [max_abs_err(g, r) for g, r in zip(got, ref)]
    if not all(torch.equal(g, r) for g, r in zip(got, ref)):
        raise AssertionError(f"turbo kernel != plain (L, a_nii, b_nii) at "
                             f"{tuple(args[0].shape)}, win {win}, acq {acq}: "
                             f"max |err| {errs}")
    return errs


def check_turbo(cell: DlCell, dev) -> dict:
    """Half-iteration kernel vs plain at the main path's shape,
    C = 13 * 256 = 3328 codeblocks, K = 5824 (n = K+3 trellis steps), and
    at the ragged shapes."""
    for c, n, win, acq in TURBO_RAGGED:
        turbo_equal_plain(turbo_inputs(c, n, win, SEED + n, dev), win, acq)
    geom = cell.geom
    c, n, win, acq = geom.info.c * BATCH, geom.k + 3, 128, 16
    n_w = -(-n // win)
    u, v, a0, b0 = turbo_inputs(c, n, win, SEED + 1, dev)
    errs = turbo_equal_plain((u, v, a0, b0), win, acq)
    ms = cuda_time_ms(lambda: turbo_mod.half_iteration_raw(u, v, a0, b0,
                                                           win, acq), 20)
    plain_ms = cuda_time_ms(lambda: turbo_mod.half_iteration_plain(
        u, v, a0, b0, win, acq), 3)
    # bytes: u, v in and L out, the boundary metrics in and out; operations
    # per trellis position: 30 (alpha step) + 30 (beta step) + 39 (combine)
    # adds, maxes and halvings, plus the 2 * acq acquisition steps of each
    # window
    n_bytes = 4 * (3 * c * n + 4 * c * n_w * 8)
    ops = c * n * 99 + c * n_w * acq * 60
    return {"name": "turbo_half_iteration", "shape": [c, n, win, acq],
            "max_abs_err": max(errs), "ms": ms, "plain_ms": plain_ms,
            "library_ms": None, **bound(n_bytes, ops, F32_OPS_PER_S)}


def _complex_noise(shape, seed: int, dev) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
    return torch.as_tensor(x.astype(np.complex64), device=dev)


def check_resample(dev) -> dict:
    """Resampler kernel vs plain at the scanner's shape: 16 captures of
    400 000 samples (20 ms at 20 Msps), 192/125."""
    x = _complex_noise(RESAMPLE_CHECK_SHAPE, SEED + 2, dev)
    got = poly_mod.resample_poly(x, 192, 125)
    ref = poly_mod.resample_poly_plain(x, 192, 125)
    torch.cuda.synchronize()
    err = max_abs_err(torch.view_as_real(got), torch.view_as_real(ref))
    if not torch.equal(got, ref):
        raise AssertionError(f"resample kernel != plain: max |err| {err}")
    ms = cuda_time_ms(lambda: poly_mod.resample_poly(x, 192, 125), 20)
    plain_ms = cuda_time_ms(lambda: poly_mod.resample_poly_plain(x, 192,
                                                                 125), 5)
    # 12 real taps times a complex sample per output: 24 mul + 22 add
    return {"name": "resample_poly", "shape": [*RESAMPLE_CHECK_SHAPE, 192,
                                                125],
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "library_ms": None,
            **bound(8 * (x.numel() + got.numel()) + 4 * 192 * 12,
                    got.numel() * 46, F32_FLOP_PER_S)}


def library_conv1d_ms(x: torch.Tensor, filt: np.ndarray,
                      tf32: bool) -> float:
    """The one PyTorch call nearest to the PSS correlator:
    ``torch.nn.functional.conv1d`` of the zero-padded complex streams with
    the conjugate replicas, in full f32 (``tf32`` False) or with cuDNN's
    TF32 allowed (True).  It gives the complex correlation of the same
    (C, 3, L) outputs and leaves out the kernel's |.|^2, so it is a
    yardstick that does a little less.  Used nowhere in the port."""
    w = torch.as_tensor(np.conj(filt), device=x.device)[:, None, :]
    xp = torch.nn.functional.pad(x, (0, filt.shape[1] - 1))[:, None, :]
    before = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        y = torch.nn.functional.conv1d(xp, w)
        if y.shape != (x.shape[0], 3, x.shape[1]):
            raise AssertionError(f"conv1d yardstick shape {tuple(y.shape)}")
        del y
        return cuda_time_ms(lambda: torch.nn.functional.conv1d(xp, w), 3)
    finally:
        torch.backends.cudnn.allow_tf32 = before


def check_pss(dev) -> list[dict]:
    """PSS correlator and detect kernels vs plain at 4 carriers x 20
    subframes of 20 MHz (nf = 2048): the f32 kernels bit for bit; the bf16
    kernels within ``pss.BF16_TOL`` of each carrier's peak magnitude, and
    exactly in the root and index of every carrier's peak."""
    filt = sync.pss_time_filters(SCAN_CFG)
    n_c, length = PSS_CHECK_SHAPE
    x = _complex_noise(PSS_CHECK_SHAPE, SEED + 3, dev)
    for c in range(n_c):
        x[c, 5000 + 7919 * c:5000 + 7919 * c + filt.shape[1]] += \
            30.0 * torch.as_tensor(filt[c % 3], device=dev)
    want = [5000 + 7919 * c for c in range(n_c)]
    tol = pss_mod.BF16_TOL
    # a complex multiply-add per (output, root, tap): 4 mul + 4 add, whatever
    # computes it (the Toeplitz form's extra chunk is not useful work); the
    # magnitude's 3 flop per output vanish beside them
    flop = x.numel() * 3 * filt.shape[1] * 8
    in_bytes = 8 * (x.numel() + filt.size)
    corr_bytes = in_bytes + 4 * 3 * x.numel()
    shape = list(PSS_CHECK_SHAPE)

    def found(parts, tile, name):
        nid2, idx, _, _ = pss_mod.pss_reduce_combine(*parts, tile, length)
        if nid2.tolist() != [c % 3 for c in range(n_c)] or \
                any(abs(i - w) > 2 for i, w in zip(idx.tolist(), want)):
            raise AssertionError(f"{name} found {nid2.tolist()} at "
                                 f"{idx.tolist()}, inserted at {want}")
        return nid2, idx

    out = []
    # -- f32: the direct correlator, bit for bit
    got = pss_mod.pss_corr_mag(x, filt, "f32")
    ref = pss_mod.pss_corr_mag_plain(x, filt, "f32")
    torch.cuda.synchronize()
    err = max_abs_err(got, ref)
    if not torch.equal(got, ref):
        raise AssertionError(f"PSS correlator kernel != plain: max |err| "
                             f"{err}")
    peak_f32 = got.flatten(1).argmax(dim=1)
    del got, ref
    out.append({"name": "pss_corr_mag", "shape": shape, "max_abs_err": err,
                "ms": cuda_time_ms(
                    lambda: pss_mod.pss_corr_mag(x, filt, "f32"), 5),
                "plain_ms": cuda_time_ms(
                    lambda: pss_mod.pss_corr_mag_plain(x, filt, "f32"), 1, 0),
                "library_ms": library_conv1d_ms(x, filt, tf32=False),
                "library": "conv1d, f32, TF32 off",
                **bound(corr_bytes, flop, F32_FLOP_PER_S)})
    got = pss_mod.pss_detect(x, filt, "f32")[:3]
    ref = pss_mod.pss_detect_plain(x, filt, "f32")
    torch.cuda.synchronize()
    errs = [max_abs_err(g, r) for g, r in zip(got, ref)]
    if not all(torch.equal(g, r) for g, r in zip(got, ref)):
        raise AssertionError(f"PSS detect kernel != plain (max, argmax, "
                             f"sum): max |err| {errs}")
    found(got, pss_mod.TILE, "PSS detect (f32)")
    out.append({"name": "pss_detect", "shape": shape,
                "max_abs_err": max(errs),
                "ms": cuda_time_ms(
                    lambda: pss_mod.pss_detect(x, filt, "f32"), 5),
                "plain_ms": cuda_time_ms(
                    lambda: pss_mod.pss_detect_plain(x, filt, "f32"), 1, 0),
                "library_ms": None,
                **bound(in_bytes + sum(4 * g.numel() for g in got), flop,
                        F32_FLOP_PER_S)})

    # -- bf16: the Toeplitz GEMM on the tensor cores, by tolerance
    got = pss_mod.pss_corr_mag(x, filt)
    ref = pss_mod.pss_corr_mag_plain(x, filt)
    torch.cuda.synchronize()
    peak = ref.amax(dim=(1, 2))
    rel = ((got - ref).abs().amax(dim=(1, 2)) / peak).tolist()
    err = max_abs_err(got, ref)
    peak_got = got.flatten(1).argmax(dim=1)
    if max(rel) > tol or not torch.equal(peak_got,
                                         ref.flatten(1).argmax(dim=1)):
        raise AssertionError(f"PSS bf16 correlator vs plain: |err| / peak "
                             f"per carrier {rel} (limit {tol}), or another "
                             f"root or index")
    moved = int((peak_got != peak_f32).sum())
    del got
    out.append({"name": "pss_corr_mag_bf16", "shape": shape,
                "max_abs_err": err, "max_rel_err_of_peak": max(rel),
                "tolerance_of_peak": tol, "peaks_moved_vs_f32": moved,
                "ms": cuda_time_ms(lambda: pss_mod.pss_corr_mag(x, filt), 10),
                "plain_ms": cuda_time_ms(
                    lambda: pss_mod.pss_corr_mag_plain(x, filt), 1, 0),
                "library_ms": library_conv1d_ms(x, filt, tf32=True),
                "library": "conv1d, f32 with cuDNN TF32 on",
                **bound(corr_bytes, flop, BF16_TENSOR_FLOP_PER_S)})
    got = pss_mod.pss_detect(x, filt)[:3]
    rp = pss_mod.pss_detect_plain(x, filt)
    torch.cuda.synchronize()
    max_rel = float((got[0] - rp[0]).abs().max() / peak.max())
    sum_rel = float(((got[2] - rp[2]).abs() / rp[2]).max())
    a = found(got, pss_mod.TILE_BF16, "PSS detect (bf16)")
    b = found(rp, pss_mod.TILE_BF16, "PSS detect plain (bf16)")
    # the per-tile sum adds 16 384 non-negative magnitudes in f32 in another
    # order: relative rounding ~1e-7 * sqrt(terms), held to the same limit
    if max_rel > tol or sum_rel > tol or not all(
            torch.equal(g, r) for g, r in zip(a, b)):
        raise AssertionError(f"PSS bf16 detect vs plain: tile max off by "
                             f"{max_rel} of the peak, tile sum by {sum_rel} "
                             f"(limit {tol}), combine {a} vs {b}")
    out.append({"name": "pss_detect_bf16", "shape": shape,
                "max_abs_err": max_abs_err(got[0], rp[0]),
                "max_rel_err_of_peak": max_rel, "sum_rel_err": sum_rel,
                "tolerance_of_peak": tol,
                "ms": cuda_time_ms(lambda: pss_mod.pss_detect(x, filt), 10),
                "plain_ms": cuda_time_ms(
                    lambda: pss_mod.pss_detect_plain(x, filt), 1, 0),
                "library_ms": None,
                **bound(in_bytes + sum(4 * g.numel() for g in got), flop,
                        BF16_TENSOR_FLOP_PER_S)})
    return out


def scanner_captures() -> tuple[list, list]:
    """16 channels of 20 ms at 20 Msps (seed 0), written under ``WORK``:
    12 live cells (distinct ids covering n_id_2 0/1/2; n_ant 1 on 6, 2 on
    4, 4 on 2; CFO uniform in +-5 kHz; SNR 10-20 dB; start offset uniform
    in [0, 10 ms); a different start SFN each) and 4 dead channels (AWGN
    only).  Returns (channels, expected captures or None when dead)."""
    rng = np.random.default_rng(SEED)
    WORK.mkdir(parents=True, exist_ok=True)
    ids = [int(3 * n1 + k % 3)
           for k, n1 in enumerate(rng.choice(168, N_LIVE, replace=False))]
    ants = [1] * 6 + [2] * 4 + [4] * 2
    sfns = rng.choice(1024, N_LIVE, replace=False)
    nsf10 = 10 * SCAN_CFG.n_samps_subframe
    chans, caps = [], []
    for k in range(N_LIVE + N_DEAD):
        path = WORK / f"ch{k:02d}.fc32"
        if k < N_LIVE:
            cell = cell_gen.Cell(n_rb_dl=100, n_cell_id=ids[k],
                                 n_ant=ants[k],
                                 phich_resource=(0.5, 1.0, 2.0)[k % 3])
            cap = cell_gen.capture(
                cell, SCAN_S, sfn0=int(sfns[k]),
                offset=int(rng.integers(0, nsf10)),
                cfo_hz=float(rng.uniform(-5e3, 5e3)),
                snr_db=float(rng.uniform(10.0, 20.0)), rate_hz=SDR_RATE,
                seed=SEED + k)
            write_iq(str(path), cap.iq)
            caps.append((cell, cap))
        else:
            n = int(SCAN_S * SDR_RATE)
            write_iq(str(path), (rng.standard_normal(n) + 1j
                                 * rng.standard_normal(n)) * 0.05)
            caps.append(None)
        chans.append(scanner.Channel(str(3000 + k), str(path),
                                     rate_hz=SDR_RATE))
    return chans, caps


def check_scan_reports(reports: list, caps: list) -> None:
    for d, c in zip(reports, caps):
        if c is None:
            if d.get("mib") is not None or \
                    d.get("prescan", {}).get("detected", True):
                raise AssertionError(f"dead channel {d['channel']} "
                                     f"reported a cell: {d}")
            continue
        cell, cap = c
        mib = d.get("mib") or {}
        got = (d.get("n_cell_id"), d.get("n_ant"), mib.get("n_rb_dl"),
               mib.get("phich_resource"), mib.get("sfn"))
        want = (cell.n_cell_id, cell.n_ant, cell.n_rb_dl,
                cell.phich_resource, cap.sfn)
        if got != want:
            raise AssertionError(f"channel {d['channel']}: reported "
                                 f"(cell, n_ant, n_rb, phich, sfn) {got}, "
                                 f"sent {want}")


def scan_card_vs_cpu(chan, dev, card: str) -> dict:
    """One capture scanned on the card and on the CPU (plain versions)."""
    x = torch.from_numpy(read_iq(chan.path))
    res = {}
    for name, d in (("card", dev), ("cpu", torch.device("cpu"))):
        xn = poly_mod.resample_poly(x.to(d), 192, 125)
        t0 = time.perf_counter()
        res[name] = file_scan.scan(xn, SCAN_CFG, max_si_subframes=0)
        res[name + "_s"] = time.perf_counter() - t0
    g, c = res["card"], res["cpu"]
    for f in ("n_cell_id", "frame_start", "n_ant", "sfn", "mib"):
        if getattr(g, f) != getattr(c, f):
            raise AssertionError(f"card vs CPU scan: {f} {getattr(g, f)} "
                                 f"!= {getattr(c, f)}")
    diffs = {"cfo_hz": abs(g.cfo_hz - c.cfo_hz),
             "rsrp_db": abs(g.rsrp_dbfs - c.rsrp_dbfs),
             "snr_db": abs(g.snr_db - c.snr_db),
             "evm_pct": abs(g.evm_pct - c.evm_pct)}
    if diffs["cfo_hz"] > 1.0 or diffs["rsrp_db"] > 0.1 or \
            diffs["snr_db"] > 0.1:
        raise AssertionError(f"card vs CPU scan differ: {diffs}")
    print(f"[scan-cpu-vs-card] channel {chan.label}: integers and MIB "
          f"equal; |diff| {diffs}; card {res['card_s']:.3f} s, CPU "
          f"{res['cpu_s']:.3f} s ({card})")
    return diffs


def find_pss_f32(chan, dev) -> dict:
    """``sync.find_pss`` on one capture in f32 (the direct correlator, the
    reference's study mode) and in the default: the same root, the index
    within one sample (the lobe's top is flat below the noise)."""
    x = poly_mod.resample_poly(torch.from_numpy(read_iq(chan.path)).to(dev),
                               192, 125)
    pss_mod.CORR_LAUNCHES = 0
    nid2, idx, _ = sync.find_pss(x, SCAN_CFG, mdtype="f32")
    torch.cuda.synchronize()
    launches = pss_mod.CORR_LAUNCHES
    nid2_d, idx_d, _ = sync.find_pss(x, SCAN_CFG)
    moved = int(idx) - int(idx_d)
    print(f"[find-pss-f32] channel {chan.label}: root {int(nid2)} at "
          f"{int(idx)} in f32, root {int(nid2_d)} at {int(idx_d)} in bf16; "
          f"launches {launches}")
    if int(nid2) != int(nid2_d) or abs(moved) > 1 or launches <= 0:
        raise AssertionError("find_pss in f32 and in bf16 disagree, or the "
                             "f32 correlator was not launched")
    return {"launches": launches, "idx_moved": moved}


def run_scanner(dev, card: str) -> dict:
    """The scanner path: 16 channels through scan_channels(prescan=True),
    twice (run 0 warms caches, run 1 is reported), each run with its own
    launch counts, and each must report the cells that were sent.  Then
    the f32 correlator through ``find_pss`` on one capture."""
    t0 = time.perf_counter()
    chans, caps = scanner_captures()
    print(f"[scan-gen] {len(chans)} captures of {SCAN_S * 1e3:.0f} ms at "
          f"{SDR_RATE / 1e6:.0f} Msps: {time.perf_counter() - t0:.2f} s")
    runs = []
    for tag in ("first", "second"):
        scanner.STAGE_SECONDS.clear()
        host.READS = 0
        poly_mod.LAUNCHES = 0
        pss_mod.CORR_LAUNCHES = pss_mod.CORR_BF16_LAUNCHES = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        reports = scanner.scan_channels(chans, SCAN_CFG, prescan=True,
                                        device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {"resample_poly": poly_mod.LAUNCHES,
                    "pss_corr_mag_bf16": pss_mod.CORR_BF16_LAUNCHES}
        check_scan_reports(reports, caps)
        for name, cnt in launches.items():
            if cnt <= 0:
                raise AssertionError(f"the scanner path never launched "
                                     f"{name}")
        if pss_mod.CORR_LAUNCHES:
            raise AssertionError("the scanner path launched the f32 "
                                 "correlator: bf16 is its default")
        runs.append({"tag": tag, "wall_s": wall, "stages":
                     dict(scanner.STAGE_SECONDS), "reads": host.READS,
                     "launches": launches})
    n = len(chans)
    for r in runs:
        st = r["stages"]
        print(f"[scanner] {r['tag']} run: {N_LIVE}/{N_LIVE} live cells with "
              f"the sent id, n_ant and MIB, {N_DEAD}/{N_DEAD} dead flagged; "
              f"wall {r['wall_s'] * 1e3 / n:.2f} ms per channel (resample "
              f"{st.get('resample', 0) * 1e3 / n:.2f}, prescan "
              f"{st.get('prescan', 0) * 1e3 / n:.2f}, scan "
              f"{st.get('scan', 0) * 1e3 / N_LIVE:.2f} per live channel); "
              f"host reads {r['reads']} ({r['reads'] / n:.2f} per channel); "
              f"launches {r['launches']} ({card})")
    f32 = find_pss_f32(chans[0], dev)
    diffs = scan_card_vs_cpu(chans[0], dev, card)
    return {"wall_s": runs[1]["wall_s"], "stages": runs[1]["stages"],
            "reads": runs[1]["reads"],
            "launches": {**runs[1]["launches"],
                         "pss_corr_mag": f32["launches"]},
            "first_wall_s": runs[0]["wall_s"],
            "find_pss_f32_idx_moved": f32["idx_moved"], "cpu_vs_card": diffs}


def run_sweep(dev, card: str) -> dict:
    """The band sweep: 128 carriers x 20 subframes through the detect
    kernel, in bf16 (the default) and in f32.  Every carrier must give root
    1, and the same index as the plain version of the same arithmetic on
    the same samples, within the PSS correlation's main lobe (+-8 of
    2048/62 = 33 samples) of the inserted PSS start: at the reference
    synthesis's noise level the lobe's top is flat to ~0.3% per sample,
    below the noise, so the exact sample is the noise's choice (and may
    move by one between the two arithmetics)."""
    length = SWEEP_SF * SCAN_CFG.n_samps_subframe
    t0 = time.perf_counter()
    x_np, want = scan_throughput.sweep_signal(SCAN_CFG, SWEEP_CARRIERS,
                                              length, seed=SEED)
    x = torch.from_numpy(x_np).to(dev)
    del x_np
    print(f"[sweep-gen] {SWEEP_CARRIERS} x {length} samples "
          f"({x.numel() * 8 / 1e6:.0f} MB): {time.perf_counter() - t0:.2f} s")
    filt = sync.pss_time_filters(SCAN_CFG)
    res = {}
    for mdtype in pss_mod.MDTYPES:
        pss_mod.DETECT_LAUNCHES = pss_mod.DETECT_BF16_LAUNCHES = 0
        nid2, idx, _ = scan_throughput.detect(x, SCAN_CFG, mdtype)
        nid2, idx = nid2.tolist(), idx.tolist()
        launches = (pss_mod.DETECT_BF16_LAUNCHES if mdtype == "bf16"
                    else pss_mod.DETECT_LAUNCHES)
        ref_idx = []
        for c0 in range(0, SWEEP_CARRIERS, 16):
            parts = pss_mod.pss_detect_plain(x[c0:c0 + 16], filt, mdtype)
            ref_idx += pss_mod.pss_reduce_combine(
                *parts, pss_mod.detect_tile(mdtype), length)[1].tolist()
        dev_from_sent = [i - int(w) for i, w in zip(idx, want)]
        bad = [c for c in range(SWEEP_CARRIERS)
               if nid2[c] != 1 or idx[c] != ref_idx[c]
               or abs(dev_from_sent[c]) > 8]
        if bad or launches <= 0:
            raise AssertionError(f"sweep ({mdtype}): carriers {bad} wrong "
                                 f"(launches {launches})")
        times = []
        for _ in range(SWEEP_REPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            scan_throughput.detect(x, SCAN_CFG, mdtype)[2].cpu()
            times.append(time.perf_counter() - t0)
        t = float(np.median(times))
        msps = SWEEP_CARRIERS * length / t / 1e6
        exact = sum(d == 0 for d in dev_from_sent)
        off = {c: d for c, d in enumerate(dev_from_sent) if d}
        print(f"[sweep] {mdtype}: {SWEEP_CARRIERS} carriers x {SWEEP_SF} sf: "
              f"all root 1, index equal to the plain version's on all; "
              f"{exact} exactly at the inserted PSS start, the rest "
              f"(carrier: samples off) {off}; median {t * 1e3:.2f} ms per "
              f"sweep (n={len(times)}) = {msps:.1f} Msps ({card})")
        res[mdtype] = {"median_ms": t * 1e3, "msps": msps,
                       "launches": launches, "exact_idx": exact, "idx": idx}
    moved = sum(a != b for a, b in zip(res["bf16"]["idx"], res["f32"]["idx"]))
    print(f"[sweep] carriers whose peak index differs between the bf16 and "
          f"the f32 kernel: {moved} of {SWEEP_CARRIERS}")
    for r in res.values():
        del r["idx"]
    return {**res["bf16"], "f32": res["f32"], "moved_vs_f32": moved}


def decode_counted(name: str, dec, x: torch.Tensor, tb_ref: np.ndarray,
                   want_ok: int) -> dict:
    """One decode with the demap and turbo launch counts set to 0 just
    before it and read just after; ``want_ok`` transport blocks must pass
    their CRC, and when that is all of them the bits must equal the sent."""
    torch.cuda.reset_peak_memory_stats()
    demap_mod.LAUNCHES = 0
    turbo_mod.LAUNCHES = 0
    bits, ok, n_iter = dec(x)
    torch.cuda.synchronize()
    launches = {"demap": demap_mod.LAUNCHES,
                "turbo_half_iteration": turbo_mod.LAUNCHES}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    stats = dec.last_stats
    n_ok, n = int(ok.sum()), len(tb_ref)
    bits_ok = bool(np.array_equal(bits.cpu().numpy(), tb_ref))
    print(f"[{name}] crc ok {n_ok}/{n}, bits equal sent: {bits_ok}, n_iter "
          f"{n_iter}/{dec.n_iter}, host syncs {stats.syncs}, compacted "
          f"retries {stats.retries}, launches {launches}")
    if bits.shape != tb_ref.shape or bits.dtype != torch.int8:
        raise AssertionError(f"{name}: tb_bits {tuple(bits.shape)} "
                             f"{bits.dtype}")
    if n_ok != want_ok or (want_ok == n and not bits_ok):
        raise AssertionError(f"{name}: {n_ok}/{n} transport blocks decoded, "
                             f"{want_ok} expected (bits equal: {bits_ok})")
    for kernel, cnt in launches.items():
        if cnt <= 0:
            raise AssertionError(f"the {name} path never launched {kernel}")
    return {"launches": launches, "n_iter": n_iter, "syncs": stats.syncs,
            "retries": stats.retries, "peak_gb": peak_gb}


def card_vs_cpu(name: str, dec, dec_cpu, x_small: torch.Tensor) -> None:
    """The card's decode of a small slice equals the CPU's (plain
    versions): bits, CRC flags and n_iter equal, the de-matched LLRs within
    1e-4 of the largest (FFT rounding)."""
    d_gpu, d_cpu = dec.front(x_small), dec_cpu.front(x_small.cpu())
    out_gpu, out_cpu = dec.turbo(d_gpu), dec_cpu.turbo(d_cpu)
    front_err = max_abs_err(d_gpu.cpu(), d_cpu)
    front_scale = float(d_cpu.abs().max())
    print(f"[{name}-cpu-vs-card] {out_cpu[0].shape[0]} transport blocks: "
          f"de-matched LLR max |diff| {front_err:.3e} (max |LLR| "
          f"{front_scale:.1f}); n_iter {out_gpu[2]} vs {out_cpu[2]}")
    if not (torch.equal(out_gpu[0].cpu(), out_cpu[0])
            and torch.equal(out_gpu[1].cpu(), out_cpu[1])
            and out_gpu[2] == out_cpu[2]):
        raise AssertionError(f"{name}: card and CPU decodes of the same "
                             f"slice differ")
    if front_err > 1e-4 * front_scale:
        raise AssertionError(f"{name}: card and CPU fronts differ beyond "
                             f"FFT rounding")


def time_decode(dec, x: torch.Tensor, reps: int) -> tuple[float, float]:
    """(median, p90) seconds of ``dec(x)``: host clock around synchronised
    calls."""
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dec(x)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return float(np.median(times)), float(np.percentile(times, 90))


def run_dl(cell: DlCell, dev, card: str) -> dict:
    """The DL path: 256 subframes of the bench.py headline config."""
    t0 = time.perf_counter()
    iq, tb_ref = dl_subframes(cell, BATCH, SNR_DB, seed=SEED)
    print(f"[gen] {BATCH} subframes, TBS {cell.geom.tbs}, C={cell.geom.info.c}"
          f", K={cell.geom.k}, {SNR_DB} dB: {time.perf_counter() - t0:.2f} s")
    dec = make_batch_decoder(*cell.decoder_args(), device=dev)
    x = torch.from_numpy(iq).to(dev)
    out = decode_counted("decode", dec, x, tb_ref, BATCH)
    card_vs_cpu("decode", dec,
                make_batch_decoder(*cell.decoder_args(), device="cpu"), x[:4])
    torch.cuda.reset_peak_memory_stats()
    dec.front(x)
    torch.cuda.synchronize()
    front_gb = torch.cuda.max_memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()
    t_med, t_p90 = time_decode(dec, x, DECODE_REPS)
    decode_gb = torch.cuda.max_memory_allocated() / 1e9
    mbps = BATCH * cell.geom.tbs / t_med / 1e6
    print(f"[timing] decode B={BATCH}: median {t_med * 1e3:.3f} ms/batch, "
          f"p90 {t_p90 * 1e3:.3f} (n={DECODE_REPS}), {mbps:.2f} Mbit/s "
          f"({card})")
    print(f"[memory] peak allocated: first decode {out['peak_gb']:.2f} GB, "
          f"front {front_gb:.2f} GB, steady decode {decode_gb:.2f} GB "
          f"({card})")
    front_ms = cuda_time_ms(lambda: dec.front(x), 5)
    print(f"[timing] front (OFDM..de-match) {front_ms:.3f} ms/batch ({card})")
    return {**out, "decode_ms": t_med * 1e3, "decode_p90_ms": t_p90 * 1e3,
            "mbit_per_s": mbps, "peak_gb": decode_gb, "front_ms": front_ms}


def run_ul(cell: UlCell, dev, card: str) -> dict:
    """The UL-SCH path: 256 gridded subframes at 100 PRB / TBS 75376."""
    geom = cell.alloc.geom
    t0 = time.perf_counter()
    iq, tb_ref = ul_subframes(cell, BATCH, SNR_DB, seed=SEED)
    print(f"[ul-gen] {BATCH} subframes, {cell.alloc.n_prb} PRB, TBS "
          f"{geom.tbs}, C={geom.info.c}, K={geom.k}, {cell.alloc.scheme}, "
          f"{SNR_DB} dB: {time.perf_counter() - t0:.2f} s")
    dec = make_pusch_batch_decoder(*cell.decoder_args(), device=dev)
    x = torch.from_numpy(iq).to(dev)
    out = decode_counted("ul", dec, x, tb_ref, BATCH)
    card_vs_cpu("ul", dec,
                make_pusch_batch_decoder(*cell.decoder_args(), device="cpu"),
                x[:4])
    torch.cuda.reset_peak_memory_stats()
    t_med, t_p90 = time_decode(dec, x, UL_REPS)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    mbps = BATCH * geom.tbs / t_med / 1e6
    front_ms = cuda_time_ms(lambda: dec.front(x), 5)
    print(f"[ul] decode B={BATCH}: median {t_med * 1e3:.3f} ms/batch, p90 "
          f"{t_p90 * 1e3:.3f} (n={UL_REPS}), {mbps:.2f} Mbit/s; front (LS.."
          f"de-match) {front_ms:.3f} ms/batch; peak allocated {peak_gb:.2f} "
          f"GB ({card})")
    return {**out, "decode_ms": t_med * 1e3, "decode_p90_ms": t_p90 * 1e3,
            "mbit_per_s": mbps, "front_ms": front_ms, "peak_gb": peak_gb}


def run_harq(cell: DlCell, dev, card: str) -> dict:
    """The HARQ-IR path: rv 0 + rv 2 of 64 transport blocks at
    ``HARQ_SNR_DB``, where rv 0 alone must decode none and the combination
    all; then both decoders timed at 25 dB."""
    t0 = time.perf_counter()
    iq, tb_ref, cells = harq_transmissions(
        cell, HARQ_SUBFRAMES, HARQ_RVS, HARQ_BATCH, HARQ_SNR_DB, seed=SEED)
    iq_hi, tb_hi, _ = harq_transmissions(
        cell, HARQ_SUBFRAMES, HARQ_RVS, HARQ_BATCH, SNR_DB, seed=SEED + 1)
    print(f"[harq-gen] 2 x {len(cells)} x {HARQ_BATCH} subframes, subframes "
          f"{HARQ_SUBFRAMES}, rv {HARQ_RVS}, {HARQ_SNR_DB} and {SNR_DB} dB: "
          f"{time.perf_counter() - t0:.2f} s")
    dec_h = make_batch_harq_decoder(*harq_decoder_args(cells), device=dev)
    dec_1 = make_batch_decoder(*cells[0].decoder_args(), device=dev)
    x = torch.from_numpy(iq).to(dev)
    out = decode_counted(f"harq rv0+rv2 {HARQ_SNR_DB} dB", dec_h, x, tb_ref,
                         HARQ_BATCH)
    decode_counted(f"harq rv0 alone {HARQ_SNR_DB} dB", dec_1, x[0], tb_ref, 0)
    card_vs_cpu("harq", dec_h, make_batch_harq_decoder(
        *harq_decoder_args(cells), device="cpu"), x[:, :4])
    x_hi = torch.from_numpy(iq_hi).to(dev)
    decode_counted(f"harq rv0+rv2 {SNR_DB} dB", dec_h, x_hi, tb_hi,
                   HARQ_BATCH)
    decode_counted(f"harq rv0 alone {SNR_DB} dB", dec_1, x_hi[0], tb_hi,
                   HARQ_BATCH)
    # in turns, so that a change in the host's load meets both alike
    pairs = [(time_decode(dec_h, x_hi, 1)[0],
              time_decode(dec_1, x_hi[0], 1)[0]) for _ in range(HARQ_REPS)]
    t_h, t_1 = (float(np.median(t)) for t in zip(*pairs))
    print(f"[harq] B={HARQ_BATCH}, {SNR_DB} dB: combined median "
          f"{t_h * 1e3:.3f} ms/batch, rv 0 alone {t_1 * 1e3:.3f} (n="
          f"{HARQ_REPS} each, in turns), ratio {t_h / t_1:.3f} ({card})")
    f_h = cuda_time_ms(lambda: dec_h.front(x_hi), 5)
    f_1 = cuda_time_ms(lambda: dec_1.front(x_hi[0]), 5)
    print(f"[harq] fronts by CUDA events: two summed {f_h:.3f} ms/batch, "
          f"one {f_1:.3f} ({card})")
    return {**out, "snr_db": HARQ_SNR_DB, "combined_ms": t_h * 1e3,
            "single_ms": t_1 * 1e3, "ratio": t_h / t_1,
            "combined_front_ms": f_h, "single_front_ms": f_1}


def run_probe(dev, card: str) -> dict:
    """The probe's entry point, as its CLI drives it."""
    acs_mod.LAUNCHES = 0
    res = acs_probe.run(rounds=PROBE_ROUNDS[-1], reps=5, device=dev)
    launches = acs_mod.LAUNCHES
    if launches <= 0:
        raise AssertionError("the probe path never launched acs_probe")
    print(f"[probe] {res['elements']} elements x {res['rounds']} rounds: f32 "
          f"{res['f32']['ms']:.4f} ms = {res['f32']['tops']:.2f} T add/max "
          f"per s, bf16 {res['bf16']['ms']:.4f} ms = "
          f"{res['bf16']['tops']:.2f}; bf16/f32 {res['ratio']:.3f}; launches "
          f"{launches} ({card})")
    return {**res, "launches": launches}


PHASE_SECONDS: dict = {}


def timed(name: str, fn, *args):
    """``fn(*args)``, its wall time kept under ``name``."""
    t0 = time.perf_counter()
    out = fn(*args)
    PHASE_SECONDS[name] = PHASE_SECONDS.get(name, 0.0) \
        + time.perf_counter() - t0
    return out


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (the port's smoke run "
                         "has no CPU fallback)")
    card = card_line()
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device {torch.cuda.get_device_name(0)} x "
          f"{torch.cuda.device_count()}")
    dev = torch.device("cuda", 0)

    # 1. build
    t0 = time.perf_counter()
    lib = library()
    build_s = time.perf_counter() - t0
    regs = [ln.strip() for ln in lib.ptxas_log.splitlines()
            if "registers" in ln or "Compiling entry" in ln]
    print(f"[build] nvcc sm_90a: {build_s:.2f} s ({lib.path.name}; {card})")
    for ln in regs:
        print(f"[build] {ln}")

    # 2. each kernel against its plain version at the main paths' shapes
    cell, ul_cell = DlCell(), UlCell()
    cfg = cell.cfg
    dl_sgn, _ = dl_demap_plans(cfg, cell.re_idx, cell.geom, seq.pdsch_c_init(
        cell.rnti, cell.subframe, cell.n_cell_id))
    ul_dec = make_pusch_batch_decoder(*ul_cell.decoder_args(), device="cpu")
    demap_ul = timed("check_demap", check_demap, "demap (UL shape)",
                     ul_dec.ul_front.sgn.numpy(), ul_cell.alloc.n_re,
                     ul_cell.alloc.scheme, dev)
    kernels = [timed("check_demap", check_demap, "demap", dl_sgn,
                     cfg.n_sym_subframe * cfg.n_sc, cell.scheme, dev),
               timed("check_turbo", check_turbo, cell, dev),
               *timed("check_pss", check_pss, dev),
               timed("check_resample", check_resample, dev),
               timed("check_acs_probe", check_acs_probe, dev)]
    for k in [*kernels, demap_ul]:
        lib_ms = k["library_ms"]
        how = (f"within {k['max_rel_err_of_peak']:.2e} of the peak (limit "
               f"{k['tolerance_of_peak']}), root and index equal"
               if "tolerance_of_peak" in k else "bit-exact")
        print(f"[kernel] {k['name']} {k['shape']}: {how} vs plain; "
              f"kernel {k['ms']:.4f} ms, plain {k['plain_ms']:.4f} ms, "
              f"bound {k['bound_ms']:.4f} ms by {k['bound_by']} "
              f"({k['bytes'] / 1e6:.1f} MB, {k['ops'] / 1e9:.2f} G "
              f"operations), library call "
              f"{'none' if lib_ms is None else f'{lib_ms:.4f} ms'} ({card})")
    acs = kernels[-1]
    print(f"[kernel] acs_probe bf16 (packed pairs): bit-exact vs plain at "
          f"{PROBE_ROUNDS} rounds; kernel {acs['bf16_ms']:.4f} ms, plain "
          f"{acs['bf16_plain_ms']:.4f} ms, bound {acs['bf16_bound_ms']:.4f} "
          f"ms by {acs['bf16_bound_by']}; f32 {acs['tops']:.2f} and bf16 "
          f"{acs['bf16_tops']:.2f} T add/max per s, ratio "
          f"{acs['bf16_over_f32']:.3f} ({card})")

    # 3. the main paths, each with its launch counts
    dl = timed("dl", run_dl, cell, dev, card)
    launches = dict(dl["launches"])
    scan_out = timed("scanner", run_scanner, dev, card)
    launches.update(scan_out["launches"])
    sweep = timed("sweep", run_sweep, dev, card)
    launches["pss_detect_bf16"] = sweep["launches"]
    launches["pss_detect"] = sweep["f32"]["launches"]
    ul = timed("ul", run_ul, ul_cell, dev, card)
    harq = timed("harq", run_harq, cell, dev, card)
    probe = timed("probe", run_probe, dev, card)
    print("[phases] seconds: " + ", ".join(
        f"{k} {v:.1f}" for k, v in PHASE_SECONDS.items()))
    launches["acs_probe"] = probe["launches"]
    launches["demap (UL shape)"] = ul["launches"]["demap"]
    by_path = {name: {"dl": dl["launches"][name], "ul": ul["launches"][name],
                      "harq": harq["launches"][name]}
               for name in ("demap", "turbo_half_iteration")}

    extra = ("bytes", "ops", "shape", "tops", "bf16_over_f32", "library",
             "max_rel_err_of_peak", "sum_rel_err", "tolerance_of_peak",
             "peaks_moved_vs_f32")
    print(json.dumps({"kernels": [
        {"name": k["name"], "route": "cuda", "source": SOURCES[k["name"]][0],
         "replaces": SOURCES[k["name"]][1], "launches": launches[k["name"]],
         **({"launches_by_path": by_path[k["name"]]}
            if k["name"] in by_path else {}),
         **{key: k[key] for key in k
            if key in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                       "bound_by", "library_ms") + extra
            or key.startswith("bf16_")}} for k in [*kernels, demap_ul]],
        "demap_ul_shape": {key: demap_ul[key] for key in
                           ("shape", "ms", "plain_ms", "bound_ms",
                            "bound_by", "max_abs_err")},
        "decode_ms": dl["decode_ms"], "decode_p90_ms": dl["decode_p90_ms"],
        "mbit_per_s": dl["mbit_per_s"], "peak_gb": dl["peak_gb"],
        "n_iter": dl["n_iter"], "syncs": dl["syncs"],
        "front_ms": dl["front_ms"],
        "ul": {key: ul[key] for key in
               ("decode_ms", "decode_p90_ms", "mbit_per_s", "front_ms",
                "peak_gb", "n_iter", "syncs", "retries")},
        "harq": {key: harq[key] for key in
                 ("snr_db", "combined_ms", "single_ms", "ratio", "n_iter",
                  "combined_front_ms", "single_front_ms")},
        "probe": {"f32_ms": probe["f32"]["ms"], "bf16_ms": probe["bf16"]["ms"],
                  "f32_tops": probe["f32"]["tops"],
                  "bf16_tops": probe["bf16"]["tops"],
                  "ratio": probe["ratio"]},
        "scan_ms_per_channel": scan_out["wall_s"] * 1e3 / (N_LIVE + N_DEAD),
        "scan_stage_s": scan_out["stages"],
        "scan_host_reads": scan_out["reads"],
        "find_pss_f32_idx_moved": scan_out["find_pss_f32_idx_moved"],
        "sweep_ms": sweep["median_ms"], "sweep_msps": sweep["msps"],
        "sweep_f32_ms": sweep["f32"]["median_ms"],
        "sweep_f32_msps": sweep["f32"]["msps"],
        "sweep_moved_vs_f32": sweep["moved_vs_f32"],
        "build_s": build_s, "phase_s": PHASE_SECONDS, "card": card}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    sys.exit(main())
