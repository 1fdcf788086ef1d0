#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``lteax_torch/kernels/csrc`` with nvcc
(sm_90a), holds each kernel against its plain torch version on the card at
the main path's shapes, then drives the DL-SCH decoder through
``lteax_torch.pipeline.make_batch_decoder`` at the ``bench.py`` headline
configuration (20 MHz, 100 PRB, MCS 28, TBS 75376, C=13 x K=5824) on a
batch of 256 subframes at 25 dB from ``lteax_torch.sim.dl_gen`` (seed 0).
It checks that every transport block decodes to the bits that were sent,
that the decode went through both kernels, and that the card's decode of a
small slice equals the CPU's; then it times the decode and each kernel
against its plain version.  Any failure raises (exit code != 0).  The last
line is one JSON object naming the device; the one before it lists the
kernels with their launch counts, errors and times.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

import lteax_torch.kernels.demap as demap_mod
import lteax_torch.kernels.turbo_mlm as turbo_mod
from lteax_torch.kernels._build import library
from lteax_torch.pipeline import dl_demap_plans, make_batch_decoder
from lteax_torch.phy import seq
from lteax_torch.sim.dl_gen import DlCell, dl_subframes

BATCH = 256
SNR_DB = 25.0
SEED = 0
DECODE_REPS = 110     # median and p90 each with >= 10 samples beyond


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


def check_demap(cell: DlCell, dev) -> dict:
    """Demap kernel vs plain at the main path's shape: (256, 16800) 64QAM
    with the headline cell's sign planes (zeros off the PDSCH)."""
    cfg, geom = cell.cfg, cell.geom
    sgn, _ = dl_demap_plans(cfg, cell.re_idx, geom, seq.pdsch_c_init(
        cell.rnti, cell.subframe, cell.n_cell_id))
    n = cfg.n_sym_subframe * cfg.n_sc
    rng = np.random.default_rng(SEED)
    t = lambda x: torch.as_tensor(x.astype(np.float32), device=dev)
    xr = t(rng.standard_normal((BATCH, n)) * 0.7)
    xi = t(rng.standard_normal((BATCH, n)) * 0.7)
    inv_nv = t(rng.uniform(10.0, 1000.0, (BATCH, n)))
    sgn = t(sgn)
    got = demap_mod.demap_planar(xr, xi, inv_nv, sgn, cell.scheme)
    ref = demap_mod.demap_planar_plain(xr, xi, inv_nv, sgn, cell.scheme)
    torch.cuda.synchronize()
    if not torch.equal(got, ref):
        raise AssertionError(f"demap kernel != plain: max |err| "
                             f"{max_abs_err(got, ref)}")
    ms = cuda_time_ms(lambda: demap_mod.demap_planar(xr, xi, inv_nv, sgn,
                                                     cell.scheme), 50)
    plain_ms = cuda_time_ms(lambda: demap_mod.demap_planar_plain(
        xr, xi, inv_nv, sgn, cell.scheme), 10)
    return {"name": "demap", "shape": [BATCH, n, geom.qm],
            "max_abs_err": max_abs_err(got, ref), "ms": ms,
            "plain_ms": plain_ms}


def check_turbo(cell: DlCell, dev) -> dict:
    """Half-iteration kernel vs plain at the main path's shape:
    C = 13 * 256 = 3328 codeblocks, K = 5824 (n = K+3 trellis steps)."""
    geom = cell.geom
    c, n, win, acq = geom.info.c * BATCH, geom.k + 3, 128, 16
    n_w = -(-n // win)
    rng = np.random.default_rng(SEED + 1)
    t = lambda x: torch.as_tensor(x.astype(np.float32), device=dev)
    u = t(rng.standard_normal((c, n)) * 8.0)
    v = t(rng.standard_normal((c, n)) * 8.0)
    a0 = t(-np.abs(rng.standard_normal((c, n_w, 8))) * 4.0)
    b0 = t(-np.abs(rng.standard_normal((c, n_w, 8))) * 4.0)
    a0, b0 = turbo_mod._pin_boundaries(a0, b0)
    got = turbo_mod.half_iteration_raw(u, v, a0, b0, win, acq)
    ref = turbo_mod.half_iteration_plain(u, v, a0, b0, win, acq)
    torch.cuda.synchronize()
    errs = [max_abs_err(g, r) for g, r in zip(got, ref)]
    if not all(torch.equal(g, r) for g, r in zip(got, ref)):
        raise AssertionError(f"turbo kernel != plain (L, a_nii, b_nii): "
                             f"max |err| {errs}")
    ms = cuda_time_ms(lambda: turbo_mod.half_iteration_raw(u, v, a0, b0,
                                                           win, acq), 20)
    plain_ms = cuda_time_ms(lambda: turbo_mod.half_iteration_plain(
        u, v, a0, b0, win, acq), 3)
    return {"name": "turbo_half_iteration", "shape": [c, n, win, acq],
            "max_abs_err": max(errs), "ms": ms, "plain_ms": plain_ms}


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

    # 2. each kernel against its plain version at the main path's shapes
    cell = DlCell()
    kernels = [check_demap(cell, dev), check_turbo(cell, dev)]
    for k in kernels:
        print(f"[kernel] {k['name']} {k['shape']}: bit-exact vs plain; "
              f"kernel {k['ms']:.4f} ms, plain {k['plain_ms']:.4f} ms "
              f"({card})")

    # 3. the main path: 256 subframes of the bench.py headline config
    t0 = time.perf_counter()
    iq, tb_ref = dl_subframes(cell, BATCH, SNR_DB, seed=SEED)
    print(f"[gen] {BATCH} subframes, TBS {cell.geom.tbs}, C={cell.geom.info.c}"
          f", K={cell.geom.k}, {SNR_DB} dB: {time.perf_counter() - t0:.2f} s")
    dec = make_batch_decoder(*cell.decoder_args(), device=dev)
    x = torch.from_numpy(iq).to(dev)
    torch.cuda.reset_peak_memory_stats()
    demap_mod.LAUNCHES = 0
    turbo_mod.LAUNCHES = 0
    bits, ok, n_iter = dec(x)
    torch.cuda.synchronize()
    first_gb = torch.cuda.max_memory_allocated() / 1e9
    launches = {"demap": demap_mod.LAUNCHES,
                "turbo_half_iteration": turbo_mod.LAUNCHES}
    stats = dec.last_stats
    n_ok = int(ok.sum())
    bits_ok = bool(np.array_equal(bits.cpu().numpy(), tb_ref))
    print(f"[decode] crc ok {n_ok}/{BATCH}, bits equal sent: {bits_ok}, "
          f"n_iter {n_iter}/{dec.n_iter}, host syncs {stats.syncs}, "
          f"compacted retries {stats.retries}, launches {launches}")
    if n_ok != BATCH or not bits_ok:
        raise AssertionError("the main path did not decode every TB")
    if bits.shape != (BATCH, cell.geom.tbs) or bits.dtype != torch.int8:
        raise AssertionError(f"tb_bits {tuple(bits.shape)} {bits.dtype}")
    for name, cnt in launches.items():
        if cnt <= 0:
            raise AssertionError(f"the main path never launched {name}")

    # 4. the card's decode of a small slice equals the CPU's (plain versions)
    small = slice(0, 4)
    dec_cpu = make_batch_decoder(*cell.decoder_args(), device="cpu")
    x_cpu = torch.from_numpy(iq[small])
    d_gpu = dec.front(x[small])
    d_cpu = dec_cpu.front(x_cpu)
    out_gpu = dec.turbo(d_gpu)
    out_cpu = dec_cpu.turbo(d_cpu)
    front_err = max_abs_err(d_gpu.cpu(), d_cpu)
    front_scale = float(d_cpu.abs().max())
    print(f"[cpu-vs-card] B=4: de-matched LLR max |diff| {front_err:.3e} "
          f"(max |LLR| {front_scale:.1f}); n_iter {out_gpu[2]} vs "
          f"{out_cpu[2]}")
    if not (torch.equal(out_gpu[0].cpu(), out_cpu[0])
            and torch.equal(out_gpu[1].cpu(), out_cpu[1])
            and out_gpu[2] == out_cpu[2]):
        raise AssertionError("card and CPU decodes of the same slice differ")
    if front_err > 1e-4 * front_scale:
        raise AssertionError("card and CPU fronts differ beyond FFT rounding")

    # 5. timing: the whole decode, host clock around synchronised calls
    torch.cuda.reset_peak_memory_stats()
    dec.front(x)
    torch.cuda.synchronize()
    front_gb = torch.cuda.max_memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(DECODE_REPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dec(x)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    decode_gb = torch.cuda.max_memory_allocated() / 1e9
    t_med = float(np.median(times))
    t_p90 = float(np.percentile(times, 90))
    mbps = BATCH * cell.geom.tbs / t_med / 1e6
    print(f"[timing] decode B={BATCH}: median {t_med * 1e3:.3f} ms/batch, "
          f"p90 {t_p90 * 1e3:.3f} (n={len(times)}), {mbps:.2f} Mbit/s "
          f"({card})")
    print(f"[memory] peak allocated: first decode {first_gb:.2f} GB, front "
          f"{front_gb:.2f} GB, steady decode {decode_gb:.2f} GB ({card})")
    front_ms = cuda_time_ms(lambda: dec.front(x), 5)
    print(f"[timing] front (OFDM..de-match) {front_ms:.3f} ms/batch ({card})")

    sources = {"demap": ("lteax_torch/kernels/csrc/demap.cu",
                         "lteax/kernels/demap.py:68"),
               "turbo_half_iteration": ("lteax_torch/kernels/csrc/turbo.cu",
                                        "lteax/kernels/turbo_mlm.py:536")}
    print(json.dumps({"kernels": [
        {"name": k["name"], "route": "cuda", "source": sources[k["name"]][0],
         "replaces": sources[k["name"]][1], "launches": launches[k["name"]],
         "max_abs_err": k["max_abs_err"], "ms": k["ms"],
         "plain_ms": k["plain_ms"]} for k in kernels],
        "decode_ms": t_med * 1e3, "decode_p90_ms": t_p90 * 1e3,
        "mbit_per_s": mbps, "peak_gb": decode_gb, "n_iter": n_iter,
        "syncs": stats.syncs, "build_s": build_s, "card": card}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    sys.exit(main())
