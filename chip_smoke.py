#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``lteax_torch/kernels/csrc`` with nvcc
(sm_90a, one nvcc per source, in parallel), holds each kernel against its
plain torch version on the card at the main paths' shapes, then drives
three paths, each with the launch counters set to 0 just before it and
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
3. The PSS band sweep (``lteax_torch.bench.scan_throughput.detect``, the
   fused detect kernel) over 128 carriers x 20 subframes of 20 MHz: every
   carrier must give root 1 at the inserted index.

Any failure raises (exit code != 0).  Every timing line carries the card's
name and power limit.  The last line is one JSON object naming the
device; the one before it lists the kernels with their launch counts,
errors and times.
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
import lteax_torch.kernels.demap as demap_mod
import lteax_torch.kernels.polyphase as poly_mod
import lteax_torch.kernels.pss as pss_mod
import lteax_torch.kernels.turbo_mlm as turbo_mod
from lteax.io.iq import write_iq
from lteax_torch import host
from lteax.phy.config import PhyConfig
from lteax_torch.bench import scan_throughput
from lteax_torch.kernels._build import library
from lteax_torch.pipeline import dl_demap_plans, make_batch_decoder
from lteax_torch.phy import seq
from lteax_torch.phy.sync import pss_time_filters
from lteax_torch.sim import cell_gen
from lteax_torch.sim.dl_gen import DlCell, dl_subframes

BATCH = 256
SNR_DB = 25.0
SEED = 0
DECODE_REPS = 110     # median and p90 each with >= 10 samples beyond

SCAN_CFG = PhyConfig(n_rb_dl=100)
SDR_RATE = 20e6       # the captures' rate; the scanner resamples 192/125
SCAN_S = 0.02         # 20 ms per capture
N_LIVE, N_DEAD = 12, 4
SWEEP_CARRIERS, SWEEP_SF, SWEEP_REPS = 128, 20, 5
PSS_CHECK_SHAPE = (4, 20 * SCAN_CFG.n_samps_subframe)   # K4/K5 vs plain
RESAMPLE_CHECK_SHAPE = (16, 400_000)                    # K6 vs plain, 192/125
WORK = Path(__file__).resolve().parent / "build" / "chip_smoke"

SOURCES = {
    "demap": ("lteax_torch/kernels/csrc/demap.cu",
              "lteax/kernels/demap.py:68"),
    "turbo_half_iteration": ("lteax_torch/kernels/csrc/turbo.cu",
                             "lteax/kernels/turbo_mlm.py:536"),
    "pss_corr_mag": ("lteax_torch/kernels/csrc/pss.cu",
                     "lteax/kernels/pss.py:55"),
    "pss_detect": ("lteax_torch/kernels/csrc/pss.cu",
                   "lteax/kernels/pss.py:134"),
    "resample_poly": ("lteax_torch/kernels/csrc/polyphase.cu",
                      "lteax/kernels/polyphase.py:60"),
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
    return {"name": "resample_poly", "shape": [*RESAMPLE_CHECK_SHAPE, 192,
                                                125],
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms}


def check_pss(dev) -> list[dict]:
    """PSS correlator and detect kernels vs plain at 4 carriers x 20
    subframes of 20 MHz (nf = 2048), bit for bit."""
    filt = pss_time_filters(SCAN_CFG)
    x = _complex_noise(PSS_CHECK_SHAPE, SEED + 3, dev)
    for c in range(PSS_CHECK_SHAPE[0]):
        x[c, 5000 + 7919 * c:5000 + 7919 * c + filt.shape[1]] += \
            30.0 * torch.as_tensor(filt[c % 3], device=dev)
    out = []
    got = pss_mod.pss_corr_mag(x, filt)
    ref = pss_mod.pss_corr_mag_plain(x, filt)
    torch.cuda.synchronize()
    err = max_abs_err(got, ref)
    if not torch.equal(got, ref):
        raise AssertionError(f"PSS correlator kernel != plain: max |err| "
                             f"{err}")
    del got, ref
    out.append({"name": "pss_corr_mag", "shape": list(PSS_CHECK_SHAPE),
                "max_abs_err": err,
                "ms": cuda_time_ms(lambda: pss_mod.pss_corr_mag(x, filt), 5),
                "plain_ms": cuda_time_ms(
                    lambda: pss_mod.pss_corr_mag_plain(x, filt), 1, 0)})
    got = pss_mod.pss_detect(x, filt)[:3]
    ref = pss_mod.pss_detect_plain(x, filt)
    torch.cuda.synchronize()
    errs = [max_abs_err(g, r) for g, r in zip(got, ref)]
    if not all(torch.equal(g, r) for g, r in zip(got, ref)):
        raise AssertionError(f"PSS detect kernel != plain (max, argmax, "
                             f"sum): max |err| {errs}")
    nid2, idx, _, _ = pss_mod.pss_reduce_combine(*got, pss_mod.TILE,
                                                 PSS_CHECK_SHAPE[1])
    want = [5000 + 7919 * c for c in range(PSS_CHECK_SHAPE[0])]
    if nid2.tolist() != [c % 3 for c in range(PSS_CHECK_SHAPE[0])] or \
            any(abs(i - w) > 2 for i, w in zip(idx.tolist(), want)):
        raise AssertionError(f"PSS detect found {nid2.tolist()} at "
                             f"{idx.tolist()}, inserted at {want}")
    out.append({"name": "pss_detect", "shape": list(PSS_CHECK_SHAPE),
                "max_abs_err": max(errs),
                "ms": cuda_time_ms(lambda: pss_mod.pss_detect(x, filt), 5),
                "plain_ms": cuda_time_ms(
                    lambda: pss_mod.pss_detect_plain(x, filt), 1, 0)})
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
    from lteax.io.iq import read_iq
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


def run_scanner(dev, card: str) -> dict:
    """The scanner path: 16 channels through scan_channels(prescan=True)."""
    t0 = time.perf_counter()
    chans, caps = scanner_captures()
    print(f"[scan-gen] {len(chans)} captures of {SCAN_S * 1e3:.0f} ms at "
          f"{SDR_RATE / 1e6:.0f} Msps: {time.perf_counter() - t0:.2f} s")
    runs = []
    for run in range(2):          # run 0 warms caches; run 1 is reported
        scanner.STAGE_SECONDS.clear()
        host.READS = 0
        poly_mod.LAUNCHES = pss_mod.CORR_LAUNCHES = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        reports = scanner.scan_channels(chans, SCAN_CFG, prescan=True,
                                        device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {"resample_poly": poly_mod.LAUNCHES,
                    "pss_corr_mag": pss_mod.CORR_LAUNCHES}
        check_scan_reports(reports, caps)
        for name, cnt in launches.items():
            if cnt <= 0:
                raise AssertionError(f"the scanner path never launched "
                                     f"{name}")
        runs.append({"wall_s": wall, "stages": dict(scanner.STAGE_SECONDS),
                     "reads": host.READS,
                     "launches": launches})
    n = len(chans)
    for tag, r in zip(("first", "second"), runs):
        st = r["stages"]
        print(f"[scanner] {tag} run: {N_LIVE}/{N_LIVE} live cells with the "
              f"sent id, n_ant and MIB, {N_DEAD}/{N_DEAD} dead flagged; wall "
              f"{r['wall_s'] * 1e3 / n:.2f} ms per channel (resample "
              f"{st.get('resample', 0) * 1e3 / n:.2f}, prescan "
              f"{st.get('prescan', 0) * 1e3 / n:.2f}, scan "
              f"{st.get('scan', 0) * 1e3 / N_LIVE:.2f} per live channel); "
              f"host reads {r['reads']} ({r['reads'] / n:.2f} per channel); "
              f"launches {r['launches']} ({card})")
    diffs = scan_card_vs_cpu(chans[0], dev, card)
    return {**runs[1], "first_wall_s": runs[0]["wall_s"],
            "cpu_vs_card": diffs}


def run_sweep(dev, card: str) -> dict:
    """The band sweep: 128 carriers x 20 subframes through the detect
    kernel.  Every carrier must give root 1, and the same index as the
    plain version on the same samples, within the PSS correlation's main
    lobe (+-8 of 2048/62 = 33 samples) of the inserted PSS start: at the
    reference synthesis's noise level the lobe's top is flat to ~0.3% per
    sample, below the noise, so the exact sample is the noise's choice."""
    length = SWEEP_SF * SCAN_CFG.n_samps_subframe
    t0 = time.perf_counter()
    x_np, want = scan_throughput.sweep_signal(SCAN_CFG, SWEEP_CARRIERS,
                                              length, seed=SEED)
    x = torch.from_numpy(x_np).to(dev)
    del x_np
    print(f"[sweep-gen] {SWEEP_CARRIERS} x {length} samples "
          f"({x.numel() * 8 / 1e6:.0f} MB): {time.perf_counter() - t0:.2f} s")
    pss_mod.DETECT_LAUNCHES = 0
    nid2, idx, _ = scan_throughput.detect(x, SCAN_CFG)
    nid2, idx = nid2.tolist(), idx.tolist()
    launches = pss_mod.DETECT_LAUNCHES
    filt = pss_time_filters(SCAN_CFG)
    ref_idx = []
    for c0 in range(0, SWEEP_CARRIERS, 16):
        parts = pss_mod.pss_detect_plain(x[c0:c0 + 16], filt)
        ref_idx += pss_mod.pss_reduce_combine(*parts, pss_mod.TILE,
                                              length)[1].tolist()
    dev_from_sent = [i - int(w) for i, w in zip(idx, want)]
    bad = [c for c in range(SWEEP_CARRIERS)
           if nid2[c] != 1 or idx[c] != ref_idx[c]
           or abs(dev_from_sent[c]) > 8]
    if bad or launches <= 0:
        raise AssertionError(f"sweep: carriers {bad} wrong (launches "
                             f"{launches})")
    times = []
    for _ in range(SWEEP_REPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        scan_throughput.detect(x, SCAN_CFG)[2].cpu()
        times.append(time.perf_counter() - t0)
    t = float(np.median(times))
    msps = SWEEP_CARRIERS * length / t / 1e6
    exact = sum(d == 0 for d in dev_from_sent)
    off = {c: d for c, d in enumerate(dev_from_sent) if d}
    print(f"[sweep] {SWEEP_CARRIERS} carriers x {SWEEP_SF} sf: all root 1, "
          f"index equal to the plain version's on all; {exact} exactly at "
          f"the inserted PSS start, the rest (carrier: samples off) {off}; "
          f"median "
          f"{t * 1e3:.2f} ms per sweep (n={len(times)}) = {msps:.1f} Msps "
          f"({card})")
    return {"median_ms": t * 1e3, "msps": msps, "launches": launches,
            "exact_idx": exact}


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
    cell = DlCell()
    kernels = [check_demap(cell, dev), check_turbo(cell, dev),
               *check_pss(dev), check_resample(dev)]
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

    # 6. the scanner path, 7. the sweep path
    scan_out = run_scanner(dev, card)
    launches.update(scan_out["launches"])
    sweep = run_sweep(dev, card)
    launches["pss_detect"] = sweep["launches"]

    print(json.dumps({"kernels": [
        {"name": k["name"], "route": "cuda", "source": SOURCES[k["name"]][0],
         "replaces": SOURCES[k["name"]][1], "launches": launches[k["name"]],
         "max_abs_err": k["max_abs_err"], "ms": k["ms"],
         "plain_ms": k["plain_ms"]} for k in kernels],
        "decode_ms": t_med * 1e3, "decode_p90_ms": t_p90 * 1e3,
        "mbit_per_s": mbps, "peak_gb": decode_gb, "n_iter": n_iter,
        "syncs": stats.syncs,
        "scan_ms_per_channel": scan_out["wall_s"] * 1e3 / (N_LIVE + N_DEAD),
        "scan_stage_s": scan_out["stages"],
        "scan_host_reads": scan_out["reads"],
        "sweep_ms": sweep["median_ms"], "sweep_msps": sweep["msps"],
        "build_s": build_s, "card": card}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    sys.exit(main())
