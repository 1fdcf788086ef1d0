"""Where a decode's time goes on the card: device time by kernel, the
device's busy share of the wall, and the host's operators by their own CPU
time.

    python -m lteax_torch.bench.decode_profile [--batch 256] [--reps 10]
        [--path dl|ul-single|ul-uci|ctrl]

``dl`` (default) decodes ``--batch`` subframes of the headline
configuration (20 MHz, MCS 28, 25 dB, seed 0); ``ul-single`` / ``ul-uci``
one subframe of the UL cell (100 PRB, TBS 75376, 25 dB) per call through
``pusch.pusch_decode`` / ``pusch_decode_uci`` (2 ACK, 1 RI bits); ``ctrl``
one blind decode (DCI 2, C-RNTI space) of a 20 MHz control region from
``sim/ctrl_gen.py``.  Each runs ``--reps`` times under ``torch.profiler``
(CPU and CUDA activities) after a warm-up, and prints the wall per call
(host clock around synchronised calls, profiler on), the sum of device
kernel time per call, their ratio (the device's busy share), the kernels
by device time and the host operators by self CPU time.  One JSON object
on the last line.  The profiler slows the host side, so the wall here is
above ``chip_smoke.py``'s; the device times are the kernels' own.
"""

from __future__ import annotations

import argparse
import json
import time

import torch
from torch.profiler import ProfilerActivity, profile

import numpy as np

from lteax_torch.bench.timing import card_line
from lteax_torch.pipeline import make_batch_decoder
from lteax_torch.sim.dl_gen import DlCell, dl_subframes


def _decode_dl(batch: int):
    cell = DlCell()
    iq, _ = dl_subframes(cell, batch, 25.0, seed=0)
    dec = make_batch_decoder(*cell.decoder_args())
    x = torch.from_numpy(iq).cuda()
    return lambda: dec(x)[1]


def _decode_ul(uci: bool):
    from lteax_torch.phy.channels import pusch
    from lteax_torch.sim.ul_gen import UlCell, ul_subframes
    cell = UlCell()
    u = pusch.PuschUci(n_ack=2, n_ri=1) if uci else None
    iq, _ = ul_subframes(cell, 1, 25.0, seed=0, uci=u, ack=(1, 0), ri=(1,))
    g = torch.from_numpy(iq[0, ..., 0] + 1j * iq[0, ..., 1]).cuda()
    if uci:
        return lambda: pusch.pusch_decode_uci(g, *cell.decoder_args(), u)[1]
    return lambda: pusch.pusch_decode(g, *cell.decoder_args())[1]


def _decode_ctrl():
    from lteax_torch.phy.channels import pdcch
    from lteax_torch.phy.config import PhyConfig
    from lteax_torch.phy.grid import pdcch_flat_idx
    from lteax_torch.phy.mod import demodulate_maxlog
    from lteax_torch.sim import ctrl_gen
    cfg, cid, cfi, ng, sf = PhyConfig(n_rb_dl=100), 301, 3, 1.0, 6
    rng = np.random.default_rng(0)
    dcis = ctrl_gen.ue_dci_plan(cfg, cid, cfi, ng, sf, [("2", 4)], [], rng)
    grid = ctrl_gen.ctrl_subframe(cfg, cid, cfi, ng, sf, dcis,
                                  np.zeros((13, 8), int))
    y = torch.from_numpy(grid.reshape(-1)[pdcch_flat_idx(
        cfg, cid, cfi, ng).reshape(-1)]).cuda()
    logical = pdcch.pdcch_llrs_to_logical(demodulate_maxlog(y, "qpsk") * 4,
                                          cfg, cid, cfi, ng, sf)
    n_cce = pdcch.n_cce(cfg, cid, cfi, ng)
    return lambda: torch.tensor(bool(pdcch.pdcch_blind_decode_2(
        logical, 100, dcis[0].rnti, n_cce, subframe=sf)))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--top", type=int, default=12)
    ap.add_argument("--path", default="dl",
                    choices=("dl", "ul-single", "ul-uci", "ctrl"))
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("decode_profile: needs a CUDA device")
    card = card_line()
    run = {"dl": lambda: _decode_dl(a.batch),
           "ul-single": lambda: _decode_ul(False),
           "ul-uci": lambda: _decode_ul(True), "ctrl": _decode_ctrl}[a.path]()
    for _ in range(3):
        ok = run()
    if not bool(ok.all()):
        raise AssertionError("decode_profile: a decode failed")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(a.reps):
            run()
            torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / a.reps
    # device-side events only: an operator's entry repeats its kernels' time
    rows = [(e.key, e.self_device_time_total / 1e3 / a.reps, e.count / a.reps)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.self_device_time_total > 0]
    rows.sort(key=lambda r: -r[1])
    device_ms = sum(r[1] for r in rows)
    if device_ms <= 0:
        raise AssertionError("decode_profile: the profiler saw no device time")
    for name, ms, cnt in rows[:a.top]:
        print(f"{ms:8.4f} ms  {100 * ms / device_ms:5.1f}%  x{cnt:6.1f}  "
              f"{name[:90]}")
    host = [(e.key, e.self_cpu_time_total / 1e3 / a.reps, e.count / a.reps)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CPU]
    host.sort(key=lambda r: -r[1])
    for name, ms, cnt in host[:a.top]:
        print(f"host {ms:8.4f} ms  x{cnt:6.1f}  {name[:80]}")
    print(json.dumps({
        "card": card, "path": a.path, "batch": a.batch, "reps": a.reps,
        "wall_ms": wall_ms,
        "device_ms": device_ms, "device_busy_share": device_ms / wall_ms,
        "launches_per_decode": sum(r[2] for r in rows),
        "top": [{"name": n[:60], "ms": ms, "per_decode": c}
                for n, ms, c in rows[:a.top]],
        "host_top": [{"name": n[:60], "ms": ms, "per_decode": c}
                     for n, ms, c in host[:a.top]]}))


if __name__ == "__main__":
    main()
