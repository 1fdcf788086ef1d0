"""HARQ IR combining overhead against the single-rv decode: the port's
counterpart of ``bench/harq_throughput.py``.

    python -m lteax_torch.bench.harq_throughput [--batch 384] [--snr-db 25]
        [--reps 10] [--depth 2] [--device cpu]

The production HARQ decoder (``pipeline.make_batch_harq_decoder``: one
front per transmission, the d-domain soft combine, one turbo batch)
against the single-rv decoder (``make_batch_decoder``) at the reference's
geometry: 20 MHz, 100 PRB, MCS 28 (TBS 75376), cfi 1, cell 214, RNTI
0x1234, the same transport blocks sent in subframe 1 at rv 0 and in
subframe 2 at rv 2 (``sim.dl_gen.harq_transmissions``: 32 distinct blocks
from numpy seed 0 tiled to the batch, AWGN at ``--snr-db``), IQ staged in
bf16 as the reference stages it (``bench/timing.py::stage_iq``), 6 turbo
iterations.  Each decoder runs
``--reps`` calls with up to ``--depth`` results in flight before their CRC
flags are read (the reference's sustained mode; the port's decoders read
their early-stop flags on the way, so little is left in flight).  Prints
one JSON line: the combined decoder's decoded Mbit/s (TBS times the blocks
that pass their CRC, over the time a call), the single-rv decoder's, and
the overhead ratio of their times, with the card's name and power limit;
``--device cpu`` is a dry run and says so.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from lteax_torch.bench.timing import (add_numerics_args, card_line,
                                      numerics, numerics_fields, stage_iq)
from lteax_torch.pipeline import make_batch_decoder, make_batch_harq_decoder
from lteax_torch.sim.dl_gen import (DlCell, harq_decoder_args,
                                    harq_transmissions)

SUBFRAMES, RVS = (1, 2), (0, 2)
N_ITER = 6
IQ = "bf16"


def sustain(dec, x: torch.Tensor, reps: int, depth: int):
    """-> (seconds a call, CRC passes and turbo iterations of the warm-up
    call): ``reps`` calls with at most ``depth`` CRC flag tensors pending
    before each is read."""
    _, ok, n_iter = dec(x)
    t0 = time.perf_counter()
    pend = []
    for _ in range(reps):
        pend.append(dec(x)[1])
        if len(pend) > depth:
            pend.pop(0).cpu()
    for p in pend:
        p.cpu()
    return (time.perf_counter() - t0) / reps, int(ok.sum()), n_iter


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=384)
    ap.add_argument("--snr-db", type=float, default=25.0)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--depth", type=int, default=2)
    ap.add_argument("--device", default=None,
                    help="default: the current CUDA device")
    add_numerics_args(ap)
    a = ap.parse_args(argv)
    cells = [DlCell(subframe=sf, rv=rv) for sf, rv in zip(SUBFRAMES, RVS)]
    dec_h = make_batch_harq_decoder(*harq_decoder_args(cells),
                                    n_iter=N_ITER, tuning=numerics(a),
                                    device=a.device)
    dec_1 = make_batch_decoder(*cells[0].decoder_args(), n_iter=N_ITER,
                               tuning=numerics(a), device=a.device)
    print(f"building 32 distinct subframes x {len(RVS)} rvs (tiled to "
          f"{a.batch})...", file=sys.stderr)
    iq, _, _ = harq_transmissions(cells[0], SUBFRAMES, RVS, a.batch,
                                  a.snr_db, seed=0)
    x = stage_iq(iq, IQ).to(dec_h.device)
    t_h, ok_h, it_h = sustain(dec_h, x, a.reps, a.depth)
    t_1, ok_1, it_1 = sustain(dec_1, x[0], a.reps, a.depth)
    tbs = cells[0].geom.tbs
    mbps_h, mbps_1 = ok_h * tbs / t_h / 1e6, ok_1 * tbs / t_1 / 1e6
    print(f"single-rv: {t_1 * 1e3:.2f} ms/batch ({mbps_1:.1f} Mbit/s, crc "
          f"{ok_1}/{a.batch}); HARQ rv0+rv2: {t_h * 1e3:.2f} ms/batch "
          f"({mbps_h:.1f} Mbit/s, crc {ok_h}/{a.batch})", file=sys.stderr)
    on_card = x.device.type == "cuda"
    out = {"metric": "HARQ IR (rv0+rv2) combining overhead, 20 MHz MCS28, "
                     f"{IQ} IQ in",
           "value": round(mbps_h, 2),
           "unit": "Mbit/s/GPU" if on_card else "Mbit/s/CPU (dry run)",
           "single_rv_mbps": round(mbps_1, 2),
           "overhead_ratio": round(t_h / t_1, 3),
           "combined_ms": t_h * 1e3, "single_ms": t_1 * 1e3,
           "crc_ok": ok_h, "single_crc_ok": ok_1, "n_iter": it_h,
           "single_n_iter": it_1, "batch": a.batch,
           "depth": a.depth, "iq": IQ, **numerics_fields(a),
           "card": card_line() if on_card else "cpu"}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
