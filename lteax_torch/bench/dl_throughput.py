"""DL-SCH decode throughput at the ``bench.py`` configuration: the port's
bench CLI.

    python -m lteax_torch.bench.dl_throughput [--batch 256] [--reps 10]
        [--iters 6] [--snr-db 25] [--iq f32|bf16|sc8] [--trace DIR]
        [--device cpu]

20 MHz, 100 PRB, MCS 28 (TBS 75376, 64QAM, C=13 x K=5824), cfi 1, cell
214, subframe 1, RNTI 0x1234 (``bench.py:49-54``); 64 distinct subframes
from numpy seed 0 tiled to the batch, AWGN at 25 dB
(``lteax_torch.sim.dl_gen``, the recipe of ``bench.py:67-113``), staged
as ``--iq`` says (f32 by default; ``bench.py:101-109`` stages bf16 or sc8:
``bench/timing.py::stage_iq``).
The decoder is ``make_batch_decoder`` on the card (``--device cpu``: a dry
run of the plain versions).  Prints one JSON line shaped like
``bench.py``'s: the metric, the rate of decoded bits (TBS times the
transport blocks that pass their CRC) over the median decode time in
Mbit/s per GPU, ``vs_baseline`` over the 75.376 Mbit/s real-time rate of
this configuration, the CRC count of the warm-up decode and whether the
bits of the blocks that pass equal those sent, ``n_iter``, the
batch, the IQ staging and the card's name and power limit; ``--trace
DIR`` writes a Chrome trace of the timed decodes (``decode_batch`` ranges,
the kernels) into DIR.
"""

from __future__ import annotations

import argparse
import json
import sys


from lteax_torch.bench.timing import (IQ_FORMATS, add_numerics_args,
                                      bench_decode, numerics,
                                      numerics_fields, stage_iq)
from lteax_torch.pipeline import make_batch_decoder
from lteax_torch.sim.dl_gen import DlCell, dl_subframes

REAL_TIME_MBIT_S = 75.376


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--iters", type=int, default=6)
    ap.add_argument("--snr-db", type=float, default=25.0)
    ap.add_argument("--iq", default="f32", choices=IQ_FORMATS,
                    help="IQ staging of the device boundary "
                         "(bench/timing.py::stage_iq)")
    ap.add_argument("--trace", default=None, metavar="DIR",
                    help="profile the timed decodes into a Chrome trace "
                         "in DIR")
    ap.add_argument("--device", default=None,
                    help="default: the current CUDA device")
    add_numerics_args(ap)
    a = ap.parse_args(argv)
    cell = DlCell()
    dec = make_batch_decoder(*cell.decoder_args(), n_iter=a.iters,
                             tuning=numerics(a), device=a.device)
    iq, tb = dl_subframes(cell, a.batch, a.snr_db, seed=0)
    res = bench_decode(dec, stage_iq(iq, a.iq).to(dec.device), tb, a.reps,
                       a.trace)
    print(f"crc ok {res['crc_ok']}/{a.batch}, bits equal sent: "
          f"{res['bits_equal']}, n_iter {res['n_iter']}/{a.iters}; median "
          f"{res['median_ms']:.3f} ms, p90 {res['p90_ms']:.3f} (n={a.reps})",
          file=sys.stderr)
    value = round(res["mbit_per_s"], 2)
    out = {"metric": "decoded DL-SCH throughput, 20 MHz MCS28 (TBS 75376), "
                     f"turbo max-6-iter with CRC early stop, {a.iq} IQ in",
           "value": value, "unit": res["unit"],
           # the ratio of the value as printed, so that the line agrees
           # with itself whatever the rounding
           "vs_baseline": round(value / REAL_TIME_MBIT_S, 3),
           "crc_ok": res["crc_ok"], "bits_equal": res["bits_equal"],
           "n_iter": res["n_iter"],
           "batch": a.batch, "iq": a.iq, **numerics_fields(a),
           "card": res["card"],
           "trace": res["trace"]}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
