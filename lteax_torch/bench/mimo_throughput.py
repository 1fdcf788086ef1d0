"""2x2 dual-codeword DL-SCH decode throughput, 20 MHz: the port's
counterpart of ``bench/mimo_throughput.py``.

    python -m lteax_torch.bench.mimo_throughput [--batch 256] [--reps 6]
        [--iters 6] [--mcs 28] [--tm 3|4] [--cb-index 0] [--snr-db 25]
        [--cmat bench|corr|8 numbers] [--detector mmse|sic]
        [--iq f32|bf16|sc8] [--trace DIR] [--device cpu]

The signal is ``lteax_torch.sim.mimo_gen`` at the script's recipe (seed 0,
16 distinct subframes tiled to the batch); the decoder is
``make_mimo_batch_decoder`` on the card (``--device cpu``: a dry run of
the plain versions).  Prints one JSON line: the metric, the rate of
decoded bits (TBS times the transport blocks that pass their CRC, 2 *
batch of them when all do, over the median decode time), the CRC count of
the warm-up decode, whether the passing blocks' bits equal those sent,
the batch, ``n_iter`` and the card's name and power
limit; ``--iq`` stages the IQ (``bench/timing.py::stage_iq``), ``--trace
DIR`` writes a Chrome trace of the timed decodes.  The tracked
TM4 configuration is ``--tm 4 --cmat corr --mcs 24 --snr-db 28 --batch
192``, with ``--detector sic``.
"""

from __future__ import annotations

import argparse
import json
import sys


from lteax_torch.bench.timing import IQ_FORMATS, bench_decode, stage_iq
from lteax_torch.phy.tuning import DecoderTuning
from lteax_torch.pipeline import make_mimo_batch_decoder
from lteax_torch.sim.mimo_gen import MimoCell, decoder_rows, mimo_subframes


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--reps", type=int, default=6)
    ap.add_argument("--iters", type=int, default=6)
    ap.add_argument("--mcs", type=int, default=28)
    ap.add_argument("--tm", type=int, default=3, choices=(3, 4))
    ap.add_argument("--cb-index", type=int, default=0)
    ap.add_argument("--snr-db", type=float, default=25.0)
    ap.add_argument("--cmat", default="bench",
                    help="'bench' (near-orthogonal), 'corr' (correlated, "
                         "unequal columns: the SIC regime) or 8 "
                         "comma-separated re,im pairs row-major")
    ap.add_argument("--detector", default="mmse", choices=("mmse", "sic"))
    ap.add_argument("--iq", default="f32", choices=IQ_FORMATS,
                    help="IQ staging of the device boundary "
                         "(bench/timing.py::stage_iq)")
    ap.add_argument("--trace", default=None, metavar="DIR",
                    help="profile the timed decodes into a Chrome trace "
                         "in DIR")
    ap.add_argument("--device", default=None,
                    help="default: the current CUDA device")
    a = ap.parse_args(argv)
    cell = MimoCell(mcs=a.mcs, tm=a.tm, cb_index=a.cb_index)
    geom = cell.geom
    print(f"n_re {geom.n_re}, TBS {geom.tbs} x2, C={geom.info.c}, "
          f"K={geom.k}, code rate {(geom.tbs + 24) / geom.g:.3f}/cw",
          file=sys.stderr)
    dec = make_mimo_batch_decoder(
        *cell.decoder_args(), n_iter=a.iters,
        tuning=DecoderTuning(mimo_detector=a.detector), **cell.precoding,
        device=a.device)
    iq, tb = mimo_subframes(cell, a.batch, a.snr_db, a.cmat, seed=0)
    res = bench_decode(dec, stage_iq(iq, a.iq).to(dec.device),
                       decoder_rows(tb), a.reps, a.trace)
    print(f"crc ok {res['crc_ok']}/{2 * a.batch}, bits equal sent: "
          f"{res['bits_equal']}, n_iter {res['n_iter']}/{a.iters}; median "
          f"{res['median_ms']:.3f} ms, p90 {res['p90_ms']:.3f} (n={a.reps})",
          file=sys.stderr)
    out = {"metric": f"decoded 2x2 TM{a.tm} dual-codeword DL-SCH "
                     f"({a.detector.upper()}), 20 MHz MCS{a.mcs}, "
                     f"{a.snr_db:g} dB, channel {a.cmat}, {a.iq} IQ in",
           "value": round(res["mbit_per_s"], 2), "unit": res["unit"],
           "crc_ok": res["crc_ok"], "bits_equal": res["bits_equal"],
           "batch": a.batch,
           "n_iter": res["n_iter"], "iq": a.iq, "card": res["card"],
           "trace": res["trace"]}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
