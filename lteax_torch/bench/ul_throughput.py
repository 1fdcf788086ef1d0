"""UL-SCH (PUSCH) decode throughput at the ``bench/ul_throughput.py``
configuration: the port's UL bench CLI.

    python -m lteax_torch.bench.ul_throughput [--batch 256] [--reps 10]
        [--iters 6] [--snr-db 25] [--static-nv] [--iq f32|bf16|sc8]
        [--trace DIR] [--device cpu]

100 PRB, TBS 75376, 64QAM (C=13 x K=5824), cell 214, subframe 4, RNTI
0x3D (``bench/ul_throughput.py:48-49``); 16 distinct gridded subframes from
numpy seed 0 tiled to the batch, AWGN at 25 dB (``lteax_torch.sim.ul_gen``,
the recipe of ``bench/ul_throughput.py:53-70``), staged as ``--iq``
says (f32 by default, ``bench/timing.py::stage_iq``).  The decoder is
``make_pusch_batch_decoder`` on the card (``--device cpu``: a dry run of
the plain versions): DM-RS LS estimate, denoised, MMSE, IDFT, the demap
kernel, the composed de-match gather, the turbo kernel with CRC early stop
and compacted retry.  The noise is estimated per subframe from the DM-RS
residual; ``--static-nv`` pins the true noise variance instead.  Prints
one JSON line shaped like ``dl_throughput``'s: the metric, the rate of
decoded bits (TBS times the transport blocks that pass their CRC) over the
median decode time in Mbit/s per GPU, ``vs_baseline`` over the 75.376
Mbit/s real-time rate, the CRC count of the warm-up decode and whether the
bits of the blocks that pass equal those sent, ``n_iter``,
the batch, the IQ staging and the card's name and power limit; ``--trace
DIR`` writes a Chrome trace of the timed decodes (``decode_batch`` ranges,
the kernels) into DIR.
"""

from __future__ import annotations

import argparse
import json
import sys


from lteax_torch.bench.timing import IQ_FORMATS, bench_decode, stage_iq
from lteax_torch.pipeline import make_pusch_batch_decoder
from lteax_torch.sim.ul_gen import UlCell, ul_subframes

REAL_TIME_MBIT_S = 75.376


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--iters", type=int, default=6)
    ap.add_argument("--snr-db", type=float, default=25.0)
    ap.add_argument("--static-nv", action="store_true",
                    help="pin the true noise variance instead of the "
                         "per-subframe DM-RS-residual estimate")
    ap.add_argument("--iq", default="f32", choices=IQ_FORMATS,
                    help="IQ staging of the device boundary "
                         "(bench/timing.py::stage_iq)")
    ap.add_argument("--trace", default=None, metavar="DIR",
                    help="profile the timed decodes into a Chrome trace "
                         "in DIR")
    ap.add_argument("--device", default=None,
                    help="default: the current CUDA device")
    a = ap.parse_args(argv)
    cell = UlCell()
    nv = 10 ** (-a.snr_db / 10.0)
    dec = make_pusch_batch_decoder(*cell.decoder_args(), n_iter=a.iters,
                                   noise_var=nv if a.static_nv else None,
                                   device=a.device)
    iq, tb = ul_subframes(cell, a.batch, a.snr_db, seed=0)
    res = bench_decode(dec, stage_iq(iq, a.iq).to(dec.device), tb, a.reps,
                       a.trace)
    print(f"crc ok {res['crc_ok']}/{a.batch}, bits equal sent: "
          f"{res['bits_equal']}, n_iter {res['n_iter']}/{a.iters}; median "
          f"{res['median_ms']:.3f} ms, p90 {res['p90_ms']:.3f} (n={a.reps})",
          file=sys.stderr)
    value = round(res["mbit_per_s"], 2)
    out = {"metric": "decoded UL-SCH throughput, 20 MHz 64QAM TBS 75376, "
                     f"turbo max-6-iter with CRC early stop, {a.iq} IQ in",
           "value": value, "unit": res["unit"],
           # the ratio of the value as printed, so that the line agrees
           # with itself whatever the rounding
           "vs_baseline": round(value / REAL_TIME_MBIT_S, 3),
           "crc_ok": res["crc_ok"], "bits_equal": res["bits_equal"],
           "n_iter": res["n_iter"],
           "batch": a.batch, "iq": a.iq, "card": res["card"],
           "trace": res["trace"]}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
