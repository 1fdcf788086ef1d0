"""Timing and reporting shared by the decode benches and ``chip_smoke.py``:
the card's name and power limit, the IQ staging of the device boundary,
the decoders' numerics options, and decode times on the host's clock around synchronised calls (a decode
syncs on device flags itself, so the host clock is what a caller waits),
each call a ``lteax.decode_batch`` range, optionally profiled into a
trace."""

from __future__ import annotations

import contextlib
import subprocess
import time

import numpy as np
import torch

from lteax_torch.io.iq import from_iq_f32, to_iq_bf16, to_iq_sc8
from lteax_torch.phy.tuning import (MDTYPES, OFDM_DFTS, UL_DFTS,
                                     DecoderTuning)
from lteax_torch.utils.trace import profile_to, stage

IQ_FORMATS = ("f32", "bf16", "sc8")


def stage_iq(iq: np.ndarray, fmt: str) -> torch.Tensor:
    """IQ float32 pairs (..., 2) -> the host tensor a bench hands the
    decoder: ``f32`` as it is, ``bf16`` rounded to bfloat16 pairs, ``sc8``
    int8 pairs at full scale (127 over the largest component, as an SDR's
    gain would set it: ``to_iq_sc8``'s fixed scale of 127 would clip the
    components above 1.0, 6% of the headline signal's, and its 64QAM would
    not decode).  The decoders are scale-invariant."""
    if fmt == "f32":
        return torch.from_numpy(iq)
    x = from_iq_f32(iq)
    if fmt == "bf16":
        return to_iq_bf16(x)
    if fmt == "sc8":
        return torch.from_numpy(to_iq_sc8(x, 127.0 / float(np.abs(iq).max())))
    raise ValueError(f"unknown IQ staging {fmt!r} "
                     f"(use {'/'.join(IQ_FORMATS)})")


NUMERICS = ("mdtype", "demap_in", "ofdm_dft", "ul_dft", "nofreeze",
            "combine_bf16", "planar_int8")
"""The tuning fields the bench CLIs set (:func:`add_numerics_args`)."""


def add_numerics_args(ap) -> None:
    """``--mdtype``, ``--demap-in``, ``--ofdm-dft``, ``--ul-dft``,
    ``--nofreeze``, ``--combine-bf16`` and ``--planar-int8``: the decoder's
    trellis, demap staging, OFDM demod DFT, UL transform and the three
    turbo knobs (the counterparts of the reference's ``LTEAX_PALLAS_DTYPE``,
    ``LTEAX_DEMAP_IN``, ``LTEAX_OFDM_DFT``, ``LTEAX_UL_DFT``,
    ``LTEAX_PALLAS_NOFREEZE``, ``LTEAX_COMBINE_BF16`` and
    ``LTEAX_PLANAR_INT8``), default the exact f32 profile; ``--mdtype bf16
    --demap-in bf16 --ofdm-dft factored`` is the reference's shipped
    numerics (``SHIPPED``)."""
    ap.add_argument("--mdtype", default="f32", choices=MDTYPES,
                    help="turbo trellis metric dtype")
    ap.add_argument("--demap-in", default="f32", choices=("f32", "bf16"),
                    help="demap kernel input staging dtype")
    ap.add_argument("--ofdm-dft", default="fft", choices=OFDM_DFTS,
                    help="the OFDM demod's DFT")
    ap.add_argument("--ul-dft", default="fft", choices=UL_DFTS,
                    help="the UL transform de-precoding")
    ap.add_argument("--nofreeze", action="store_true",
                    help="no freeze and no pin at the main beta sweep's "
                    "dead positions")
    ap.add_argument("--combine-bf16", action="store_true",
                    help="the bf16 trellis's combine sums and maxima in bf16")
    ap.add_argument("--planar-int8", action="store_true",
                    help="the planar demap output quantized to int8")


def numerics_fields(a) -> dict:
    """The options of :func:`add_numerics_args`, by tuning field (for a
    bench's JSON line)."""
    return {f: getattr(a, f) for f in NUMERICS}


def numerics(a, **kw) -> DecoderTuning:
    """The tuning of :func:`add_numerics_args`' options (and ``kw``)."""
    return DecoderTuning(**numerics_fields(a), **kw)


def card_line() -> str:
    """``nvidia-smi``'s name and power limit of the first card."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def time_decode(dec, x: torch.Tensor, reps: int) -> tuple[float, float]:
    """(median, p90) seconds of ``dec(x)`` over ``reps`` synchronised
    calls, each a ``lteax.decode_batch`` range."""
    times = []
    for _ in range(reps):
        _sync(x.device)
        with stage("decode_batch"):
            t0 = time.perf_counter()
            dec(x)
            _sync(x.device)
            times.append(time.perf_counter() - t0)
    return float(np.median(times)), float(np.percentile(times, 90))


def bench_decode(dec, x: torch.Tensor, rows: np.ndarray, reps: int,
                 trace_dir: str | None = None) -> dict:
    """One warm-up decode, checked against the sent transport blocks
    ``rows`` (n_tb, TBS), then ``reps`` timed ones (profiled into a Chrome
    trace in ``trace_dir`` when one is named).  -> {"crc_ok",
    "bits_equal" (of the blocks that pass their CRC), "n_iter",
    "median_ms", "p90_ms", "mbit_per_s", "unit", "card", "trace"}: the
    rate counts the bits of the blocks that pass their CRC; a run on the
    CPU is a dry run and says so in its unit and card."""
    bits, ok, n_iter = dec(x)
    ok = ok.cpu().numpy()
    crc_ok = int(ok.sum())
    bits_equal = bool(np.array_equal(bits.cpu().numpy()[ok], rows[ok]))
    with (profile_to(trace_dir) if trace_dir
          else contextlib.nullcontext()) as prof:
        t_med, t_p90 = time_decode(dec, x, reps)
    on_card = x.device.type == "cuda"
    return {"crc_ok": crc_ok, "bits_equal": bits_equal, "n_iter": n_iter,
            "median_ms": t_med * 1e3, "p90_ms": t_p90 * 1e3,
            "mbit_per_s": crc_ok * rows.shape[1] / t_med / 1e6,
            "unit": "Mbit/s/GPU" if on_card else "Mbit/s/CPU (dry run)",
            "card": card_line() if on_card else "cpu",
            "trace": prof.trace_path if trace_dir else None}
