"""Config #2: DL-SCH turbo BER/BLER vs SNR sweep (AWGN), 5 MHz class; the
port's counterpart of ``bench/snr_sweep.py``.

    python -m lteax_torch.bench.snr_sweep [--n-rb 25] [--mcs 10]
        [--blocks 20] [--iters 6] [--decoder device|pallas] [--device cpu]

Prints the reference's CSV: ``esn0_db,ber,bler``, one line per SNR point.
Without ``--device`` the sweep runs on the current CUDA device (and
raises without one); ``--device cpu`` runs the plain versions.

:func:`bler_gate` is the config #2 gate of ``tests/test_snr_sweep.py``,
jax-free: the production decoder's waterfall held to the PRODUCTION curves
of ``docs/bler_awgn.csv`` within a ±0.5 dB shift.
"""

from __future__ import annotations

import argparse
import re
import sys
from pathlib import Path

import numpy as np
import torch

from lteax_torch.phy import seq
from lteax_torch.phy.channels import pdsch as pdsch_mod
from lteax_torch.phy.mod import BITS_PER_SYM, demodulate_maxlog
from lteax_torch.phy.tables.tbs import get_tbs_for_mcs
from lteax_torch.phy.tuning import DecoderTuning
from lteax_torch.pipeline import TurboTail, _crc_plans, _resolve_device

CID, SF, RNTI = 100, 1, 0x1234
CSV = Path(__file__).resolve().parents[2] / "docs" / "bler_awgn.csv"
GATE_MARGIN = 0.15      # binomial noise at 48 blocks (3.6 sigma at p=0.5)
GATE_STEP = 0.5         # stored curve spacing == the tolerance in dB
GATE_SEEDS, GATE_BLOCKS = (2, 5), 24


def sweep(n_rb: int = 25, mcs: int = 10, n_blocks: int = 20,
          esn0_points=None, n_iter: int = 6, seed: int = 0,
          decoder: str = "device", device=None):
    """BER and BLER of ``n_blocks`` transport blocks at each Es/N0 point:
    -> (tbs, scheme, [(esn0_db, ber, bler), ...]).

    The reference's arguments and draw order: from
    ``np.random.default_rng(seed)`` the TB bits first, then each point's
    noise (real parts, then imaginary parts), so that one seed gives the
    same transmitted symbols and noise in both packages.  The symbols
    (``pdsch_encode_cbs``: CRC, segmentation, turbo encode, rate match,
    scrambling, modulation, on 12 * n_rb * 11 REs) take AWGN, then exact
    max-log LLRs (``demodulate_maxlog`` with the true noise) go to:

    - ``decoder="device"``: ``pdsch.pdsch_decode_device``, the reference's
      XLA-scan decoder's counterpart: the turbo kernel at the
      single-subframe settings (``phy.tuning.SINGLE_SUBFRAME``: win 32,
      ``n_iter`` iterations, no early stop);
    - ``decoder="pallas"``: the production tail (``pipeline.TurboTail`` at
      the port's ``DecoderTuning()``: win 128, CRC early stop, compacted
      retry), the counterpart of the reference's Pallas turbo stage at its
      shipped profile.  The port's trellis is f32; the reference's shipped
      profile (whose curves ``docs/bler_awgn.csv`` stores as PRODUCTION)
      runs a bf16 trellis, about 0.1 dB worse at threshold (KNOWN_ISSUES),
      well inside the ±0.5 dB band the config #2 gate holds.

    Runs on ``device`` (default: the current CUDA device)."""
    dev = _resolve_device(device)
    tbs, scheme = get_tbs_for_mcs(mcs, n_rb)
    qm = BITS_PER_SYM[scheme]
    n_re = 12 * n_rb * 11  # ~PDSCH REs of a subframe (cfi 2, minus CRS-ish)
    geom = pdsch_mod.pdsch_geometry(tbs, n_re, qm, 0)
    rng = np.random.default_rng(seed)

    if esn0_points is None:
        # center the sweep near the code rate's Shannon-ish threshold
        rate = tbs / (n_re * qm)
        base = 10 * np.log10(2 ** (rate * qm) - 1)
        esn0_points = [base - 1 + 0.5 * i for i in range(7)]

    if decoder == "pallas":
        tail = TurboTail(geom, n_iter, DecoderTuning(),
                         DecoderTuning().retry_m_dl, *_crc_plans(geom), dev)
        sgn = torch.as_tensor(seq.scrambling_symbols_np(
            seq.pdsch_c_init(RNTI, SF, CID), geom.g), device=dev)

        def decode(llr):
            d = pdsch_mod.soft_dematch(llr * sgn, geom)
            bits, oks, _ = tail(d.reshape(-1, 3, geom.k + 4))
            return bits, oks
    elif decoder == "device":
        def decode(llr):
            return pdsch_mod.pdsch_decode_device(llr, geom, RNTI, SF, CID,
                                                 n_iter=n_iter)[:2]
    else:
        raise ValueError(f"decoder {decoder!r}: \"device\" or \"pallas\"")

    tb_bits = rng.integers(0, 2, size=(n_blocks, tbs)).astype(np.int32)
    cbs = np.stack([pdsch_mod.pdsch_prepare_cbs(tb_bits[i], geom)
                    for i in range(n_blocks)])
    syms = pdsch_mod.pdsch_encode_cbs(cbs, geom, RNTI, SF, CID, scheme)
    sent = torch.as_tensor(tb_bits, dtype=torch.int8, device=dev)

    results = []
    for esn0_db in esn0_points:
        nv = 10 ** (-esn0_db / 10)
        noise = (rng.standard_normal(syms.shape)
                 + 1j * rng.standard_normal(syms.shape)) * np.sqrt(nv / 2)
        rx = torch.as_tensor((syms + noise).astype(np.complex64), device=dev)
        bits, oks = decode(demodulate_maxlog(rx, scheme, nv))
        ber = float(torch.mean((bits != sent).to(torch.float64)))
        bler = float(1.0 - torch.mean(oks.to(torch.float64)))
        results.append((float(esn0_db), ber, bler))
    return tbs, scheme, results


def stored_production_curves(path=CSV) -> dict:
    """The PRODUCTION section of ``docs/bler_awgn.csv`` ->
    {(n_rb, mcs): [(esn0_db, ber, bler), ...]} sorted by SNR (the parse of
    ``tests/test_snr_sweep.py``)."""
    curves, key, in_prod = {}, None, False
    with open(path) as f:
        for line in f:
            line = line.strip()
            if "PRODUCTION decoder curve" in line:
                in_prod = True
                continue
            if not in_prod:
                continue
            m = re.match(r"#\s*n_rb=(\d+)\s+mcs=(\d+)", line)
            if m:
                key = (int(m.group(1)), int(m.group(2)))
                curves[key] = []
                continue
            if line.startswith("#") or not line:
                continue
            snr, ber, bler = (float(v) for v in line.split(","))
            curves[key].append((snr, ber, bler))
    if not curves:
        raise ValueError(f"no PRODUCTION section in {path}")
    return {k: sorted(v) for k, v in curves.items()}


def gate_points(curve) -> tuple[list, float]:
    """The waterfall's top (stored BLER >= 0.8), mid (0 < BLER < 1, nearest
    0.5) and first zero + 0.5 dB SNRs, each with the BLER band a <= 0.5 dB
    shift of the stored curve (linear interpolation, clamped) could give,
    widened by the binomial margin: ([(snr, lo, hi)] * 3, zero snr)."""
    xs, ys = [p[0] for p in curve], [p[2] for p in curve]
    at = lambda s: float(np.interp(s, xs, ys))
    top = next(s for s, _, bl in curve if bl >= 0.8)
    zero = next(s for s, _, bl in curve if bl == 0.0)
    mids = [(abs(bl - 0.5), s) for s, _, bl in curve
            if 0.0 < bl < 1.0 and top < s < zero]
    if not mids:
        raise ValueError(f"no mid point between {top} and {zero} dB")
    pts = []
    for s in (top, min(mids)[1], zero + GATE_STEP):
        lo = at(s + GATE_STEP) - GATE_MARGIN
        hi = at(s - GATE_STEP) + GATE_MARGIN
        pts.append((s, max(0.0, lo), min(1.0, hi) if hi < 1.0 else 1.0))
    return pts, zero


def bler_gate(n_rb: int, mcs: int, device=None) -> dict:
    """Config #2's gate (``tests/test_snr_sweep.py::_run_gate``) through
    the production decoder: BLER at the stored curve's gate points over
    ``GATE_SEEDS`` x ``GATE_BLOCKS`` blocks, each within its ±0.5 dB-shift
    band, and BER 0 at the zero + 0.5 dB point.  -> {"points": [(snr, lo,
    hi, bler, ber)], "scheme", "ok"}."""
    pts, _ = gate_points(stored_production_curves()[(n_rb, mcs)])
    snrs = [s for s, _, _ in pts]
    blers, bers = np.zeros(len(snrs)), np.zeros(len(snrs))
    for seed in GATE_SEEDS:
        _, scheme, res = sweep(n_rb=n_rb, mcs=mcs, n_blocks=GATE_BLOCKS,
                               n_iter=6, esn0_points=snrs, seed=seed,
                               decoder="pallas", device=device)
        blers += np.array([r[2] for r in res]) / len(GATE_SEEDS)
        bers += np.array([r[1] for r in res]) / len(GATE_SEEDS)
    rows = [(s, lo, hi, float(bl), float(be))
            for (s, lo, hi), bl, be in zip(pts, blers, bers)]
    ok = all(lo <= bl <= hi for _, lo, hi, bl, _ in rows) and bers[-1] == 0.0
    return {"points": rows, "scheme": scheme, "ok": bool(ok)}


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--n-rb", type=int, default=25)
    p.add_argument("--mcs", type=int, default=10)
    p.add_argument("--blocks", type=int, default=20)
    p.add_argument("--iters", type=int, default=6)
    p.add_argument("--decoder", default="device", choices=("device",
                                                            "pallas"))
    p.add_argument("--device", default=None,
                   help="default: the current CUDA device")
    a = p.parse_args(argv)
    tbs, scheme, res = sweep(a.n_rb, a.mcs, a.blocks, n_iter=a.iters,
                             decoder=a.decoder, device=a.device)
    print(f"# TBS={tbs} {scheme} n_rb={a.n_rb} mcs={a.mcs}", file=sys.stderr)
    print("esn0_db,ber,bler")
    for e, ber, bler in res:
        print(f"{e:.2f},{ber:.5f},{bler:.3f}")
    return tbs, scheme, res


if __name__ == "__main__":
    main()
