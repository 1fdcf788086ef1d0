"""Multi-rank dry run of the sharded decoders; counterpart of
``__graft_entry__.dryrun_multichip`` (``:106-443``).

:func:`dryrun_multichip` spawns ``n`` ranks and runs six cases on a
``1 x n`` mesh and, when ``n`` is even, on a ``2 x n/2`` mesh (the
reference needs n >= 4 for that; here n = 2 gives a ``chan`` split that
one card can run).  Each case decodes real encoded transport blocks, one a
``time`` shard, and asserts that every CRC passes and the bits equal the
bits sent, so a broken decoder fails the dry run, not only a broken
launch:

1. the halo front (the PSS matched filter over the time-sharded samples)
   and the DL decoder at 6 PRB, MCS 9;
2. the acquire decoder at ``n_rb`` PRB (20 MHz by default), MCS 28: the
   halo PSS correlation across ranks and the DL decode;
3. the UL-SCH decoder at 6 PRB;
4. 2x2 TM3 MMSE at 6 PRB;
5. HARQ-IR, rv 0 + rv 2, at an SNR where rv 0 alone decodes none and the
   combination all;
6. TM4 SIC over a correlated channel of unequal column powers.

With ``prescan=(cfg, captures)`` each mesh also runs the channel-sharded
PSS prescan over the ``chan`` axis on the (n_chan, L) native-rate
captures, and each rank returns its detections.

    python -m lteax_torch.shard.dryrun N [--device cpu] [--backend gloo]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from lteax_torch.phy.channels.pusch import PuschAlloc
from lteax_torch.phy.config import PhyConfig
from lteax_torch.phy.sync import pss_time_filters
from lteax_torch.phy.tuning import DecoderTuning
from lteax_torch.pipeline import _iq_to_complex
from lteax_torch.shard import pipeline as sp
from lteax_torch.shard.halo import overlap_save_correlate
from lteax_torch.shard.mesh import (CHAN_AXIS, TIME_AXIS, axis_size,
                                    device_type, local_slice, make_mesh,
                                    mesh_device, spawn)
from lteax_torch.shard.scanner import batched_prescan
from lteax_torch.sim.dl_gen import (DlCell, dl_subframes, harq_decoder_args,
                                    harq_transmissions)
from lteax_torch.sim.mimo_gen import MimoCell, decoder_rows, mimo_subframes
from lteax_torch.sim.ul_gen import UlCell, ul_subframes


def _check(name: str, mesh, bits: torch.Tensor, ok: torch.Tensor,
           n_ok: int, n_want: int, sent: np.ndarray) -> str:
    """Every CRC of the global batch passed and the local bits are the
    local rows of the bits sent."""
    if n_ok != n_want or not bool(ok.all()):
        raise AssertionError(f"{name}: CRC pass {n_ok}/{n_want}")
    want = local_slice(sent, mesh, 0, TIME_AXIS)
    if not np.array_equal(bits.cpu().numpy(), want):
        raise AssertionError(f"{name}: decoded bits differ from those sent")
    return f"n_ok={n_ok}/{n_want}, bits exact"


def _case_dl(mesh, dev) -> str:
    nt = axis_size(mesh, TIME_AXIS)
    cell = DlCell(n_rb_dl=6, n_cell_id=150, mcs=9, cfi=3)
    iq, tb = dl_subframes(cell, nt, snr_db=15.0, seed=11)
    x = torch.from_numpy(local_slice(iq, mesh, 0, TIME_AXIS)).to(dev)
    taps = torch.as_tensor(pss_time_filters(cell.cfg)[0], device=dev)
    corr = overlap_save_correlate(_iq_to_complex(x).reshape(-1), taps,
                                  mesh).abs()
    dec = sp.make_sharded_decoder(mesh, *cell.decoder_args(), n_iter=4,
                                  device=dev)
    return (f"DL 6 PRB: halo-correlate {tuple(corr.shape)} a shard, "
            + _check("DL 6 PRB", mesh, *dec(x), nt, tb))


def _case_acquire(mesh, dev, n_rb: int) -> str:
    nt = axis_size(mesh, TIME_AXIS)
    cell = DlCell(n_rb_dl=n_rb, n_cell_id=150, mcs=28, cfi=1)
    iq, tb = dl_subframes(cell, nt, snr_db=30.0, seed=11)
    x = torch.from_numpy(local_slice(iq, mesh, 0, TIME_AXIS)).to(dev)
    dec = sp.make_sharded_acquire_decoder(mesh, *cell.decoder_args(),
                                          n_iter=3, device=dev)
    bits, ok, n_ok, peak = dec(x)
    if not peak > 0.0:
        raise AssertionError(f"acquire: pss_peak {peak}")
    return (f"acquire {n_rb} PRB MCS 28: "
            + _check("acquire", mesh, bits, ok, n_ok, nt, tb)
            + f", pss_peak={peak:.2f}")


def _case_ul(mesh, dev) -> str:
    nt = axis_size(mesh, TIME_AXIS)
    cell = UlCell(alloc=PuschAlloc(n_prb=6, rb_start=0, mcs_tbs=504, qm=2))
    iq, tb = ul_subframes(cell, nt, snr_db=30.0, seed=7)
    x = torch.from_numpy(local_slice(iq, mesh, 0, TIME_AXIS)).to(dev)
    dec = sp.make_sharded_pusch_decoder(mesh, *cell.decoder_args(),
                                        n_iter=4, device=dev)
    return "UL (PUSCH): " + _check("UL", mesh, *dec(x), nt, tb)


def _case_mimo(mesh, dev, tm: int) -> str:
    nt = axis_size(mesh, TIME_AXIS)
    if tm == 3:
        cell, cmat, snr, tuning = MimoCell(n_rb_dl=6, cfi=2, mcs=6), \
            "bench", 25.0, DecoderTuning()
    else:
        # column 1 is 0.74-correlated with column 0 at ~4.5 dB less power
        cell, cmat, snr, tuning = MimoCell(n_rb_dl=6, cfi=2, mcs=15, tm=4), \
            "corr", 20.0, DecoderTuning(mimo_detector="sic")
    iq, tb = mimo_subframes(cell, nt, snr, cmat, seed=5)
    x = torch.from_numpy(local_slice(iq, mesh, 1, TIME_AXIS)).to(dev)
    dec = sp.make_sharded_mimo_decoder(mesh, *cell.decoder_args(),
                                       **cell.precoding, n_iter=6,
                                       tuning=tuning, device=dev)
    name = "2x2 TM3 MMSE" if tm == 3 else "TM4 SIC"
    # (2B, TBS) rows, b-major in (subframe, codeword): a shard's rows are
    # its subframes' two codewords
    return f"{name}: " + _check(name, mesh, *dec(x), 2 * nt,
                                decoder_rows(tb))


def _case_harq(mesh, dev) -> str:
    nt = axis_size(mesh, TIME_AXIS)
    cell = DlCell(n_rb_dl=6, n_cell_id=150, mcs=9, cfi=2)
    iq, tb, cells = harq_transmissions(cell, (1, 2), (0, 2), nt, snr_db=3.0,
                                       seed=3)
    x = torch.from_numpy(local_slice(iq, mesh, 1, TIME_AXIS)).to(dev)
    dec0 = sp.make_sharded_decoder(mesh, *cells[0].decoder_args(), device=dev)
    n0 = dec0(x[0])[2]
    if n0:
        raise AssertionError(f"rv 0 alone decoded {n0}/{nt}: the SNR is not "
                             f"below its threshold")
    dec = sp.make_sharded_harq_decoder(mesh, *harq_decoder_args(cells),
                                       device=dev)
    return (f"HARQ IR (rv0+rv2): rv0 alone {n0}/{nt}, combined "
            + _check("HARQ", mesh, *dec(x), nt, tb))


def _dryrun_rank(kind: str, n_rb: int, prescan) -> dict:
    """One rank: the six cases on each mesh shape, its result lines and
    (with ``prescan``) its detections by mesh shape."""
    n = torch.distributed.get_world_size()
    shapes = [(1, n)] + ([(2, n // 2)] if n % 2 == 0 else [])
    lines, detections = [], {}
    for shape in shapes:
        mesh = make_mesh(*shape, device=kind)
        dev = mesh_device(mesh)
        tag = f"mesh {shape[0]}x{shape[1]}"
        for case in (lambda: _case_dl(mesh, dev),
                     lambda: _case_acquire(mesh, dev, n_rb),
                     lambda: _case_ul(mesh, dev),
                     lambda: _case_mimo(mesh, dev, 3),
                     lambda: _case_harq(mesh, dev),
                     lambda: _case_mimo(mesh, dev, 4)):
            lines.append(f"{tag} {case()} - OK")
        if prescan is not None:
            cfg, caps = prescan
            detections[shape] = batched_prescan(
                torch.from_numpy(caps).to(dev), cfg, mesh=mesh)
            lines.append(f"{tag} prescan over chan: {caps.shape[0]} "
                         f"captures, {axis_size(mesh, CHAN_AXIS)} chan "
                         f"shards, detected "
                         f"{sum(d['detected'] for d in detections[shape])}"
                         f" - OK")
    return {"lines": lines, "prescan": detections}


def dryrun_multichip(n_devices: int, device=None, backend: str | None = None,
                     n_rb: int = 100,
                     prescan: tuple[PhyConfig, np.ndarray] | None = None,
                     verbose: bool = True) -> list:
    """Spawn ``n_devices`` ranks on ``device`` (default: the cards, one a
    rank by NCCL; ``backend="gloo"`` for ranks that share a card;
    ``device="cpu"``) and run the dry run; raises on the first failure.
    Returns each rank's ``mesh.RankResult`` (its lines, detections and
    kernel launch counts)."""
    res = spawn(_dryrun_rank, n_devices, device, backend, device_type(device),
                n_rb, prescan)
    if verbose:
        print(f"dryrun_multichip({n_devices}):")
        for line in res[0].value["lines"]:
            print(f"  {line}")
        print(f"dryrun_multichip({n_devices}) - OK")
    return res


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="multi-rank dry run of the "
                                 "sharded decoders")
    ap.add_argument("n", type=int, help="ranks")
    ap.add_argument("--device", default=None,
                    help="cuda (default: one card a rank) or cpu")
    ap.add_argument("--backend", default=None, help="nccl or gloo")
    ap.add_argument("--n-rb", type=int, default=100,
                    help="bandwidth of the acquire case")
    a = ap.parse_args(argv)
    dryrun_multichip(a.n, a.device, a.backend, a.n_rb)


if __name__ == "__main__":
    main()
