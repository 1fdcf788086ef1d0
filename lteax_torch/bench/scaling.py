"""Scaling bench of the sharded DL decoder: samples/s against the number
of ranks; counterpart of ``bench/scaling.py``.

    python -m lteax_torch.bench.scaling [--n-rb 100] [--mcs 28] [--per-dev 4]
        [--reps 5] [--acquire] [--nproc N] [--device cpu] [--backend gloo]

For each rank count 1, 2, 4, 8 up to ``--nproc``, that many ranks
(``shard.mesh.spawn``) build a ``1 x n`` mesh and decode ``--per-dev``
subframes each through ``make_sharded_decoder`` (``--acquire``: the halo
PSS acquisition and the decoder, ``make_sharded_acquire_decoder``): one
warm-up decode, then ``--reps`` timed ones; a rep's time is the slowest
rank's.  The subframes are the ``bench.py`` recipe at 30 dB
(``sim.dl_gen``, seed 0), the same on every rank.

Prints one JSON line: for each rank count the samples/s and Mbit/s of
decoded bits over the median time, the kernel launches summed over the
ranks (warm-up and timed decodes), and the efficiency against one rank,
``samples_per_s / (n * samples_per_s(1))``.  The efficiency is null unless
every rank has a card of its own: ranks that share a card carry
``"ranks_per_card"`` > 1 and are not a scaling number, and on the CPU
(``--device cpu``, a dry run) every rank shares the host.  With one card
the run records the 1-device baseline that a run on N cards compares
against.  The reference's ``--xla-turbo`` has no counterpart: the port has
one turbo decoder.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from lteax_torch.bench.timing import (add_numerics_args, card_line, numerics,
                                      numerics_fields)
from lteax_torch.shard import pipeline as sp
from lteax_torch.shard.mesh import device_type, make_mesh, mesh_device, spawn
from lteax_torch.sim.dl_gen import DlCell, dl_subframes


def _cell(n_rb: int, mcs: int) -> DlCell:
    # the reference's control region: cfi 1 above 10 PRB, else 3 symbols
    return DlCell(n_rb_dl=n_rb, mcs=mcs, cfi=1 if n_rb > 10 else 3)


def _rank(kind: str, n_rb: int, mcs: int, per_dev: int, reps: int,
          acquire: bool, tuning=None) -> dict:
    """One rank: its decode times (s) and the global n_ok."""
    mesh = make_mesh(device=kind)
    dev = mesh_device(mesh)
    cell = _cell(n_rb, mcs)
    make = sp.make_sharded_acquire_decoder if acquire else \
        sp.make_sharded_decoder
    dec = make(mesh, *cell.decoder_args(), n_iter=6, tuning=tuning,
               device=dev)
    iq, _ = dl_subframes(cell, per_dev, snr_db=30.0, seed=0)
    x = torch.from_numpy(iq).to(dev)
    sync = (lambda: torch.cuda.synchronize(dev)) if kind == "cuda" else \
        (lambda: None)
    n_ok = dec(x)[2]
    times = []
    for _ in range(reps):
        torch.distributed.barrier()
        sync()
        t0 = time.perf_counter()
        n_ok = dec(x)[2]
        sync()
        times.append(time.perf_counter() - t0)
    return {"times": times, "n_ok": n_ok}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description="sharded DL decode: samples/s "
                                 "against the number of ranks")
    ap.add_argument("--n-rb", type=int, default=100)
    ap.add_argument("--mcs", type=int, default=28)
    ap.add_argument("--acquire", action="store_true",
                    help="bench the halo PSS acquisition and the decoder")
    ap.add_argument("--per-dev", type=int, default=4)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--nproc", type=int, default=None,
                    help="largest rank count (1, 2, 4, 8 up to it; default: "
                         "the cards, or 1 on the CPU)")
    ap.add_argument("--device", default=None,
                    help="cuda (default: a card a rank) or cpu (a dry run)")
    ap.add_argument("--backend", default=None,
                    help="nccl (default on cards) or gloo (ranks that share "
                         "a card, or the CPU)")
    add_numerics_args(ap)
    a = ap.parse_args(argv)
    kind = device_type(a.device)
    cell = _cell(a.n_rb, a.mcs)
    n_samps, tbs = cell.cfg.n_samps_subframe, cell.geom.tbs
    n_cards = torch.cuda.device_count() if kind == "cuda" else 0
    nproc = a.nproc or max(n_cards, 1)
    rows = []
    for n in (d for d in (1, 2, 4, 8) if d <= nproc):
        ranks = spawn(_rank, n, kind, a.backend, kind, a.n_rb, a.mcs,
                      a.per_dev, a.reps, a.acquire, numerics(a))
        t = float(np.median(np.max([r.value["times"] for r in ranks],
                                   axis=0)))
        n_ok = ranks[0].value["n_ok"]
        total = n * a.per_dev
        rows.append({"n_dev": n,
                     "ranks_per_card": -(-n // n_cards) if n_cards else None,
                     "samples_per_s": total * n_samps / t,
                     "mbit_per_s": n_ok * tbs / t / 1e6, "ms": t * 1e3,
                     "n_ok": n_ok, "total_sf": total,
                     "launches": {k: sum(r.launches[k] for r in ranks)
                                  for k in ranks[0].launches}})
        print(f"n_dev={n}: {total * n_samps / t / 1e6:.2f} Msps, "
              f"{t * 1e3:.1f} ms, crc {n_ok}/{total}", file=sys.stderr)
    base = rows[0]["samples_per_s"]
    own_cards = [r["ranks_per_card"] == 1 for r in rows]
    for r in rows:
        r["efficiency"] = (r["samples_per_s"] / (base * r["n_dev"])
                           if all(own_cards) and len(rows) > 1 else None)
    out = {"metric": f"sharded DL {'acquire + ' if a.acquire else ''}decode "
                     f"throughput, {a.n_rb} PRB MCS {a.mcs} (TBS {tbs}), "
                     f"{a.per_dev} subframes a rank",
           "unit": "samples/s" if kind == "cuda" else "samples/s (CPU dry "
                                                       "run)",
           "results": rows, "reps": a.reps, "device": kind,
           **numerics_fields(a),
           "backend": a.backend or ("nccl" if kind == "cuda" else "gloo"),
           "card": card_line() if kind == "cuda" else "cpu"}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
