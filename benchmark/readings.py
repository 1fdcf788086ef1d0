"""The readings the limits of ``benchmark/limits/<cell>.json`` are set from,
in one process a cell (set-up is paid once):

    python3 benchmark/readings.py --workload <name> --seeds 1,2,... \\
        [--control-seeds ...] [--fault-seeds ...] [--seconds 2]

For each seed: the cell's inputs, one decode of each batch, a short
window of the cell's own load, and the comparison of ``benchmark/check.py``
-- for the program as configured (``--seeds``), for the control, the
program with its int8 LLR path (``planar_int8``) switched on
(``--control-seeds``), and with each fault of ``benchmark/faults.py``
planted (``--fault-seeds``).  One JSON line a reading on standard
output.  ``--cpu-dry-run`` as in ``benchmark/run.py``.
"""

import argparse
import contextlib
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from benchmark import check, faults, run, spec, window  # noqa: E402
from benchmark.traffic import make_inputs  # noqa: E402


def reading(system, cfg, traffic, dec, seed, seconds, device) -> dict:
    inputs = make_inputs(system, cfg, traffic, seed, device)
    loop = window.Loop(dec, inputs, device)
    for i in range(traffic["noise_batches"]):
        loop.batch(i)
    keep, rows = check.sample(seed, traffic)
    rec = loop.window(seconds, keep, spans=False)
    side = check.program_side(rec, inputs, rows, system.geometry(cfg).c,
                              spec.codewords(system))
    del loop, inputs, rec
    return check.compare(system, cfg, side)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--fault-seeds", default="")
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--cpu-dry-run", action="store_true")
    args = ap.parse_args(argv)
    ints = lambda s: [int(x) for x in s.split(",") if x]
    import torch
    bench = spec.benchmark()
    cell = spec.workload(bench, args.workload)
    cfg = spec.config(cell["config"])
    traffic = spec.traffic(cell["traffic"])
    if args.cpu_dry_run:
        device = torch.device("cpu")
        traffic = {**traffic, **run.DRY_RUN}
    else:
        device = torch.device("cuda", 0)
    system = spec.system(cfg)
    dec = system.decoder(cfg, cfg["tuning"], device)
    ctrl = system.decoder(cfg, {**cfg["tuning"], "planar_int8": True},
                          device)
    c = system.geometry(cfg).c
    todo = ([("program", s, dec, None) for s in ints(args.seeds)]
            + [("control", s, ctrl, None) for s in ints(args.control_seeds)]
            + [(f, s, dec, f) for s in ints(args.fault_seeds)
               for f in faults.FAULTS])
    for kind, seed, d, fault in todo:
        with (faults.planted(fault, d, c) if fault
              else contextlib.nullcontext()):
            numbers = reading(system, cfg, traffic, d, seed, args.seconds,
                              device)
        print(json.dumps({"cell": cell["name"], "kind": kind, "seed": seed,
                          **numbers}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
