"""Run one cell of the benchmark once, from the root of a checkout:

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

Set-up (``setup_s``, from this script's first line to the window's start)
imports the program, makes the cell's inputs from the seed
(``benchmark/traffic.py``), builds the program's decoder and decodes each
of the cell's batches once (the first call builds or loads the kernels).
Then the closed loop runs for ``--seconds`` (``benchmark/window.py``); a
traced run then profiles ``trace_batches`` more batches twice, the
device's activity alone (its metrics) and with the host's operations (the
names of the idle gaps).  Once the window has closed and the device's peak
memory is read, the reference checks what the timed path produced
(``benchmark/check.py``).  The last line of
standard output is the result as one JSON object; the last lines of
standard error are the numbers compared, each beside its limit.

``--cpu-dry-run`` runs the same at a tiny batch on the CPU, with the
program's plain kernels, for the harness's tests; it says so in its
``device``.  Without it the run needs a CUDA device and exits with 2
where there is none.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

FORBIDDEN = {"jax", "jaxlib", "flax", "lteax"}
"""Top-level module names that no run may load: JAX and the JAX package
(compared whole: the port's ``lteax_torch`` is not ``lteax``)."""

DRY_RUN = {"batch": 12, "distinct_tbs": 4, "noise_batches": 2,
           "check_tbs": 4, "trace_batches": 2}
"""The traffic's sizes in a CPU dry run."""


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--cpu-dry-run", action="store_true")
    return ap.parse_args(argv)


def loaded_forbidden() -> list[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & FORBIDDEN)


def power_limit_w() -> float | None:
    """The card's power limit from ``nvidia-smi`` (None where it says
    nothing)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, timeout=60).stdout.split()
        return float(out[0])
    except (OSError, ValueError, IndexError, subprocess.TimeoutExpired):
        return None


def main(argv=None) -> int:
    args = parse(argv)
    from benchmark import spec
    bench = spec.benchmark()
    cell = spec.workload(bench, args.workload)
    cfg = spec.config(cell["config"])
    traffic = spec.traffic(cell["traffic"])
    limits = spec.limits(cell["name"])
    import torch
    if args.cpu_dry_run:
        device = torch.device("cpu")
        traffic = {**traffic, **DRY_RUN}
    elif (not torch.cuda.is_available()
          or torch.cuda.device_count() < cell["chips"]):
        print(f"{cell['name']} needs {cell['chips']} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    else:
        device = torch.device("cuda", 0)
    from benchmark import check, window
    from benchmark.traffic import make_inputs
    system = spec.system(cfg)
    phases = {"import_s": time.perf_counter() - T0}

    t = time.perf_counter()
    inputs = make_inputs(system, cfg, traffic, args.seed, device)
    phases["inputs_s"] = time.perf_counter() - t
    t = time.perf_counter()
    dec = system.decoder(cfg, cfg["tuning"], device)
    phases["decoder_s"] = time.perf_counter() - t
    t = time.perf_counter()
    loop = window.Loop(dec, inputs, device)
    for i in range(traffic["noise_batches"]):
        loop.batch(i)
    if args.trace:
        loop.traced(1, 0, host=False)
        loop.traced(1, 0, host=True)
    phases["warmup_s"] = time.perf_counter() - t
    setup_s = time.perf_counter() - T0
    print(json.dumps({"setup": phases}), file=sys.stderr)

    keep, rows = check.sample(args.seed, traffic)
    record = loop.window(args.seconds, keep, spans=bool(args.trace))
    print(json.dumps({"window": window.summary(record)}), file=sys.stderr)
    trace = None
    if args.trace:
        n, first = traffic["trace_batches"], len(record.latencies)
        trace = loop.traced(n, first, host=False)
        trace["idle_gaps"] = loop.traced(n, first + n, host=True)[
            "idle_gaps"]
    on_card = device.type == "cuda"
    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name(device) if on_card else "cpu",
           "count": 1,
           "memory_peak_bytes": (torch.cuda.max_memory_allocated(device)
                                 if on_card else 0)}
    if on_card:
        dev["power_limit_w"] = power_limit_w()
    if trace is not None:
        dev.update(busy_s=trace["busy_s"], window_s=trace["window_s"])
    run = spec.Run(cfg, traffic, system, record, setup_s, trace)
    metrics = {}
    for m in spec.metrics(bench, cell["name"], bool(args.trace)):
        value = spec.reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    side = check.program_side(record, inputs, rows, system.geometry(cfg).c,
                              spec.codewords(system))
    # An operation is one transport block's decode.  It fails where the
    # program's answer is wrong: its CRCs pass and its bits are not those
    # sent.  A block whose CRC fails is reported as lost, the answer a
    # receiver owes (HARQ retransmits it); at a threshold SNR some are,
    # in the reference too.  They count in ``decoded_mbit_s`` by the
    # bits they do not deliver, and ``tb_lost`` holds the program to
    # the reference's decodes.
    attempted, failed = record.attempted, record.crc_false_pass
    del dec, loop, inputs, record, run
    if on_card:
        torch.cuda.empty_cache()
    numbers = check.compare(system, cfg, side)
    bad = loaded_forbidden()
    if bad:
        print(f"the run loaded {bad}: neither JAX nor the JAX package may "
              "run here", file=sys.stderr)
        return 3
    checks = check.judged(numbers, limits)
    result = {"correct": check.correct(checks), "attempted": attempted,
              "failed": failed, "metrics": metrics, "device": dev}
    if trace is not None:
        result["breakdown"] = {"device_ops": trace["device_ops"],
                               "idle_gaps": trace["idle_gaps"]}
    result["checks"] = checks
    for name, c in checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
