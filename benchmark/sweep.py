"""The first-transmission BLER of the program across SNRs, to place a
cell at a threshold (the SNR whose BLER is nearest the target):

    python3 benchmark/sweep.py --config <name> --traffic <name> \\
        --snrs 20.5,20.75,... --seeds 1,2 [--cpu-dry-run]

For each seed and SNR: the traffic's inputs at that SNR
(``benchmark/traffic.py``, its sizes as the traffic file gives them), one
decode of each batch to warm up, then one more of each, counted: the
transport blocks whose CRCs failed over all blocks, the mean turbo
iterations a batch, and the blocks whose CRCs passed with wrong bits.  One
JSON line a reading on standard output.
"""

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from benchmark import run, spec, window  # noqa: E402
from benchmark.traffic import make_inputs  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config", required=True)
    ap.add_argument("--traffic", required=True)
    ap.add_argument("--snrs", required=True)
    ap.add_argument("--seeds", default="1")
    ap.add_argument("--cpu-dry-run", action="store_true")
    args = ap.parse_args(argv)
    cfg = spec.config(args.config)
    traffic = spec.traffic(args.traffic)
    if args.cpu_dry_run:
        device = torch.device("cpu")
        traffic = {**traffic, **run.DRY_RUN}
    else:
        device = torch.device("cuda", 0)
    system = spec.system(cfg)
    dec = system.decoder(cfg, cfg["tuning"], device)
    for seed in (int(s) for s in args.seeds.split(",")):
        for snr in (float(s) for s in args.snrs.split(",")):
            inputs = make_inputs(system, cfg, {**traffic, "snr_db": snr},
                                 seed, device)
            loop = window.Loop(dec, inputs, device)
            n = len(inputs.batches)
            for i in range(n):
                loop.batch(i)
            loop.tally.zero_()
            iters = []
            for i in range(n):
                loop.batch(i)
                iters.append(dec.last_stats.n_iter)
            good, false_pass = (int(v) for v in loop.tally.tolist())
            blocks = n * len(inputs.sent)
            failed = blocks - good - false_pass
            print(json.dumps({
                "config": args.config, "snr_db": snr, "seed": seed,
                "blocks": blocks, "crc_failed": failed,
                "bler": failed / blocks, "crc_false_pass": false_pass,
                "turbo_iters": float(np.mean(iters))}), flush=True)
            del loop, inputs
    return 0


if __name__ == "__main__":
    sys.exit(main())
