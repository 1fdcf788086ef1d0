"""Multi-process dry run of the channel axis across processes (config #5's
shape); counterpart of ``bench/multihost_dryrun.py``.

    python -m lteax_torch.bench.multihost_dryrun [--nproc 2] [--device cpu]

``--nproc`` processes (``shard.mesh.spawn``, one gloo group: the
processes stand for hosts, and ranks that share a card need gloo) each own
two channels, one live cell (6 PRB, one frame, cell id 100 + rank, from
``apps.file_gen``) and one of noise, detect the PSS on their own device
(the correlator kernel on the card), and sum their detections over the
group (a process detects when the peak over both its channels passes 30
times their mean): every process must read ``nproc``.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch
import torch.distributed as dist

from lteax_torch.apps.file_gen import GenConfig, generate
from lteax_torch.phy.config import PhyConfig
from lteax_torch.phy.sync import pss_correlate
from lteax_torch.shard.mesh import device_type, spawn


def _worker(kind: str) -> int:
    idx, n = dist.get_rank(), dist.get_world_size()
    dev = torch.device("cuda", torch.cuda.current_device()) \
        if kind == "cuda" else torch.device("cpu")
    cfg = PhyConfig(n_rb_dl=6)
    rng = np.random.default_rng(idx)
    live = generate(GenConfig(n_rb_dl=6, n_cell_id=100 + idx, n_frames=1),
                    device=dev)
    dead = 0.01 * (rng.standard_normal(len(live))
                   + 1j * rng.standard_normal(len(live)))
    chans = torch.from_numpy(np.stack([live, dead]).astype(np.complex64))
    p = pss_correlate(chans.to(dev), cfg)        # both channels: one peak
    detected = (p.max() > 30.0 * p.mean()).to(torch.int64).reshape(1)
    total = detected.cpu()
    dist.all_reduce(total)
    n_detected = int(total)
    print(f"[proc {idx}] global detected cells: {n_detected}", flush=True)
    if n_detected != n:
        raise AssertionError((n_detected, n))
    return n_detected


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="channel axis across "
                                 "processes, cell count summed over gloo")
    ap.add_argument("--nproc", type=int, default=2)
    ap.add_argument("--device", default=None,
                    help="cuda (default; the processes share the cards) or "
                         "cpu")
    a = ap.parse_args(argv)
    kind = device_type(a.device)
    spawn(_worker, a.nproc, kind, "gloo", kind)
    print("multihost dryrun OK")


if __name__ == "__main__":
    main()
