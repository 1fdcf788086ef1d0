"""Channel-batched PSS prescan (config #5's stage 1) on one device;
counterpart of ``lteax.shard.scanner``.

PSS detection metrics for ALL channels in one batched call: the PSS
correlator kernel over (n_chan, L), then per-channel reductions, and one
host read for the whole batch.  The reference shards the channel axis over
a mesh and sums the detections with a ``psum``; on one device that sum is
the plain sum.
"""

from __future__ import annotations

import torch

from lteax_torch.phy.config import PhyConfig
from lteax_torch.host import read
from lteax_torch.phy.sync import pss_correlate, pss_peak


def make_pss_detector(cfg: PhyConfig, threshold: float = 30.0):
    """-> fn: (n_chan, L) complex64 -> (detected (n_chan,) bool,
    n_id_2 (n_chan,) int32, pss_idx (n_chan,) int32, peak_ratio
    (n_chan,) f32, n_detected scalar int32), all on the input's device."""

    def detect(x: torch.Tensor):
        p = pss_correlate(x, cfg)                     # (n_chan, 3, L)
        nid2, idx, peak = pss_peak(p)
        ratio = peak / torch.clamp_min(p.mean(dim=(-2, -1)), 1e-20)
        det = ratio > threshold
        return (det, nid2.to(torch.int32), idx.to(torch.int32), ratio,
                det.to(torch.int32).sum())

    return detect


def batched_prescan(captures: torch.Tensor, cfg: PhyConfig,
                    threshold: float = 30.0) -> list[dict]:
    """(n_chan, L) complex captures -> per-channel detection dicts, with
    one device -> host read."""
    det, nid2, idx, ratio, _ = make_pss_detector(cfg, threshold)(captures)
    d, n, i, r = read(torch.stack([det.double(), nid2.double(),
                                   idx.double(), ratio.double()]))
    return [{"detected": bool(d[c]), "n_id_2": int(n[c]),
             "pss_idx": int(i[c]), "peak_ratio": r[c]}
            for c in range(len(d))]
