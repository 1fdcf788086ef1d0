"""Channel-batched PSS prescan (config #5's stage 1); counterpart of
``lteax.shard.scanner``.

PSS detection metrics for ALL channels in one batched call: the PSS
correlator kernel over (n_chan, L), then per-channel reductions, and one
host read for the whole batch.  On one device the detections' count is a
plain sum.  Over a rank mesh the channel axis is split over ``chan``
(:func:`make_sharded_pss_detector`): each rank correlates its own
channels, and the count is summed over ``chan`` and then over ``time``,
as the reference's two ``psum``s do; ``time`` replicas hold the same
channels, so on a mesh with n_time > 1 that count is n_time times the
distinct detections, in the reference too.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from lteax_torch.phy.config import PhyConfig
from lteax_torch.host import read
from lteax_torch.phy.sync import pss_correlate, pss_peak
from lteax_torch.shard.mesh import (CHAN_AXIS, TIME_AXIS, all_gather,
                                    all_reduce, axis_size, local_slice)


def make_pss_detector(cfg: PhyConfig, threshold: float = 30.0,
                      mdtype: str = "bf16"):
    """-> fn: (n_chan, L) complex64 -> (detected (n_chan,) bool,
    n_id_2 (n_chan,) int32, pss_idx (n_chan,) int32, peak_ratio
    (n_chan,) f32, n_detected scalar int32), all on the input's device."""

    def detect(x: torch.Tensor):
        p = pss_correlate(x, cfg, mdtype)              # (n_chan, 3, L)
        nid2, idx, peak = pss_peak(p)
        ratio = peak / torch.clamp_min(p.mean(dim=(-2, -1)), 1e-20)
        det = ratio > threshold
        return (det, nid2.to(torch.int32), idx.to(torch.int32), ratio,
                det.to(torch.int32).sum())

    return detect


def make_sharded_pss_detector(mesh, cfg: PhyConfig, capture_len: int,
                              threshold: float = 30.0, mdtype: str = "bf16"):
    """-> fn: this rank's ``chan`` slice (n_chan / n_chan_shards,
    ``capture_len``) complex64 -> (detected, n_id_2, pss_idx, peak_ratio
    of the local channels, n_detected summed over the mesh as a python
    int)."""
    detect = make_pss_detector(cfg, threshold, mdtype)

    def local(x: torch.Tensor):
        if x.shape[-1] != capture_len:
            raise ValueError(f"captures of {x.shape[-1]} samples, detector "
                             f"built for {capture_len}")
        det, nid2, idx, ratio, n_det = detect(x)
        n_det = all_reduce(n_det, dist.ReduceOp.SUM, mesh, CHAN_AXIS)
        n_det = all_reduce(n_det, dist.ReduceOp.SUM, mesh, TIME_AXIS)
        return det, nid2, idx, ratio, int(n_det)

    return local


def batched_prescan(captures: torch.Tensor, cfg: PhyConfig,
                    threshold: float = 30.0, mdtype: str = "bf16",
                    mesh=None) -> list[dict]:
    """(n_chan, L) complex captures -> per-channel detection dicts, with
    one device -> host read.  With a ``mesh`` every rank passes all the
    captures, the channel count is padded to the ``chan`` size, each rank
    detects its ``chan`` slice and every rank returns all the dicts."""
    if mesh is None:
        det, nid2, idx, ratio, _ = make_pss_detector(cfg, threshold,
                                                     mdtype)(captures)
        res = torch.stack([det.double(), nid2.double(), idx.double(),
                           ratio.double()])
    else:
        n_chan, l = captures.shape
        pad = (-n_chan) % axis_size(mesh, CHAN_AXIS)
        x = torch.cat([captures, captures.new_zeros((pad, l))]) \
            if pad else captures
        det, nid2, idx, ratio, _ = make_sharded_pss_detector(
            mesh, cfg, l, threshold, mdtype)(local_slice(x, mesh, 0,
                                                         CHAN_AXIS))
        res = all_gather(torch.stack([det.double(), nid2.double(),
                                      idx.double(), ratio.double()]),
                         mesh, CHAN_AXIS)
        res = res.permute(1, 0, 2).reshape(4, -1)[:, :n_chan]
    d, n, i, r = read(res)
    return [{"detected": bool(d[c]), "n_id_2": int(n[c]),
             "pss_idx": int(i[c]), "peak_ratio": r[c]}
            for c in range(len(d))]
