"""PDSCH geometry, rate de-match plan and desegmentation (36.212 §5.3.2).

``pdsch_geometry``, ``_global_rm_idx`` and ``_global_rm_inv`` are numpy
copies of the plan code in ``lteax.phy.channels.pdsch``; segmentation is the
port's own copy too (``lteax_torch.phy.fec.segmentation``).  The port imports
nothing of ``lteax``; the tests hold each copy equal to its original.
"""

from __future__ import annotations

import dataclasses
from functools import lru_cache

import numpy as np
import torch

from lteax_torch.phy.fec.segmentation import SegmentInfo, segment_info
from lteax_torch.phy.fec.ratematch import turbo_rm_indices


@dataclasses.dataclass(frozen=True)
class PdschGeometry:
    """Static per-(TBS, n_re, Qm, rv) geometry."""
    tbs: int
    n_re: int
    qm: int
    rv: int
    info: SegmentInfo
    e_list: tuple[int, ...]

    @property
    def k(self) -> int:
        return self.info.k_plus

    @property
    def g(self) -> int:
        return self.n_re * self.qm


@lru_cache(maxsize=None)
def pdsch_geometry(tbs: int, n_re: int, qm: int, rv: int) -> PdschGeometry:
    info = segment_info(tbs + 24)
    if not info.uniform:
        raise NotImplementedError("non-uniform codeblock segmentation")
    g = n_re * qm
    c = info.c
    gp = g // qm
    gamma = gp % c
    e_small = qm * (gp // c)
    e_big = qm * (-(-gp // c))
    e_list = tuple([e_small] * (c - gamma) + [e_big] * gamma)
    assert sum(e_list) == g, (sum(e_list), g)
    return PdschGeometry(tbs=tbs, n_re=n_re, qm=qm, rv=rv, info=info,
                         e_list=e_list)


@lru_cache(maxsize=None)
def _global_rm_idx(geom: PdschGeometry) -> np.ndarray:
    """(G,) indices into flattened per-CB d streams (C * 3*(K+4))."""
    d_len = geom.k + 4
    parts = []
    for c, e in enumerate(geom.e_list):
        idx = turbo_rm_indices(d_len, e, geom.rv)
        parts.append(c * 3 * d_len + idx.astype(np.int64))
    return np.concatenate(parts).astype(np.int32)


@lru_cache(maxsize=None)
def _global_rm_inv(geom: PdschGeometry):
    """Inverse map for gather-based de-matching: (inv (C*3D,), injective).

    inv[p] = position in e of d-flat bit p, or G (a zero sentinel) if never
    transmitted; valid only when no bit is transmitted twice."""
    idx = _global_rm_idx(geom).astype(np.int64)
    d_total = geom.info.c * 3 * (geom.k + 4)
    counts = np.bincount(idx, minlength=d_total)
    injective = bool(counts.max() <= 1)
    inv = np.full(d_total, geom.g, dtype=np.int32)
    if injective:
        inv[idx] = np.arange(geom.g, dtype=np.int32)
    return inv, injective


def desegment_device(payload: torch.Tensor, info: SegmentInfo) -> torch.Tensor:
    """Desegmentation (uniform K): (..., C, K_payload) -> (..., B)."""
    parts = [payload[..., 0, info.f:]]
    for ci in range(1, info.c):
        parts.append(payload[..., ci, :])
    return torch.cat(parts, dim=-1)
