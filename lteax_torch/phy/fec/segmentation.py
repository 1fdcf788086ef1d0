"""Code block segmentation and concatenation (36.212 §5.1.2).

(reference capability: segmentation logic inside
``liblte/src/liblte_phy.cc :: liblte_phy_pdsch_channel_encode`` /
``turbo_encode`` call sites.)

Host-side: sizes (C, K+, K-, F) are static per transport-block size, so the
split is computed once in numpy and the device sees fixed shapes.  LTE TBS
values are designed so that B' / C usually lands exactly on a valid K
(uniform codeblocks); the general two-size case is represented by padding
K- blocks up to K+ with filler (static masks), which this module reports.

The port's own copy of ``lteax/phy/fec/segmentation.py``: the port
imports nothing of the JAX package, and ``tests/test_torch_plans.py``
holds the two equal.
"""

from __future__ import annotations

import dataclasses
from functools import lru_cache

import numpy as np

from lteax_torch.phy.tables.turbo_qpp import VALID_K, smallest_valid_k

Z_MAX = 6144  # maximum turbo codeblock size
L_CB = 24     # per-codeblock CRC24B length when C > 1


@dataclasses.dataclass(frozen=True)
class SegmentInfo:
    b: int            # input bits (incl. TB CRC24A)
    c: int            # number of code blocks
    k_plus: int
    k_minus: int      # 0 if unused
    c_plus: int
    c_minus: int
    f: int            # filler bits (prepended to block 0)
    cb_crc: bool      # whether each block carries CRC24B

    @property
    def k_list(self) -> tuple[int, ...]:
        return (self.k_minus,) * self.c_minus + (self.k_plus,) * self.c_plus

    @property
    def uniform(self) -> bool:
        return self.c_minus == 0


@lru_cache(maxsize=None)
def segment_info(b: int) -> SegmentInfo:
    """36.212 §5.1.2 exactly."""
    if b <= Z_MAX:
        c, bp, cb_crc = 1, b, False
    else:
        c = -(-b // (Z_MAX - L_CB))
        bp = b + c * L_CB
        cb_crc = True
    k_plus = smallest_valid_k(-(-bp // c))
    if c == 1:
        k_minus, c_minus, c_plus = 0, 0, 1
        f = k_plus - bp
    else:
        idx = int(np.searchsorted(VALID_K, k_plus)) - 1
        k_minus = int(VALID_K[idx]) if idx >= 0 else 0
        dk = k_plus - k_minus
        c_minus = (c * k_plus - bp) // dk if dk else 0
        c_plus = c - c_minus
        f = c_plus * k_plus + c_minus * k_minus - bp
    return SegmentInfo(b=b, c=c, k_plus=k_plus, k_minus=k_minus,
                       c_plus=c_plus, c_minus=c_minus, f=f, cb_crc=cb_crc)


def segment_bits(bits: np.ndarray, info: SegmentInfo) -> np.ndarray:
    """Split TB bits (B,) -> (C, K) numpy int array of codeblock payloads
    WITHOUT codeblock CRC attached (CRC24B is attached by the encoder so it
    can run on device).  Filler bits are zeros at the start of block 0
    (36.212 sets them <NULL>; value 0 on the encoder side is the universal
    convention, the decoder discards them).

    Requires uniform segmentation (info.uniform) for a single static K; the
    mixed K+/K- case pads the first C- blocks — not yet wired into the device
    path (LTE TBS tables make uniform the overwhelmingly common case).
    """
    if not info.uniform:
        raise NotImplementedError("non-uniform codeblock sizes not yet wired")
    k = info.k_plus
    payload = k - (L_CB if info.cb_crc else 0)
    out = np.zeros((info.c, payload), dtype=np.int64)
    pos = 0
    for ci in range(info.c):
        start = info.f if ci == 0 else 0
        take = payload - start
        out[ci, start:] = bits[pos:pos + take]
        pos += take
    assert pos == info.b
    return out


def desegment_bits(blocks: np.ndarray, info: SegmentInfo) -> np.ndarray:
    """Inverse of segment_bits: (C, K_payload) -> (B,)."""
    payload = blocks.shape[-1]
    parts = [blocks[0, info.f:]]
    for ci in range(1, info.c):
        parts.append(blocks[ci])
    out = np.concatenate(parts)
    assert len(out) == info.b, (len(out), info.b)
    return out


# ---------------------------------------------------------------------------
# General (mixed K+/K-) segmentation — 36.212 §5.1.2 without the uniform
# restriction.  No TBS in the 36.213 tables produces a mixed split (verified
# over all 151 carried TBS values), so this path exists for spec completeness
# and arbitrary-B users; the batched device pipeline keeps the single-K fast
# path.  Blocks are grouped per K so each bucket is still a static-shape
# device batch (C-, K-) / (C+, K+).
# ---------------------------------------------------------------------------

def segment_bits_general(bits: np.ndarray, info: SegmentInfo) -> list:
    """TB bits (B,) -> list of C payload arrays (K_r - 24 if cb_crc else K_r).

    Block order is the spec's: the C- short blocks first, then C+ long ones;
    filler zeros prepend block 0."""
    out: list[np.ndarray] = []
    pos = 0
    for ci, k in enumerate(info.k_list):
        payload = k - (L_CB if info.cb_crc else 0)
        blk = np.zeros(payload, dtype=np.int64)
        start = info.f if ci == 0 else 0
        take = payload - start
        blk[start:] = bits[pos:pos + take]
        pos += take
        out.append(blk)
    assert pos == info.b, (pos, info.b)
    return out


def desegment_bits_general(blocks: list, info: SegmentInfo) -> np.ndarray:
    """Inverse of segment_bits_general: list of (K_payload_r,) -> (B,)."""
    parts = [np.asarray(blocks[0])[info.f:]]
    parts.extend(np.asarray(b) for b in blocks[1:])
    out = np.concatenate(parts)
    assert len(out) == info.b, (len(out), info.b)
    return out


def k_buckets(info: SegmentInfo) -> list:
    """(k, block_indices) per distinct K — each a static-shape device batch."""
    buckets: dict[int, list[int]] = {}
    for ci, k in enumerate(info.k_list):
        buckets.setdefault(k, []).append(ci)
    return sorted(buckets.items())
