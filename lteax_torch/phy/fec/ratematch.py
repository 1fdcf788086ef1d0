"""Turbo rate-matching plan (36.212 §5.1.4.1).

Numpy copy of ``lteax.phy.fec.ratematch.turbo_rm_indices`` (whose module
imports jax); the tests hold it equal to the original.  The whole rate
match — sub-block interleave, circular buffer, NULL skipping, rv offset —
is one index vector ``e = d_flat[idx]``; de-matching is its inverse gather
(``lteax_torch.phy.channels.pdsch``).
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np

# Table 5.1.4-1 (turbo) inter-column permutation, 32 columns
PERM_TURBO = np.array(
    [0, 16, 8, 24, 4, 20, 12, 28, 2, 18, 10, 26, 6, 22, 14, 30,
     1, 17, 9, 25, 5, 21, 13, 29, 3, 19, 11, 27, 7, 23, 15, 31],
    dtype=np.int64)

_C = 32  # sub-block interleaver columns


def _subblock_col_read(d_len: int, perm: np.ndarray) -> np.ndarray:
    """(R*32,) positions into the ND-padded stream, read column-wise after
    the inter-column permutation."""
    r = -(-d_len // _C)
    cols = np.repeat(perm, r)
    rows = np.tile(np.arange(r), _C)
    return rows * _C + cols


@lru_cache(maxsize=None)
def turbo_rm_indices(d_len: int, e_len: int, rv: int,
                     n_cb: int | None = None) -> np.ndarray:
    """(E,) int32 indices into flat d = [d0 | d1 | d2], each D = K+4."""
    D = d_len
    R = -(-D // _C)
    Kp = R * _C
    ND = Kp - D
    v01 = _subblock_col_read(D, PERM_TURBO)                    # streams 0, 1
    k_arr = np.arange(Kp, dtype=np.int64)
    v2 = (PERM_TURBO[k_arr // R] + _C * (k_arr % R) + 1) % Kp  # stream 2
    w2d = np.full(3 * Kp, -1, dtype=np.int64)                  # -1 == NULL
    w2d[:Kp] = np.where(v01 >= ND, v01 - ND, -1)
    w2d[Kp::2] = np.where(v01 >= ND, D + v01 - ND, -1)
    w2d[Kp + 1::2] = np.where(v2 >= ND, 2 * D + v2 - ND, -1)
    Kw = 3 * Kp
    ncb = Kw if n_cb is None else min(n_cb, Kw)
    k0 = R * (2 * (-(-ncb // (8 * R))) * rv + 2)
    order = (k0 + np.arange(ncb)) % ncb
    valid = order[w2d[order] >= 0]
    idx = w2d[valid[np.arange(e_len) % len(valid)]]
    return idx.astype(np.int32)
