"""Turbo and convolutional rate-matching plans (36.212 §5.1.4.1-2).

Numpy copies of ``lteax.phy.fec.ratematch.turbo_rm_indices`` and
``conv_rm_indices`` (whose module imports jax); the tests hold them equal
to the originals.  The whole rate match — sub-block interleave, circular
buffer, NULL skipping, rv offset — is one index vector
``e = d_flat[idx]``; de-matching is its inverse (turbo:
``lteax_torch.phy.channels.pdsch``; convolutional: :func:`rate_unmatch`).
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

# Table 5.1.4-1 (turbo) inter-column permutation, 32 columns
PERM_TURBO = np.array(
    [0, 16, 8, 24, 4, 20, 12, 28, 2, 18, 10, 26, 6, 22, 14, 30,
     1, 17, 9, 25, 5, 21, 13, 29, 3, 19, 11, 27, 7, 23, 15, 31],
    dtype=np.int64)

# Table 5.1.4-2 (convolutional)
PERM_CONV = np.array(
    [1, 17, 9, 25, 5, 21, 13, 29, 3, 19, 11, 27, 7, 23, 15, 31,
     0, 16, 8, 24, 4, 20, 12, 28, 2, 18, 10, 26, 6, 22, 14, 30],
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


@lru_cache(maxsize=None)
def conv_rm_indices(d_len: int, e_len: int) -> np.ndarray:
    """(E,) int32 indices into flat d = [d0 | d1 | d2] (36.212 §5.1.4.2)."""
    D = d_len
    R = -(-D // _C)
    Kp = R * _C
    ND = Kp - D
    v = _subblock_col_read(D, PERM_CONV)
    w2d = np.concatenate([
        np.where(v >= ND, s * D + v - ND, -1) for s in range(3)
    ])
    order = np.arange(3 * Kp)
    valid = order[w2d[order] >= 0]
    idx = w2d[valid[np.arange(e_len) % len(valid)]]
    return idx.astype(np.int32)


def rate_match(d: np.ndarray, idx: np.ndarray) -> np.ndarray:
    """d (..., 3, D) encoded streams -> e (..., E) transmitted bits."""
    d = np.asarray(d)
    return d.reshape(*d.shape[:-2], -1)[..., idx]


@lru_cache(maxsize=None)
def _unmatch_cycles(idx_key: bytes, d_total: int) -> np.ndarray:
    """(n_cycles, d_total) int64: row k holds, for each d-flat position,
    the e-position of its (k+1)-th transmission, or E (a zero slot)."""
    idx = np.frombuffer(idx_key, dtype=np.int32)
    e_len = len(idx)
    counts = np.bincount(idx, minlength=d_total)
    inv = np.full((max(int(counts.max()), 1), d_total), e_len, np.int64)
    seen = np.zeros(d_total, np.int64)
    for e, p in enumerate(idx):
        inv[seen[p], p] = e
        seen[p] += 1
    return inv


def rate_unmatch(e_llrs: torch.Tensor, idx: np.ndarray,
                 d_len: int) -> torch.Tensor:
    """e_llrs (..., E) -> d LLRs (..., 3, D); repeats soft-combine by
    addition.

    The repeats of each position are summed in the order they were sent,
    as a sum of gathers — not a scatter-add, whose atomic additions on a
    CUDA device come in no fixed order — so a card and a CPU give the same
    LLRs."""
    inv = torch.as_tensor(_unmatch_cycles(np.asarray(idx, np.int32)
                                          .tobytes(), 3 * d_len),
                          device=e_llrs.device)
    ext = torch.nn.functional.pad(e_llrs, (0, 1))      # the zero slot
    out = torch.zeros((*e_llrs.shape[:-1], 3 * d_len), dtype=e_llrs.dtype,
                      device=e_llrs.device)
    for row in inv:
        out = out + ext[..., row]
    return out.reshape(*e_llrs.shape[:-1], 3, d_len)
