"""Turbo and convolutional rate-matching plans (36.212 §5.1.4.1-2).

Numpy copies of ``lteax.phy.fec.ratematch.turbo_rm_indices``,
``conv_rm_indices`` and ``unmatch_inv_cycles`` (whose module imports jax);
the tests hold them equal to the originals.  The whole rate match — sub-block interleave, circular
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


def unmatch_inv_cycles(idx: np.ndarray, d_total: int) -> np.ndarray:
    """Occurrence-rank inverse maps: a soft de-match scatter-add as a SUM
    OF GATHERS.

    Returns inv (n_cycles, d_total) int32 with inv[k, p] = the e-position of
    the (k+1)-th transmission of d-flat bit p, or ``len(idx)`` (a zero slot
    appended to e).  n_cycles is the largest repetition count: 1 when the
    rate match is injective, ceil(E/L) when the circular buffer wraps."""
    idx = np.asarray(idx, dtype=np.int64)
    e_len = len(idx)
    order = np.argsort(idx, kind="stable")
    si = idx[order]
    first = np.r_[True, si[1:] != si[:-1]]
    grp_start = np.maximum.accumulate(np.where(first, np.arange(e_len), 0))
    rank = np.arange(e_len) - grp_start
    n_cycles = int(rank.max()) + 1 if e_len else 1
    inv = np.full((n_cycles, d_total), e_len, dtype=np.int32)
    inv[rank, si] = order.astype(np.int32)
    return inv


# bounded: one (n_cycles, 3D) int32 entry per live de-match geometry
@lru_cache(maxsize=64)
def _unmatch_cycles(idx_key: bytes, d_total: int) -> np.ndarray:
    return unmatch_inv_cycles(np.frombuffer(idx_key, dtype=np.int32), d_total)


def sum_gathers(ext: torch.Tensor, inv) -> torch.Tensor:
    """The soft de-match of ``ext`` (..., E+1), whose last slot is a zero,
    through occurrence-rank maps ``inv`` (n_cycles, N): one gather a cycle,
    summed in the order the repeats were sent — not a scatter-add, whose
    atomic additions on a CUDA device come in no fixed order — so a card
    and a CPU give the same LLRs.  -> (..., N)."""
    out = ext[..., inv[0]]
    for row in inv[1:]:
        out = out + ext[..., row]
    return out


def rate_unmatch(e_llrs: torch.Tensor, idx: np.ndarray,
                 d_len: int) -> torch.Tensor:
    """e_llrs (..., E) -> d LLRs (..., 3, D); repeats soft-combine by
    addition (:func:`sum_gathers`)."""
    inv = torch.as_tensor(_unmatch_cycles(np.asarray(idx, np.int32)
                                          .tobytes(), 3 * d_len),
                          dtype=torch.int64, device=e_llrs.device)
    ext = torch.nn.functional.pad(e_llrs, (0, 1))      # the zero slot
    return sum_gathers(ext, inv).reshape(*e_llrs.shape[:-1], 3, d_len)
