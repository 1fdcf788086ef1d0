"""Modulation tables and mapper (36.211 §7.1).

Numpy copies of ``lteax.phy.mod.constellation`` and ``_pam_axis``; the
tests hold them equal to the originals.  The soft demapper is the demap
kernel (``lteax_torch.kernels.demap``): for the Gray square QAM schemes the
max-log subset minimum factorizes per axis into an L-level PAM problem,
which ``_pam_axis`` describes.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np

BITS_PER_SYM = {"bpsk": 1, "qpsk": 2, "16qam": 4, "64qam": 6}


@lru_cache(maxsize=None)
def constellation(scheme: str) -> np.ndarray:
    """(2**m,) complex64 table indexed by the bit-group value (b0 = MSB)."""
    m = BITS_PER_SYM[scheme]
    pts = np.zeros(2 ** m, dtype=np.complex64)
    for v in range(2 ** m):
        b = [(v >> (m - 1 - i)) & 1 for i in range(m)]
        if scheme == "bpsk":
            i_ = q_ = (1 - 2 * b[0]) / np.sqrt(2)
        elif scheme == "qpsk":
            i_ = (1 - 2 * b[0]) / np.sqrt(2)
            q_ = (1 - 2 * b[1]) / np.sqrt(2)
        elif scheme == "16qam":
            i_ = (1 - 2 * b[0]) * (2 - (1 - 2 * b[2])) / np.sqrt(10)
            q_ = (1 - 2 * b[1]) * (2 - (1 - 2 * b[3])) / np.sqrt(10)
        else:  # 64qam
            i_ = (1 - 2 * b[0]) * (4 - (1 - 2 * b[2]) * (2 - (1 - 2 * b[4]))) / np.sqrt(42)
            q_ = (1 - 2 * b[1]) * (4 - (1 - 2 * b[3]) * (2 - (1 - 2 * b[5]))) / np.sqrt(42)
        pts[v] = i_ + 1j * q_
    return pts


@lru_cache(maxsize=None)
def _pam_axis(scheme: str) -> tuple[np.ndarray, np.ndarray]:
    """Per-axis PAM decomposition of a Gray square QAM constellation.

    Returns (levels (L,) float32, bit_is_one (m/2, L) bool); the per-axis
    bit group is (b0, b2, b4)|I / (b1, b3, b5)|Q, one table for both axes.
    """
    ma = BITS_PER_SYM[scheme] // 2
    lv = np.zeros(2 ** ma, dtype=np.float32)
    for v in range(2 ** ma):
        b = [(v >> (ma - 1 - i)) & 1 for i in range(ma)]
        if scheme == "qpsk":
            lv[v] = (1 - 2 * b[0]) / np.sqrt(2)
        elif scheme == "16qam":
            lv[v] = (1 - 2 * b[0]) * (2 - (1 - 2 * b[1])) / np.sqrt(10)
        else:  # 64qam
            lv[v] = (1 - 2 * b[0]) * (4 - (1 - 2 * b[1]) * (2 - (1 - 2 * b[2]))) / np.sqrt(42)
    v = np.arange(2 ** ma)
    bit1 = np.stack([((v >> (ma - 1 - i)) & 1) for i in range(ma)]).astype(np.bool_)
    return lv, bit1


def modulate(bits: np.ndarray, scheme: str) -> np.ndarray:
    """bits (..., N*m) -> symbols (..., N) complex64 (table lookup, the
    same values as ``lteax.phy.mod.modulate``)."""
    m = BITS_PER_SYM[scheme]
    groups = np.asarray(bits).reshape(*np.shape(bits)[:-1], -1, m).astype(np.int64)
    weights = np.asarray([1 << (m - 1 - i) for i in range(m)], dtype=np.int64)
    return constellation(scheme)[groups @ weights]
