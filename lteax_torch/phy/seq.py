"""Gold scrambling sequence and CRS values (36.211 §7.2, §6.10.1).

Numpy copies of the host plan code in ``lteax.phy.seq`` (which imports jax
at load time); the tests hold each copy equal to its original.  The DL
receive chain needs only the host forms: the scrambling signs are
batch-invariant, so they are computed once per decoder.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np

NC = 1600  # Gold sequence offset (36.211 §7.2)
N_RB_MAX = 110


@lru_cache(maxsize=None)
def _gold_tables(n: int) -> tuple[np.ndarray, np.ndarray]:
    """Returns (x1_part (n,) uint8, basis (31, n) uint8): c = x1_part xor
    (c_init bits @ basis), the x2 register being linear in c_init."""
    total = NC + n + 31
    x1 = np.zeros(total, dtype=np.uint8)
    x1[0] = 1
    x2 = np.zeros(total, dtype=np.uint32)   # bit j = basis-j stream
    for j in range(31):
        x2[j] = 1 << j
    for k in range(total - 31):
        x1[k + 31] = x1[k + 3] ^ x1[k]
        x2[k + 31] = x2[k + 3] ^ x2[k + 2] ^ x2[k + 1] ^ x2[k]
    x1_part = x1[NC:NC + n].copy()
    basis = np.zeros((31, n), dtype=np.uint8)
    seg = x2[NC:NC + n]
    for j in range(31):
        basis[j] = (seg >> j) & 1
    return x1_part, basis


def gold_sequence_np(c_init: int, n: int) -> np.ndarray:
    """Pseudo-random sequence c (36.211 §7.2), (n,) int64 bits."""
    x1_part, basis = _gold_tables(n)
    cbits = np.array([(c_init >> j) & 1 for j in range(31)], dtype=np.int64)
    return ((cbits @ basis.astype(np.int64)) + x1_part) % 2


def scrambling_symbols_np(c_init: int, n: int) -> np.ndarray:
    """(1-2c) as float32 — multiply LLRs to descramble."""
    return (1.0 - 2.0 * gold_sequence_np(c_init, n)).astype(np.float32)


def pdsch_c_init(rnti: int, subframe: int, n_cell_id: int,
                 codeword: int = 0) -> int:
    """PDSCH scrambler init (36.211 §6.3.1)."""
    return (int(rnti) * 2 ** 14 + codeword * 2 ** 13 + int(subframe) * 512
            + int(n_cell_id))


@lru_cache(maxsize=None)
def crs_values(n_cell_id: int, ns: int, l: int, n_rb_dl: int,
               extended_cp: bool = False) -> np.ndarray:
    """(2*n_rb_dl,) complex64 CRS QPSK values r_{l,ns}(m') for slot ns,
    symbol l, trimmed to the central n_rb_dl."""
    n_cp = 0 if extended_cp else 1
    c_init = 1024 * (7 * (ns + 1) + l + 1) * (2 * n_cell_id + 1) \
        + 2 * n_cell_id + n_cp
    c = gold_sequence_np(c_init, 4 * N_RB_MAX)
    m = np.arange(2 * N_RB_MAX)
    r = ((1 - 2 * c[2 * m]) + 1j * (1 - 2 * c[2 * m + 1])) / np.sqrt(2)
    mp0 = N_RB_MAX - n_rb_dl
    return r[mp0:mp0 + 2 * n_rb_dl].astype(np.complex64)
