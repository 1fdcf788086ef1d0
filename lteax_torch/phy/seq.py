"""Gold scrambling sequence, CRS values, PSS and SSS (36.211 §7.2,
§6.10.1, §6.11).

Numpy copies of the host plan code in ``lteax.phy.seq`` (which imports jax
at load time); the tests hold each copy equal to its original.  The
receive chains need only the host forms: the scrambling signs and the
sync sequences are capture-invariant, so they are computed once.
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


# ---------------------------------------------------------------------------
# PSS — Zadoff-Chu length 63, roots 25/29/34 (36.211 §6.11.1)
# ---------------------------------------------------------------------------

PSS_ROOTS = (25, 29, 34)  # N_id_2 = 0, 1, 2


@lru_cache(maxsize=None)
def pss_sequence(n_id_2: int) -> np.ndarray:
    """(62,) complex64 frequency-domain PSS."""
    u = PSS_ROOTS[n_id_2]
    n = np.arange(62)
    d = np.where(
        n < 31,
        np.exp(-1j * np.pi * u * n * (n + 1) / 63.0),
        np.exp(-1j * np.pi * u * (n + 1) * (n + 2) / 63.0),
    )
    return d.astype(np.complex64)


# ---------------------------------------------------------------------------
# SSS — interleaved m-sequences (36.211 §6.11.2)
# ---------------------------------------------------------------------------

@lru_cache(maxsize=None)
def _m_seq(taps: tuple[int, ...]) -> np.ndarray:
    """Length-31 BPSK m-sequence: x(i+5) = xor of x(i+t) for t in taps,
    x(4) = 1 and x(0..3) = 0."""
    x = np.zeros(31, dtype=np.int64)
    x[4] = 1
    for i in range(26):
        x[i + 5] = np.bitwise_xor.reduce([x[i + t] for t in taps])
    return 1 - 2 * x


@lru_cache(maxsize=None)
def sss_m0_m1(n_id_1: int) -> tuple[int, int]:
    qp = n_id_1 // 30
    q = (n_id_1 + qp * (qp + 1) // 2) // 30
    mp = n_id_1 + q * (q + 1) // 2
    m0 = mp % 31
    m1 = (m0 + mp // 31 + 1) % 31
    return m0, m1


@lru_cache(maxsize=None)
def sss_sequence(n_id_1: int, n_id_2: int, subframe5: bool) -> np.ndarray:
    """(62,) float32 (BPSK) SSS for subframe 0 (False) or 5 (True)."""
    m0, m1 = sss_m0_m1(n_id_1)
    n = np.arange(31)
    s, c, z = _m_seq((2, 0)), _m_seq((3, 0)), _m_seq((4, 2, 1, 0))
    s0, s1 = s[(n + m0) % 31], s[(n + m1) % 31]
    c0, c1 = c[(n + n_id_2) % 31], c[(n + n_id_2 + 3) % 31]
    z1m0, z1m1 = z[(n + (m0 % 8)) % 31], z[(n + (m1 % 8)) % 31]
    d = np.zeros(62, dtype=np.float32)
    if not subframe5:
        d[0::2] = s0 * c0
        d[1::2] = s1 * c1 * z1m0
    else:
        d[0::2] = s1 * c0
        d[1::2] = s0 * c1 * z1m1
    return d


@lru_cache(maxsize=None)
def sss_bank(n_id_2: int, subframe5: bool) -> np.ndarray:
    """(168, 62) float32 correlation bank over all N_id_1 hypotheses."""
    return np.stack([sss_sequence(i, n_id_2, subframe5) for i in range(168)])
