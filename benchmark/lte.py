"""The benchmark's frozen copy of the LTE primitives (36.211, 36.212).

Copied from the port's numpy plan code (``lteax_torch/phy/config.py``,
``seq.py``, ``grid.py``, ``mod.py``, ``fec/crc.py``, ``fec/segmentation.py``,
``fec/turbo.py``, ``fec/ratematch.py``, ``tables/turbo_qpp.py``,
``channels/pdsch.py`` and ``channels/pusch.py``) and frozen here, so that a
change to the program cannot move the yardstick: the transmitters
(``benchmark/tx.py``) and the plain receivers (``benchmark/reference.py``)
use these and nothing of the program.  Only the pieces the benchmark's
configurations reach are kept: normal cyclic prefix, CRS ports 0 and 1,
PDSCH codewords 0 and 1, uniform codeblock segmentation.
"""

from __future__ import annotations

import dataclasses
from functools import lru_cache

import numpy as np

# -- numerology (36.211 §6.2.3, §6.12) --

NRB_TO_NFFT = {6: 128, 15: 256, 25: 512, 50: 1024, 75: 1536, 100: 2048}
N_SYM_SLOT = 7
N_SYM_SUBFRAME = 14


@dataclasses.dataclass(frozen=True)
class Numerology:
    """Normal-CP numerology of ``n_rb`` resource blocks."""
    n_rb: int

    @property
    def n_fft(self) -> int:
        return NRB_TO_NFFT[self.n_rb]

    @property
    def n_sc(self) -> int:
        return 12 * self.n_rb

    @property
    def cp_lengths(self) -> tuple[int, ...]:
        """CP samples of the 14 symbols of a subframe."""
        return tuple([160 * self.n_fft // 2048]
                     + [144 * self.n_fft // 2048] * 6) * 2

    @property
    def symbol_starts(self) -> np.ndarray:
        """Sample offset of each symbol's data part in a subframe."""
        starts, off = [], 0
        for cp in self.cp_lengths:
            off += cp
            starts.append(off)
            off += self.n_fft
        return np.asarray(starts)

    @property
    def sc_to_fft_bin(self) -> np.ndarray:
        """Occupied subcarrier (low to high frequency) -> FFT bin; DC
        unused."""
        half = self.n_sc // 2
        return np.concatenate([np.arange(self.n_fft - half, self.n_fft),
                               np.arange(1, half + 1)]).astype(np.int64)


def subframe_to_samples(grid: np.ndarray, num: Numerology) -> np.ndarray:
    """Grids (..., 14, n_sc) -> time samples (..., n_samps) complex64:
    orthonormal IFFT, cyclic prefix."""
    freq = np.zeros((*grid.shape[:-1], num.n_fft), np.complex64)
    freq[..., num.sc_to_fft_bin] = grid
    t = np.fft.ifft(freq, axis=-1) * np.sqrt(num.n_fft)
    parts = [np.concatenate([t[..., s, -cp:], t[..., s, :]], axis=-1)
             for s, cp in enumerate(num.cp_lengths)]
    return np.concatenate(parts, axis=-1).astype(np.complex64)


# -- Gold sequence, CRS (36.211 §7.2, §6.10.1) --

NC = 1600
N_RB_MAX = 110


@lru_cache(maxsize=None)
def _gold_tables(n: int) -> tuple[np.ndarray, np.ndarray]:
    """(x1 part (n,), basis (31, n)): c = x1 xor (c_init bits @ basis)."""
    total = NC + n + 31
    x1 = np.zeros(total, dtype=np.uint8)
    x1[0] = 1
    x2 = np.zeros(total, dtype=np.uint32)
    for j in range(31):
        x2[j] = 1 << j
    for k in range(total - 31):
        x1[k + 31] = x1[k + 3] ^ x1[k]
        x2[k + 31] = x2[k + 3] ^ x2[k + 2] ^ x2[k + 1] ^ x2[k]
    seg = x2[NC:NC + n]
    basis = np.stack([(seg >> j) & 1 for j in range(31)]).astype(np.uint8)
    return x1[NC:NC + n].copy(), basis


def gold(c_init: int, n: int) -> np.ndarray:
    """Pseudo-random sequence c (36.211 §7.2), (n,) int64 bits."""
    x1, basis = _gold_tables(n)
    cbits = np.array([(c_init >> j) & 1 for j in range(31)], dtype=np.int64)
    return ((cbits @ basis.astype(np.int64)) + x1) % 2


def pdsch_c_init(rnti: int, subframe: int, n_cell_id: int, q: int = 0) -> int:
    """PDSCH scrambler init of codeword ``q`` (36.211 §6.3.1):
    n_RNTI 2^14 + q 2^13 + floor(n_s / 2) 2^9 + N_ID^cell."""
    return rnti * 2 ** 14 + q * 2 ** 13 + subframe * 512 + n_cell_id


def pusch_c_init(rnti: int, subframe: int, n_cell_id: int) -> int:
    """PUSCH scrambler init (36.211 §5.3.1)."""
    return rnti * 2 ** 14 + subframe * 512 + n_cell_id


CRS_SYMS = (0, 4, 7, 11)
"""Ports 0 and 1's CRS symbols of a normal-CP subframe."""


def crs_shift(sym: int, n_cell_id: int, port: int = 0) -> int:
    """CRS comb offset of ``port`` (0 or 1) in subframe symbol ``sym``:
    v = 0 in symbol 0 of a slot and 3 in symbol 4 for port 0, the other
    way round for port 1 (§6.10.1.2)."""
    return ((0 if sym % N_SYM_SLOT == 0 else 3) + 3 * port
            + n_cell_id % 6) % 6


def crs_values(n_cell_id: int, ns: int, l: int, n_rb: int) -> np.ndarray:
    """(2 n_rb,) CRS QPSK values of slot ns, symbol l, central n_rb."""
    c_init = (1024 * (7 * (ns + 1) + l + 1) * (2 * n_cell_id + 1)
              + 2 * n_cell_id + 1)
    c = gold(c_init, 4 * N_RB_MAX)
    m = np.arange(2 * N_RB_MAX)
    r = ((1 - 2 * c[2 * m]) + 1j * (1 - 2 * c[2 * m + 1])) / np.sqrt(2)
    return r[N_RB_MAX - n_rb:N_RB_MAX + n_rb].astype(np.complex64)


def crs_grid(num: Numerology, n_cell_id: int, subframe: int, port: int = 0):
    """-> (flat indices (4, 2 n_rb), values (4, 2 n_rb)) of the CRS of
    ``port`` (0 or 1) in a (14 * n_sc) grid; both ports send the same
    values."""
    if port not in (0, 1):
        raise ValueError(f"CRS port {port}: only ports 0 and 1 are kept")
    idx, val = [], []
    for sym in CRS_SYMS:
        k = 6 * np.arange(2 * num.n_rb) + crs_shift(sym, n_cell_id, port)
        idx.append(sym * num.n_sc + k)
        val.append(crs_values(n_cell_id, 2 * subframe + sym // N_SYM_SLOT,
                              sym % N_SYM_SLOT, num.n_rb))
    return np.stack(idx), np.stack(val)


def pdsch_re_idx(num: Numerology, n_cell_id: int, cfi: int,
                 subframe: int, crs_ports: int = 1) -> np.ndarray:
    """Flat indices of a full-band PDSCH allocation's REs in a cell of
    ``crs_ports`` (1 or 2) CRS ports, frequency first, symbols cfi..13,
    skipping every port's CRS, and PSS / SSS / PBCH in subframes 0 and 5
    (36.211 §6.3.5, §6.4)."""
    reserved = np.zeros((N_SYM_SUBFRAME, num.n_sc), bool)
    for port in range(crs_ports):
        reserved.reshape(-1)[
            crs_grid(num, n_cell_id, subframe, port)[0].ravel()] = True
    c72 = num.n_sc // 2 - 36 + np.arange(72)
    if subframe in (0, 5):
        reserved[N_SYM_SLOT - 1, c72] = reserved[N_SYM_SLOT - 2, c72] = True
    if subframe == 0:
        reserved[N_SYM_SLOT:N_SYM_SLOT + 4, c72] = True
    sc = np.arange(num.n_sc)
    return np.concatenate([s * num.n_sc + sc[~reserved[s]]
                           for s in range(cfi, N_SYM_SUBFRAME)])


# -- modulation (36.211 §7.1) --

BITS_PER_SYM = {"qpsk": 2, "16qam": 4, "64qam": 6}


@lru_cache(maxsize=None)
def pam_axis(scheme: str) -> tuple[np.ndarray, np.ndarray]:
    """Per-axis PAM of a Gray square QAM: (levels (L,), bit_is_one
    (m/2, L)); the axis bits are (b0, b2, b4) on I, (b1, b3, b5) on Q."""
    ma = BITS_PER_SYM[scheme] // 2
    v = np.arange(2 ** ma)
    bits = np.stack([(v >> (ma - 1 - i)) & 1 for i in range(ma)])
    s = 1 - 2 * bits
    if ma == 1:
        lv = s[0] / np.sqrt(2)
    elif ma == 2:
        lv = s[0] * (2 - s[1]) / np.sqrt(10)
    else:
        lv = s[0] * (4 - s[1] * (2 - s[2])) / np.sqrt(42)
    return lv.astype(np.float64), bits.astype(bool)


def modulate(bits: np.ndarray, scheme: str) -> np.ndarray:
    """bits (..., N m) -> symbols (..., N) complex64 (b0 on I, b1 on Q)."""
    m = BITS_PER_SYM[scheme]
    g = np.asarray(bits).reshape(*np.shape(bits)[:-1], -1, m)
    lv, _ = pam_axis(scheme)
    w = 1 << np.arange(m // 2 - 1, -1, -1)
    i_ = lv[g[..., 0::2] @ w]
    q_ = lv[g[..., 1::2] @ w]
    return (i_ + 1j * q_).astype(np.complex64)


# -- CRC (36.212 §5.1.1) --

CRC_POLYS = {"24A": 0x864CFB, "24B": 0x800063}


@lru_cache(maxsize=None)
def crc_matrix(n_bits: int, kind: str) -> np.ndarray:
    """(n_bits, 24) uint8: crc(m) = m @ M mod 2, m MSB first."""
    poly, mask = CRC_POLYS[kind], (1 << 24) - 1
    rems = np.zeros((n_bits, 24), dtype=np.uint8)
    r = 1
    for _ in range(24):
        r <<= 1
        if r >> 24:
            r = (r & mask) ^ poly
    for i in range(n_bits):
        rems[n_bits - 1 - i] = [(r >> (23 - j)) & 1 for j in range(24)]
        r <<= 1
        if r >> 24:
            r = (r & mask) ^ poly
    return rems


def crc_parity(bits: np.ndarray, kind: str) -> np.ndarray:
    """(..., N) bits -> (..., 24) CRC parity."""
    m = crc_matrix(bits.shape[-1], kind).astype(np.float32)
    return (bits.astype(np.float32) @ m).astype(np.int64) % 2


def attach_crc(bits: np.ndarray, kind: str) -> np.ndarray:
    return np.concatenate([bits.astype(np.int64), crc_parity(bits, kind)],
                          axis=-1)


def crc_ok(bits_with_crc: np.ndarray, kind: str) -> np.ndarray:
    """(..., N + 24) -> (...,) bool."""
    return np.all(crc_parity(bits_with_crc[..., :-24], kind)
                  == bits_with_crc[..., -24:], axis=-1)


# -- turbo code (36.212 §5.1.3.2) --

QPP_TABLE: dict[int, tuple[int, int]] = {
    40: (3, 10), 48: (7, 12), 56: (19, 42), 64: (7, 16), 72: (7, 18),
    80: (11, 20), 88: (5, 22), 96: (11, 24), 104: (7, 26), 112: (41, 84),
    120: (103, 90), 128: (15, 32), 136: (9, 34), 144: (17, 108), 152: (9, 38),
    160: (21, 120), 168: (101, 84), 176: (21, 44), 184: (57, 46), 192: (23, 48),
    200: (13, 50), 208: (27, 52), 216: (11, 36), 224: (27, 56), 232: (85, 58),
    240: (29, 60), 248: (33, 62), 256: (15, 32), 264: (17, 198), 272: (33, 68),
    280: (103, 210), 288: (19, 36), 296: (19, 74), 304: (37, 76), 312: (19, 78),
    320: (21, 120), 328: (21, 82), 336: (115, 84), 344: (193, 86), 352: (21, 44),
    360: (133, 90), 368: (81, 46), 376: (45, 94), 384: (23, 48), 392: (243, 98),
    400: (151, 40), 408: (155, 102), 416: (25, 52), 424: (51, 106),
    432: (47, 72), 440: (91, 110), 448: (29, 168), 456: (29, 114),
    464: (247, 58), 472: (29, 118), 480: (89, 180), 488: (91, 122),
    496: (157, 62), 504: (55, 84), 512: (31, 64), 528: (17, 66), 544: (35, 68),
    560: (227, 420), 576: (65, 96), 592: (19, 74), 608: (37, 76),
    624: (41, 234), 640: (39, 80), 656: (185, 82), 672: (43, 252),
    688: (21, 86), 704: (155, 44), 720: (79, 120), 736: (139, 92),
    752: (23, 94), 768: (217, 48), 784: (25, 98), 800: (17, 80),
    816: (127, 102), 832: (25, 52), 848: (239, 106), 864: (17, 48),
    880: (137, 110), 896: (215, 112), 912: (29, 114), 928: (15, 58),
    944: (147, 118), 960: (29, 60), 976: (59, 122), 992: (65, 124),
    1008: (55, 84), 1024: (31, 64), 1056: (17, 66), 1088: (171, 204),
    1120: (67, 140), 1152: (35, 72), 1184: (19, 74), 1216: (39, 76),
    1248: (19, 78), 1280: (199, 240), 1312: (21, 82), 1344: (211, 252),
    1376: (21, 86), 1408: (43, 88), 1440: (149, 60), 1472: (45, 92),
    1504: (49, 846), 1536: (71, 48), 1568: (13, 28), 1600: (17, 80),
    1632: (25, 102), 1664: (183, 104), 1696: (55, 954), 1728: (127, 96),
    1760: (27, 110), 1792: (29, 112), 1824: (29, 114), 1856: (57, 116),
    1888: (45, 354), 1920: (31, 120), 1952: (59, 610), 1984: (185, 124),
    2016: (113, 420), 2048: (31, 64), 2112: (17, 66), 2176: (171, 136),
    2240: (209, 420), 2304: (253, 216), 2368: (367, 444), 2432: (265, 456),
    2496: (181, 468), 2560: (39, 80), 2624: (27, 164), 2688: (127, 504),
    2752: (143, 172), 2816: (43, 88), 2880: (29, 300), 2944: (45, 92),
    3008: (157, 188), 3072: (47, 96), 3136: (13, 28), 3200: (111, 240),
    3264: (443, 204), 3328: (51, 104), 3392: (51, 212), 3456: (451, 192),
    3520: (257, 220), 3584: (57, 336), 3648: (313, 228), 3712: (271, 232),
    3776: (179, 236), 3840: (331, 120), 3904: (363, 244), 3968: (375, 248),
    4032: (127, 168), 4096: (31, 64), 4160: (33, 130), 4224: (43, 264),
    4288: (33, 134), 4352: (477, 408), 4416: (35, 138), 4480: (233, 280),
    4544: (357, 142), 4608: (337, 480), 4672: (37, 146), 4736: (71, 444),
    4800: (71, 120), 4864: (37, 152), 4928: (39, 462), 4992: (127, 234),
    5056: (39, 158), 5120: (39, 80), 5184: (31, 96), 5248: (113, 902),
    5312: (41, 166), 5376: (251, 336), 5440: (43, 170), 5504: (21, 86),
    5568: (43, 174), 5632: (45, 176), 5696: (45, 178), 5760: (161, 120),
    5824: (89, 182), 5888: (323, 184), 5952: (47, 186), 6016: (23, 94),
    6080: (47, 190), 6144: (263, 480),
}

VALID_K = np.array(sorted(QPP_TABLE), dtype=np.int64)


@lru_cache(maxsize=None)
def qpp(k: int) -> np.ndarray:
    """The QPP interleaver: out[i] = in[pi[i]]."""
    f1, f2 = QPP_TABLE[k]
    i = np.arange(k, dtype=np.int64)
    return (f1 * i + f2 * i * i) % k


def _rsc(bits: np.ndarray):
    """One constituent RSC (g0 = 1 + D^2 + D^3, g1 = 1 + D + D^3) over
    blocks (n, K) -> (parity (n, K), x tail (n, 3), z tail (n, 3))."""
    n, k = bits.shape
    s = np.zeros(n, dtype=np.int64)
    parity = np.zeros((n, k), dtype=np.int64)
    for i in range(k):
        d1, d2, d3 = (s >> 2) & 1, (s >> 1) & 1, s & 1
        w = bits[:, i] ^ d2 ^ d3
        parity[:, i] = w ^ d1 ^ d3
        s = (w << 2) | (d1 << 1) | d2
    xt = np.zeros((n, 3), dtype=np.int64)
    zt = np.zeros((n, 3), dtype=np.int64)
    for i in range(3):
        d1, d2, d3 = (s >> 2) & 1, (s >> 1) & 1, s & 1
        xt[:, i] = d2 ^ d3
        zt[:, i] = d1 ^ d3
        s = (d1 << 1) | d2
    return parity, xt, zt


def turbo_encode(bits: np.ndarray, k: int) -> np.ndarray:
    """(..., K) -> d (..., 3, K + 4) with the §5.1.3.2.2 tail."""
    lead = bits.shape[:-1]
    b = np.asarray(bits, dtype=np.int64).reshape(-1, k)
    p1, xt1, zt1 = _rsc(b)
    p2, xt2, zt2 = _rsc(b[:, qpp(k)])
    t = lambda *cols: np.stack(cols, axis=1)
    d0 = np.concatenate([b, t(xt1[:, 0], zt1[:, 1], xt2[:, 0], zt2[:, 1])], 1)
    d1 = np.concatenate([p1, t(zt1[:, 0], xt1[:, 2], zt2[:, 0], xt2[:, 2])], 1)
    d2 = np.concatenate([p2, t(xt1[:, 1], zt1[:, 2], xt2[:, 1], zt2[:, 2])], 1)
    return np.stack([d0, d1, d2], axis=1).reshape(*lead, 3, k + 4)


# -- segmentation and rate matching (36.212 §5.1.2, §5.1.4.1) --

@dataclasses.dataclass(frozen=True)
class Geometry:
    """A transport block's codeword geometry: C codeblocks of K (uniform
    segmentation), G coded bits at Qm, rv."""
    tbs: int
    g: int
    qm: int
    rv: int = 0

    @property
    def c(self) -> int:
        b = self.tbs + 24
        return 1 if b <= 6144 else -(-b // (6144 - 24))

    @property
    def k(self) -> int:
        b = self.tbs + 24 + (24 * self.c if self.c > 1 else 0)
        k = int(VALID_K[np.searchsorted(VALID_K, -(-b // self.c))])
        if k * self.c != b:
            raise ValueError(f"TBS {self.tbs}: segmentation not uniform")
        return k

    @property
    def e_list(self) -> tuple[int, ...]:
        gp, c = self.g // self.qm, self.c
        gamma = gp % c
        return ((self.qm * (gp // c),) * (c - gamma)
                + (self.qm * -(-gp // c),) * gamma)


PERM = np.array([0, 16, 8, 24, 4, 20, 12, 28, 2, 18, 10, 26, 6, 22, 14, 30,
                 1, 17, 9, 25, 5, 21, 13, 29, 3, 19, 11, 27, 7, 23, 15, 31])


def rm_indices(d_len: int, e_len: int, rv: int) -> np.ndarray:
    """(E,) indices into one codeblock's flat d = [d0 | d1 | d2]."""
    r = -(-d_len // 32)
    kp = 32 * r
    nd = kp - d_len
    v01 = np.tile(np.arange(r), 32) * 32 + np.repeat(PERM, r)
    k_arr = np.arange(kp)
    v2 = (PERM[k_arr // r] + 32 * (k_arr % r) + 1) % kp
    w = np.full(3 * kp, -1, dtype=np.int64)
    w[:kp] = np.where(v01 >= nd, v01 - nd, -1)
    w[kp::2] = np.where(v01 >= nd, d_len + v01 - nd, -1)
    w[kp + 1::2] = np.where(v2 >= nd, 2 * d_len + v2 - nd, -1)
    k0 = r * (2 * -(-3 * kp // (8 * r)) * rv + 2)
    order = (k0 + np.arange(3 * kp)) % (3 * kp)
    valid = order[w[order] >= 0]
    return w[valid[np.arange(e_len) % len(valid)]]


@lru_cache(maxsize=None)
def rm_idx(geom: Geometry) -> np.ndarray:
    """(G,) indices of the codeword's bits into the C codeblocks' flat d
    streams (C * 3 (K + 4))."""
    d_len = geom.k + 4
    return np.concatenate([c * 3 * d_len + rm_indices(d_len, e, geom.rv)
                           for c, e in enumerate(geom.e_list)])


def segment(tb_bits: np.ndarray, geom: Geometry) -> np.ndarray:
    """TBs (..., TBS) -> codeblocks (..., C, K) with CRC24A, and CRC24B
    where segmented (uniform: no filler)."""
    a = attach_crc(tb_bits, "24A")
    if geom.c == 1:
        return a[..., None, :]
    cbs = a.reshape(*a.shape[:-1], geom.c, geom.k - 24)
    return attach_crc(cbs, "24B")


def desegment(cbs: np.ndarray, geom: Geometry):
    """Codeblocks (..., C, K) -> (TB bits (..., TBS), CRC ok (...,)):
    every CRC24B (segmented) and the CRC24A."""
    ok = np.ones(cbs.shape[:-2], bool)
    if geom.c > 1:
        ok &= np.all(crc_ok(cbs, "24B"), axis=-1)
        cbs = cbs[..., :-24]
    a = cbs.reshape(*cbs.shape[:-2], -1)
    return a[..., :-24], ok & crc_ok(a, "24A")


# -- PUSCH (36.211 §5.5, 36.212 §5.2.2.8) --

DMRS_SYMS = (3, 10)
DATA_SYMS = tuple(s for s in range(14) if s not in DMRS_SYMS)


def _prime_below(n: int) -> int:
    return next(c for c in range(n - 1, 1, -1)
                if all(c % d for d in range(2, int(c ** 0.5) + 1)))


def _slot_byte(c_init: int, ns: int) -> int:
    c = gold(c_init, 8 * (ns + 1))
    return int(np.sum(c[8 * ns:8 * ns + 8] * (1 << np.arange(8))))


def dmrs(n_cell_id: int, ns: int, m_sc: int) -> np.ndarray:
    """PUSCH DM-RS of slot ns (§5.5.2.1): Zadoff-Chu base sequence (m_sc
    >= 36, no group hopping, v 0, delta_ss 0, n_dmrs 0) at its cyclic
    shift."""
    u = n_cell_id % 30
    n_zc = _prime_below(m_sc)
    qbar = n_zc * (u + 1) / 31.0
    q = int(np.floor(qbar + 0.5))
    m = np.arange(n_zc)
    base = np.exp(-1j * np.pi * q * m * (m + 1) / n_zc)[np.arange(m_sc) % n_zc]
    alpha = 2 * np.pi * (_slot_byte((n_cell_id // 30) * 32 + u, ns) % 12) / 12
    return (np.exp(1j * alpha * np.arange(m_sc)) * base).astype(np.complex64)


def ul_interleaver(g: int, qm: int) -> np.ndarray:
    """Data-only channel interleaver: out[i] = in[idx[i]]; Qm-bit groups
    written row-major into 12 columns, read column-major."""
    r = g // (12 * qm)
    order = np.arange(r * 12).reshape(r, 12).T.reshape(-1)
    return (order[:, None] * qm + np.arange(qm)[None, :]).reshape(-1)


def ul_chest_taps(m_sc: int) -> np.ndarray:
    """The DM-RS estimate's delay-domain keep-mask (the CP's span plus a
    negative-delay guard)."""
    mask = np.zeros(m_sc)
    mask[:max(4, int(np.ceil(m_sc * 144 / 2048)) + 2)] = 1.0
    mask[-max(2, m_sc // 128):] = 1.0
    return mask
