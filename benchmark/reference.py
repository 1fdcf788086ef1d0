"""The plain reference receivers, in float64 numpy: what the program's
fronts and its turbo tail compute, worked out again from the same IQ with
the benchmark's own LTE primitives (``benchmark/lte.py``) and nothing of
the program.

- :func:`dl_front`: OFDM (FFT), LS at port 0's CRS, linear interpolation
  in frequency (edges extrapolated) and in time (edges held), the noise
  from the CRS pairs of equal comb shift, the bias-corrected MMSE
  equaliser, the exact max-log demap of each bit (LLR = log P(0)/P(1)),
  descrambling and the soft de-match -> (S * C, 3, K + 4).
- :func:`ul_front`: LS at the two DM-RS symbols, denoised in the delay
  domain, linear time interpolation, the MMSE equaliser, the unitary IDFT,
  the post-IDFT noise as each symbol's mean, the demap, descrambling, the
  channel de-interleaver and the de-match.
- :func:`turbo_decode`: max-log-MAP over the whole codeblock (no
  windows), the extrinsic damped by ``ext_scale``, up to ``n_iter`` full
  iterations, each codeblock stopped once its CRC24B passes; then
  desegmentation and CRC24A.
"""

from __future__ import annotations

import numpy as np

from benchmark import lte, tx


def _complex(iq: np.ndarray) -> np.ndarray:
    return iq[..., 0].astype(np.float64) + 1j * iq[..., 1]


def _interp_matrix(points: np.ndarray, n: int, hold: bool) -> np.ndarray:
    """(n, len(points)) linear interpolation from ``points`` to 0..n-1;
    beyond the end points extrapolated (``hold`` False) or held."""
    w = np.zeros((n, len(points)))
    for k in range(n):
        j = int(np.searchsorted(points, k))
        if hold and (j == 0 or j >= len(points)):
            w[k, min(j, len(points) - 1)] = 1.0
            continue
        a = min(max(j - 1, 0), len(points) - 2)
        t = (k - points[a]) / (points[a + 1] - points[a])
        w[k, a], w[k, a + 1] = 1 - t, t
    return w


def demap(x: np.ndarray, scale: np.ndarray, scheme: str) -> np.ndarray:
    """Max-log LLRs of symbols x (..., N) times ``scale`` (..., N) ->
    (..., N * m), bit order (b0|I, b1|Q, b2|I, ...); positive: bit 0."""
    lv, bit1 = lte.pam_axis(scheme)
    ma = len(bit1)
    out = np.empty((*x.shape, 2 * ma))
    for axis, y in ((0, x.real), (1, x.imag)):
        d = (y[..., None] - lv) ** 2
        for j in range(ma):
            out[..., 2 * j + axis] = (
                np.min(np.where(bit1[j], d, np.inf), axis=-1)
                - np.min(np.where(bit1[j], np.inf, d), axis=-1)) * scale
    return out.reshape(*x.shape[:-1], -1)


def dematch(e_llr: np.ndarray, geom: lte.Geometry) -> np.ndarray:
    """Descrambled codeword LLRs (S, G) -> (S * C, 3, K + 4): repeats add,
    unsent positions are 0."""
    d = np.zeros((len(e_llr), geom.c * 3 * (geom.k + 4)))
    for row, e in zip(d, e_llr):
        np.add.at(row, lte.rm_idx(geom), e)
    return d.reshape(-1, 3, geom.k + 4)


def dl_front(cfg: dict, iq: np.ndarray) -> np.ndarray:
    """IQ (S, n_samps, 2) -> de-matched LLRs (S * C, 3, K + 4)."""
    num = lte.Numerology(cfg["n_rb"])
    cell, sf = cfg["n_cell_id"], cfg["subframe"]
    x = _complex(iq)
    blocks = x[:, num.symbol_starts[:, None] + np.arange(num.n_fft)]
    grid = (np.fft.fft(blocks, axis=-1) / np.sqrt(num.n_fft))[
        ..., num.sc_to_fft_bin]                          # (S, 14, n_sc)
    flat = grid.reshape(len(x), -1)
    crs_idx, crs_val = lte.crs_grid(num, cell, sf)
    ls = flat[:, crs_idx] * np.conj(crs_val)             # (S, 4, 2 n_rb)
    hf = np.stack([ls[:, p] @ _interp_matrix(
        crs_idx[p] % num.n_sc, num.n_sc, hold=False).T for p in range(4)],
        axis=1)                                          # (S, 4, n_sc)
    wt = _interp_matrix(np.asarray(lte.CRS_SYMS), 14, hold=True)
    h = np.einsum("sp,bpk->bsk", wt, hf).reshape(len(x), -1)
    nv = np.maximum(np.mean(np.abs(ls[:, :2] - ls[:, 2:]) ** 2,
                            axis=(1, 2)) / 2, 1e-6)[:, None]
    p = np.abs(h) ** 2
    eq = flat * np.conj(h) / (p + nv) / np.maximum(p / (p + nv), 1e-12)
    re_idx = lte.pdsch_re_idx(num, cell, cfg["cfi"], sf)
    geom = tx.dl_geometry(cfg)
    llr = demap(eq[:, re_idx], (p / nv)[:, re_idx], cfg["scheme"])
    sgn = 1 - 2 * lte.gold(lte.pdsch_c_init(cfg["rnti"], sf, cell), geom.g)
    return dematch(llr * sgn, geom)


def ul_front(cfg: dict, iq: np.ndarray) -> np.ndarray:
    """Grids (S, 14, m_sc, 2) -> de-matched LLRs (S * C, 3, K + 4)."""
    m_sc = 12 * cfg["n_prb"]
    grid = _complex(iq)
    s = len(grid)
    ref = [np.conj(lte.dmrs(cfg["n_cell_id"], 2 * cfg["subframe"] + slot,
                            m_sc)) for slot in range(2)]
    ls = [grid[:, sym] * r for sym, r in zip(lte.DMRS_SYMS, ref)]
    nv = np.maximum(np.mean(np.abs(ls[0] - ls[1]) ** 2, axis=-1) / 2,
                    1e-6)[:, None, None]
    taps = lte.ul_chest_taps(m_sc)
    h0, h1 = (np.fft.fft(np.fft.ifft(h, axis=-1) * taps, axis=-1)[:, None]
              for h in ls)
    d0, d1 = lte.DMRS_SYMS
    w = np.clip([(t - d0) / (d1 - d0) for t in lte.DATA_SYMS], 0, 1)[:, None]
    h = (1 - w) * h0 + w * h1                            # (S, 12, m_sc)
    p = np.abs(h) ** 2
    xf = (grid[:, list(lte.DATA_SYMS)] * np.conj(h) / (p + nv)
          / np.maximum(p / (p + nv), 1e-12))
    xt = np.fft.ifft(xf, axis=-1) * np.sqrt(m_sc)
    eff = np.mean(nv / np.maximum(p, 1e-12), axis=-1, keepdims=True)
    llr = demap(xt.reshape(s, -1),
                np.broadcast_to(1 / eff, xt.shape).reshape(s, -1),
                cfg["scheme"])
    geom = tx.ul_geometry(cfg)
    llr *= 1 - 2 * lte.gold(lte.pusch_c_init(cfg["rnti"], cfg["subframe"],
                                             cfg["n_cell_id"]), geom.g)
    e_llr = np.empty_like(llr)
    e_llr[:, lte.ul_interleaver(geom.g, geom.qm)] = llr
    return dematch(e_llr, geom)


# -- max-log-MAP turbo decoder --

def _trellis():
    """(next state (8, 2), parity sign (8, 2)) of the RSC: state (d1, d2,
    d3), w = b ^ d2 ^ d3, next (w, d1, d2), parity w ^ d1 ^ d3."""
    ns = np.zeros((8, 2), np.int64)
    z = np.zeros((8, 2), np.int64)
    for s in range(8):
        d1, d2, d3 = s >> 2 & 1, s >> 1 & 1, s & 1
        for b in range(2):
            w = b ^ d2 ^ d3
            ns[s, b] = w << 2 | d1 << 1 | d2
            z[s, b] = w ^ d1 ^ d3
    return ns, 1 - 2 * z


NS, ZSIGN = _trellis()
# branch metric index of (state, bit): 0 (u + v) / 2, 1 (u - v) / 2,
# 2 -(u - v) / 2, 3 -(u + v) / 2; bit 0 sends x = +1
CODE = np.where(ZSIGN > 0, 0, 1) + np.array([0, 2])
# the two branches into each state: (previous state, input bit)
PREV = np.array([[(s, b) for s in range(8) for b in range(2)
                  if NS[s, b] == t] for t in range(8)])
PREV_CODE = CODE[PREV[..., 0], PREV[..., 1]]


def _siso(u: np.ndarray, v: np.ndarray) -> np.ndarray:
    """One constituent max-log-MAP pass: systematic + a priori u and
    parity v (C, n) over n = K + 3 steps from state 0 to state 0 ->
    a posteriori LLRs (C, n)."""
    c, n = u.shape
    gp, gm = 0.5 * (u + v).T, 0.5 * (u - v).T
    g = np.stack([gp, gm, -gm, -gp], axis=1)             # (n, 4, C)
    alpha = np.empty((n + 1, 8, c))
    a = np.full((8, c), -np.inf)
    a[0] = 0.0
    alpha[0] = a
    p0, p1 = PREV[:, 0, 0], PREV[:, 1, 0]
    c0, c1 = PREV_CODE[:, 0], PREV_CODE[:, 1]
    for t in range(n):
        a = np.maximum(a[p0] + g[t][c0], a[p1] + g[t][c1])
        a -= a.max(axis=0)
        alpha[t + 1] = a
    llr = np.empty((n, c))
    b = np.full((8, c), -np.inf)
    b[0] = 0.0
    for t in range(n - 1, -1, -1):
        gb = g[t][CODE] + b[NS]                          # (8, 2, C)
        m = alpha[t][:, None, :] + gb
        llr[t] = m[:, 0].max(axis=0) - m[:, 1].max(axis=0)
        b = gb.max(axis=1)
        b -= b.max(axis=0)
    return llr.T


def turbo_decode(d: np.ndarray, k: int, n_iter: int, ext_scale: float,
                 early_crc: bool) -> np.ndarray:
    """De-matched LLRs (C, 3, K + 4) -> hard bits (C, K): up to ``n_iter``
    iterations; with ``early_crc`` a codeblock whose CRC24B passes after
    an iteration keeps those bits and stops."""
    pi = lte.qpp(k)
    inv = np.argsort(pi)
    d0, d1, d2 = d[:, 0], d[:, 1], d[:, 2]
    ls = d0[:, :k]
    x1 = np.stack([d0[:, k], d2[:, k], d1[:, k + 1]], 1)
    z1 = np.stack([d1[:, k], d0[:, k + 1], d2[:, k + 1]], 1)
    x2 = np.stack([d0[:, k + 2], d2[:, k + 2], d1[:, k + 3]], 1)
    z2 = np.stack([d1[:, k + 2], d0[:, k + 3], d2[:, k + 3]], 1)
    v1 = np.concatenate([d1[:, :k], z1], 1)
    v2 = np.concatenate([d2[:, :k], z2], 1)
    bits = np.zeros((len(d), k), np.int64)
    live = np.arange(len(d))
    le21 = np.zeros((len(d), k))
    for _ in range(n_iter):
        s = live
        l1 = _siso(np.concatenate([ls[s] + le21[s], x1[s]], 1), v1[s])[:, :k]
        le12 = ext_scale * (l1 - ls[s] - le21[s])
        la2 = le12[:, pi]
        l2 = _siso(np.concatenate([ls[s][:, pi] + la2, x2[s]], 1),
                   v2[s])[:, :k]
        le21[s] = (ext_scale * (l2 - ls[s][:, pi] - la2))[:, inv]
        bits[s] = (l2[:, inv] < 0)
        if not early_crc:
            continue
        live = s[~lte.crc_ok(bits[s], "24B")]
        if not len(live):
            break
    return bits


def decode(d: np.ndarray, geom: lte.Geometry, n_iter: int,
           ext_scale: float):
    """(S * C, 3, K + 4) -> (TB bits (S, TBS), CRC ok (S,))."""
    bits = turbo_decode(d, geom.k, n_iter, ext_scale, geom.c > 1)
    return lte.desegment(bits.reshape(-1, geom.c, geom.k), geom)
