"""LTE turbo code tables and encoder (36.212 §5.1.3.2).

Numpy copies of ``lteax.phy.fec.turbo._trellis`` and ``_unrolled_wiring``
(the tests hold them equal to the originals) plus a numpy encoder for the
test-signal generator.  The decoder is ``lteax_torch.kernels.turbo_mlm``.

Trellis: RSC with g0 = 1 + D^2 + D^3 (feedback), g1 = 1 + D + D^3.
State s = (d1, d2, d3), d1 newest;  w = b ^ d2 ^ d3;  next = (w, d1, d2);
parity z = w ^ d1 ^ d3.  LLR convention: L = log P(0)/P(1).
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np

from lteax_torch.phy.tables.turbo_qpp import qpp_interleaver


@lru_cache(maxsize=None)
def _trellis():
    """Forward and backward trellis tables for the 8-state RSC."""
    ns = np.zeros((8, 2), dtype=np.int32)       # next state
    psign = np.zeros((8, 2), dtype=np.float32)  # 1 - 2*parity
    for s in range(8):
        d1, d2, d3 = (s >> 2) & 1, (s >> 1) & 1, s & 1
        for b in range(2):
            w = b ^ d2 ^ d3
            z = w ^ d1 ^ d3
            ns[s, b] = (w << 2) | (d1 << 1) | d2
            psign[s, b] = 1.0 - 2.0 * z
    prev = np.zeros((8, 2), dtype=np.int32)
    in_ssign = np.zeros((8, 2), dtype=np.float32)
    in_psign = np.zeros((8, 2), dtype=np.float32)
    for sp in range(8):
        cands = [(s, b) for s in range(8) for b in range(2) if ns[s, b] == sp]
        assert len(cands) == 2
        for t, (s, b) in enumerate(cands):
            prev[sp, t] = s
            in_ssign[sp, t] = 1.0 - 2.0 * b
            in_psign[sp, t] = psign[s, b]
    ssign = np.array([[1.0, -1.0]] * 8, dtype=np.float32)
    return ns, ssign, psign, prev, in_ssign, in_psign


@lru_cache(maxsize=None)
def _unrolled_wiring():
    """Constant wiring for the state-unrolled ACS: (fwd, bwd, out0, out1).

      fwd[s'] = (p0, p1, g0, g1): a_new[s'] = max(a[p0]+γ(g0), a[p1]+γ(g1))
      bwd[s]  = (n0, n1, g0, g1): b_new[s] = max(b[n0]+γ(g0), b[n1]+γ(g1))
      out0[s] = (ns, g): bit-0 transition of state s;  out1[s] likewise.
    γ codes: 0=+(u+v)/2, 1=+(u-v)/2, 2=-(u-v)/2, 3=-(u+v)/2.
    """
    ns, ssign, psign, prev, in_ss, in_ps = _trellis()

    def code(ss, ps):
        if ss > 0:
            return 0 if ps > 0 else 1
        return 2 if ps > 0 else 3

    fwd = []
    for sp in range(8):
        fwd.append((int(prev[sp, 0]), int(prev[sp, 1]),
                    code(in_ss[sp, 0], in_ps[sp, 0]),
                    code(in_ss[sp, 1], in_ps[sp, 1])))
    bwd = []
    out0 = []
    out1 = []
    for s in range(8):
        g0 = code(1.0, psign[s, 0])
        g1 = code(-1.0, psign[s, 1])
        bwd.append((int(ns[s, 0]), int(ns[s, 1]), g0, g1))
        out0.append((int(ns[s, 0]), g0))
        out1.append((int(ns[s, 1]), g1))
    return tuple(fwd), tuple(bwd), tuple(out0), tuple(out1)


def _rsc_encode(bits: np.ndarray):
    """One RSC constituent over a batch of blocks, stepping all blocks in
    lock-step: bits (n, K) -> (parity (n, K), x_tail (n, 3), z_tail (n, 3))."""
    n, k = bits.shape
    s = np.zeros(n, dtype=np.int64)
    parity = np.zeros((n, k), dtype=np.int64)
    for i in range(k):
        d1, d2, d3 = (s >> 2) & 1, (s >> 1) & 1, s & 1
        w = bits[:, i] ^ d2 ^ d3
        parity[:, i] = w ^ d1 ^ d3
        s = (w << 2) | (d1 << 1) | d2
    x_tail = np.zeros((n, 3), dtype=np.int64)
    z_tail = np.zeros((n, 3), dtype=np.int64)
    for i in range(3):
        d1, d2, d3 = (s >> 2) & 1, (s >> 1) & 1, s & 1
        x_tail[:, i] = d2 ^ d3             # forces w = 0
        z_tail[:, i] = d1 ^ d3
        s = (d1 << 1) | d2
    return parity, x_tail, z_tail


def turbo_encode(bits: np.ndarray, k: int) -> np.ndarray:
    """Encode codeblocks: bits (..., K) -> d (..., 3, K+4) streams with the
    36.212 §5.1.3.2.2 tail multiplexing (as ``lteax.phy.fec.turbo``)."""
    lead = bits.shape[:-1]
    b = np.asarray(bits, dtype=np.int64).reshape(-1, k)
    pi = np.asarray(qpp_interleaver(k))
    p1, xt1, zt1 = _rsc_encode(b)
    p2, xt2, zt2 = _rsc_encode(b[:, pi])
    d0 = np.concatenate([b, np.stack([xt1[:, 0], zt1[:, 1], xt2[:, 0],
                                      zt2[:, 1]], axis=1)], axis=1)
    d1 = np.concatenate([p1, np.stack([zt1[:, 0], xt1[:, 2], zt2[:, 0],
                                       xt2[:, 2]], axis=1)], axis=1)
    d2 = np.concatenate([p2, np.stack([xt1[:, 1], zt1[:, 2], xt2[:, 1],
                                       zt2[:, 2]], axis=1)], axis=1)
    return np.stack([d0, d1, d2], axis=1).reshape(*lead, 3, k + 4)
