"""Batched turbo re-encoder for interference cancellation (MIMO SIC);
counterpart of ``lteax.phy.fec.reencode``.

The RSC constituents are GF(2)-linear: every parity and tail bit is an XOR
of input bits, so a codeblock's encode is one bit-matrix product,
(N, K) @ (K, K+6).  The matrix (:func:`_rsc_matrix`, a numpy copy of the
reference's, held equal by the tests) is built on the host from the
impulse response; the product runs as a float32 0/1 matmul with TF32 off
(:func:`lteax_torch.phy.fec.crc.exact_f32_matmul`): every sum is an
integer below 2^24 (K <= 6144), so its remainder mod 2 is exact.  TF32, or
a half-precision output, would round sums above 2^11 and flip parities.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from lteax_torch.phy.fec.crc import exact_f32_matmul
from lteax_torch.phy.tables.turbo_qpp import qpp_interleaver


def _rsc_step_np(s: int, b: int) -> tuple[int, int]:
    """One RSC step from state s (3 bits) on input b -> (state, parity)."""
    d1, d2, d3 = (s >> 2) & 1, (s >> 1) & 1, s & 1
    w = b ^ d2 ^ d3
    z = w ^ d1 ^ d3
    return (w << 2) | (d1 << 1) | d2, z


def _rsc_tails_np(s: int) -> tuple[list[int], list[int]]:
    """The three termination steps from end state s -> (x_tail, z_tail)."""
    x_t, z_t = [], []
    for _ in range(3):
        d1, d2, d3 = (s >> 2) & 1, (s >> 1) & 1, s & 1
        x_t.append(d2 ^ d3)
        z_t.append(d1 ^ d3)
        s = (d1 << 1) | d2
    return x_t, z_t


@lru_cache(maxsize=4)
def _rsc_matrix(k: int) -> np.ndarray:
    """(K, K+6) uint8 GF(2) matrix: input bits -> [parity (K), x_tail (3),
    z_tail (3)] of one RSC constituent.  Row j: the impulse parity response
    from position j on, and the tails of the state an impulse at j leaves
    after K-j steps."""
    h = np.zeros(k, dtype=np.uint8)
    states = np.zeros(k + 1, dtype=np.int32)
    s = 0
    for n in range(k):
        s, z = _rsc_step_np(s, 1 if n == 0 else 0)
        h[n] = z
        states[n + 1] = s
    m = np.zeros((k, k + 6), dtype=np.uint8)
    for j in range(k):
        m[j, j:k] = h[: k - j]
        x_t, z_t = _rsc_tails_np(int(states[k - j]))
        m[j, k:k + 3] = x_t
        m[j, k + 3:k + 6] = z_t
    return m


@lru_cache(maxsize=4)
def _device_tables(k: int, device: torch.device):
    """(the (K, K+6) float32 matrix, the QPP permutation) on ``device``."""
    return (torch.as_tensor(_rsc_matrix(k), dtype=torch.float32,
                            device=device),
            torch.as_tensor(np.asarray(qpp_interleaver(k)), dtype=torch.int64,
                            device=device))


def turbo_reencode_batch(bits: torch.Tensor, k: int) -> torch.Tensor:
    """(N, K) decoded codeblock bits -> (N, 3, K+4) int32 d streams, equal to
    ``turbo.turbo_encode``, as two matmuls (one per constituent)."""
    exact_f32_matmul()
    m, pi = _device_tables(k, bits.device)
    bf = bits.to(torch.float32)
    o1 = torch.remainder(bf @ m, 2.0).to(torch.int32)
    o2 = torch.remainder(bf[:, pi] @ m, 2.0).to(torch.int32)
    p1, xt1, zt1 = o1[:, :k], o1[:, k:k + 3], o1[:, k + 3:k + 6]
    p2, xt2, zt2 = o2[:, :k], o2[:, k:k + 3], o2[:, k + 3:k + 6]
    b = bits.to(torch.int32)
    # tail multiplexing of 36.212 §5.1.3.2.2, as turbo.turbo_encode
    d0 = torch.cat([b, torch.stack(
        [xt1[:, 0], zt1[:, 1], xt2[:, 0], zt2[:, 1]], dim=1)], dim=1)
    d1 = torch.cat([p1, torch.stack(
        [zt1[:, 0], xt1[:, 2], zt2[:, 0], xt2[:, 2]], dim=1)], dim=1)
    d2 = torch.cat([p2, torch.stack(
        [xt1[:, 1], zt1[:, 2], xt2[:, 1], zt2[:, 2]], dim=1)], dim=1)
    return torch.stack([d0, d1, d2], dim=1)
