"""2x2 spatial multiplexing: layer mapping, TM3/TM4 precoding, MMSE demix
(counterpart of ``lteax.phy.mimo``).

36.211 references:
- layer mapping for spatial multiplexing: §6.3.3.2 (2 codewords -> 2
  layers, one layer per codeword);
- large-delay CDD: §6.3.4.2.2, y(i) = W D(i) U x(i) with W = I/sqrt2,
  U = [[1, 1], [1, -1]]/sqrt2, D(i) = diag(1, (-1)^i);
- codebook precoding: §6.3.4.2.1 and Table 6.3.4.2.3-2 (2 ports).

The codebooks and the CDD sign are numpy copies of the reference's (the
tests hold them equal); the functions are the reference's formulas in the
same order, on complex64 tensors with the RE axis last.
"""

from __future__ import annotations

import numpy as np
import torch

# 2-port codebook (36.211 Table 6.3.4.2.3-2): 1 layer as column vectors,
# 2 layers as matrices (index 3 exists for 1 layer only)
CODEBOOK_2TX_1L = (
    np.array([1, 1], dtype=np.complex64) / np.sqrt(2),
    np.array([1, -1], dtype=np.complex64) / np.sqrt(2),
    np.array([1, 1j], dtype=np.complex64) / np.sqrt(2),
    np.array([1, -1j], dtype=np.complex64) / np.sqrt(2),
)
CODEBOOK_2TX_2L = (
    np.array([[1, 0], [0, 1]], dtype=np.complex64) / np.sqrt(2),
    np.array([[1, 1], [1, -1]], dtype=np.complex64) / 2.0,
    np.array([[1, 1], [1j, -1j]], dtype=np.complex64) / 2.0,
)


def codebook_2l(cb_index: int) -> np.ndarray:
    """The 2-layer precoding matrix W (ports x layers); indices 0-2."""
    if cb_index not in range(len(CODEBOOK_2TX_2L)):
        raise ValueError(f"2-layer codebook index {cb_index}: 0, 1 or 2")
    return CODEBOOK_2TX_2L[cb_index]


def _cdd_sign(n: int) -> np.ndarray:
    """(-1)^i sequence (the D(i) phase for 2 layers)."""
    return (1.0 - 2.0 * (np.arange(n) % 2)).astype(np.float32)


def _sign(n: int, device) -> torch.Tensor:
    return torch.as_tensor(_cdd_sign(n), device=device)


def layer_map_2cw(d0: torch.Tensor, d1: torch.Tensor) -> torch.Tensor:
    """Two codewords -> two layers: x (..., 2, M)."""
    return torch.stack([d0, d1], dim=-2)


def precode_tm3(x: torch.Tensor):
    """Large-delay CDD, 2 layers -> 2 ports.  x (..., 2, M) -> (y0, y1):
    y0 = (x0 + x1)/2, y1 = (-1)^i (x0 - x1)/2."""
    s = _sign(x.shape[-1], x.device)
    y0 = (x[..., 0, :] + x[..., 1, :]) * 0.5
    y1 = (x[..., 0, :] - x[..., 1, :]) * 0.5 * s
    return y0, y1


def precode_tm4(x: torch.Tensor, cb_index: int):
    """Closed-loop codebook precoding, y = W x.  x (..., 2, M) -> (y0, y1)."""
    w = codebook_2l(cb_index)
    return tuple(x[..., 0, :] * complex(w[p, 0]) + x[..., 1, :] * complex(w[p, 1])
                 for p in range(2))


def precode_tm4_1layer(d: torch.Tensor, cb_index: int):
    """Closed-loop rank-1 precoding: one codeword (..., M) -> 2 ports."""
    v = CODEBOOK_2TX_1L[cb_index]
    return d * complex(v[0]), d * complex(v[1])


def heff_tm3(h: torch.Tensor) -> torch.Tensor:
    """Effective per-layer channel of TM3: h (..., n_rx, 2 ports, M) ->
    (..., n_rx, 2 layers, M); with s = (-1)^i, layer 0 sees
    (h_p0 + s h_p1)/2 and layer 1 (h_p0 - s h_p1)/2."""
    s = _sign(h.shape[-1], h.device)
    hs1 = h[..., :, 1, :] * s
    m0 = (h[..., :, 0, :] + hs1) * 0.5
    m1 = (h[..., :, 0, :] - hs1) * 0.5
    return torch.stack([m0, m1], dim=-2)


def heff_tm4(h: torch.Tensor, cb_index: int) -> torch.Tensor:
    """Effective per-layer channel of TM4, H W: h (..., n_rx, 2, M) ->
    (..., n_rx, 2 layers, M)."""
    w = codebook_2l(cb_index)
    return torch.stack([h[..., :, 0, :] * complex(w[0, k])
                        + h[..., :, 1, :] * complex(w[1, k])
                        for k in range(2)], dim=-2)


def mmse_demix_2layers(y: torch.Tensor, heff: torch.Tensor, noise_var):
    """Per-RE unbiased 2x2 MMSE demix.

    y (..., n_rx, M); heff (..., n_rx, 2 layers, M); ``noise_var`` a scalar
    or a tensor that broadcasts against (..., M).  Returns (x_hat
    (..., 2, M), eff_nv (..., 2, M)): the bias-corrected estimates and each
    layer's post-MMSE effective noise for unit-power constellations,
    (1 - b_k) / b_k with b_k = [I - nv A^-1]_kk, A = H^H H + nv I solved in
    closed form."""
    h0 = heff[..., :, 0, :]
    h1 = heff[..., :, 1, :]
    nv = noise_var
    g00 = torch.sum(h0.abs() ** 2, dim=-2) + nv
    g11 = torch.sum(h1.abs() ** 2, dim=-2) + nv
    g01 = torch.sum(torch.conj(h0) * h1, dim=-2)
    det = torch.clamp_min(g00 * g11 - g01.abs() ** 2, 1e-24)
    z0 = torch.sum(torch.conj(h0) * y, dim=-2)
    z1 = torch.sum(torch.conj(h1) * y, dim=-2)
    x0 = (g11 * z0 - g01 * z1) / det
    x1 = (g00 * z1 - torch.conj(g01) * z0) / det
    b0 = torch.clamp_min(1.0 - nv * g11 / det, 1e-9)
    b1 = torch.clamp_min(1.0 - nv * g00 / det, 1e-9)
    x = torch.stack([x0 / b0, x1 / b1], dim=-2)
    eff = torch.stack([(1.0 - b0) / b0, (1.0 - b1) / b1], dim=-2)
    return x, torch.clamp_min(eff, 1e-12)
