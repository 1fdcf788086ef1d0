"""CRC per 36.212 §5.1.1 (counterpart of ``lteax.phy.fec.crc``).

The CRC of a fixed-length message is GF(2)-linear: ``crc = bits @ M mod 2``
with the (N, L) contribution matrix :func:`crc_matrix` (a numpy copy of the
reference's, held equal to it by the tests).  On the device the product
runs as a float32 0/1 matmul — CUDA has no int32 matmul — which is exact
while every sum stays below 2^24 (N <= 75376 here); TF32 would keep only
10 mantissa bits, so :func:`exact_f32_matmul` switches it off.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

# name -> (L, generator low bits).  g(x) = x^L + poly_low  (36.212 §5.1.1)
CRC_POLYS: dict[str, tuple[int, int]] = {
    "24A": (24, 0x864CFB),
    "24B": (24, 0x800063),
    "16": (16, 0x1021),
    "8": (8, 0x9B),
}


@lru_cache(maxsize=None)
def crc_matrix(n_bits: int, kind: str) -> np.ndarray:
    """(n_bits, L) uint8 matrix: crc(m) = m @ M mod 2 (m MSB-first)."""
    L, poly = CRC_POLYS[kind]
    mask = (1 << L) - 1
    r = 1
    rems = np.zeros((n_bits, L), dtype=np.uint8)
    for _ in range(L):
        r <<= 1
        if r >> L:
            r = (r & mask) ^ poly
    for i in range(n_bits):  # i counts from the LAST message bit backwards
        rems[n_bits - 1 - i] = [(r >> (L - 1 - j)) & 1 for j in range(L)]
        r <<= 1
        if r >> L:
            r = (r & mask) ^ poly
    return rems


def attach_crc_np(bits: np.ndarray, kind: str) -> np.ndarray:
    """Host CRC attach: (..., N) -> (..., N + L) int64."""
    m = crc_matrix(bits.shape[-1], kind).astype(np.int64)
    p = (bits.astype(np.int64) @ m) % 2
    return np.concatenate([bits.astype(np.int64), p], axis=-1)


def exact_f32_matmul() -> None:
    """Keep float32 matmuls in full float32 on the card (0/1 CRC sums and
    the chest interpolation both rely on it)."""
    torch.backends.cuda.matmul.allow_tf32 = False


def crc_parity_ok(bits: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """(..., N) 0/1 bits against a float32 (N, L) contribution matrix whose
    rows already include the received parity positions -> (...,) bool,
    True where the full-length syndrome is zero."""
    s = bits.to(torch.float32) @ m
    return torch.all(torch.remainder(s, 2.0) == 0.0, dim=-1)


def check_crc(bits_with_crc: torch.Tensor, kind: str,
              m: torch.Tensor | None = None):
    """Split and verify.  Returns (payload, ok (...,) bool).

    ``m`` is the float32 (N - L, L) contribution matrix on the bits' device;
    callers that check the same length repeatedly pass it in."""
    L, _ = CRC_POLYS[kind]
    payload, rx_par = bits_with_crc[..., :-L], bits_with_crc[..., -L:]
    if m is None:
        m = torch.as_tensor(crc_matrix(payload.shape[-1], kind),
                            dtype=torch.float32, device=payload.device)
    p = torch.remainder(payload.to(torch.float32) @ m, 2.0)
    ok = torch.all(p == rx_par.to(torch.float32), dim=-1)
    return payload, ok
