"""Factored DFT / IDFT over the last axis: counterpart of ``lteax.phy.dft``.

N = N1·N2 (Cooley–Tukey, decimation in time, n = n1 + N1·n2,
k = N2·k1 + k2):

  X[N2·k1+k2] = Σ_{n1} W_N^{±n1·k2} W_{N1}^{±n1·k1} Σ_{n2} x[n1+N1·n2] W_{N2}^{±n2·k2}

an inner DFT_{N2} along n2 (a (N2, N2) complex matmul), a twiddle by
W_N^{n1·k2}, and an outer DFT_{N1} along n1; a prime N is one dense
matmul.  Each complex matmul is four real ones (:func:`cmatmul`).

The reference ran these matmuls on the TPU's matrix unit at two
precisions, and :func:`cmatmul`'s ``bf16`` switch models both:

- ``bf16=False``: the reference's ``Precision.HIGHEST``, an f32 matmul.  On
  the card it must not run through TF32, which rounds the operands to 10
  bits: a CUDA call raises while ``torch.backends.cuda.matmul.allow_tf32``
  is set.
- ``bf16=True``: the TPU's single pass (``precision=None``).  Each real
  operand is rounded to bf16 (round to nearest even), then multiplied in
  f32: a product of two bf16 values is exact in f32, and the sums stay
  f32.  XLA:CPU ignores ``precision=None``, so the reference computes this
  form in f32 on the CPU; the port computes the TPU's rounding everywhere.

:func:`dft_factored` (the SC-FDMA transform's ``"factored"`` form) runs at
HIGHEST, as the reference's; the OFDM demod's factored forms
(``lteax_torch.phy.ofdm``) use both.  The constants are uploaded once per
(N, direction, form, device).
"""

from __future__ import annotations

import math
from functools import lru_cache

import numpy as np
import torch


@lru_cache(maxsize=None)
def _split(n: int) -> tuple[int, int]:
    """Factor pair (n1, n2), n1·n2 = n, closest to sqrt(n).  (1, n) if prime."""
    best = (1, n)
    for d in range(2, int(n ** 0.5) + 1):
        if n % d == 0:
            best = (d, n // d)
    return best


@lru_cache(maxsize=None)
def _consts(n: int, inverse: bool) -> tuple:
    """(n1, n2, w1 (n1, n1), w2 (n2, n2), twiddle (n2, n1)) complex64."""
    n1, n2 = _split(n)
    sign = 2j if inverse else -2j
    w1 = np.exp(sign * np.pi * np.outer(np.arange(n1), np.arange(n1)) / n1)
    w2 = np.exp(sign * np.pi * np.outer(np.arange(n2), np.arange(n2)) / n2)
    # twiddle[k2, n1] = W_N^{±n1·k2}
    tw = np.exp(sign * np.pi * np.outer(np.arange(n2), np.arange(n1)) / n)
    c64 = np.complex64
    return n1, n2, w1.astype(c64), w2.astype(c64), tw.astype(c64)


def round_bf16(x: torch.Tensor) -> torch.Tensor:
    """f32 values rounded to bf16 (round to nearest even), kept in f32."""
    return x.to(torch.bfloat16).to(torch.float32)


def planes(x, bf16: bool) -> tuple[torch.Tensor, torch.Tensor]:
    """A complex tensor's (real, imag) f32 planes, each rounded to bf16
    when ``bf16``; a (real, imag) pair passes as it is (the constants'
    planes, made once)."""
    if isinstance(x, tuple):
        return x
    re, im = x.real, x.imag
    return (round_bf16(re), round_bf16(im)) if bf16 else (re, im)


def check_no_tf32(x: torch.Tensor) -> None:
    """Raise where an f32 product on ``x``'s device would run through TF32
    (a CUDA tensor while ``torch.backends.cuda.matmul.allow_tf32`` is set)."""
    if x.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("an f32 (HIGHEST) DFT product with TF32 on: "
                           "TF32 rounds the operands to 10 bits; set "
                           "torch.backends.cuda.matmul.allow_tf32 = False")


def cmatmul(a, b, bf16: bool = False) -> torch.Tensor:
    """a @ b as four real matmuls (complex64 out); ``a`` and ``b`` are
    complex tensors or (real, imag) plane pairs (see :func:`planes`)."""
    ar, ai = planes(a, bf16)
    br, bi = planes(b, bf16)
    if not bf16:
        check_no_tf32(ar)
    return torch.complex(ar @ br - ai @ bi, ar @ bi + ai @ br)


@lru_cache(maxsize=64)
def plan(n: int, inverse: bool, bf16: bool, device: torch.device):
    """The constants of an n-point transform on ``device``: (n1, n2, w1
    planes, w2 planes, twiddle complex64), the planes rounded to bf16 when
    ``bf16``."""
    n1, n2, w1, w2, tw = _consts(n, inverse)
    up = lambda w: planes(torch.as_tensor(w, device=device), bf16)
    return n1, n2, up(w1), up(w2), torch.as_tensor(tw, device=device)


def dft_factored(x: torch.Tensor, inverse: bool = False,
                 unitary: bool = False) -> torch.Tensor:
    """DFT (or IDFT) over the last axis of complex ``x`` as two small f32
    matmuls (HIGHEST) and a twiddle; a prime length is one dense matmul.

    Matches ``np.fft.fft`` / ``np.fft.ifft`` conventions; ``unitary=True``
    scales by 1/sqrt(N) instead (both directions), the SC-FDMA unitary
    transform pair."""
    x = x.to(torch.complex64)
    n = x.shape[-1]
    n1, n2, w1, w2, tw = plan(n, inverse, False, x.device)
    lead = x.shape[:-1]
    if n1 == 1:                         # prime: dense W (w2 is the full DFT)
        y = cmatmul(x, (w2[0].T, w2[1].T))
    else:
        # v[..., n2, n1] = x[..., n1 + N1*n2]; the inner DFT along n2 gives
        # a[..., k2, n1], the outer along n1 c[..., k2, k1]
        a = cmatmul(w2, x.reshape(*lead, n2, n1)) * tw
        c = cmatmul(a, w1)
        y = c.transpose(-1, -2).reshape(*lead, n)  # X[N2*k1 + k2] = c[k2, k1]
    if unitary:
        return y * float(np.float32(1.0 / math.sqrt(n)))
    if inverse:
        return y * float(np.float32(1.0 / n))
    return y
