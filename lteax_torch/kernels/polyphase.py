"""Rational P/Q polyphase resampler for the multi-carrier scanner front.

Port of the TPU kernel ``lteax/kernels/polyphase.py::resample_poly_pallas``
to the CUDA kernel ``csrc/polyphase.cu``.  Output sample y[j*P + r] is the
12-tap FIR

    y[j*P + r] = sum_t bank[(r*Q) mod P, t] * x[j*Q + off_r + T-1 - t],
    off_r = floor(r*Q / P),

the upfirdn identity behind the reference's dense (K_in, P) frame weight
(:func:`_frame_weight`), whose zero entries the kernel skips.  Taps are
accumulated t = 0..T-1 in order, real and imaginary parts separately, in
the kernel and in :func:`resample_poly_plain` alike, so the two agree bit
for bit.  :func:`resample_poly` takes (..., L) complex64 streams (every
leading axis is a batch of channels); CPU tensors take the plain version,
CUDA tensors launch the kernel.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

LAUNCHES = 0
"""Kernel launches since the last reset (plain-version calls do not count)."""


@lru_cache(maxsize=None)
def design_polyphase(p: int, q: int, taps_per_phase: int = 12,
                     beta: float = 8.0) -> np.ndarray:
    """Kaiser-windowed sinc low-pass at cutoff min(1/P, 1/Q), gain P.

    Returns (P, taps_per_phase) float32 subfilter bank: subfilter r holds
    h[r], h[r+P], h[r+2P], ...  (h of length P*taps_per_phase)."""
    n = p * taps_per_phase
    cutoff = 1.0 / max(p, q)
    k = np.arange(n) - (n - 1) / 2
    h = np.sinc(cutoff * k) * cutoff * np.kaiser(n, beta)
    h = h * p / np.sum(h)
    return h.reshape(taps_per_phase, p).T.astype(np.float32).copy()


@lru_cache(maxsize=None)
def _frame_weight(p: int, q: int, taps_per_phase: int) -> np.ndarray:
    """(K_in, P) f32 weight: output frame j = x[jQ : jQ+K_in] @ W, with
    W[off_r + t, r] = bank[(rQ) mod P, T-1-t] and zeros elsewhere."""
    bank = design_polyphase(p, q, taps_per_phase)
    t = bank.shape[1]
    off = [(r * q) // p for r in range(p)]
    w = np.zeros((max(off) + t, p), dtype=np.float32)
    for r in range(p):
        sub = bank[(r * q) % p]
        for tt in range(t):
            w[off[r] + tt, r] = sub[t - 1 - tt]
    return w


def n_frames_out(l: int, p: int, q: int, taps_per_phase: int = 12) -> int:
    """Output frames (of P samples) of an L-sample stream: the reference's
    edge-trimmed length (L - T - max off_r) // Q."""
    return max((l - taps_per_phase - (((p - 1) * q) // p)) // q, 0)


@lru_cache(maxsize=8)
def _plain_plan(p: int, q: int, t: int, n_frames: int, device):
    """(bank rows per output phase (T, P) f32, base index (F, P) int64)."""
    bank = design_polyphase(p, q, t)
    r = np.arange(p)
    taps = bank[(r * q) % p].T.copy()                     # (T, P)
    base = (np.arange(n_frames)[:, None] * q + ((r * q) // p)[None, :]
            + t - 1)
    return (torch.as_tensor(taps, device=device),
            torch.as_tensor(base, device=device))


def resample_poly_plain(x: torch.Tensor, p: int, q: int,
                        taps_per_phase: int = 12) -> torch.Tensor:
    """Plain torch version: (C, L) complex64 -> (C, n_frames*P) complex64,
    the 12 taps accumulated in the kernel's order over (C, frames, P)."""
    c, l = x.shape
    f = n_frames_out(l, p, q, taps_per_phase)
    taps, base = _plain_plan(p, q, taps_per_phase, f, x.device)
    xr, xi = x.real.contiguous(), x.imag.contiguous()
    yr = yi = None
    for t in range(taps_per_phase):
        idx = base - t
        b = taps[t]
        tr, ti = b * xr[:, idx], b * xi[:, idx]
        yr = tr if yr is None else yr + tr
        yi = ti if yi is None else yi + ti
    return torch.complex(yr, yi).reshape(c, f * p)


def resample_poly(x: torch.Tensor, p: int, q: int,
                  taps_per_phase: int = 12) -> torch.Tensor:
    """Resample (..., L) complex64 by P/Q -> (..., n_frames*P).

    CPU tensors take the plain version; CUDA tensors launch the kernel."""
    global LAUNCHES
    lead, l = x.shape[:-1], x.shape[-1]
    xc = x.reshape(-1, l)
    if not x.is_cuda:
        y = resample_poly_plain(xc.to(torch.complex64), p, q, taps_per_phase)
        return y.reshape(*lead, -1)
    from lteax_torch.kernels._build import (check_cuda, library,
                                            stream_handle)
    if x.dtype != torch.complex64:
        raise ValueError(f"resample_poly: needs complex64 CUDA tensors, got "
                         f"{x.dtype}")
    xv = torch.view_as_real(xc.contiguous())             # (C, L, 2) f32
    bank = torch.as_tensor(design_polyphase(p, q, taps_per_phase),
                           device=x.device)
    check_cuda("resample_poly", xv, bank)
    f = n_frames_out(l, p, q, taps_per_phase)
    y = torch.empty((xc.shape[0], f * p, 2), dtype=torch.float32,
                    device=x.device)
    if f > 0 and xc.shape[0] > 0:
        library().call("lteax_resample", xv.data_ptr(), bank.data_ptr(),
                       y.data_ptr(), xc.shape[0], l, p, q, taps_per_phase,
                       f, stream_handle(x))
        LAUNCHES += 1
    return torch.view_as_complex(y).reshape(*lead, f * p)
