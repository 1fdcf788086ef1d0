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

The kernel's launch is planned here (:func:`launch_plan`: threads, items
a thread, frames a tile, blocks, shared memory), so that the CPU tests can
check the tiling and emulate the kernel's walk.
"""

from __future__ import annotations

from fractions import Fraction
from functools import lru_cache
from typing import NamedTuple

import numpy as np
import torch

LAUNCHES = 0
"""Kernel launches since the last reset (plain-version calls do not count)."""

TAPS = 12                      # the kernel's taps a phase
THREADS = range(128, 513, 32)  # block sizes the plan picks from
PER_THREAD = (1, 2, 4)         # items a thread (the kernel's instances)
SPAN_TARGET = 2048             # input samples a tile stages, about
SMEM_BLOCK = 232_448           # 227 KB, a block's most shared memory
SMEM_SM = 233_472              # 228 KB an SM, 1 KB of it reserved a block
REGS_EST = {1: 48, 2: 64, 4: 104}  # registers a thread (ptxas, sm_90a)
MIN_BLOCKS_PER_SM = 2


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


def k_in(p: int, q: int) -> int:
    """Input samples one output frame reads: max off_r + TAPS."""
    return ((p - 1) * q) // p + TAPS


class LaunchPlan(NamedTuple):
    """How ``csrc/polyphase.cu`` cuts a (C, L) launch.  A block of
    ``threads`` threads holds ``per_thread`` items (frame slot, phase) a
    thread; a pass computes ``slots`` frames of the ``groups``-th share of
    the phases; a tile is ``frames`` frames (a multiple of ``slots``) of
    one channel, ``tiles`` tiles a channel; ``blocks`` blocks a phase group
    walk the C*tiles tiles with a stride of ``blocks``, two staging buffers
    of ``buf`` samples each (``smem`` bytes in all)."""
    threads: int
    per_thread: int
    slots: int
    groups: int
    frames: int
    tiles: int
    blocks: int
    buf: int
    smem: int


def _thread_map(p: int, q: int, kin: int) -> tuple[int, int, int, int]:
    """(threads, per_thread, slots, groups) with the fewest phase groups,
    then the fewest idle items, then the fewest items a thread, then the
    block nearest 256 threads."""
    s_max = (SMEM_BLOCK // 16 - kin - 2) // q + 1     # frames one buffer holds
    best = None
    for r in PER_THREAD:
        for nt in THREADS:
            items = nt * r
            s = min(items // p, s_max)
            if s >= 1:
                g, idle, total = 1, items - s * p, items
            else:
                s, g = 1, -(-p // items)
                idle, total = g * items - p, g * items
            key = (g, Fraction(idle, total), r, abs(nt - 256))
            if best is None or key < best[0]:
                best = (key, (nt, r, s, g))
    return best[1]


@lru_cache(maxsize=64)
def launch_plan(c: int, l: int, p: int, q: int, n_sm: int) -> LaunchPlan:
    """The kernel's launch for (C, L) streams at P/Q on ``n_sm`` SMs:
    tiles of about ``SPAN_TARGET`` input samples, cut smaller until the
    work fills ``MIN_BLOCKS_PER_SM`` blocks an SM with two tiles each; as
    many blocks as fit on the card at once, each walking an equal share of
    the tiles."""
    nf = n_frames_out(l, p, q)
    kin = k_in(p, q)
    if c <= 0 or nf <= 0:
        raise ValueError(f"resample_poly: nothing to launch for C={c}, "
                         f"L={l} at {p}/{q}")
    buf = lambda frames: ((frames - 1) * q + kin + 2) & ~1
    if buf(1) > SMEM_BLOCK // 16:
        raise ValueError(f"resample_poly: one frame of {p}/{q} reads {kin} "
                         f"samples, more than the kernel stages")
    nt, r, s, g = _thread_map(p, q, kin)
    units = lambda frames: c * g * -(-nf // frames)
    passes = max(1, SPAN_TARGET // (s * q))
    while passes > 1 and buf(passes * s) > SMEM_BLOCK // 16:
        passes -= 1
    while passes > 1 and units(passes * s) < 2 * MIN_BLOCKS_PER_SM * n_sm:
        passes -= 1
    frames = passes * s
    tiles = -(-nf // frames)
    smem = 16 * buf(frames)
    per_sm = max(1, min(2048 // nt, SMEM_SM // (smem + 1024),
                        65536 // (nt * REGS_EST[r]), 32))
    per_block = -(-units(frames) // (n_sm * per_sm))
    return LaunchPlan(nt, r, s, g, frames, tiles, -(-(c * tiles) // per_block),
                      buf(frames), smem)


@lru_cache(maxsize=16)
def _device_bank(p: int, q: int, device: str) -> torch.Tensor:
    """The (P, TAPS) bank on ``device``, uploaded once per ratio."""
    return torch.as_tensor(design_polyphase(p, q, TAPS), device=device)


@lru_cache(maxsize=None)
def _sm_count(device: str) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


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
                  taps_per_phase: int = TAPS) -> torch.Tensor:
    """Resample (..., L) complex64 by P/Q -> (..., n_frames*P).

    CPU tensors take the plain version; CUDA tensors launch the kernel,
    which is built for ``TAPS`` taps a phase."""
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
    if taps_per_phase != TAPS:
        raise ValueError(f"resample_poly: the kernel takes {TAPS} taps a "
                         f"phase, not {taps_per_phase}")
    xv = torch.view_as_real(xc.contiguous())             # (C, L, 2) f32
    if xv.data_ptr() % 16:              # the kernel copies 16-byte pairs
        xv = xv.clone()
    bank = _device_bank(p, q, str(x.device))
    check_cuda("resample_poly", xv, bank)
    c, f = xc.shape[0], n_frames_out(l, p, q)
    y = torch.empty((c, f * p, 2), dtype=torch.float32, device=x.device)
    if f > 0 and c > 0:
        pl = launch_plan(c, l, p, q, _sm_count(str(x.device)))
        library().call("lteax_resample", xv.data_ptr(), bank.data_ptr(),
                       y.data_ptr(), c, l, p, q, f, pl.threads, pl.per_thread,
                       pl.slots, pl.groups, pl.frames, pl.tiles, pl.blocks,
                       pl.buf, stream_handle(x))
        LAUNCHES += 1
    return torch.view_as_complex(y).reshape(*lead, f * p)
