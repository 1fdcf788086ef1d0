"""PSS matched-filter correlation magnitude and fused detect.

Ports of two TPU kernels of ``lteax/kernels/pss.py`` to one CUDA source,
``csrc/pss.cu`` (a direct time-domain correlator; see the note there):

- :func:`pss_corr_mag` replaces ``pss_corr_mag_pallas``: |corr|^2 of
  (..., L) complex64 against the 3 PSS replicas, (..., 3, L) float32 with
  ``corr[n] = sum_k x[n+k] conj(h[k])`` (peak index = PSS start sample);
- :func:`pss_detect` replaces ``pss_detect_pallas``: the same, with each
  tile of ``TILE`` outputs reduced in the kernel to (max, first argmax,
  sum) per root, combined by :func:`pss_reduce_combine`.

Each has a plain torch version of the same arithmetic (k accumulated in
order, every product and sum rounded to f32, the detect reduction in the
kernel's tree), which CPU tensors take; CUDA tensors launch the kernel.
"""

from __future__ import annotations

import numpy as np
import torch

TILE = 1024
"""Outputs per kernel block and per detect partial (``kTile`` in pss.cu)."""
_THREADS, _PER = 256, 4       # kThreads, kPer: the reduction tree's shape

CORR_LAUNCHES = 0
"""Launches of the correlator entry since the last reset."""
DETECT_LAUNCHES = 0
"""Launches of the detect entry since the last reset."""


def _replicas(filt, device) -> torch.Tensor:
    """(3, nf) complex64 replicas on ``device``."""
    return torch.as_tensor(np.asarray(filt, dtype=np.complex64),
                           device=device)


def _corr_mag_padded(x: torch.Tensor, filt, lp: int) -> torch.Tensor:
    """(C, L) complex -> (C, 3, lp) |corr|^2 over x zero-padded to
    lp + nf - 1 samples, taps k = 0..nf-1 in order."""
    h = _replicas(filt, x.device)
    nf = h.shape[-1]
    c, l = x.shape
    xr = torch.nn.functional.pad(x.real.to(torch.float32), (0, lp + nf - l))
    xi = torch.nn.functional.pad(x.imag.to(torch.float32), (0, lp + nf - l))
    hr = h.real.contiguous()
    hi = h.imag.contiguous()
    cr = torch.zeros((c, 3, lp), dtype=torch.float32, device=x.device)
    ci = torch.zeros_like(cr)
    for k in range(nf):
        a = xr[:, None, k:k + lp]
        b = xi[:, None, k:k + lp]
        hrk, hik = hr[:, k, None], hi[:, k, None]
        tr = a * hrk
        tr += b * hik
        cr += tr
        ti = b * hrk
        ti -= a * hik
        ci += ti
    return cr * cr + ci * ci


def pss_corr_mag_plain(x: torch.Tensor, filt) -> torch.Tensor:
    """Plain torch version: (C, L) complex64 -> (C, 3, L) float32."""
    return _corr_mag_padded(x, filt, x.shape[-1])


def _split(x: torch.Tensor, name: str):
    """(..., L) -> (C, L) and the leading shape; CUDA tensors must be
    complex64."""
    if x.is_cuda and x.dtype != torch.complex64:
        raise ValueError(f"{name}: needs complex64 CUDA tensors, got "
                         f"{x.dtype}")
    return x.reshape(-1, x.shape[-1]), x.shape[:-1]


def pss_corr_mag(x: torch.Tensor, filt) -> torch.Tensor:
    """|corr|^2 of x (..., L) against the 3 replicas ``filt`` (3, nf)
    -> (..., 3, L) float32.  CPU: plain version; CUDA: the kernel."""
    global CORR_LAUNCHES
    xc, lead = _split(x, "pss_corr_mag")
    l = xc.shape[-1]
    if not x.is_cuda:
        return pss_corr_mag_plain(xc, filt).reshape(*lead, 3, l)
    from lteax_torch.kernels._build import check_cuda, library, stream_handle
    xv = torch.view_as_real(xc.contiguous())
    hv = torch.view_as_real(_replicas(filt, x.device))
    check_cuda("pss_corr_mag", xv, hv)
    out = torch.empty((xc.shape[0], 3, l), dtype=torch.float32,
                      device=x.device)
    library().call("lteax_pss_corr", xv.data_ptr(), hv.data_ptr(),
                   out.data_ptr(), xc.shape[0], l, hv.shape[1],
                   stream_handle(x))
    CORR_LAUNCHES += 1
    return out.reshape(*lead, 3, l)


def pss_detect_plain(x: torch.Tensor, filt):
    """Plain torch version of the detect entry: (C, L) complex64 ->
    (maxv f32, argv int32, sumv f32), each (C, 3, n_tiles), reduced per
    tile in the kernel's order."""
    c, l = x.shape
    n_tiles = -(-l // TILE)
    m = _corr_mag_padded(x, filt, n_tiles * TILE)
    m = m.reshape(c, 3, n_tiles, _PER, _THREADS)   # position j*256 + thread
    s = m[..., 0, :]
    for j in range(1, _PER):
        s = s + m[..., j, :]                        # per thread, j in order
    s = s.reshape(c, 3, n_tiles, _THREADS // 32, 32)
    off = 16
    while off:
        s = s[..., :off] + s[..., off:2 * off]      # warp shuffle tree
        off //= 2
    tot = s[..., 0, 0]
    for w in range(1, _THREADS // 32):
        tot = tot + s[..., w, 0]                    # warps in order
    flat = m.reshape(c, 3, n_tiles, TILE)
    maxv = flat.amax(dim=-1)
    argv = torch.argmax((flat == maxv[..., None]).to(torch.uint8), dim=-1)
    return maxv, argv.to(torch.int32), tot


def pss_detect(x: torch.Tensor, filt):
    """Correlate + reduce per tile.  x (..., L) complex64 -> (maxv, argv,
    sumv, TILE, L): (..., 3, n_tiles) partials in the reference's tuple
    form; combine with :func:`pss_reduce_combine`.  CPU: plain version;
    CUDA: the kernel (the (C, 3, L) magnitudes are never written)."""
    global DETECT_LAUNCHES
    xc, lead = _split(x, "pss_detect")
    c, l = xc.shape
    n_tiles = -(-l // TILE)
    if not x.is_cuda:
        parts = pss_detect_plain(xc, filt)
    else:
        from lteax_torch.kernels._build import (check_cuda, library,
                                                stream_handle)
        xv = torch.view_as_real(xc.contiguous())
        hv = torch.view_as_real(_replicas(filt, x.device))
        check_cuda("pss_detect", xv, hv)
        maxv = torch.empty((c, 3, n_tiles), dtype=torch.float32,
                           device=x.device)
        argv = torch.empty((c, 3, n_tiles), dtype=torch.int32,
                           device=x.device)
        sumv = torch.empty_like(maxv)
        library().call("lteax_pss_detect", xv.data_ptr(), hv.data_ptr(),
                       maxv.data_ptr(), argv.data_ptr(), sumv.data_ptr(),
                       c, l, hv.shape[1], stream_handle(x))
        DETECT_LAUNCHES += 1
        parts = (maxv, argv, sumv)
    shape = (*lead, 3, n_tiles)
    return (*(p.reshape(shape) for p in parts), TILE, l)


def pss_reduce_combine(maxv, argv, sumv, tile_len: int, l: int):
    """Per-tile partials -> (n_id_2, peak_idx, peak, mean), ties to the
    first tile attaining the maximum (the result does not depend on the
    tile length)."""
    root_max = maxv.amax(dim=-1)                       # (..., 3)
    n_id_2 = torch.argmax(root_max, dim=-1)
    pick = n_id_2[..., None, None].expand(*n_id_2.shape, 1, maxv.shape[-1])
    mr = torch.gather(maxv, -2, pick)[..., 0, :]       # (..., n_tiles)
    ar = torch.gather(argv, -2, pick)[..., 0, :]
    peak = mr.amax(dim=-1)
    tile = torch.argmax(mr, dim=-1)
    idx = tile * tile_len + torch.gather(ar, -1, tile[..., None])[..., 0]
    mean = sumv.sum(dim=(-2, -1)) / (3 * l)
    return n_id_2, idx, peak, mean
