"""PSS matched-filter correlation magnitude and fused detect.

Ports of two TPU kernels of ``lteax/kernels/pss.py`` to one CUDA source,
``csrc/pss.cu`` (see the note there):

- :func:`pss_corr_mag` replaces ``pss_corr_mag_pallas``: |corr|^2 of
  (..., L) complex64 against the 3 PSS replicas, (..., 3, L) float32 with
  ``corr[n] = sum_k x[n+k] conj(h[k])`` (peak index = PSS start sample);
- :func:`pss_detect` replaces ``pss_detect_pallas``: the same, with each
  tile of outputs reduced in the kernel to (max, first argmax, sum) per
  root, combined by :func:`pss_reduce_combine`.

Both take the reference's ``mdtype`` and run one kernel, the Toeplitz-chunk
GEMM on the tensor cores.  ``"bf16"``, the default as in the reference,
makes one pass: x and the replicas rounded to bfloat16, products exact,
float32 accumulation.  ``"f32"`` splits x and the replicas into three
bfloat16 planes each (:func:`split_bf16`) and makes the six passes of the
plane products with i + j <= 2 (``PSS_F32_PASSES`` in pss.cu), which keep
the correlation at the float32 level.  Each has a plain torch version,
which CPU tensors take (the bf16-rounded inputs, or x and the replicas as
they are, through one f32 loop with the taps in order); CUDA tensors
launch the kernel.  Each kernel sums in another order than its plain
version, so it is held to it by :data:`BF16_TOL` or :data:`F32_TOL` of each
carrier's peak, and exactly in the root and peak index.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

FRAME = 64
"""Samples per GEMM row of the kernel (``kFrame`` in pss.cu)."""
TILE_ROWS = 256
"""Frames per block of the kernel (``kRows`` in pss.cu)."""
TILE_BF16 = FRAME * TILE_ROWS
"""Outputs per block and per detect partial of either routine."""
PLANES = 3
"""bfloat16 planes of each operand in the f32 routine."""
F32_PASSES = PLANES * (PLANES + 1) // 2
"""Passes of the f32 routine: the plane products X_i B_j with i + j <= 2
(``PSS_F32_PASSES`` in pss.cu)."""

BF16_TOL = 1e-4
"""Largest |kernel - plain| of the bf16 routine, relative to the carrier's
peak magnitude.  Both sum the same exact products of bf16-rounded inputs
in float32; a 4096-term sum whose partial sums stay below the peak's
square root carries at most a few 1e-6 of the peak in either order, and
the magnitude doubles the relative error: 1e-4 leaves a factor of ten."""

F32_TOL = 2e-5
"""Largest |kernel - plain| of the f32 routine, relative to the carrier's
peak magnitude.  Neither side is exact.  The kernel's three-plane split
leaves out products of order 2^-24 and adds each chunk's partial sums in
float32; the plain version sums 2048 taps in order in float32, which
carries ~u * sqrt(nf / 3) of the correlation at its peak.  Against a
float64 correlation at 20 MHz (``chip_smoke.py``'s ``[pss-f32]``, a PSS at
30x the noise's amplitude) the kernel is ~1e-6 of the peak magnitude off
and the plain version ~2e-6, so no bound near 1e-6 holds between them;
2e-5 leaves a factor of six over their sum.  It lies well below the bf16
routine's distance from the same correlation (its inputs keep 8
significant bits: a few 1e-4 of the peak, ``[pss-bf16]``), so a kernel
that fell back to bf16 products would fail it."""

CORR_LAUNCHES = 0
"""Launches of the f32 correlator entry since the last reset."""
DETECT_LAUNCHES = 0
"""Launches of the f32 detect entry since the last reset."""
CORR_BF16_LAUNCHES = 0
"""Launches of the bf16 correlator entry since the last reset."""
DETECT_BF16_LAUNCHES = 0
"""Launches of the bf16 detect entry since the last reset."""

MDTYPES = ("bf16", "f32")


def _check_mdtype(mdtype: str) -> None:
    if mdtype not in MDTYPES:
        raise ValueError(f"mdtype must be one of {MDTYPES}, got {mdtype!r}")


def _replicas(filt, device) -> torch.Tensor:
    """(3, nf) complex64 replicas on ``device``."""
    return torch.as_tensor(np.asarray(filt, dtype=np.complex64),
                           device=device)


def _round_bf16(x: torch.Tensor) -> torch.Tensor:
    """Real and imaginary parts rounded to bfloat16 (nearest even), kept
    as complex64."""
    r = torch.view_as_real(x.to(torch.complex64))
    return torch.view_as_complex(r.to(torch.bfloat16).to(torch.float32))


def _chunk_matrices(filt: np.ndarray, f: int) -> np.ndarray:
    """(3, (nc+1)*F, F) complex64 stacked Toeplitz chunks of conj(h):
    G_c[s, i] = conj(h[c*F + s - i]) where 0 <= c*F + s - i < nf, so that a
    tile of T output frames is sum_c X[c : c+T, :] @ G_c.  The port's own
    copy of ``lteax.kernels.pss._chunk_matrices``."""
    nf = filt.shape[1]
    nc = -(-nf // f)
    g = np.zeros((3, (nc + 1) * f, f), np.complex64)
    hh = np.conj(filt)
    s_idx = np.arange((nc + 1) * f)[:, None]          # chunk-stacked s
    i_idx = np.arange(f)[None, :]
    d = s_idx - i_idx                                  # = c*F + s - i
    valid = (d >= 0) & (d < nf)
    for r in range(3):
        g[r][valid] = hh[r][d[valid]]
    return g


def toeplitz_operand_np(filt) -> np.ndarray:
    """The bf16 kernel's B operand as float32 values (bf16-representable
    once rounded): (nc+1, 3, 2F, 2F) real matrices B[c, root, k, n] of the
    complex product as one real GEMM, with A's K index 2s + p (p = 0 the
    real, 1 the imaginary part of sample s of a frame) and N index 2i + q
    (q = 0 the real, 1 the imaginary part of output i):

        [cr | ci] = [xr | xi] @ [[gr, gi], [-gi, gr]]."""
    filt = np.asarray(filt, dtype=np.complex64)
    nf, f = filt.shape[1], FRAME
    nch = -(-nf // f) + 1
    g = _chunk_matrices(filt, f).reshape(3, nch, f, f).transpose(1, 0, 2, 3)
    gr, gi = g.real, g.imag
    b = np.empty((nch, 3, f, 2, f, 2), np.float32)     # [c, r, s, p, i, q]
    b[:, :, :, 0, :, 0] = gr
    b[:, :, :, 1, :, 0] = -gi
    b[:, :, :, 0, :, 1] = gi
    b[:, :, :, 1, :, 1] = gr
    return b.reshape(nch, 3, 2 * f, 2 * f)


def split_bf16(v: torch.Tensor) -> list[torch.Tensor]:
    """The f32 routine's split of float32 ``v`` into :data:`PLANES`
    bfloat16 planes, v0 = bf16(v), v1 = bf16(v - v0), v2 = bf16(v - v0 -
    v1) (nearest even; both subtractions exact in float32), as the kernel
    splits x.  The planes sum to v exactly for every float32 value of
    magnitude 2^-110 or more."""
    planes, rest = [], v.to(torch.float32)
    for _ in range(PLANES):
        p = rest.to(torch.bfloat16)
        planes.append(p)
        rest = rest - p.to(torch.float32)
    return planes


def _image(b: torch.Tensor) -> torch.Tensor:
    """(nch, 3, K, N) bfloat16 -> the kernel's shared-memory image
    (nch, 3, K/8, N, 8): per chunk and root the K-major core matrices of 8
    rows x 16 bytes that ``wgmma`` reads without a swizzle."""
    nch, _, k, n = b.shape
    return b.reshape(nch, 3, k // 8, 8, n).transpose(3, 4).contiguous()


def _toeplitz_image(filt: np.ndarray) -> torch.Tensor:
    """The bf16 routine's B operand in the kernel's image, bfloat16
    (nc+1, 3, K/8, N, 8).  The replicas are rounded to bfloat16 before the
    chunks are cut (negation is exact), so the kernel multiplies what the
    plain version does."""
    b = toeplitz_operand_np(_round_bf16(torch.from_numpy(filt)).numpy())
    return _image(torch.from_numpy(b).to(torch.bfloat16))


def _toeplitz_planes(filt: np.ndarray) -> torch.Tensor:
    """The f32 routine's B operand: the Toeplitz operand of the unrounded
    replicas split into :data:`PLANES` bfloat16 planes, each in the
    kernel's image, (PLANES, nc+1, 3, K/8, N, 8).  Plane 0 is the bf16
    routine's image (negation commutes with rounding)."""
    b = torch.from_numpy(toeplitz_operand_np(filt))
    return torch.stack([_image(p) for p in split_bf16(b)])


@lru_cache(maxsize=8)
def _operand(mdtype: str, raw: bytes, nf: int, device: str) -> torch.Tensor:
    """The kernel's replica operand on ``device``: the Toeplitz image, in
    three planes for "f32" and one for "bf16".  Kept per content
    of the replicas (``raw``, their complex64 bytes): the wrappers run
    once per capture batch, and neither the operand's construction nor its
    upload belongs on that path, while replicas that changed, in place or
    not, get a new operand."""
    filt = np.frombuffer(raw, np.complex64).reshape(3, nf).copy()
    if mdtype == "f32":
        return _toeplitz_planes(filt).to(device)
    return _toeplitz_image(filt).to(device)


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


def _rounded(x: torch.Tensor, filt, mdtype: str):
    """x and the replicas as the ``mdtype`` routine multiplies them."""
    _check_mdtype(mdtype)
    if mdtype == "f32":
        return x, filt
    return _round_bf16(x), _round_bf16(_replicas(filt, "cpu")).numpy()


def pss_corr_mag_plain(x: torch.Tensor, filt,
                       mdtype: str = "bf16") -> torch.Tensor:
    """Plain torch version: (C, L) complex64 -> (C, 3, L) float32."""
    x, filt = _rounded(x, filt, mdtype)
    return _corr_mag_padded(x, filt, x.shape[-1])


def _split(x: torch.Tensor, name: str):
    """(..., L) -> (C, L) and the leading shape; CUDA tensors must be
    complex64."""
    if x.is_cuda and x.dtype != torch.complex64:
        raise ValueError(f"{name}: needs complex64 CUDA tensors, got "
                         f"{x.dtype}")
    return x.reshape(-1, x.shape[-1]), x.shape[:-1]


def _launch(entry: str, name: str, xc: torch.Tensor, filt, mdtype: str,
            outs: list) -> None:
    """Launch ``entry`` (f32) or ``entry + "_bf16"`` on (C, L) complex64
    ``xc`` with the output tensors ``outs``; both take the Toeplitz image
    of their arithmetic (:func:`_operand`)."""
    from lteax_torch.kernels._build import check_cuda, library, stream_handle
    xv = torch.view_as_real(xc.contiguous())
    nf = np.asarray(filt).shape[1]
    raw = np.ascontiguousarray(filt, dtype=np.complex64).tobytes()
    hv = _operand(mdtype, raw, nf, str(xc.device))
    check_cuda(name, xv)
    if mdtype != "f32":
        entry += "_bf16"
    library().call(entry, xv.data_ptr(), hv.data_ptr(),
                   *(o.data_ptr() for o in outs), xc.shape[0], xc.shape[1],
                   nf, stream_handle(xc))


def pss_corr_mag(x: torch.Tensor, filt, mdtype: str = "bf16") -> torch.Tensor:
    """|corr|^2 of x (..., L) against the 3 replicas ``filt`` (3, nf)
    -> (..., 3, L) float32.  CPU: plain version; CUDA: the kernel."""
    global CORR_LAUNCHES, CORR_BF16_LAUNCHES
    _check_mdtype(mdtype)
    xc, lead = _split(x, "pss_corr_mag")
    l = xc.shape[-1]
    if not x.is_cuda:
        return pss_corr_mag_plain(xc, filt, mdtype).reshape(*lead, 3, l)
    out = torch.empty((xc.shape[0], 3, l), dtype=torch.float32,
                      device=x.device)
    _launch("lteax_pss_corr", "pss_corr_mag", xc, filt, mdtype, [out])
    if mdtype == "f32":
        CORR_LAUNCHES += 1
    else:
        CORR_BF16_LAUNCHES += 1
    return out.reshape(*lead, 3, l)


def pss_detect_plain(x: torch.Tensor, filt, mdtype: str = "bf16"):
    """Plain torch version of the detect entry: (C, L) complex64 ->
    (maxv f32, argv int32, sumv f32), each (C, 3, n_tiles)."""
    x, filt = _rounded(x, filt, mdtype)
    c, l = x.shape
    tile = TILE_BF16
    n_tiles = -(-l // tile)
    m = _corr_mag_padded(x, filt, n_tiles * tile)
    flat = m.reshape(c, 3, n_tiles, tile)
    tot = flat.sum(dim=-1)
    maxv = flat.amax(dim=-1)
    argv = torch.argmax((flat == maxv[..., None]).to(torch.uint8), dim=-1)
    return maxv, argv.to(torch.int32), tot


def pss_detect(x: torch.Tensor, filt, mdtype: str = "bf16"):
    """Correlate + reduce per tile.  x (..., L) complex64 -> (maxv, argv,
    sumv, tile, L): (..., 3, n_tiles) partials in the reference's tuple
    form; combine with :func:`pss_reduce_combine`.  CPU: plain version;
    CUDA: the kernel (the (C, 3, L) magnitudes are never written)."""
    global DETECT_LAUNCHES, DETECT_BF16_LAUNCHES
    _check_mdtype(mdtype)
    xc, lead = _split(x, "pss_detect")
    c, l = xc.shape
    tile = TILE_BF16
    n_tiles = -(-l // tile)
    if not x.is_cuda:
        parts = pss_detect_plain(xc, filt, mdtype)
    else:
        maxv = torch.empty((c, 3, n_tiles), dtype=torch.float32,
                           device=x.device)
        argv = torch.empty((c, 3, n_tiles), dtype=torch.int32,
                           device=x.device)
        sumv = torch.empty_like(maxv)
        parts = (maxv, argv, sumv)
        _launch("lteax_pss_detect", "pss_detect", xc, filt, mdtype,
                list(parts))
        if mdtype == "f32":
            DETECT_LAUNCHES += 1
        else:
            DETECT_BF16_LAUNCHES += 1
    shape = (*lead, 3, n_tiles)
    return (*(p.reshape(shape) for p in parts), tile, l)


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
