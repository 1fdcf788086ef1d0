"""Fused max-log QAM demap + LLR scaling + descramble, planar output.

Port of the TPU kernel ``lteax/kernels/demap.py::demap_descr_planar_pallas``
to the CUDA kernel ``csrc/demap.cu`` (one thread per (subframe, column),
HBM-bound; see the note in the source).  :func:`demap_planar_plain` is the
same arithmetic in plain torch; :func:`demap_planar` runs it for CPU
tensors and launches the kernel for CUDA tensors.

Output is PLANAR — (B, m, Np): plane j holds bit j of every symbol — and a
zero descramble sign gives exactly 0.0, which the de-match map's zero slot
relies on (``lteax_torch.pipeline``).

The inputs may be staged in bf16 (the reference's ``demap_in="bf16"``) and
the output written in bf16 (its ``out_dtype=bf16`` under a bf16 trellis):
the arithmetic is f32 either way, and each LLR rounds once on output.
"""

from __future__ import annotations

import numpy as np
import torch

from lteax_torch.phy.mod import BITS_PER_SYM, _pam_axis
from lteax_torch.phy.seq import scrambling_symbols_np

LAUNCHES = 0
"""Launches of the f32-in, f32-out form since the last reset
(plain-version calls do not count)."""

FORM_LAUNCHES = {"bf16": 0, "bf16_in": 0, "bf16_out": 0}
"""Launches of the other forms, as :data:`LAUNCHES`: bf16 in and out,
bf16 in and f32 out, f32 in and bf16 out."""

_DTYPES = (torch.float32, torch.bfloat16)


def _form(in_dtype: torch.dtype, out_dtype: torch.dtype) -> str | None:
    """The form's key in :data:`FORM_LAUNCHES` (None: the f32 form)."""
    bf_out = out_dtype == torch.bfloat16
    if in_dtype == torch.bfloat16:
        return "bf16" if bf_out else "bf16_in"
    return "bf16_out" if bf_out else None


def planar_sgn_np(c_init: int, g: int, m: int, npad: int) -> np.ndarray:
    """(m, npad) f32 scrambling signs in planar layout: plane j, column s
    holds the sign of interleaved bit s*m + j; columns past g/m hold 1
    (the demap zero-pads 1/nv there, so they emit 0 all the same)."""
    n = g // m
    out = np.ones((m, npad), dtype=np.float32)
    out[:, :n] = scrambling_symbols_np(c_init, g).reshape(n, m).T
    return out


def _npad(n: int, sgn_planar: torch.Tensor) -> int:
    # lane padding follows the sign planes when they are wider (the DL
    # full-grid path keeps >=1 zeroed pad column as the de-match zero slot)
    return max(-(-n // 128) * 128, sgn_planar.shape[1])


def demap_planar_plain(xr, xi, inv_nv, sgn_planar, scheme: str,
                       out_dtype: torch.dtype = torch.float32):
    """Plain torch version: (B, N) xr, xi, inv_nv (f32 or bf16, widened to
    f32) and (m, Np) f32 signs -> (B, m, Np) LLRs in ``out_dtype``
    (columns past N see zero inputs)."""
    m = BITS_PER_SYM[scheme]
    pam, bit1 = _pam_axis(scheme)
    levels = [float(s) for s in pam]
    bsz, n = xr.shape
    npad = _npad(n, sgn_planar)
    pad = lambda x: torch.nn.functional.pad(x.to(torch.float32),
                                            (0, npad - n))
    scale = pad(inv_nv)
    out = torch.empty((bsz, m, npad), dtype=out_dtype, device=xr.device)
    for axis, y in ((0, pad(xr)), (1, pad(xi))):
        d = [(y - s) * (y - s) for s in levels]
        for j in range(m // 2):
            d0 = d1 = None
            for i, one in enumerate(bit1[j]):
                if one:
                    d1 = d[i] if d1 is None else torch.minimum(d1, d[i])
                else:
                    d0 = d[i] if d0 is None else torch.minimum(d0, d[i])
            plane = 2 * j + axis
            out[:, plane, :] = (d1 - d0) * scale * sgn_planar[plane]
    return out


def demap_planar(xr, xi, inv_nv, sgn_planar, scheme: str,
                 out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """(B, N) xr, xi, inv_nv, all f32 or all bf16; (m, Np) f32 signs ->
    (B, m, Np) LLRs in ``out_dtype`` (f32 or bf16).

    CPU tensors take the plain version; CUDA tensors launch the kernel."""
    global LAUNCHES
    m = BITS_PER_SYM[scheme]
    if scheme not in ("qpsk", "16qam", "64qam"):
        raise ValueError(f"demap kernel supports QPSK/16QAM/64QAM, not {scheme}")
    bsz, n = xr.shape
    npad = _npad(n, sgn_planar)
    if sgn_planar.shape != (m, npad):
        raise ValueError(f"sign planes {tuple(sgn_planar.shape)} != {(m, npad)}")
    if xr.dtype not in _DTYPES or out_dtype not in _DTYPES:
        raise ValueError(f"demap: f32 or bf16 in and out, not {xr.dtype} -> "
                         f"{out_dtype}")
    if not xr.is_cuda:
        return demap_planar_plain(xr, xi, inv_nv, sgn_planar, scheme,
                                  out_dtype)
    from lteax_torch.kernels._build import check_cuda, library, stream_handle
    check_cuda("demap_planar", xr, xi, inv_nv, dtype=xr.dtype)
    check_cuda("demap_planar", sgn_planar)
    out = torch.empty((bsz, m, npad), dtype=out_dtype, device=xr.device)
    levels = np.ascontiguousarray(_pam_axis(scheme)[0], dtype=np.float32)
    bf = torch.bfloat16
    library().call("lteax_demap", xr.data_ptr(), xi.data_ptr(),
                   inv_nv.data_ptr(), sgn_planar.data_ptr(), out.data_ptr(),
                   bsz, n, npad, m, levels.ctypes.data, int(xr.dtype == bf),
                   int(out_dtype == bf), stream_handle(xr))
    form = _form(xr.dtype, out_dtype)
    if form is None:
        LAUNCHES += 1
    else:
        FORM_LAUNCHES[form] += 1
    return out
