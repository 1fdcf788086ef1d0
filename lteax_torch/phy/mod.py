"""Modulation tables, mapper and max-log soft demapper (36.211 §7.1).

Numpy copies of ``lteax.phy.mod.constellation`` and ``_pam_axis``; the
tests hold them equal to the originals.  For the Gray square QAM schemes
the max-log subset minimum factorizes per axis into an L-level PAM
problem, which ``_pam_axis`` describes.  The PDSCH's full-grid demap is
the demap kernel (``lteax_torch.kernels.demap``); the short control and
broadcast channels (PBCH: 240 QPSK symbols) use :func:`demodulate_maxlog`.
:func:`modulate` is the test signals' numpy mapper; :func:`modulate_arith`
maps on the device (the MIMO SIC re-modulation).
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

BITS_PER_SYM = {"bpsk": 1, "qpsk": 2, "16qam": 4, "64qam": 6}


@lru_cache(maxsize=None)
def constellation(scheme: str) -> np.ndarray:
    """(2**m,) complex64 table indexed by the bit-group value (b0 = MSB)."""
    m = BITS_PER_SYM[scheme]
    pts = np.zeros(2 ** m, dtype=np.complex64)
    for v in range(2 ** m):
        b = [(v >> (m - 1 - i)) & 1 for i in range(m)]
        if scheme == "bpsk":
            i_ = q_ = (1 - 2 * b[0]) / np.sqrt(2)
        elif scheme == "qpsk":
            i_ = (1 - 2 * b[0]) / np.sqrt(2)
            q_ = (1 - 2 * b[1]) / np.sqrt(2)
        elif scheme == "16qam":
            i_ = (1 - 2 * b[0]) * (2 - (1 - 2 * b[2])) / np.sqrt(10)
            q_ = (1 - 2 * b[1]) * (2 - (1 - 2 * b[3])) / np.sqrt(10)
        else:  # 64qam
            i_ = (1 - 2 * b[0]) * (4 - (1 - 2 * b[2]) * (2 - (1 - 2 * b[4]))) / np.sqrt(42)
            q_ = (1 - 2 * b[1]) * (4 - (1 - 2 * b[3]) * (2 - (1 - 2 * b[5]))) / np.sqrt(42)
        pts[v] = i_ + 1j * q_
    return pts


@lru_cache(maxsize=None)
def _pam_axis(scheme: str) -> tuple[np.ndarray, np.ndarray]:
    """Per-axis PAM decomposition of a Gray square QAM constellation.

    Returns (levels (L,) float32, bit_is_one (m/2, L) bool); the per-axis
    bit group is (b0, b2, b4)|I / (b1, b3, b5)|Q, one table for both axes.
    """
    ma = BITS_PER_SYM[scheme] // 2
    lv = np.zeros(2 ** ma, dtype=np.float32)
    for v in range(2 ** ma):
        b = [(v >> (ma - 1 - i)) & 1 for i in range(ma)]
        if scheme == "qpsk":
            lv[v] = (1 - 2 * b[0]) / np.sqrt(2)
        elif scheme == "16qam":
            lv[v] = (1 - 2 * b[0]) * (2 - (1 - 2 * b[1])) / np.sqrt(10)
        else:  # 64qam
            lv[v] = (1 - 2 * b[0]) * (4 - (1 - 2 * b[1]) * (2 - (1 - 2 * b[2]))) / np.sqrt(42)
    v = np.arange(2 ** ma)
    bit1 = np.stack([((v >> (ma - 1 - i)) & 1) for i in range(ma)]).astype(np.bool_)
    return lv, bit1


def modulate(bits: np.ndarray, scheme: str) -> np.ndarray:
    """bits (..., N*m) -> symbols (..., N) complex64 (table lookup, the
    same values as ``lteax.phy.mod.modulate``)."""
    m = BITS_PER_SYM[scheme]
    groups = np.asarray(bits).reshape(*np.shape(bits)[:-1], -1, m).astype(np.int64)
    weights = np.asarray([1 << (m - 1 - i) for i in range(m)], dtype=np.int64)
    return constellation(scheme)[groups @ weights]


def modulate_arith(bits: torch.Tensor, scheme: str) -> torch.Tensor:
    """bits (..., N*m) -> symbols (..., N) complex64, elementwise: the
    36.211 §7.1 Gray formulas evaluated arithmetically (the same mapping
    as :func:`modulate`), in the reference's order of operations."""
    m = BITS_PER_SYM[scheme]
    g = bits.reshape(*bits.shape[:-1], -1, m).to(torch.float32)
    s = 1.0 - 2.0 * g                                 # +1 for bit 0
    if scheme == "bpsk":
        v = s[..., 0] / np.sqrt(2)
        return torch.complex(v, v)
    if scheme == "qpsk":
        return torch.complex(s[..., 0] / np.sqrt(2), s[..., 1] / np.sqrt(2))
    if scheme == "16qam":
        i_ = s[..., 0] * (2.0 - s[..., 2]) / np.sqrt(10)
        q_ = s[..., 1] * (2.0 - s[..., 3]) / np.sqrt(10)
        return torch.complex(i_, q_)
    i_ = s[..., 0] * (4.0 - s[..., 2] * (2.0 - s[..., 4])) / np.sqrt(42)
    q_ = s[..., 1] * (4.0 - s[..., 3] * (2.0 - s[..., 5])) / np.sqrt(42)
    return torch.complex(i_, q_)


def _axis_llr(y: torch.Tensor, scheme: str) -> torch.Tensor:
    """min_{bit=1} (y-s)^2 - min_{bit=0} (y-s)^2 per axis bit:
    (..., N) real -> (..., N, m/2)."""
    pam, bit1 = _pam_axis(scheme)
    d = [(y - float(s)) ** 2 for s in pam]
    out = []
    for row in bit1:
        d0 = d1 = None
        for i, one in enumerate(row):
            if one:
                d1 = d[i] if d1 is None else torch.minimum(d1, d[i])
            else:
                d0 = d[i] if d0 is None else torch.minimum(d0, d[i])
        out.append(d1 - d0)
    return torch.stack(out, dim=-1)


def demodulate_maxlog(symbols: torch.Tensor, scheme: str,
                      noise_var=None) -> torch.Tensor:
    """Exact max-log LLRs.  symbols (..., N) complex -> (..., N*m) float32,
    bit order per symbol (b0|I, b1|Q, b2|I, ...); positive => bit 0.
    ``noise_var``: scalar or per-symbol (..., N) effective noise."""
    if scheme not in ("qpsk", "16qam", "64qam"):
        raise ValueError(f"demodulate_maxlog supports QPSK/16QAM/64QAM, "
                         f"not {scheme}")
    llr = torch.stack([_axis_llr(symbols.real, scheme),
                       _axis_llr(symbols.imag, scheme)], dim=-1)
    llr = llr.reshape(*symbols.shape, -1)                # (..., N, m)
    if noise_var is not None:
        llr = llr / torch.as_tensor(noise_var, device=llr.device)[..., None]
    return llr.reshape(*symbols.shape[:-1], -1)
