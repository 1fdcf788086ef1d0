"""CRS channel estimation and noise estimate (port 0, LS + 2-D linear
interpolation), counterpart of ``lteax.phy.chest``.

The interpolation matrices and CRS reference values are numpy copies of the
reference's host plan code (the tests hold them equal); the interpolation
runs as real-decomposed float32 matmuls, as in the reference, in full
float32 (``lteax_torch.phy.fec.crc.exact_f32_matmul``).
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from lteax.phy.config import PhyConfig
from lteax.phy.grid import _crs_v, crs_flat_idx, crs_symbols
from lteax_torch.phy import seq


@lru_cache(maxsize=None)
def _freq_interp_matrix(cfg: PhyConfig, shift: int) -> np.ndarray:
    """(n_sc, 2*n_rb) linear interpolation from the CRS comb (spacing 6,
    offset ``shift``) to all subcarriers, edge-extrapolated."""
    n_p = 2 * cfg.n_rb_dl
    pk = shift + 6 * np.arange(n_p)
    w = np.zeros((cfg.n_sc, n_p), dtype=np.float32)
    for k in range(cfg.n_sc):
        j = np.searchsorted(pk, k)
        if j == 0:
            a, b = 0, 1
        elif j >= n_p:
            a, b = n_p - 2, n_p - 1
        else:
            a, b = j - 1, j
        t = (k - pk[a]) / (pk[b] - pk[a])
        w[k, a] = 1 - t
        w[k, b] = t
    return w


@lru_cache(maxsize=None)
def _time_interp_matrix(cfg: PhyConfig, pilot_syms: tuple[int, ...]) -> np.ndarray:
    """(n_sym, n_pilot_syms) linear-in-time interpolation with edge hold."""
    ps = np.asarray(pilot_syms, dtype=np.float64)
    w = np.zeros((cfg.n_sym_subframe, len(ps)), dtype=np.float32)
    for s in range(cfg.n_sym_subframe):
        j = np.searchsorted(ps, s)
        if j == 0:
            w[s, 0] = 1.0
        elif j >= len(ps):
            w[s, -1] = 1.0
        else:
            a, b = j - 1, j
            t = (s - ps[a]) / (ps[b] - ps[a])
            w[s, a] = 1 - t
            w[s, b] = t
    return w


@lru_cache(maxsize=None)
def _crs_ref_values(cfg: PhyConfig, n_cell_id: int, port: int,
                    subframe: int) -> np.ndarray:
    """(n_pilot_syms, 2*n_rb) complex64 expected CRS values."""
    vals = []
    for sym in crs_symbols(port, cfg):
        slot = sym // cfg.n_sym_slot
        vals.append(seq.crs_values(n_cell_id, 2 * subframe + slot,
                                   sym % cfg.n_sym_slot, cfg.n_rb_dl,
                                   cfg.extended_cp))
    return np.stack(vals)


@lru_cache(maxsize=32)
def _consts(cfg: PhyConfig, n_cell_id: int, subframe: int, port: int,
            device: torch.device):
    """Per-(cell, subframe, device) tensors: pilot indices, conj(ref), the
    stacked frequency interpolators and the time interpolator."""
    syms = crs_symbols(port, cfg)
    pidx = crs_flat_idx(cfg, n_cell_id, port).astype(np.int64).reshape(
        len(syms), 2 * cfg.n_rb_dl)
    ref = _crs_ref_values(cfg, n_cell_id, port, subframe)
    vs = n_cell_id % 6
    shifts = [(_crs_v(port, sym % cfg.n_sym_slot, sym // cfg.n_sym_slot) + vs)
              % 6 for sym in syms]
    wf = np.stack([_freq_interp_matrix(cfg, s) for s in shifts])
    wt = _time_interp_matrix(cfg, syms)
    t = lambda x: torch.as_tensor(x, device=device)
    return t(pidx), t(np.conj(ref)), t(wf), t(wt)


def _ls(grid: torch.Tensor, cfg, n_cell_id, subframe, port):
    pidx, ref_c, wf, wt = _consts(cfg, n_cell_id, subframe, port, grid.device)
    flat = grid.reshape(*grid.shape[:-2], -1)
    return flat[..., pidx] * ref_c, wf, wt          # (..., n_ps, n_p)


def estimate_channel(grid: torch.Tensor, cfg: PhyConfig, n_cell_id: int,
                     subframe: int, port: int = 0) -> torch.Tensor:
    """LS at the CRS, then frequency and time linear interpolation.
    grid (..., n_sym, n_sc) complex64 -> H of the same shape."""
    h_ls, wf, wt = _ls(grid, cfg, n_cell_id, subframe, port)
    fr = torch.einsum("...pj,pkj->...pk", h_ls.real, wf)
    fi = torch.einsum("...pj,pkj->...pk", h_ls.imag, wf)
    tr = torch.einsum("sp,...pk->...sk", wt, fr)
    ti = torch.einsum("sp,...pk->...sk", wt, fi)
    return torch.complex(tr, ti)


def estimate_noise_var(grid: torch.Tensor, cfg: PhyConfig, n_cell_id: int,
                       subframe: int, port: int = 0) -> torch.Tensor:
    """Noise variance (...,) from same-comb-shift CRS symbol pairs: their
    LS difference is pure noise for a channel static over half a subframe."""
    h_ls, _, _ = _ls(grid, cfg, n_cell_id, subframe, port)
    n_half = h_ls.shape[-2] // 2
    d = h_ls[..., :n_half, :] - h_ls[..., n_half:2 * n_half, :]
    nv = torch.mean(d.abs() ** 2, dim=(-2, -1)) / 2.0
    return torch.clamp_min(nv, 1e-6)
