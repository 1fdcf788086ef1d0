"""CRS channel estimation (ports 0-3, LS + 2-D linear interpolation, with
an optional delay-domain denoise, or Wiener frequency interpolation), noise
estimate, SISO / MRC / SFBC / SFBC+FSTD equalisation and the matching
transmit precoders; counterpart of ``lteax.phy.chest``.

The interpolation and Wiener matrices and the CRS reference values are
numpy copies of the reference's host plan code (the tests hold them
equal); the interpolation runs as real-decomposed float32 matmuls, as in
the reference, in full float32 (``lteax_torch.phy.fec.crc.
exact_f32_matmul``).  The equalisers and precoders are the reference's
elementwise formulas in the same order.
"""

from __future__ import annotations

import math
from functools import lru_cache

import numpy as np
import torch

from lteax_torch.phy.config import PhyConfig
from lteax_torch.phy.grid import _crs_v, crs_flat_idx, crs_symbols
from lteax_torch.phy import seq
from lteax_torch.phy.channels.pusch import chest_denoise, chest_taps


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


@lru_cache(maxsize=8)
def _taps(n_sc: int, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(chest_taps(n_sc), device=device)


def _time_interp(wt: torch.Tensor, fr: torch.Tensor, fi: torch.Tensor):
    tr = torch.einsum("sp,...pk->...sk", wt, fr)
    ti = torch.einsum("sp,...pk->...sk", wt, fi)
    return torch.complex(tr, ti)


def estimate_channel(grid: torch.Tensor, cfg: PhyConfig, n_cell_id: int,
                     subframe: int, port: int = 0,
                     denoise: bool = False) -> torch.Tensor:
    """LS at the CRS, then frequency and time linear interpolation.
    grid (..., n_sym, n_sc) complex64 -> H of the same shape.

    ``denoise`` projects each pilot symbol's frequency-interpolated
    estimate onto the cyclic prefix's delay span
    (``pusch.chest_denoise``) before the time interpolation."""
    h_ls, wf, wt = _ls(grid, cfg, n_cell_id, subframe, port)
    fr = torch.einsum("...pj,pkj->...pk", h_ls.real, wf)
    fi = torch.einsum("...pj,pkj->...pk", h_ls.imag, wf)
    if denoise:
        h_f = chest_denoise(torch.complex(fr, fi), _taps(cfg.n_sc,
                                                          grid.device))
        fr, fi = h_f.real, h_f.imag
    return _time_interp(wt, fr, fi)


@lru_cache(maxsize=None)
def _mmse_pilot_corr(cfg: PhyConfig, shift: int, tau_max_us: float
                     ) -> tuple[np.ndarray, np.ndarray]:
    """Frequency correlations of a uniform power-delay profile over
    [0, tau_max], r(dk) = exp(-j pi dk df tau) sinc(dk df tau), at the true
    signed FFT frequencies (the band skips DC).  Returns (R_dp (n_sc, n_p),
    R_pp (n_p, n_p))."""
    df = 15e3
    tau = tau_max_us * 1e-6
    n_p = 2 * cfg.n_rb_dl
    bins = cfg.sc_to_fft_bin.astype(np.int64)
    f = ((bins + cfg.n_fft // 2) % cfg.n_fft) - cfg.n_fft // 2
    pk = f[shift + 6 * np.arange(n_p)]

    def r(dk):
        x = dk * df * tau
        return np.exp(-1j * np.pi * x) * np.sinc(x)

    r_dp = r(f[:, None] - pk[None, :]).astype(np.complex64)
    r_pp = r(pk[:, None] - pk[None, :]).astype(np.complex64)
    return r_dp, r_pp


@lru_cache(maxsize=None)
def _wiener_matrix(cfg: PhyConfig, shift: int, tau_max_us: float,
                   nv_prior: float) -> np.ndarray:
    """W = R_dp (R_pp + nv I)^-1 (n_sc, n_p) for a static noise prior,
    inverted on the host."""
    r_dp, r_pp = _mmse_pilot_corr(cfg, shift, tau_max_us)
    a = r_pp + np.complex64(nv_prior) * np.eye(r_pp.shape[0],
                                               dtype=np.complex64)
    return (r_dp @ np.linalg.inv(a)).astype(np.complex64)


@lru_cache(maxsize=16)
def _wiener_consts(cfg: PhyConfig, n_cell_id: int, port: int,
                   tau_max_us: float, nv_q: float, device: torch.device):
    """Per pilot symbol's Wiener matrix, stacked (n_ps, n_sc, n_p), as
    real and imaginary float32 tensors."""
    vs = n_cell_id % 6
    w = np.stack([_wiener_matrix(
        cfg, (_crs_v(port, sym % cfg.n_sym_slot, sym // cfg.n_sym_slot) + vs)
        % 6, tau_max_us, nv_q) for sym in crs_symbols(port, cfg)])
    t = lambda x: torch.as_tensor(np.ascontiguousarray(x), device=device)
    return t(w.real), t(w.imag)


def estimate_channel_mmse(grid: torch.Tensor, cfg: PhyConfig, n_cell_id: int,
                          subframe: int, port: int, noise_var: float,
                          tau_max_us: float = 5.0) -> torch.Tensor:
    """Wiener (MMSE) frequency interpolation with a static noise prior,
    then linear time interpolation.  grid (..., n_sym, n_sc) -> H.

    The prior is rounded to a 1 dB grid (as in the reference, which keys
    its cached host inverse by it); the complex product runs as four real
    float32 matmuls."""
    h_ls, _, wt = _ls(grid, cfg, n_cell_id, subframe, port)
    nv_q = 10.0 ** (round(10.0 * np.log10(max(float(noise_var), 1e-12)))
                    / 10.0)
    wr, wi = _wiener_consts(cfg, n_cell_id, port, tau_max_us, nv_q,
                            grid.device)
    xr, xi = h_ls.real, h_ls.imag
    mm = lambda x, w: torch.einsum("...pj,pkj->...pk", x, w)
    fr = mm(xr, wr) - mm(xi, wi)
    fi = mm(xr, wi) + mm(xi, wr)
    return _time_interp(wt, fr, fi)


def estimate_noise_var(grid: torch.Tensor, cfg: PhyConfig, n_cell_id: int,
                       subframe: int, port: int = 0) -> torch.Tensor:
    """Noise variance (...,) from same-comb-shift CRS symbol pairs: their
    LS difference is pure noise for a channel static over half a subframe."""
    h_ls, _, _ = _ls(grid, cfg, n_cell_id, subframe, port)
    n_half = h_ls.shape[-2] // 2
    d = h_ls[..., :n_half, :] - h_ls[..., n_half:2 * n_half, :]
    nv = torch.mean(d.abs() ** 2, dim=(-2, -1)) / 2.0
    return torch.clamp_min(nv, 1e-6)


SQRT2 = math.sqrt(2.0)


def _guard(p: torch.Tensor) -> torch.Tensor:
    return torch.clamp_min(p, 1e-12)


def equalize_siso(grid: torch.Tensor, h: torch.Tensor, noise_var):
    """MMSE single-port equaliser with bias correction.  Returns (x_hat,
    eff_noise_var = noise_var / |h|^2)."""
    p = torch.abs(h) ** 2
    x = grid * torch.conj(h) / (p + noise_var)
    scale = p / (p + noise_var)
    x = x / _guard(scale)
    return x, noise_var / _guard(p)


def equalize_mrc(y: torch.Tensor, h: torch.Tensor, noise_var):
    """Maximum-ratio combining of one layer over the RX antennas.
    y, h (..., n_rx, n_re) -> (x_hat (..., n_re), eff_nv (..., n_re)):
    x = sum_r conj(h_r) y_r / sum_r |h_r|^2, eff_nv = nv / sum_r |h_r|^2."""
    p = torch.sum(torch.abs(h) ** 2, dim=-2)
    x = torch.sum(torch.conj(h) * y, dim=-2) / _guard(p)
    return x, noise_var / _guard(p)


def combine_sfbc(y: torch.Tensor, h0: torch.Tensor, h1: torch.Tensor,
                 noise_var):
    """Alamouti (SFBC, 2 TX ports, 36.211 §6.3.4.3) combining of RE pairs
    (2i, 2i+1).  y, h0, h1 (..., n_re), n_re even -> (x_hat, eff_nv)."""
    y0, y1 = y[..., 0::2], y[..., 1::2]
    g0, g1 = h0[..., 0::2], h1[..., 0::2]
    p = torch.abs(g0) ** 2 + torch.abs(g1) ** 2
    x0 = (torch.conj(g0) * y0 + g1 * torch.conj(y1)) / _guard(p)
    x1 = (torch.conj(g0) * y1 - g1 * torch.conj(y0)) / _guard(p)
    x = torch.stack([x0, x1], dim=-1).reshape(*y.shape[:-1], -1)
    eff = noise_var / _guard(p)
    eff_nv = torch.stack([eff, eff], dim=-1).reshape(*y.shape[:-1], -1)
    return x * SQRT2, eff_nv * 2.0


def equalize_res(y: torch.Tensor, h0: torch.Tensor, h1, noise_var,
                 n_ant: int):
    """Equalise gathered REs (channel-mapping order): SISO or 2-port SFBC."""
    if n_ant == 1:
        return equalize_siso(y, h0, noise_var)
    return combine_sfbc(y, h0, h1, noise_var)


def combine_sfbc_fstd(y: torch.Tensor, h0, h1, h2, h3, noise_var):
    """4-port SFBC+FSTD combining.  y, h* (..., n), n % 4 == 0: ports
    (0, 2) carry the Alamouti pair on REs (0, 1) of each quadruplet, ports
    (1, 3) on REs (2, 3)."""
    lead = y.shape[:-1]
    q = y.reshape(*lead, -1, 4)
    g0 = h0.reshape(*lead, -1, 4)[..., 0]
    g2 = h2.reshape(*lead, -1, 4)[..., 0]
    g1 = h1.reshape(*lead, -1, 4)[..., 2]
    g3 = h3.reshape(*lead, -1, 4)[..., 2]
    pa = torch.abs(g0) ** 2 + torch.abs(g2) ** 2
    pb = torch.abs(g1) ** 2 + torch.abs(g3) ** 2
    x0 = (torch.conj(g0) * q[..., 0] + g2 * torch.conj(q[..., 1])) / _guard(pa)
    x1 = (torch.conj(g0) * q[..., 1] - g2 * torch.conj(q[..., 0])) / _guard(pa)
    x2 = (torch.conj(g1) * q[..., 2] + g3 * torch.conj(q[..., 3])) / _guard(pb)
    x3 = (torch.conj(g1) * q[..., 3] - g3 * torch.conj(q[..., 2])) / _guard(pb)
    x = torch.stack([x0, x1, x2, x3], dim=-1).reshape(*lead, -1)
    ea = noise_var / _guard(pa)
    eb = noise_var / _guard(pb)
    eff = torch.stack([ea, ea, eb, eb], dim=-1).reshape(*lead, -1)
    return x * SQRT2, eff * 2.0


def precode_sfbc(x: torch.Tensor):
    """TX: symbol pairs onto 2 ports (36.211 §6.3.4.3).  x (..., n), n
    even -> (port 0 [x0, x1]/sqrt2, port 1 [-x1*, x0*]/sqrt2)."""
    x0, x1 = x[..., 0::2], x[..., 1::2]
    s = 1.0 / SQRT2
    p0 = torch.stack([x0, x1], dim=-1).reshape(*x.shape[:-1], -1) * s
    p1 = torch.stack([-torch.conj(x1), torch.conj(x0)],
                     dim=-1).reshape(*x.shape[:-1], -1) * s
    return p0, p1


def precode_sfbc_fstd(x: torch.Tensor):
    """TX: 4-port SFBC+FSTD (36.211 §6.3.4.3).  x (..., n), n % 4 == 0
    -> the 4 ports' symbols (port order 0, 1, 2, 3)."""
    s = 1.0 / SQRT2
    q = x.reshape(*x.shape[:-1], -1, 4)
    z = torch.zeros_like(q[..., 0])
    p0 = torch.stack([q[..., 0], q[..., 1], z, z], dim=-1)
    p2 = torch.stack([-torch.conj(q[..., 1]), torch.conj(q[..., 0]), z, z],
                     dim=-1)
    p1 = torch.stack([z, z, q[..., 2], q[..., 3]], dim=-1)
    p3 = torch.stack([z, z, -torch.conj(q[..., 3]), torch.conj(q[..., 2])],
                     dim=-1)
    flat = lambda p: p.reshape(*x.shape[:-1], -1) * s
    return flat(p0), flat(p1), flat(p2), flat(p3)
