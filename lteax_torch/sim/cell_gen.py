"""Jax-free LTE cell captures for the scanner: PSS, SSS, CRS and PBCH.

The counterpart of the PSS/SSS/CRS/PBCH part of ``lteax.apps.file_gen``
(``build_subframe_grid``, ``generate``): the same grids at those REs, in
numpy and torch, so that a machine without jax can make scanner inputs.
No PCFICH, PDCCH or SI is written.

:func:`capture` adds what a receiver sees: a start SFN and a start-sample
offset (the capture begins mid-transmission), a carrier frequency offset,
AWGN (``lteax.sim.channel.awgn``) at a per-resource-element SNR, and an
SDR sample rate reached through the port's polyphase resampler.

The IQ models one RX antenna with unit channels from every TX port, as
the reference's generator does.
"""

from __future__ import annotations

import dataclasses
import math
from fractions import Fraction

import numpy as np
import torch

from lteax_torch.phy.config import PhyConfig
from lteax_torch.phy.grid import (crs_flat_idx, crs_symbols, pbch_flat_idx,
                            pss_sym, sss_sym, sync_sc)
from lteax_torch.sim.channel import awgn
from lteax_torch.stack import rrc
from lteax_torch.kernels.polyphase import resample_poly
from lteax_torch.phy import seq
from lteax_torch.phy.channels import pbch
from lteax_torch.phy.ofdm import subframe_to_samples


@dataclasses.dataclass(frozen=True)
class Cell:
    n_rb_dl: int = 6
    n_cell_id: int = 0
    n_ant: int = 1
    phich_resource: float = 1.0
    phich_duration_extended: bool = False

    @property
    def cfg(self) -> PhyConfig:
        return PhyConfig(n_rb_dl=self.n_rb_dl, n_ant=self.n_ant)

    def mib(self, sfn: int) -> rrc.Mib:
        return rrc.Mib(n_rb_dl=self.n_rb_dl,
                       phich_duration_extended=self.phich_duration_extended,
                       phich_resource=self.phich_resource, sfn=sfn)


def build_subframe_grid(cell: Cell, sfn: int, sf: int,
                        pbch_quarters: np.ndarray) -> np.ndarray:
    """One subframe's (n_sym, n_sc) complex64 grid, ports superposed:
    CRS of every port, PSS/SSS (port 0) in subframes 0 and 5, and the PBCH
    quarter ``sfn % 4`` in subframe 0."""
    cfg, cid, n_ant = cell.cfg, cell.n_cell_id, cell.n_ant
    ports = np.zeros((n_ant, cfg.n_sym_subframe * cfg.n_sc), np.complex64)
    for p in range(n_ant):
        vals = [seq.crs_values(cid, 2 * sf + sym // cfg.n_sym_slot,
                               sym % cfg.n_sym_slot, cfg.n_rb_dl,
                               cfg.extended_cp)
                for sym in crs_symbols(p, cfg)]
        ports[p][crs_flat_idx(cfg, cid, p)] = np.concatenate(vals)
    if sf in (0, 5):
        scs = sync_sc(cfg)
        ports[0][pss_sym(cfg) * cfg.n_sc + scs] = seq.pss_sequence(cid % 3)
        ports[0][sss_sym(cfg) * cfg.n_sc + scs] = seq.sss_sequence(
            cid // 3, cid % 3, sf == 5)
    if sf == 0:
        per_port = pbch.pbch_quarter_to_grid(pbch_quarters[sfn % 4], cfg,
                                             cid, n_ant)
        for p in range(n_ant):
            ports[p][pbch_flat_idx(cfg, cid)] = per_port[p]
    return ports.sum(axis=0).reshape(cfg.n_sym_subframe, cfg.n_sc)


def generate(cell: Cell, n_subframes: int, sfn0: int = 0) -> np.ndarray:
    """-> (n_subframes * n_samps_subframe,) complex64 baseband starting at
    subframe 0 of frame ``sfn0``."""
    cfg = cell.cfg
    grids, quarters = [], {}
    for i in range(n_subframes):
        sfn = (sfn0 + i // 10) % 1024
        if sfn // 4 not in quarters:
            quarters[sfn // 4] = pbch.pbch_encode_40ms(
                rrc.pack_mib(cell.mib(sfn)), cell.n_ant, cell.n_cell_id,
                cfg.extended_cp)
        grids.append(build_subframe_grid(cell, sfn, i % 10,
                                         quarters[sfn // 4]))
    x = subframe_to_samples(torch.from_numpy(np.stack(grids)), cfg)
    return x.reshape(-1).numpy()


@dataclasses.dataclass(frozen=True)
class Capture:
    """What a scan of the capture should report."""
    iq: np.ndarray              # (n,) complex64 at ``rate_hz``
    rate_hz: float
    n_cell_id: int
    n_ant: int
    sfn: int                    # SFN of the first whole frame in the capture
    cfo_hz: float
    snr_db: float


def capture(cell: Cell, duration_s: float, *, sfn0: int = 0,
            offset: int = 0, cfo_hz: float = 0.0,
            snr_db: float | None = None, rate_hz: float | None = None,
            seed: int = 0) -> Capture:
    """A capture of ``duration_s`` seconds that starts ``offset`` native
    samples after the start of frame ``sfn0`` (0 <= offset < one frame).

    Impairments, in order: CFO, then AWGN at ``snr_db`` per resource
    element (unit-power REs, orthonormal OFDM), then resampling to
    ``rate_hz`` (default: native) by the port's polyphase resampler."""
    cfg = cell.cfg
    nsf = cfg.n_samps_subframe
    n_native = int(math.ceil(duration_s * cfg.fs))
    n_sf = -(-(offset + n_native) // nsf) + 2    # + resampler margin
    x = generate(cell, n_sf, sfn0)[offset:offset + n_native + 2 * nsf]
    if cfo_hz:
        n = np.arange(len(x))
        x = (x * np.exp(2j * np.pi * cfo_hz * n / cfg.fs)).astype(np.complex64)
    if snr_db is not None:
        # awgn() sets the noise against the mean sample power; shift its
        # SNR so that the noise variance per sample is 10^(-snr/10)
        p = float(np.mean(np.abs(x) ** 2))
        x = awgn(np.random.default_rng(seed), x, snr_db + 10 * np.log10(p))
    rate = float(cfg.fs) if rate_hz is None else float(rate_hz)
    if abs(rate - cfg.fs) > 1.0:
        frac = Fraction(int(round(rate)), int(round(cfg.fs))) \
            .limit_denominator(1024)
        x = resample_poly(torch.from_numpy(x), frac.numerator,
                          frac.denominator).numpy()
    n_out = int(math.ceil(duration_s * rate))
    return Capture(iq=np.ascontiguousarray(x[:n_out]), rate_hz=rate,
                   n_cell_id=cell.n_cell_id, n_ant=cell.n_ant,
                   sfn=(sfn0 + (1 if offset > 0 else 0)) % 1024,
                   cfo_hz=cfo_hz, snr_db=np.nan if snr_db is None else snr_db)
