"""Jax-free DL-SCH test signal: the recipe of ``bench.py`` in numpy/torch.

Random transport blocks from a numpy seed -> CRC24A -> segmentation and
CRC24B -> turbo encode -> rate match -> scramble -> modulation -> grid with
the port-0 CRS -> IFFT with cyclic prefix -> AWGN.  Like ``bench.py`` it
encodes at most ``max_unique`` distinct subframes and tiles them to the
batch (encoding is set-up, not the measured decode), then draws the noise
for the whole batch from the same generator.  :func:`harq_transmissions`
makes the (re)transmissions of the same transport blocks at several
redundancy versions (the recipe of ``bench/harq_throughput.py``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from lteax_torch.io.iq import to_iq_f32
from lteax_torch.phy import seq
from lteax_torch.phy.channels.pdsch import (PdschGeometry, pdsch_encode_cbs,
                                            pdsch_geometry, pdsch_prepare_cbs)
from lteax_torch.phy.config import PhyConfig
from lteax_torch.phy.grid import crs_flat_idx, crs_symbols, pdsch_flat_idx
from lteax_torch.phy.mod import BITS_PER_SYM
from lteax_torch.phy.ofdm import subframe_to_samples
from lteax_torch.phy.tables.tbs import get_tbs_for_mcs


def crs_grid_values(cfg: PhyConfig, n_cell_id: int, subframe: int,
                    port: int = 0) -> np.ndarray:
    """The CRS values of ``port`` in ``crs_flat_idx`` order."""
    return np.concatenate([
        seq.crs_values(n_cell_id, 2 * subframe + sym // cfg.n_sym_slot,
                       sym % cfg.n_sym_slot, cfg.n_rb_dl)
        for sym in crs_symbols(port, cfg)])


@dataclasses.dataclass(frozen=True)
class DlCell:
    """One DL-SCH allocation: the ``bench.py`` headline is the default
    (20 MHz, 100 PRB, MCS 28, cfi 1, cell 214, subframe 1, RNTI 0x1234,
    redundancy version 0)."""
    n_rb_dl: int = 100
    n_cell_id: int = 214
    subframe: int = 1
    rnti: int = 0x1234
    mcs: int = 28
    cfi: int = 1
    rv: int = 0

    @property
    def cfg(self) -> PhyConfig:
        return PhyConfig(n_rb_dl=self.n_rb_dl)

    @property
    def prbs(self) -> tuple[int, ...]:
        return tuple(range(self.n_rb_dl))

    @property
    def scheme(self) -> str:
        return get_tbs_for_mcs(self.mcs, self.n_rb_dl)[1]

    @property
    def re_idx(self) -> np.ndarray:
        return pdsch_flat_idx(self.cfg, self.n_cell_id, self.cfi, self.prbs,
                              self.subframe)

    @property
    def geom(self) -> PdschGeometry:
        tbs = get_tbs_for_mcs(self.mcs, self.n_rb_dl)[0]
        return pdsch_geometry(tbs, len(self.re_idx),
                              BITS_PER_SYM[self.scheme], self.rv)

    def decoder_args(self):
        """Positional arguments of ``make_batch_decoder`` for this cell."""
        return (self.cfg, self.n_cell_id, self.cfi, self.prbs, self.subframe,
                self.rnti, self.geom, self.scheme)


def _clean_samples(cell: DlCell, cbs: np.ndarray) -> np.ndarray:
    """Codeblock payloads (b, C, K_payload) -> noiseless time-domain
    subframes (b, n_samps) complex64 of ``cell`` (its subframe and rv)."""
    cfg = cell.cfg
    syms = pdsch_encode_cbs(cbs, cell.geom, cell.rnti, cell.subframe,
                            cell.n_cell_id, cell.scheme)
    grids = np.zeros((len(cbs), cfg.n_sym_subframe * cfg.n_sc), np.complex64)
    grids[:, crs_flat_idx(cfg, cell.n_cell_id, 0)] = crs_grid_values(
        cfg, cell.n_cell_id, cell.subframe)
    grids[:, cell.re_idx] = syms
    return subframe_to_samples(torch.from_numpy(grids).reshape(
        len(cbs), cfg.n_sym_subframe, cfg.n_sc), cfg).numpy()


def tile_with_awgn(x: np.ndarray, b: int, snr_db: float,
                   rng: np.random.Generator) -> np.ndarray:
    """Tile the distinct signals x (b_uniq, ...) to b and add complex noise
    of variance 10^(-snr/10) per sample -> float32 (b, ..., 2)."""
    x = np.tile(x, (-(-b // len(x)),) + (1,) * (x.ndim - 1))[:b]
    nv = 10 ** (-snr_db / 10)
    return to_iq_f32(x + (rng.standard_normal(x.shape)
                          + 1j * rng.standard_normal(x.shape))
                     * np.sqrt(nv / 2))


def _random_tbs(cell: DlCell, b: int, max_unique: int,
                rng: np.random.Generator):
    """-> (distinct TBs (b_uniq, TBS), their codeblocks, TBs tiled to b)."""
    geom = cell.geom
    tb_bits = rng.integers(0, 2, size=(min(b, max_unique), geom.tbs)
                           ).astype(np.int32)
    cbs = np.stack([pdsch_prepare_cbs(t, geom) for t in tb_bits])
    return cbs, np.tile(tb_bits, (-(-b // len(tb_bits)), 1))[:b]


def dl_subframes(cell: DlCell, b: int, snr_db: float = 25.0, seed: int = 0,
                 max_unique: int = 64):
    """-> (iq (b, n_samps, 2) float32, tb_bits (b, TBS) int32) numpy.

    The noise has variance 10^(-snr/10) per complex sample (unit-power
    resource elements, orthonormal IFFT)."""
    rng = np.random.default_rng(seed)
    cbs, tb_bits = _random_tbs(cell, b, max_unique, rng)
    return tile_with_awgn(_clean_samples(cell, cbs), b, snr_db, rng), tb_bits


def harq_transmissions(cell: DlCell, subframes: tuple[int, ...],
                       rvs: tuple[int, ...], b: int, snr_db: float = 25.0,
                       seed: int = 0, max_unique: int = 32):
    """The same transport blocks sent once per (subframe, rv) pair.

    -> (iq (n_tx, b, n_samps, 2) float32, tb_bits (b, TBS) int32, cells):
    ``cells[i]`` is ``cell`` at transmission i's subframe and rv; each
    transmission gets its own noise from the one generator."""
    cells = [dataclasses.replace(cell, subframe=sf, rv=rv)
             for sf, rv in zip(subframes, rvs)]
    rng = np.random.default_rng(seed)
    cbs, tb_bits = _random_tbs(cells[0], b, max_unique, rng)
    iq = np.stack([tile_with_awgn(_clean_samples(c, cbs), b, snr_db, rng)
                   for c in cells])
    return iq, tb_bits, cells


def harq_decoder_args(cells: list[DlCell]):
    """Positional arguments of ``make_batch_harq_decoder`` for the
    transmissions ``cells`` of :func:`harq_transmissions`."""
    c0 = cells[0]
    return (c0.cfg, c0.n_cell_id, c0.cfi, c0.prbs,
            tuple(c.subframe for c in cells), c0.rnti,
            tuple(c.geom for c in cells), c0.scheme)
