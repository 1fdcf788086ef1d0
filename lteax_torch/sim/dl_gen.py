"""Jax-free DL-SCH test signal: the recipe of ``bench.py`` in numpy/torch.

Random transport blocks from a numpy seed -> CRC24A -> segmentation and
CRC24B -> turbo encode -> rate match -> scramble -> modulation -> grid with
the port-0 CRS -> IFFT with cyclic prefix -> AWGN.  Like ``bench.py`` it
encodes at most ``max_unique`` distinct subframes and tiles them to the
batch (encoding is set-up, not the measured decode), then draws the noise
for the whole batch from the same generator.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from lteax.io.iq import to_iq_f32
from lteax.phy.config import PhyConfig
from lteax.phy.fec.segmentation import segment_bits
from lteax.phy.grid import crs_flat_idx, crs_symbols, pdsch_flat_idx
from lteax.phy.tables.tbs import get_tbs_for_mcs
from lteax_torch.phy import seq
from lteax_torch.phy.channels.pdsch import (PdschGeometry, _global_rm_idx,
                                            pdsch_geometry)
from lteax_torch.phy.fec.crc import attach_crc_np
from lteax_torch.phy.fec.turbo import turbo_encode
from lteax_torch.phy.mod import BITS_PER_SYM, modulate
from lteax_torch.phy.ofdm import subframe_to_samples


def pdsch_prepare_cbs(tb_bits: np.ndarray, geom: PdschGeometry) -> np.ndarray:
    """TB payload (TBS,) -> codeblock payloads (C, K_payload)."""
    return segment_bits(attach_crc_np(np.asarray(tb_bits), "24A"), geom.info)


def pdsch_encode_cbs(cbs: np.ndarray, geom: PdschGeometry, rnti: int,
                     subframe: int, n_cell_id: int, scheme: str) -> np.ndarray:
    """(..., C, K_payload) codeblock payloads -> (..., n_re) complex64
    symbols in RE-mapping order."""
    if geom.info.cb_crc:
        cbs = attach_crc_np(cbs, "24B")
    d = turbo_encode(cbs, geom.k)                   # (..., C, 3, K+4)
    e = d.reshape(*d.shape[:-3], -1)[..., _global_rm_idx(geom)]
    c = seq.gold_sequence_np(seq.pdsch_c_init(rnti, subframe, n_cell_id),
                             geom.g)
    return modulate((e + c) % 2, scheme)


def crs_grid_values(cfg: PhyConfig, n_cell_id: int, subframe: int) -> np.ndarray:
    """Port-0 CRS values in ``crs_flat_idx`` order."""
    return np.concatenate([
        seq.crs_values(n_cell_id, 2 * subframe + sym // cfg.n_sym_slot,
                       sym % cfg.n_sym_slot, cfg.n_rb_dl)
        for sym in crs_symbols(0, cfg)])


@dataclasses.dataclass(frozen=True)
class DlCell:
    """One DL-SCH allocation: the ``bench.py`` headline is the default
    (20 MHz, 100 PRB, MCS 28, cfi 1, cell 214, subframe 1, RNTI 0x1234)."""
    n_rb_dl: int = 100
    n_cell_id: int = 214
    subframe: int = 1
    rnti: int = 0x1234
    mcs: int = 28
    cfi: int = 1

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
                              BITS_PER_SYM[self.scheme], 0)

    def decoder_args(self):
        """Positional arguments of ``make_batch_decoder`` for this cell."""
        return (self.cfg, self.n_cell_id, self.cfi, self.prbs, self.subframe,
                self.rnti, self.geom, self.scheme)


def dl_subframes(cell: DlCell, b: int, snr_db: float = 25.0, seed: int = 0,
                 max_unique: int = 64):
    """-> (iq (b, n_samps, 2) float32, tb_bits (b, TBS) int32) numpy.

    The noise has variance 10^(-snr/10) per complex sample (unit-power
    resource elements, orthonormal IFFT)."""
    cfg, geom = cell.cfg, cell.geom
    rng = np.random.default_rng(seed)
    b_uniq = min(b, max_unique)
    tb_bits = rng.integers(0, 2, size=(b_uniq, geom.tbs)).astype(np.int32)
    cbs = np.stack([pdsch_prepare_cbs(t, geom) for t in tb_bits])
    syms = pdsch_encode_cbs(cbs, geom, cell.rnti, cell.subframe,
                            cell.n_cell_id, cell.scheme)
    grids = np.zeros((b_uniq, cfg.n_sym_subframe * cfg.n_sc), np.complex64)
    grids[:, crs_flat_idx(cfg, cell.n_cell_id, 0)] = crs_grid_values(
        cfg, cell.n_cell_id, cell.subframe)
    grids[:, cell.re_idx] = syms
    x = subframe_to_samples(torch.from_numpy(grids).reshape(
        b_uniq, cfg.n_sym_subframe, cfg.n_sc), cfg).numpy()
    reps = -(-b // b_uniq)
    x = np.tile(x, (reps, 1))[:b]
    tb_bits = np.tile(tb_bits, (reps, 1))[:b]
    nv = 10 ** (-snr_db / 10)
    x = x + (rng.standard_normal(x.shape)
             + 1j * rng.standard_normal(x.shape)) * np.sqrt(nv / 2)
    return to_iq_f32(x), tb_bits
