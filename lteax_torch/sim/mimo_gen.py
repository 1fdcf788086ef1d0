"""Jax-free 2x2 dual-codeword test signal: the recipe of
``bench/mimo_throughput.py`` in numpy/torch.

Two codewords of random transport blocks (numpy seed) -> each codeword
encoded and scrambled as its own (``seq.pdsch_c_init(..., codeword=q)``)
-> layer mapping -> TM3 (large-delay CDD) or TM4 (codebook) precoding ->
the grids of ports 0 and 1 with both ports' CRS -> IFFT with cyclic prefix
-> a fixed 2x2 channel matrix -> AWGN.  As in the reference script, at
most ``max_unique`` distinct subframes are made and the noisy receive
signal is tiled to the batch, and the generator draws the bits and then
the noise in the script's order, so one seed gives the script's bits and
noise.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from lteax_torch.io.iq import to_iq_f32
from lteax_torch.phy import mimo
from lteax_torch.phy.channels.pdsch import PdschGeometry, pdsch_geometry
from lteax_torch.phy.config import PhyConfig
from lteax_torch.phy.grid import crs_flat_idx, pdsch_flat_idx
from lteax_torch.phy.mod import BITS_PER_SYM
from lteax_torch.phy.ofdm import subframe_to_samples
from lteax_torch.phy.tables.tbs import get_tbs_for_mcs
from lteax_torch.phy.channels.pdsch import (pdsch_encode_cbs,
                                            pdsch_prepare_cbs)
from lteax_torch.sim.dl_gen import crs_grid_values

CHANNELS = {
    # well-conditioned fixed channel (the script's default)
    "bench": np.array([[1.0 + 0.1j, 0.3 - 0.25j],
                       [0.2 + 0.3j, -0.95 + 0.1j]], np.complex64),
    # correlated columns of unequal power: linear MMSE pays the correlation
    # on both layers, SIC on the first only
    "corr": np.array([[1.0, 0.334],
                      [0.6, 0.608]], np.complex64),
}


def channel_matrix(spec: str) -> np.ndarray:
    """"bench", "corr", or 8 comma-separated numbers: the (re, im) pairs of
    the 2x2 matrix (rx x tx), row-major."""
    if spec in CHANNELS:
        return CHANNELS[spec]
    v = [float(t) for t in spec.split(",")]
    if len(v) != 8:
        raise ValueError(f"channel matrix {spec!r}: 'bench', 'corr' or 8 "
                         "numbers")
    return (np.array(v[0::2]) + 1j * np.array(v[1::2])).reshape(2, 2).astype(
        np.complex64)


@dataclasses.dataclass(frozen=True)
class MimoCell:
    """One 2x2 dual-codeword allocation on a 2-port cell: the
    ``bench/mimo_throughput.py`` default is the default (20 MHz, 100 PRB,
    MCS 28, cfi 1, cell 214, subframe 1, RNTI 0x1234, TM3)."""
    n_rb_dl: int = 100
    n_cell_id: int = 214
    subframe: int = 1
    rnti: int = 0x1234
    mcs: int = 28
    cfi: int = 1
    tm: int = 3
    cb_index: int = 0

    @property
    def cfg(self) -> PhyConfig:
        return PhyConfig(n_rb_dl=self.n_rb_dl, n_ant=2)

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
        """Positional arguments of ``make_mimo_batch_decoder``."""
        return (self.cfg, self.n_cell_id, self.cfi, self.prbs, self.subframe,
                self.rnti, self.geom, self.scheme)

    @property
    def precoding(self) -> dict:
        """Keyword arguments ``tm`` and ``cb_index`` of the factories."""
        return {"tm": self.tm, "cb_index": self.cb_index}


def _port_samples(cell: MimoCell, tb_bits: np.ndarray) -> np.ndarray:
    """(2 codewords, b, TBS) transport blocks -> noiseless time-domain
    samples of the two ports (2, b, n_samps) complex64."""
    cfg, geom = cell.cfg, cell.geom
    d = [pdsch_encode_cbs(np.stack([pdsch_prepare_cbs(t, geom) for t in tbq]),
                          geom, cell.rnti, cell.subframe, cell.n_cell_id,
                          cell.scheme, codeword=q)
         for q, tbq in enumerate(tb_bits)]
    x = mimo.layer_map_2cw(torch.from_numpy(d[0]), torch.from_numpy(d[1]))
    pre = (mimo.precode_tm3(x) if cell.tm == 3
           else mimo.precode_tm4(x, cell.cb_index))
    b = tb_bits.shape[1]
    ports = np.zeros((2, b, cfg.n_sym_subframe * cfg.n_sc), np.complex64)
    for p in range(2):
        ports[p][:, crs_flat_idx(cfg, cell.n_cell_id, p)] = crs_grid_values(
            cfg, cell.n_cell_id, cell.subframe, p)
        ports[p][:, cell.re_idx] = pre[p].numpy()
    return subframe_to_samples(torch.from_numpy(ports).reshape(
        2, b, cfg.n_sym_subframe, cfg.n_sc), cfg).numpy()


def mimo_subframes(cell: MimoCell, b: int, snr_db: float = 25.0,
                   cmat: str = "bench", seed: int = 0, max_unique: int = 16):
    """-> (iq (2 rx, b, n_samps, 2) float32, tb_bits (2 codewords, b, TBS)
    int32) numpy.  The noise has variance 10^(-snr/10) per complex sample
    and receive antenna."""
    if cell.tm not in (3, 4):
        raise ValueError(f"tm {cell.tm}: 3 or 4")
    rng = np.random.default_rng(seed)
    b_uniq = min(b, max_unique)
    tb_bits = rng.integers(0, 2, size=(2, b_uniq, cell.geom.tbs)).astype(
        np.int32)
    tx = _port_samples(cell, tb_bits)
    nv = 10 ** (-snr_db / 10.0)
    rx = np.einsum("rt,tbn->rbn", channel_matrix(cmat), tx)
    rx = rx + (rng.standard_normal(rx.shape)
               + 1j * rng.standard_normal(rx.shape)) * np.sqrt(nv / 2)
    reps = -(-b // b_uniq)
    return (to_iq_f32(np.tile(rx, (1, reps, 1))[:, :b]),
            np.tile(tb_bits, (1, reps, 1))[:, :b])


def decoder_rows(tb_bits: np.ndarray) -> np.ndarray:
    """(2 codewords, b, TBS) -> (2b, TBS) in the decoders' row order:
    b-major in (subframe, codeword)."""
    return np.ascontiguousarray(tb_bits.transpose(1, 0, 2)).reshape(
        -1, tb_bits.shape[-1])
