"""Jax-free UL-SCH test signal: the recipe of ``bench/ul_throughput.py`` in
numpy/torch, with or without HARQ-ACK / RI multiplexed
(:func:`pusch_encode_cbs_uci`, the encoder of
``lteax.phy.channels.pusch.pusch_encode_cbs_uci``).

Random transport blocks from a numpy seed -> CRC24A -> segmentation and
CRC24B -> turbo encode -> rate match -> channel interleave -> scramble ->
modulation -> DFT precoding -> (14, m_sc) grid with the DM-RS in symbols 3
and 10 -> AWGN.  At most ``max_unique`` distinct subframes are encoded and
tiled to the batch, as ``dl_gen.dl_subframes`` does.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from lteax_torch.phy import seq
from lteax_torch.phy.channels import pusch
from lteax_torch.phy.mod import modulate
from lteax_torch.phy.channels.pdsch import (pdsch_prepare_cbs,
                                            rate_matched_bits)
from lteax_torch.sim.dl_gen import tile_with_awgn


@dataclasses.dataclass(frozen=True)
class UlCell:
    """One UL-SCH allocation: the ``bench/ul_throughput.py`` headline is the
    default (100 PRB, TBS 75376, 64QAM, cell 214, subframe 4, RNTI 0x3D)."""
    alloc: pusch.PuschAlloc = pusch.PuschAlloc(n_prb=100, rb_start=0,
                                               mcs_tbs=75376, qm=6)
    n_cell_id: int = 214
    subframe: int = 4
    rnti: int = 0x3D

    def decoder_args(self):
        """Positional arguments of ``make_pusch_batch_decoder``."""
        return (self.alloc, self.rnti, self.subframe, self.n_cell_id)


def pusch_encode_cbs(cbs: np.ndarray, alloc: pusch.PuschAlloc, rnti: int,
                     subframe: int, n_cell_id: int,
                     dft: str = "fft") -> np.ndarray:
    """(..., C, K_payload) codeblock payloads -> (..., 14, m_sc) complex64
    SC-FDMA frequency-domain grids, DM-RS symbols left zero; ``dft`` is
    the transform precoding's form (``pusch.ul_dft``)."""
    geom = alloc.geom
    e = rate_matched_bits(cbs, geom)
    e = e[..., pusch.channel_interleaver_idx(geom.g, alloc.qm)]
    c = seq.gold_sequence_np(pusch.pusch_c_init(rnti, subframe, n_cell_id),
                             geom.g)
    return _precode(modulate((e + c) % 2, alloc.scheme), alloc, dft)


def _precode(sym: np.ndarray, alloc: pusch.PuschAlloc,
             dft: str) -> np.ndarray:
    """(..., 12 * m_sc) symbols in time-first order -> (..., 14, m_sc)
    grids: consecutive m_sc symbols share one SC-FDMA symbol, each
    transform-precoded; the DM-RS symbols are left zero."""
    data = torch.from_numpy(sym.reshape(*sym.shape[:-1], pusch.N_DATA_SYMS,
                                        alloc.m_sc))
    grid = np.zeros((*sym.shape[:-1], 14, alloc.m_sc), np.complex64)
    grid[..., pusch.DATA_SYMS, :] = pusch.ul_dft(data, inverse=False,
                                                 mode=dft).numpy()
    return grid


def pusch_encode_cbs_uci(cbs: np.ndarray, alloc: pusch.PuschAlloc, rnti: int,
                         subframe: int, n_cell_id: int, uci: pusch.PuschUci,
                         ack: tuple[int, ...] = (),
                         ri: tuple[int, ...] = (),
                         dft: str = "fft") -> np.ndarray:
    """Like :func:`pusch_encode_cbs` but multiplexing HARQ-ACK / RI bits
    (``pusch.uci_layout``): the data fill the interleaver matrix's groups
    outside the RI-reserved ones, the RI word the reserved groups and the
    ACK word punctures data groups; the matrix is read column-major, then
    scrambled over all 12 * m_sc * Qm bits.  cbs (..., C, K_payload) of
    the geometry ``pusch.alloc_geom_uci``."""
    geom = pusch.alloc_geom_uci(alloc, uci)
    q_ri = pusch.uci_q_prime(uci.n_ri, alloc, uci.beta_ri)
    q_ack = pusch.uci_q_prime(uci.n_ack, alloc, uci.beta_ack)
    read_idx, data_grp, ri_grp, ack_grp = pusch.uci_layout(
        alloc.m_sc, alloc.qm, q_ri, q_ack)
    e = rate_matched_bits(cbs, geom)                       # (..., g_data)
    lead = e.shape[:-1]
    mat = np.zeros((*lead, alloc.m_sc * pusch.N_DATA_SYMS, alloc.qm),
                   dtype=e.dtype)
    mat[..., data_grp, :] = e.reshape(*lead, -1, alloc.qm)
    for q, grp, bits in ((q_ri, ri_grp, ri), (q_ack, ack_grp, ack)):
        if q:
            mat[..., grp, :] = pusch._uci_word(tuple(bits), q * alloc.qm
                                               ).reshape(q, alloc.qm)
    stream = mat.reshape(*lead, -1)[..., read_idx]
    c = seq.gold_sequence_np(pusch.pusch_c_init(rnti, subframe, n_cell_id),
                             stream.shape[-1])
    return _precode(modulate((stream + c) % 2, alloc.scheme), alloc, dft)


def pusch_add_dmrs(grid: np.ndarray, alloc: pusch.PuschAlloc, n_cell_id: int,
                   subframe: int, n_dmrs: int = 0) -> np.ndarray:
    """Fill the DM-RS symbols (3, 10) of (..., 14, m_sc) grids at cyclic
    shift ``n_dmrs``."""
    g = np.array(grid)
    for slot, sym in enumerate(pusch.DMRS_SYMS):
        g[..., sym, :] = pusch.dmrs_pusch(n_cell_id, 2 * subframe + slot,
                                          alloc.m_sc, n_dmrs=n_dmrs)
    return g


def ul_subframes(cell: UlCell, b: int, snr_db: float = 25.0, seed: int = 0,
                 max_unique: int = 16, uci: pusch.PuschUci | None = None,
                 ack: tuple[int, ...] = (), ri: tuple[int, ...] = (),
                 dft: str = "fft"):
    """-> (iq (b, 14, m_sc, 2) float32, tb_bits (b, TBS) int32) numpy.

    The noise has variance 10^(-snr/10) per resource element (unit-power
    symbols, unitary DFT).  With ``uci`` every subframe also carries the
    HARQ-ACK bits ``ack`` and RI bits ``ri`` (:func:`pusch_encode_cbs_uci`).
    ``dft`` is the transform precoding's form (``pusch.ul_dft``)."""
    alloc, geom = cell.alloc, cell.alloc.geom
    rng = np.random.default_rng(seed)
    b_uniq = min(b, max_unique)
    tb_bits = rng.integers(0, 2, size=(b_uniq, geom.tbs)).astype(np.int32)
    cbs = np.stack([pdsch_prepare_cbs(t, geom) for t in tb_bits])
    args = (alloc, cell.rnti, cell.subframe, cell.n_cell_id)
    grids = (pusch_encode_cbs(cbs, *args, dft) if uci is None else
             pusch_encode_cbs_uci(cbs, *args, uci, ack, ri, dft))
    grids = pusch_add_dmrs(grids, alloc, cell.n_cell_id, cell.subframe)
    tb_bits = np.tile(tb_bits, (-(-b // b_uniq), 1))[:b]
    return tile_with_awgn(grids, b, snr_db, rng), tb_bits
