"""The benchmark's frozen transmitters: the recipes of the port's
``lteax_torch/sim/dl_gen.py`` and ``sim/ul_gen.py`` on the benchmark's own
copy of the LTE primitives (``benchmark/lte.py``).

Transport blocks -> CRC24A, segmentation and CRC24B -> turbo encode ->
rate match -> (UL: channel interleave) -> scramble -> 64QAM ->
DL: a full-band PDSCH grid with port 0's CRS, OFDM with cyclic prefix;
UL: DFT precoding and the DM-RS in symbols 3 and 10.  Noiseless: the
harness adds the noise on the device (``benchmark/traffic.py``).
"""

from __future__ import annotations

import numpy as np

from benchmark import lte


def dl_subframes(cfg: dict, tb_bits: np.ndarray) -> np.ndarray:
    """TBs (n, TBS) -> noiseless subframes (n, n_samps) complex64 of the
    DL-SCH configuration ``cfg``."""
    num = lte.Numerology(cfg["n_rb"])
    re_idx = lte.pdsch_re_idx(num, cfg["n_cell_id"], cfg["cfi"],
                              cfg["subframe"])
    geom = dl_geometry(cfg)
    e = codeword_bits(tb_bits, geom)
    c = lte.gold(lte.pdsch_c_init(cfg["rnti"], cfg["subframe"],
                                  cfg["n_cell_id"]), geom.g)
    grids = np.zeros((len(tb_bits), 14 * num.n_sc), np.complex64)
    crs_idx, crs_val = lte.crs_grid(num, cfg["n_cell_id"], cfg["subframe"])
    grids[:, crs_idx.ravel()] = crs_val.ravel()
    grids[:, re_idx] = lte.modulate((e + c) % 2, cfg["scheme"])
    return lte.subframe_to_samples(grids.reshape(-1, 14, num.n_sc), num)


def ul_subframes(cfg: dict, tb_bits: np.ndarray) -> np.ndarray:
    """TBs (n, TBS) -> noiseless SC-FDMA grids (n, 14, m_sc) complex64 of
    the UL-SCH configuration ``cfg``."""
    m_sc = 12 * cfg["n_prb"]
    geom = ul_geometry(cfg)
    e = codeword_bits(tb_bits, geom)[:, lte.ul_interleaver(geom.g, geom.qm)]
    c = lte.gold(lte.pusch_c_init(cfg["rnti"], cfg["subframe"],
                                  cfg["n_cell_id"]), geom.g)
    sym = lte.modulate((e + c) % 2, cfg["scheme"]).reshape(-1, 12, m_sc)
    grids = np.zeros((len(tb_bits), 14, m_sc), np.complex64)
    grids[:, list(lte.DATA_SYMS)] = np.fft.fft(sym, axis=-1) / np.sqrt(m_sc)
    for slot, s in enumerate(lte.DMRS_SYMS):
        grids[:, s] = lte.dmrs(cfg["n_cell_id"], 2 * cfg["subframe"] + slot,
                               m_sc)
    return grids


def dl_geometry(cfg: dict) -> lte.Geometry:
    num = lte.Numerology(cfg["n_rb"])
    n_re = len(lte.pdsch_re_idx(num, cfg["n_cell_id"], cfg["cfi"],
                                cfg["subframe"]))
    return lte.Geometry(cfg["tbs"], n_re * cfg["qm"], cfg["qm"], cfg["rv"])


def ul_geometry(cfg: dict) -> lte.Geometry:
    return lte.Geometry(cfg["tbs"], 12 * 12 * cfg["n_prb"] * cfg["qm"],
                        cfg["qm"], cfg["rv"])


def codeword_bits(tb_bits: np.ndarray, geom: lte.Geometry) -> np.ndarray:
    """TBs (n, TBS) -> rate-matched codeword bits (n, G)."""
    d = lte.turbo_encode(lte.segment(tb_bits, geom), geom.k)
    return d.reshape(len(tb_bits), -1)[:, lte.rm_idx(geom)]
