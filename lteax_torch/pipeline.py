"""Batched DL-SCH decoder: (B, n_samps, 2) IQ -> TB bits and CRC flags.

Counterpart of ``lteax.shard.pipeline.make_batch_decoder_pallas`` with the
natural stage boundary (``_pdsch_stages(..., planar_boundary=False)``):

  front:  IQ -> OFDM demod (FFT) -> CRS LS channel estimate + noise ->
          full-grid MMSE equalizer -> demap kernel (planar LLRs, descramble
          sign planes with zeros off the PDSCH) -> rate de-match gather
          (RE extraction folded in) -> (B*C, 3, K+4) LLRs
  turbo:  turbo decoder (half-iteration kernel, CRC early stop, compacted
          retry) -> CRC24B, desegmentation, CRC24A

Every plan (sign planes, de-match map, chest matrices, CRC matrices, QPP
tables) is built once per decoder on its device.  The TPU layout glue of
the reference (flipped-tile maps, lane picks, planar statics, the
two-program split) is not ported: it existed to avoid TPU relayouts.
"""

from __future__ import annotations

import numpy as np
import torch

from lteax.phy.config import PhyConfig
from lteax.phy.grid import pdsch_flat_idx
from lteax_torch.kernels.demap import demap_planar
from lteax_torch.kernels.turbo_mlm import TurboStats, turbo_decode_batch
from lteax_torch.phy import chest, seq
from lteax_torch.phy.channels.pdsch import (PdschGeometry, _global_rm_inv,
                                            desegment_device)
from lteax_torch.phy.fec.crc import check_crc, crc_matrix, exact_f32_matmul
from lteax_torch.phy.ofdm import samples_to_subframe
from lteax_torch.phy.tuning import DecoderTuning


def dl_demap_plans(cfg: PhyConfig, re_idx: np.ndarray, geom: PdschGeometry,
                   c_init: int):
    """Planar sign planes and the grid de-match map of the full-grid demap.

    Returns (sgn (qm, npad) f32, grid_inv (C*3*(K+4),) int64):
    - every column that carries no PDSCH gets sign 0, so the demap emits
      exact 0.0 there; npad keeps >= 1 pad column;
    - grid_inv maps d-flat position p to planar flat position
      j*npad + re_idx[s] of interleaved codeword bit g = s*qm + j, or to
      qm*npad (one appended zero column) when p was never transmitted."""
    inv_g, injective = _global_rm_inv(geom)
    if not injective:
        raise NotImplementedError("the full-grid demap needs an injective "
                                  "rate match (no circular-buffer wrap)")
    qm = geom.qm
    n_grid = cfg.n_sym_subframe * cfg.n_sc
    npad = -(-n_grid // 128) * 128
    if npad == n_grid:                 # always keep >= 1 pad column
        npad += 128
    sgn = np.zeros((qm, npad), dtype=np.float32)
    sgn[:, np.asarray(re_idx)] = seq.scrambling_symbols_np(
        c_init, geom.g).reshape(-1, qm).T
    g_idx = inv_g.astype(np.int64)
    s_sym, j_bit = g_idx // qm, g_idx % qm
    re_np = np.asarray(re_idx, dtype=np.int64)
    grid_inv = j_bit * npad + re_np[np.minimum(s_sym, len(re_np) - 1)]
    grid_inv[inv_g == geom.g] = qm * npad            # zero sentinel
    return sgn, grid_inv


class BatchDecoder:
    """DL-SCH batch decoder on one device.  Build with
    :func:`make_batch_decoder`; call on (B, n_samps_subframe, 2) IQ."""

    def __init__(self, cfg: PhyConfig, n_cell_id: int, cfi: int,
                 prbs: tuple[int, ...], subframe: int, rnti: int,
                 geom: PdschGeometry, scheme: str, n_iter: int,
                 tuning: DecoderTuning, device: torch.device):
        self.cfg, self.n_cell_id, self.subframe = cfg, n_cell_id, subframe
        self.geom, self.scheme, self.n_iter = geom, scheme, n_iter
        self.tuning, self.device = tuning, torch.device(device)
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        exact_f32_matmul()
        re_idx = pdsch_flat_idx(cfg, n_cell_id, cfi, prbs, subframe)
        sgn, grid_inv = dl_demap_plans(cfg, re_idx, geom,
                                       seq.pdsch_c_init(rnti, subframe,
                                                        n_cell_id))
        t = lambda x, dt=None: torch.as_tensor(x, dtype=dt, device=self.device)
        self.sgn = t(sgn)
        self.grid_inv = t(grid_inv)
        info = geom.info
        self.m24b = (t(crc_matrix(geom.k - 24, "24B"), torch.float32)
                     if info.cb_crc else None)
        self.m24a = t(crc_matrix(info.b - 24, "24A"), torch.float32)
        self.last_stats = TurboStats()

    def equalize(self, samples_iq: torch.Tensor):
        """IQ (B, n_samps, 2) -> full-grid xr, xi, p/nv (B, n_sym*n_sc)."""
        cfg = self.cfg
        samples = torch.complex(samples_iq[..., 0].to(torch.float32),
                                samples_iq[..., 1].to(torch.float32))
        grid = samples_to_subframe(samples, cfg)
        h = chest.estimate_channel(grid, cfg, self.n_cell_id, self.subframe)
        nv = chest.estimate_noise_var(grid, cfg, self.n_cell_id,
                                      self.subframe)[:, None]
        bsz = samples.shape[0]
        hf = h.reshape(bsz, -1)
        p = hf.abs() ** 2
        x = grid.reshape(bsz, -1) * torch.conj(hf) / (p + nv)
        x = x / torch.clamp_min(p / (p + nv), 1e-12)
        return x.real.contiguous(), x.imag.contiguous(), (p / nv).contiguous()

    def front(self, samples_iq: torch.Tensor) -> torch.Tensor:
        """IQ -> de-matched LLRs (B*C, 3, K+4): the natural stage boundary."""
        xr, xi, inv_nv = self.equalize(samples_iq)
        llr = demap_planar(xr, xi, inv_nv, self.sgn, self.scheme)
        flat = llr.reshape(llr.shape[0], -1)
        ext = torch.cat([flat, flat.new_zeros((flat.shape[0], 1))], dim=-1)
        geom = self.geom
        return ext[:, self.grid_inv].reshape(-1, 3, geom.k + 4)

    def turbo(self, llr_d: torch.Tensor):
        """(B*C, 3, K+4) -> (tb_bits (B, TBS) int8, ok (B,) bool, n_iter)."""
        t, geom = self.tuning, self.geom
        info = geom.info
        bits, stats = turbo_decode_batch(
            llr_d, geom.k, n_iter=self.n_iter, win=t.win, acq=t.acq,
            ext_scale=t.ext_scale, early_crc=t.early_crc(info.cb_crc),
            retry_m=t.retry_m_dl, retry_levels=t.retry_levels)
        self.last_stats = stats
        bits = bits.reshape(-1, info.c, geom.k)
        if info.cb_crc:
            payload, cb_ok = check_crc(bits, "24B", self.m24b)
        else:
            payload = bits
            cb_ok = torch.ones(bits.shape[:2], dtype=torch.bool,
                               device=bits.device)
        tb_bits, ok = check_crc(desegment_device(payload, info), "24A",
                                self.m24a)
        return tb_bits, ok & torch.all(cb_ok, dim=-1), stats.n_iter

    def __call__(self, samples_iq: torch.Tensor):
        if samples_iq.device != self.device:
            raise ValueError(f"IQ on {samples_iq.device}, decoder on "
                             f"{self.device}")
        return self.turbo(self.front(samples_iq))


def make_batch_decoder(cfg: PhyConfig, n_cell_id: int, cfi: int,
                       prbs: tuple[int, ...], subframe: int, rnti: int,
                       geom: PdschGeometry, scheme: str, n_iter: int = 6,
                       tuning: DecoderTuning | None = None,
                       device: torch.device | str = "cpu") -> BatchDecoder:
    """DL-SCH decoder for one (cell, allocation, subframe, RNTI) geometry.

    The returned callable takes (B, n_samps_subframe, 2) float IQ on
    ``device`` and returns (tb_bits (B, TBS) int8, ok (B,) bool, n_iter);
    ``last_stats`` holds the turbo schedule of the latest call (host syncs,
    compacted retries)."""
    return BatchDecoder(cfg, n_cell_id, cfi, prbs, subframe, rnti, geom,
                        scheme, n_iter, tuning or DecoderTuning(), device)
