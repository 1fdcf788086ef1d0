"""Batched transport-channel decoders: IQ -> TB bits and CRC flags.

Three decoders share one turbo + CRC tail (:class:`TurboTail`):

- DL-SCH (:func:`make_batch_decoder`), counterpart of
  ``lteax.shard.pipeline.make_batch_decoder_pallas`` with the natural stage
  boundary (``_pdsch_stages(..., planar_boundary=False)``):

    front:  IQ -> OFDM demod (FFT) -> CRS LS channel estimate + noise ->
            full-grid MMSE equalizer -> demap kernel (planar LLRs,
            descramble sign planes with zeros off the PDSCH) -> rate
            de-match gather (RE extraction folded in) -> (B*C, 3, K+4) LLRs
    turbo:  turbo decoder (half-iteration kernel, CRC early stop, compacted
            retry) -> CRC24B, desegmentation, CRC24A

- HARQ incremental redundancy (:func:`make_batch_harq_decoder`), counterpart
  of ``make_batch_harq_decoder_pallas``: one DL front per (re)transmission,
  summed in the d domain, then one turbo batch.
- UL-SCH (:func:`make_pusch_batch_decoder`), counterpart of
  ``make_pusch_batch_decoder``: gridded SC-FDMA subframe -> DM-RS LS
  estimate, denoised and interpolated -> MMSE equalizer -> IDFT -> demap
  kernel -> one gather composing the planar layout, the channel
  de-interleaver and the rate de-match -> the same tail.
- 2x2 MIMO, TM3/TM4 (:func:`make_mimo_batch_decoder`), counterpart of
  ``make_mimo_batch_decoder`` with ``mimo_planar_boundary=False``: OFDM
  on 2 rx -> CRS chest per (rx, port) -> per-RE MMSE demix -> demap kernel
  per codeword -> one de-match gather -> one tail over both codewords; its
  SIC variant (:func:`make_mimo_sic_batch_decoder`, counterpart of
  ``make_mimo_sic_batch_decoder``) decodes CW0, re-encodes and cancels it,
  and decodes CW1 from the clean layer.

A decoder runs on the current CUDA device unless the caller names another
device; without a CUDA device and without ``device="cpu"`` the factories
raise.  Every plan (sign planes, de-match map, chest matrices, CRC matrices, QPP
tables) is built once per decoder on its device.  The TPU layout glue of
the reference (flipped-tile maps, lane picks, planar statics, the
two-program split) is not ported: it existed to avoid TPU relayouts.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from lteax_torch.kernels.demap import demap_planar, planar_sgn_np
from lteax_torch.kernels.turbo_mlm import TurboStats, turbo_decode_batch
from lteax_torch.phy import chest, mimo, seq
from lteax_torch.phy.channels import pusch
from lteax_torch.phy.channels.pdsch import (PdschGeometry, _global_rm_cycles,
                                            _global_rm_idx, desegment_device)
from lteax_torch.phy.config import PhyConfig
from lteax_torch.phy.fec.crc import check_crc, crc_matrix, exact_f32_matmul
from lteax_torch.phy.fec.ratematch import sum_gathers
from lteax_torch.phy.fec.reencode import turbo_reencode_batch
from lteax_torch.phy.grid import pdsch_flat_idx
from lteax_torch.phy.mod import modulate_arith
from lteax_torch.phy.ofdm import samples_to_subframe
from lteax_torch.phy.tuning import DecoderTuning


def dl_demap_plans(cfg: PhyConfig, re_idx: np.ndarray, geom: PdschGeometry,
                   c_init: int):
    """Planar sign planes and the grid de-match map of the full-grid demap.

    Returns (sgn (qm, npad) f32, grid_inv (n_cycles, C*3*(K+4)) int64):
    - every column that carries no PDSCH gets sign 0, so the demap emits
      exact 0.0 there; npad keeps >= 1 pad column;
    - grid_inv[k] maps d-flat position p to planar flat position
      j*npad + re_idx[s] of interleaved codeword bit g = s*qm + j of its
      (k+1)-th transmission, or to qm*npad (one appended zero column) when
      p was sent fewer than k+1 times.  One row when the rate match is
      injective; one a cycle of the circular buffer when it wraps."""
    qm = geom.qm
    n_grid = cfg.n_sym_subframe * cfg.n_sc
    npad = -(-n_grid // 128) * 128
    if npad == n_grid:                 # always keep >= 1 pad column
        npad += 128
    sgn = np.zeros((qm, npad), dtype=np.float32)
    sgn[:, np.asarray(re_idx)] = seq.scrambling_symbols_np(
        c_init, geom.g).reshape(-1, qm).T
    cyc = _global_rm_cycles(geom).astype(np.int64)
    s_sym, j_bit = cyc // qm, cyc % qm
    re_np = np.asarray(re_idx, dtype=np.int64)
    grid_inv = j_bit * npad + re_np[np.minimum(s_sym, len(re_np) - 1)]
    grid_inv[cyc == geom.g] = qm * npad              # zero sentinel
    return sgn, grid_inv


def ul_rm_inv_planar(geom: PdschGeometry, qm: int, m_sc: int,
                     npad: int) -> np.ndarray:
    """UL de-match gather indices reading straight from the planar demap
    output, (n_cycles, C*3*(K+4)) int32 (as :func:`dl_demap_plans`): each
    row composes the planar layout, the data-only channel de-interleaver
    of 36.212 §5.2.2.8 (a (12, m_sc, qm) -> (m_sc, 12, qm) transpose) and
    one cycle of the inverse rate match.  Untransmitted positions point at
    ``qm * npad``, the zero column the front appends (never a pad column:
    an allocation whose 12 * m_sc is a multiple of 128 has none)."""
    cyc = _global_rm_cycles(geom)
    p = cyc.astype(np.int64)
    k = p // (12 * qm)
    sym = (p % (12 * qm)) // qm
    j = p % qm
    out = j * npad + sym * m_sc + k
    out[cyc == geom.g] = qm * npad
    return out.astype(np.int32)


def _resolve_device(device) -> torch.device:
    """``None`` -> the current CUDA device; raises when there is none."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: the decoders run on the card "
                               "unless the caller passes device=\"cpu\"")
        device = "cuda"
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def _gather_dematch(llr: torch.Tensor, inv: torch.Tensor,
                    d_len: int) -> torch.Tensor:
    """Planar LLRs (B, m, npad) -> (B*C, 3, d_len) through a de-match map
    (n_cycles, C*3*d_len) whose untransmitted positions point one past the
    planes, at a zero: one gather a cycle, summed in the order the repeats
    were sent (one gather when the rate match is injective)."""
    flat = llr.reshape(llr.shape[0], -1)
    ext = torch.cat([flat, flat.new_zeros((flat.shape[0], 1))], dim=-1)
    return sum_gathers(ext, inv).reshape(-1, 3, d_len)


def _plan(x: np.ndarray, device: torch.device) -> torch.Tensor:
    """A de-match map on ``device`` as (n_cycles, N) int64; a 1-D map is
    one cycle."""
    return torch.as_tensor(np.atleast_2d(x), dtype=torch.int64, device=device)


def _iq_to_complex(iq: torch.Tensor) -> torch.Tensor:
    return torch.complex(iq[..., 0].to(torch.float32),
                         iq[..., 1].to(torch.float32))


class DlFront:
    """IQ of one PDSCH transmission -> de-matched LLRs (B*C, 3, K+4)."""

    def __init__(self, cfg: PhyConfig, n_cell_id: int, subframe: int,
                 scheme: str, k: int, sgn: np.ndarray, grid_inv: np.ndarray,
                 device: torch.device):
        self.cfg, self.n_cell_id, self.subframe = cfg, n_cell_id, subframe
        self.scheme, self.d_len = scheme, k + 4
        self.sgn = torch.as_tensor(sgn, dtype=torch.float32, device=device)
        self.grid_inv = _plan(grid_inv, device)

    def equalize(self, samples_iq: torch.Tensor):
        """IQ (B, n_samps, 2) -> full-grid xr, xi, p/nv (B, n_sym*n_sc)."""
        cfg = self.cfg
        samples = _iq_to_complex(samples_iq)
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

    def __call__(self, samples_iq: torch.Tensor) -> torch.Tensor:
        xr, xi, inv_nv = self.equalize(samples_iq)
        llr = demap_planar(xr, xi, inv_nv, self.sgn, self.scheme)
        return _gather_dematch(llr, self.grid_inv, self.d_len)


class PuschFront:
    """Gridded SC-FDMA subframes (B, 14, m_sc, 2) -> de-matched LLRs
    (B*C, 3, K+4).

    ``ref0``/``ref1`` are the conjugate DM-RS of the two slots, ``w`` the
    (12, 1) time-interpolation weights of the data symbols, ``taps`` the
    denoiser's delay mask, ``sgn`` the (qm, npad) planar descramble signs
    and ``ul_inv`` the composed de-match map (:func:`ul_rm_inv_planar`).
    ``noise_var=None`` estimates the noise per subframe from the DM-RS
    residual (the two pilots' raw LS difference is noise only while the
    channel holds still over a subframe); a float pins a static prior."""

    def __init__(self, scheme: str, k: int, ref0: np.ndarray,
                 ref1: np.ndarray, w: np.ndarray, taps: np.ndarray,
                 sgn: np.ndarray, ul_inv: np.ndarray,
                 noise_var: float | None, device: torch.device):
        t = lambda x, dt: torch.as_tensor(np.asarray(x), dtype=dt,
                                          device=device)
        self.scheme, self.d_len, self.noise_var = scheme, k + 4, noise_var
        self.ref0, self.ref1 = t(ref0, torch.complex64), t(ref1, torch.complex64)
        self.w, self.taps = t(w, torch.float32), t(taps, torch.float32)
        self.sgn, self.ul_inv = t(sgn, torch.float32), _plan(ul_inv, device)
        self.data_syms = t(pusch.DATA_SYMS, torch.int64)

    def equalize(self, grid_iq: torch.Tensor):
        """-> time-domain xr, xi and 1/eff_nv, each (B, 12*m_sc)."""
        grid = _iq_to_complex(grid_iq)
        bsz = grid.shape[0]
        ls0 = grid[:, pusch.DMRS_SYMS[0]] * self.ref0   # raw LS at the pilots
        ls1 = grid[:, pusch.DMRS_SYMS[1]] * self.ref1
        if self.noise_var is None:
            nv = torch.clamp_min(
                torch.mean((ls0 - ls1).abs() ** 2, dim=-1) / 2.0, 1e-6)
        else:
            nv = torch.full((bsz,), self.noise_var, dtype=torch.float32,
                            device=grid.device)
        nv = nv[:, None, None]                  # one scalar per subframe
        h0 = pusch.chest_denoise(ls0, self.taps)[:, None]
        h1 = pusch.chest_denoise(ls1, self.taps)[:, None]
        h = (1 - self.w) * h0 + self.w * h1     # (B, 12, m_sc)
        y = grid[:, self.data_syms]
        p = h.abs() ** 2
        xf = y * torch.conj(h) / (p + nv)
        xf = xf / torch.clamp_min(p / (p + nv), 1e-12)
        xt = pusch.ul_dft(xf, inverse=True)
        # post-IDFT noise: the mean over each symbol's subcarriers
        eff = torch.mean(nv / torch.clamp_min(p, 1e-12), dim=-1, keepdim=True)
        inv_eff = (1.0 / eff).expand_as(p)
        return (xt.real.reshape(bsz, -1).contiguous(),
                xt.imag.reshape(bsz, -1).contiguous(),
                inv_eff.reshape(bsz, -1).contiguous())

    def __call__(self, grid_iq: torch.Tensor) -> torch.Tensor:
        xr, xi, inv_eff = self.equalize(grid_iq)
        llr = demap_planar(xr, xi, inv_eff, self.sgn, self.scheme)
        return _gather_dematch(llr, self.ul_inv, self.d_len)


class TurboTail:
    """De-matched LLRs (B*C, 3, K+4) -> (tb_bits (B, TBS) int8, ok (B,)
    bool, n_iter): turbo decode with CRC early stop and compacted retry,
    CRC24B, desegmentation, CRC24A.  ``last_stats`` holds the turbo
    schedule of the latest call."""

    def __init__(self, geom: PdschGeometry, n_iter: int,
                 tuning: DecoderTuning, retry_m: int, m24a: np.ndarray,
                 m24b: np.ndarray | None, device: torch.device):
        if geom.info.cb_crc and m24b is None:
            raise ValueError("segmented transport blocks need the CRC24B "
                             "matrix")
        exact_f32_matmul()
        self.geom, self.n_iter, self.tuning = geom, n_iter, tuning
        self.retry_m = retry_m
        t = lambda x: torch.as_tensor(x, dtype=torch.float32, device=device)
        self.m24a = t(m24a)
        self.m24b = t(m24b) if geom.info.cb_crc else None
        self.last_stats = TurboStats()

    def decode(self, llr_d: torch.Tensor):
        """-> (codeblock bits (B*C, K) int8, tb_bits, ok, n_iter): the tail
        with the turbo decoder's raw output (the SIC re-encode reads it)."""
        t, geom = self.tuning, self.geom
        info = geom.info
        cb_bits, stats = turbo_decode_batch(
            llr_d, geom.k, n_iter=self.n_iter, win=t.win, acq=t.acq,
            ext_scale=t.ext_scale, early_crc=t.early_crc(info.cb_crc),
            retry_m=self.retry_m, retry_levels=t.retry_levels)
        self.last_stats = stats
        bits = cb_bits.reshape(-1, info.c, geom.k)
        if info.cb_crc:
            payload, cb_ok = check_crc(bits, "24B", self.m24b)
        else:
            payload = bits
            cb_ok = torch.ones(bits.shape[:2], dtype=torch.bool,
                               device=bits.device)
        tb_bits, ok = check_crc(desegment_device(payload, info), "24A",
                                self.m24a)
        return cb_bits, tb_bits, ok & torch.all(cb_ok, dim=-1), stats.n_iter

    def __call__(self, llr_d: torch.Tensor):
        return self.decode(llr_d)[1:]


def _crc_plans(geom: PdschGeometry):
    """(CRC24A matrix, CRC24B matrix or None) of a geometry's tail."""
    info = geom.info
    return (crc_matrix(info.b - 24, "24A"),
            crc_matrix(geom.k - 24, "24B") if info.cb_crc else None)


class _Decoder:
    """A front and the shared tail on one device; subclasses give
    ``front``.  Build one with its ``make_*`` factory or ``from_plans``."""

    def __init__(self, tail: TurboTail, device: torch.device):
        self.tail, self.device = tail, device

    @property
    def n_iter(self) -> int:
        return self.tail.n_iter

    @property
    def last_stats(self) -> TurboStats:
        return self.tail.last_stats

    def front(self, x: torch.Tensor) -> torch.Tensor:
        """Input -> de-matched LLRs (B*C, 3, K+4): the stage boundary."""
        raise NotImplementedError

    def turbo(self, llr_d: torch.Tensor):
        """(B*C, 3, K+4) -> (tb_bits (B, TBS) int8, ok (B,) bool, n_iter)."""
        return self.tail(llr_d)

    def __call__(self, x: torch.Tensor):
        if x.device != self.device:
            raise ValueError(f"input on {x.device}, decoder on {self.device}")
        return self.turbo(self.front(x))


class BatchDecoder(_Decoder):
    """DL-SCH batch decoder on one device.  Build with
    :func:`make_batch_decoder`; call on (B, n_samps_subframe, 2) IQ."""

    def __init__(self, dl_front: DlFront, tail: TurboTail,
                 device: torch.device):
        super().__init__(tail, device)
        self.dl_front = dl_front

    @classmethod
    def from_plans(cls, cfg: PhyConfig, n_cell_id: int, subframe: int,
                   geom: PdschGeometry, scheme: str, sgn: np.ndarray,
                   grid_inv: np.ndarray, m24a: np.ndarray,
                   m24b: np.ndarray | None, n_iter: int = 6,
                   tuning: DecoderTuning | None = None,
                   device=None) -> "BatchDecoder":
        """Build from plan arrays given as numpy (:func:`dl_demap_plans`'s
        sign planes and de-match map, the CRC matrices)."""
        device = _resolve_device(device)
        tuning = tuning or DecoderTuning()
        return cls(DlFront(cfg, n_cell_id, subframe, scheme, geom.k, sgn,
                           grid_inv, device),
                   TurboTail(geom, n_iter, tuning, tuning.retry_m_dl, m24a,
                             m24b, device), device)

    def equalize(self, samples_iq: torch.Tensor):
        return self.dl_front.equalize(samples_iq)

    def front(self, samples_iq: torch.Tensor) -> torch.Tensor:
        return self.dl_front(samples_iq)


class HarqBatchDecoder(_Decoder):
    """HARQ-IR batch decoder: ``n_tx`` DL fronts, one tail.  Build with
    :func:`make_batch_harq_decoder`; call on (n_tx, B, n_samps, 2) IQ, slot
    i holding transmission i of every transport block in the batch."""

    def __init__(self, dl_fronts: list[DlFront], tail: TurboTail,
                 device: torch.device):
        if len(dl_fronts) < 2:
            raise ValueError("HARQ combining needs >= 2 transmissions")
        if {f.d_len for f in dl_fronts} != {tail.geom.k + 4}:
            raise ValueError("HARQ combining needs one codeblock size K")
        super().__init__(tail, device)
        self.dl_fronts = dl_fronts

    @classmethod
    def from_plans(cls, cfg: PhyConfig, n_cell_id: int,
                   subframes: tuple[int, ...], geom: PdschGeometry,
                   scheme: str, sgns: list[np.ndarray],
                   grid_invs: list[np.ndarray], m24a: np.ndarray,
                   m24b: np.ndarray | None, n_iter: int = 6,
                   tuning: DecoderTuning | None = None,
                   device=None) -> "HarqBatchDecoder":
        """Build from one (sign planes, de-match map) pair per transmission
        and the CRC matrices, all numpy; ``geom`` is the first
        transmission's."""
        if not len(subframes) == len(sgns) == len(grid_invs):
            raise ValueError("one subframe, sign plane set and de-match map "
                             "per transmission")
        device = _resolve_device(device)
        tuning = tuning or DecoderTuning()
        fronts = [DlFront(cfg, n_cell_id, sf, scheme, geom.k, s, g, device)
                  for sf, s, g in zip(subframes, sgns, grid_invs)]
        return cls(fronts, TurboTail(geom, n_iter, tuning, tuning.retry_m_dl,
                                     m24a, m24b, device), device)

    def front(self, batch_iq: torch.Tensor) -> torch.Tensor:
        """Sum of the transmissions' de-matched LLRs, in order."""
        if batch_iq.shape[0] != len(self.dl_fronts):
            raise ValueError(f"{batch_iq.shape[0]} transmissions given, "
                             f"decoder built for {len(self.dl_fronts)}")
        d = self.dl_fronts[0](batch_iq[0])
        for f, iq in zip(self.dl_fronts[1:], batch_iq[1:]):
            d = d + f(iq)
        return d


class PuschBatchDecoder(_Decoder):
    """UL-SCH batch decoder on one device.  Build with
    :func:`make_pusch_batch_decoder`; call on (B, 14, m_sc, 2) IQ grids."""

    def __init__(self, ul_front: PuschFront, tail: TurboTail,
                 device: torch.device):
        super().__init__(tail, device)
        self.ul_front = ul_front

    @classmethod
    def from_plans(cls, alloc: pusch.PuschAlloc, ref0: np.ndarray,
                   ref1: np.ndarray, w: np.ndarray, taps: np.ndarray,
                   sgn: np.ndarray, ul_inv: np.ndarray, m24a: np.ndarray,
                   m24b: np.ndarray | None, n_iter: int = 6,
                   noise_var: float | None = None,
                   tuning: DecoderTuning | None = None,
                   device=None) -> "PuschBatchDecoder":
        """Build from plan arrays given as numpy (see :class:`PuschFront`
        and the CRC matrices)."""
        device = _resolve_device(device)
        tuning = tuning or DecoderTuning()
        geom = alloc.geom
        return cls(PuschFront(alloc.scheme, geom.k, ref0, ref1, w, taps, sgn,
                              ul_inv, noise_var, device),
                   TurboTail(geom, n_iter, tuning, tuning.retry_m, m24a,
                             m24b, device), device)

    def front(self, grid_iq: torch.Tensor) -> torch.Tensor:
        return self.ul_front(grid_iq)


def make_batch_decoder(cfg: PhyConfig, n_cell_id: int, cfi: int,
                       prbs: tuple[int, ...], subframe: int, rnti: int,
                       geom: PdschGeometry, scheme: str, n_iter: int = 6,
                       tuning: DecoderTuning | None = None,
                       device=None) -> BatchDecoder:
    """DL-SCH decoder for one (cell, allocation, subframe, RNTI) geometry.

    The returned callable takes (B, n_samps_subframe, 2) float IQ on
    ``device`` (default: the current CUDA device) and returns (tb_bits
    (B, TBS) int8, ok (B,) bool, n_iter); ``last_stats`` holds the turbo
    schedule of the latest call (host syncs, compacted retries)."""
    re_idx = pdsch_flat_idx(cfg, n_cell_id, cfi, prbs, subframe)
    sgn, grid_inv = dl_demap_plans(
        cfg, re_idx, geom, seq.pdsch_c_init(rnti, subframe, n_cell_id))
    return BatchDecoder.from_plans(cfg, n_cell_id, subframe, geom, scheme,
                                   sgn, grid_inv, *_crc_plans(geom), n_iter,
                                   tuning, device)


def make_batch_harq_decoder(cfg: PhyConfig, n_cell_id: int, cfi: int,
                            prbs: tuple[int, ...],
                            subframes: tuple[int, ...], rnti: int,
                            geoms: tuple[PdschGeometry, ...], scheme: str,
                            n_iter: int = 6,
                            tuning: DecoderTuning | None = None,
                            device=None) -> HarqBatchDecoder:
    """HARQ incremental-redundancy decoder: soft-combines >= 2
    (re)transmissions of the same transport blocks, then runs one turbo
    batch on the summed d-domain LLRs.

    ``subframes``/``geoms``: one entry per transmission — the subframe it
    was sent in (scrambling and CRS positions differ) and its geometry
    (same TBS, n_re and Qm, its own ``rv``).  Combining is a sum of
    gathers, one per transmission and cycle of its circular buffer.  Input
    (n_tx, B, n_samps, 2) IQ; output as :func:`make_batch_decoder`."""
    if len(subframes) != len(geoms) or len(geoms) < 2 or \
            len({g.k for g in geoms}) != 1:
        raise ValueError("HARQ combining needs >= 2 transmissions of one TB "
                         "geometry, with one subframe each")
    plans = [dl_demap_plans(cfg, pdsch_flat_idx(cfg, n_cell_id, cfi, prbs, sf),
                            g, seq.pdsch_c_init(rnti, sf, n_cell_id))
             for sf, g in zip(subframes, geoms)]
    return HarqBatchDecoder.from_plans(
        cfg, n_cell_id, subframes, geoms[0], scheme, [p[0] for p in plans],
        [p[1] for p in plans], *_crc_plans(geoms[0]), n_iter, tuning, device)


def make_pusch_batch_decoder(alloc: pusch.PuschAlloc, rnti: int,
                             subframe: int, n_cell_id: int, n_iter: int = 6,
                             noise_var: float | None = None,
                             tuning: DecoderTuning | None = None,
                             device=None) -> PuschBatchDecoder:
    """UL-SCH (PUSCH, data only) decoder for one (allocation, RNTI,
    subframe, cell).

    The returned callable takes (B, 14, m_sc, 2) float IQ grids (the
    allocation's subcarriers of every SC-FDMA symbol) on ``device``
    (default: the current CUDA device) and returns (tb_bits (B, TBS) int8,
    ok (B,) bool, n_iter).  Noise is estimated per subframe from the DM-RS
    residual unless ``noise_var`` pins a static prior."""
    geom, m_sc, qm = alloc.geom, alloc.m_sc, alloc.qm
    d0, d1 = pusch.DMRS_SYMS
    w = np.clip(np.asarray([(s - d0) / (d1 - d0) for s in pusch.DATA_SYMS],
                           dtype=np.float32), 0.0, 1.0)[:, None]
    npad = -(-(12 * m_sc) // 128) * 128
    sgn = planar_sgn_np(pusch.pusch_c_init(rnti, subframe, n_cell_id), geom.g,
                        qm, npad)
    return PuschBatchDecoder.from_plans(
        alloc,
        np.conj(pusch.dmrs_pusch(n_cell_id, 2 * subframe, m_sc)),
        np.conj(pusch.dmrs_pusch(n_cell_id, 2 * subframe + 1, m_sc)),
        w, pusch.chest_taps(m_sc), sgn,
        ul_rm_inv_planar(geom, qm, m_sc, npad), *_crc_plans(geom), n_iter,
        noise_var, tuning, device)


# -- 2x2 MIMO (TM3 / TM4), MMSE and SIC --------------------------------------

def rm_inv_planar(geom: PdschGeometry, npad: int) -> np.ndarray:
    """De-match gather indices reading the planar demap output of the
    extracted PDSCH REs, (n_cycles, C*3*(K+4)) int64 (as
    :func:`dl_demap_plans`): interleaved codeword bit g = s*qm + j lives at
    planar flat position j*npad + s.  Untransmitted positions point at
    ``qm * npad``, the zero column the front appends."""
    cyc = _global_rm_cycles(geom)
    m = geom.qm
    out = (cyc % m).astype(np.int64) * npad + cyc // m
    out[cyc == geom.g] = m * npad
    return out


class MimoFront:
    """Two receive antennas' IQ (2, B, n_samps, 2) -> per-RE 2x2 MMSE
    demix of the PDSCH REs, the demap kernel once per codeword (each with
    its own sign planes) and one de-match gather over both codewords.

    ``chest_kind`` is "ls" (with ``denoise``) or "mmse" (the Wiener matrix
    of the static prior ``chest_nv``); ``sgn`` (2, qm, npad) holds the
    codewords' planar descramble signs and ``rm_inv`` the de-match map
    (:func:`rm_inv_planar`)."""

    def __init__(self, cfg: PhyConfig, n_cell_id: int, subframe: int,
                 scheme: str, geom: PdschGeometry, tm: int, cb_index: int,
                 re_idx: np.ndarray, sgn: np.ndarray, rm_inv: np.ndarray,
                 chest_kind: str, denoise: bool, chest_nv: float,
                 device: torch.device):
        self.cfg, self.n_cell_id, self.subframe = cfg, n_cell_id, subframe
        self.scheme, self.d_len = scheme, geom.k + 4
        self.tm, self.cb_index = tm, cb_index
        self.chest_kind, self.denoise, self.chest_nv = (chest_kind, denoise,
                                                        chest_nv)
        t = lambda x, dt: torch.as_tensor(np.asarray(x), dtype=dt,
                                          device=device)
        self.re_idx = t(re_idx, torch.int64)
        self.sgn = t(sgn, torch.float32)
        self.rm_inv = _plan(rm_inv, device)

    def _estimate(self, grids: torch.Tensor, port: int) -> torch.Tensor:
        if self.chest_kind == "mmse":
            return chest.estimate_channel_mmse(grids, self.cfg,
                                               self.n_cell_id, self.subframe,
                                               port, self.chest_nv)
        return chest.estimate_channel(grids, self.cfg, self.n_cell_id,
                                      self.subframe, port, self.denoise)

    def equalize(self, batch_iq: torch.Tensor):
        """-> (y (B, rx, M), heff (B, rx, layer, M), nvar (B,), x_hat
        (B, layer, M), eff_nv (B, layer, M)): the received PDSCH REs, the
        effective channel, the noise from rx 0 and the MMSE demix."""
        if batch_iq.shape[0] != 2:
            raise ValueError(f"2 receive antennas expected, got "
                             f"{batch_iq.shape[0]}")
        grids = samples_to_subframe(_iq_to_complex(batch_iq), self.cfg)
        flat = lambda g: g.reshape(*g.shape[:-2], -1)[..., self.re_idx]
        # (rx, B, port, M) -> (B, rx, port, M)
        h = torch.stack([flat(self._estimate(grids, port))
                         for port in range(2)], dim=2).permute(1, 0, 2, 3)
        nvar = chest.estimate_noise_var(grids[0], self.cfg, self.n_cell_id,
                                        self.subframe)
        y = flat(grids).permute(1, 0, 2)
        heff = (mimo.heff_tm3(h) if self.tm == 3
                else mimo.heff_tm4(h, self.cb_index))
        x, eff = mimo.mmse_demix_2layers(y, heff, nvar[:, None])
        return y, heff, nvar, x, eff

    def demap(self, x: torch.Tensor, eff: torch.Tensor, q: int):
        """One codeword's symbols (B, M) and effective noise -> planar LLRs
        (B, qm, npad) descrambled with codeword q's signs."""
        return demap_planar(x.real.contiguous(), x.imag.contiguous(),
                            (1.0 / eff).contiguous(), self.sgn[q],
                            self.scheme)

    def dematch(self, llr: torch.Tensor) -> torch.Tensor:
        """Planar LLRs (B', qm, npad) -> (B'*C, 3, K+4)."""
        return _gather_dematch(llr, self.rm_inv, self.d_len)

    def __call__(self, batch_iq: torch.Tensor) -> torch.Tensor:
        """-> (2B*C, 3, K+4) de-matched LLRs, b-major in (subframe,
        codeword)."""
        _, _, _, x, eff = self.equalize(batch_iq)
        llr = torch.stack([self.demap(x[:, q], eff[:, q], q)
                           for q in range(2)], dim=1)
        return self.dematch(llr.flatten(0, 1))


class MimoBatchDecoder(_Decoder):
    """2x2 MMSE dual-codeword decoder on one device.  Build with
    :func:`make_mimo_batch_decoder`; call on (2 rx, B, n_samps, 2) IQ;
    returns (tb_bits (2B, TBS) int8, ok (2B,) bool, n_iter), rows b-major
    in (subframe, codeword)."""

    def __init__(self, mimo_front: MimoFront, tail: TurboTail,
                 device: torch.device):
        super().__init__(tail, device)
        self.mimo_front = mimo_front

    def front(self, batch_iq: torch.Tensor) -> torch.Tensor:
        return self.mimo_front(batch_iq)


@dataclasses.dataclass
class SicFront:
    """What the SIC front hands on: CW0's de-matched LLRs (B*C, 3, K+4),
    CW1's planar MMSE LLRs (B, qm, npad), and the received REs, effective
    channel and noise the cancellation needs."""
    d0: torch.Tensor
    llr1: torch.Tensor
    y: torch.Tensor
    heff: torch.Tensor
    nvar: torch.Tensor


class MimoSicBatchDecoder(_Decoder):
    """2x2 successive-interference-cancellation decoder: decode CW0 from
    the MMSE demix, re-encode it (:func:`turbo_reencode_batch`), rate-match,
    scramble and modulate it, cancel it from the received REs, and decode
    CW1 from the maximum-ratio combine of layer 1's clean column.
    Subframes whose CW0 failed its CRC keep CW1's MMSE LLRs.  Same input
    and output as :class:`MimoBatchDecoder`; ``last_stats`` merges the two
    tails' schedules (n_iter the larger), ``tail_stats`` keeps both."""

    def __init__(self, mimo_front: MimoFront, tail: TurboTail,
                 scr0: np.ndarray, rm_idx: np.ndarray, device: torch.device):
        super().__init__(tail, device)
        self.mimo_front = mimo_front
        self.scr0 = torch.as_tensor(scr0, dtype=torch.int32, device=device)
        self.rm_idx = torch.as_tensor(rm_idx, dtype=torch.int64,
                                      device=device)
        self.tail_stats = (TurboStats(), TurboStats())

    @property
    def last_stats(self) -> TurboStats:
        s0, s1 = self.tail_stats
        return TurboStats(n_iter=max(s0.n_iter, s1.n_iter),
                          syncs=s0.syncs + s1.syncs,
                          retries=s0.retries + s1.retries)

    def front(self, batch_iq: torch.Tensor) -> SicFront:
        f = self.mimo_front
        y, heff, nvar, x, eff = f.equalize(batch_iq)
        return SicFront(f.dematch(f.demap(x[:, 0], eff[:, 0], 0)),
                        f.demap(x[:, 1], eff[:, 1], 1), y, heff, nvar)

    def turbo0(self, d0: torch.Tensor):
        """CW0's tail -> (codeblock bits (B*C, K), tb_bits, ok, n_iter)."""
        out = self.tail.decode(d0)
        self.tail_stats = (self.tail.last_stats, self.tail_stats[1])
        return out

    def cancel(self, cb_bits0: torch.Tensor, ok0: torch.Tensor,
               f: SicFront) -> torch.Tensor:
        """CW0's decoded codeblocks -> CW1's de-matched LLRs (B*C, 3, K+4)
        after the cancellation (the MMSE LLRs where CW0 failed)."""
        mf, geom = self.mimo_front, self.tail.geom
        bsz = f.llr1.shape[0]
        d = turbo_reencode_batch(cb_bits0, geom.k)
        e = d.reshape(bsz, -1)[:, self.rm_idx]
        s0 = modulate_arith(torch.remainder(e + self.scr0, 2), mf.scheme)
        y2 = f.y - f.heff[:, :, 0, :] * s0[:, None, :]
        x1, eff1 = chest.equalize_mrc(y2, f.heff[:, :, 1, :],
                                      f.nvar[:, None])
        llr1 = torch.where(ok0[:, None, None], mf.demap(x1, eff1, 1), f.llr1)
        return mf.dematch(llr1)

    def turbo1(self, d1: torch.Tensor):
        """CW1's tail -> (tb_bits, ok, n_iter)."""
        out = self.tail(d1)
        self.tail_stats = (self.tail_stats[0], self.tail.last_stats)
        return out

    def turbo(self, f: SicFront):
        cb0, tb0, ok0, it0 = self.turbo0(f.d0)
        tb1, ok1, it1 = self.turbo1(self.cancel(cb0, ok0, f))
        bsz = tb0.shape[0]
        return (torch.stack([tb0, tb1], dim=1).reshape(2 * bsz, -1),
                torch.stack([ok0, ok1], dim=1).reshape(2 * bsz),
                max(it0, it1))


def _mimo_front(cfg: PhyConfig, n_cell_id: int, cfi: int,
                prbs: tuple[int, ...], subframe: int, rnti: int,
                geom: PdschGeometry, scheme: str, tm: int, cb_index: int,
                chest_kind: str, tuning: DecoderTuning,
                device: torch.device) -> MimoFront:
    if cfg.n_ant != 2:
        raise ValueError("2x2 MIMO needs a 2-port cell (PhyConfig(n_ant=2))")
    if tm not in (3, 4):
        raise ValueError(f"tm {tm}: 3 (large-delay CDD) or 4 (codebook)")
    if tm == 4:
        mimo.codebook_2l(cb_index)
    re_idx = pdsch_flat_idx(cfg, n_cell_id, cfi, prbs, subframe)
    if len(re_idx) != geom.n_re:
        raise ValueError(f"geometry of {geom.n_re} REs, allocation of "
                         f"{len(re_idx)}")
    npad = -(-geom.n_re // 128) * 128
    sgn = np.stack([planar_sgn_np(seq.pdsch_c_init(rnti, subframe, n_cell_id,
                                                   q), geom.g, geom.qm, npad)
                    for q in range(2)])
    return MimoFront(cfg, n_cell_id, subframe, scheme, geom, tm, cb_index,
                     re_idx, sgn, rm_inv_planar(geom, npad), chest_kind,
                     tuning.mimo_denoise, tuning.mimo_chest_nv, device)


def make_mimo_batch_decoder(cfg: PhyConfig, n_cell_id: int, cfi: int,
                            prbs: tuple[int, ...], subframe: int, rnti: int,
                            geom: PdschGeometry, scheme: str, n_iter: int = 6,
                            tuning: DecoderTuning | None = None, tm: int = 3,
                            cb_index: int = 0, device=None):
    """2x2 dual-codeword DL-SCH decoder on a 2-port cell: TM3 (large-delay
    CDD) or TM4 (codebook ``cb_index``, 0-2).

    The returned callable takes (2 rx, B, n_samps, 2) float IQ on
    ``device`` (default: the current CUDA device) and returns (tb_bits
    (2B, TBS) int8, ok (2B,) bool, n_iter), rows b-major in (subframe,
    codeword).  Per batch: OFDM on both antennas, a CRS chest per (rx,
    port) (``tuning.mimo_chest``, ``mimo_denoise``), the noise from rx 0,
    the per-RE MMSE demix, the demap kernel per codeword and one turbo tail
    over both codewords with retry size ``tuning.retry_m_mimo``.
    ``tuning.mimo_detector="sic"`` returns
    :func:`make_mimo_sic_batch_decoder`'s decoder."""
    tuning = tuning or DecoderTuning()
    if tuning.mimo_detector == "sic":
        return make_mimo_sic_batch_decoder(cfg, n_cell_id, cfi, prbs,
                                           subframe, rnti, geom, scheme,
                                           n_iter, tuning, tm, cb_index,
                                           device)
    device = _resolve_device(device)
    front = _mimo_front(cfg, n_cell_id, cfi, prbs, subframe, rnti, geom,
                        scheme, tm, cb_index, tuning.mimo_chest, tuning,
                        device)
    return MimoBatchDecoder(front, TurboTail(
        geom, n_iter, tuning, tuning.retry_m_mimo, *_crc_plans(geom),
        device), device)


def make_mimo_sic_batch_decoder(cfg: PhyConfig, n_cell_id: int, cfi: int,
                                prbs: tuple[int, ...], subframe: int,
                                rnti: int, geom: PdschGeometry, scheme: str,
                                n_iter: int = 6,
                                tuning: DecoderTuning | None = None,
                                tm: int = 3, cb_index: int = 0,
                                device=None) -> MimoSicBatchDecoder:
    """The SIC variant of :func:`make_mimo_batch_decoder`, same input and
    output.  Its front estimates the channel by LS (``mimo_denoise``
    applies, ``mimo_chest`` does not), as the reference's SIC front does."""
    tuning = tuning or DecoderTuning()
    device = _resolve_device(device)
    front = _mimo_front(cfg, n_cell_id, cfi, prbs, subframe, rnti, geom,
                        scheme, tm, cb_index, "ls", tuning, device)
    scr0 = seq.gold_sequence_np(seq.pdsch_c_init(rnti, subframe, n_cell_id,
                                                 0), geom.g)
    return MimoSicBatchDecoder(front, TurboTail(
        geom, n_iter, tuning, tuning.retry_m_mimo, *_crc_plans(geom),
        device), scr0, _global_rm_idx(geom), device)
