"""Sharded decoders over the rank mesh; counterpart of the sharded half of
``lteax.shard.pipeline`` (``make_sharded_*``, ``:805-1055``).

Each factory wraps the port's single-device factory of
``lteax_torch.pipeline``, as the reference wraps its stage functions in
``shard_map``, with the subframe batch on the ``time`` mesh axis.  They are
SPMD: every rank builds the decoder and calls it on its local batch (its
``time`` slice of the global batch, ``mesh.local_slice``), and gets back
its local TB bits and CRC flags and the global ``n_ok``: the CRC passes
summed over the whole mesh in one all-reduce and divided exactly by the
``chan`` size, because ``chan`` replicas decode the same slice (the
reference's ``psum`` over ``time`` then ``pmean`` over ``chan``, in one
collective).  The turbo decoder's early stop and
its compacted retry stay shard-local, as in the reference: each rank stops
when its own blocks pass.  ``last_stats`` is this rank's turbo schedule
(the reference's ``_no_print_iters`` has no counterpart: the port returns
``n_iter`` there).

The reference has two sharded DL decoders: ``make_sharded_decoder`` over
its XLA turbo (the slow-path oracle) and ``make_sharded_decoder_pallas``
over its Pallas turbo.  The port has one turbo decoder, so both map to the
one :func:`make_sharded_decoder`.

Every factory passes its ``tuning`` through to the single-device factory,
trellis and demap staging included.  The reference's factories default to
``DecoderTuning.from_env()``, a bf16 trellis with bf16 demap staging and
the factored OFDM DFT; the port's default to its exact f32
``DecoderTuning()``, and ``tuning=SHIPPED`` (``phy.tuning``) gives the
reference's shipped numerics, its factored OFDM DFT included.
A decoder runs on the current CUDA device unless the caller passes
``device="cpu"`` (on a CPU mesh); the device must be of the mesh's type.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from lteax_torch.phy.channels import pusch
from lteax_torch.phy.channels.pdsch import PdschGeometry
from lteax_torch.phy.config import PhyConfig
from lteax_torch.phy.sync import pss_time_filters
from lteax_torch.phy.tuning import DecoderTuning
from lteax_torch.pipeline import (_iq_to_complex, _resolve_device,
                                  make_batch_decoder, make_batch_harq_decoder,
                                  make_mimo_batch_decoder,
                                  make_mimo_sic_batch_decoder,
                                  make_pusch_batch_decoder)
from lteax_torch.shard.halo import overlap_save_correlate
from lteax_torch.shard.mesh import (CHAN_AXIS, TIME_AXIS, all_reduce,
                                    axis_size)


def _device(mesh, device) -> torch.device:
    device = _resolve_device(device)
    if device.type != mesh.device_type:
        raise ValueError(f"a decoder on {device} over a mesh of "
                         f"{mesh.device_type} ranks")
    return device


def global_n_ok(ok: torch.Tensor, mesh) -> int:
    """The distinct CRC passes of the global batch: one SUM over the whole
    mesh, divided exactly by the ``chan`` size."""
    n = int(all_reduce(ok.sum(dtype=torch.int64), dist.ReduceOp.SUM, mesh))
    n_chan = axis_size(mesh, CHAN_AXIS)
    if n % n_chan:
        raise RuntimeError(f"chan replicas disagree: {n} CRC passes over "
                           f"{n_chan} replicas")
    return n // n_chan


class ShardedDecoder:
    """One rank's part of a sharded decoder: the single-device decoder
    ``local`` on this rank's batch, then the global ``n_ok``.  Call on the
    local batch; returns (tb_bits, ok, n_ok) with n_ok a python int."""

    def __init__(self, mesh, local):
        self.mesh, self.local = mesh, local

    @property
    def device(self) -> torch.device:
        return self.local.device

    @property
    def last_stats(self):
        return self.local.last_stats

    def __call__(self, x: torch.Tensor):
        bits, ok, _ = self.local(x)
        return bits, ok, global_n_ok(ok, self.mesh)


class ShardedAcquireDecoder(ShardedDecoder):
    """The DL decoder behind the halo PSS acquisition: the local batch,
    read as one contiguous capture across the ``time`` shards, is
    correlated with the cell's PSS replica (the halo from the next shard),
    and the replicated ``pss_peak`` is the global max of |correlation|.
    Returns (tb_bits, ok, n_ok, pss_peak) with pss_peak a python float."""

    def __init__(self, mesh, local, taps: torch.Tensor):
        super().__init__(mesh, local)
        self.taps = taps

    def acquire(self, x: torch.Tensor) -> float:
        corr = overlap_save_correlate(_iq_to_complex(x).reshape(-1),
                                      self.taps, self.mesh)
        return float(all_reduce(corr.abs().max(), dist.ReduceOp.MAX,
                                self.mesh, TIME_AXIS))

    def __call__(self, x: torch.Tensor):
        peak = self.acquire(x)
        return (*super().__call__(x), peak)


def make_sharded_decoder(mesh, cfg: PhyConfig, n_cell_id: int, cfi: int,
                         prbs: tuple[int, ...], subframe: int, rnti: int,
                         geom: PdschGeometry, scheme: str, n_iter: int = 6,
                         tuning: DecoderTuning | None = None,
                         device=None) -> ShardedDecoder:
    """Time-sharded DL-SCH decoder (the reference's
    ``make_sharded_decoder_pallas`` and ``make_sharded_decoder``): the
    local (B / n_time, n_samps, 2) IQ -> (bits, ok, n_ok)."""
    dev = _device(mesh, device)
    return ShardedDecoder(mesh, make_batch_decoder(
        cfg, n_cell_id, cfi, prbs, subframe, rnti, geom, scheme, n_iter,
        tuning, dev))


def make_sharded_harq_decoder(mesh, cfg: PhyConfig, n_cell_id: int, cfi: int,
                              prbs: tuple[int, ...],
                              subframes: tuple[int, ...], rnti: int,
                              geoms: tuple[PdschGeometry, ...], scheme: str,
                              n_iter: int = 6,
                              tuning: DecoderTuning | None = None,
                              device=None) -> ShardedDecoder:
    """Time-sharded HARQ-IR decoder (``make_sharded_harq_decoder_pallas``):
    the local (n_tx, B / n_time, n_samps, 2) IQ, the subframe batch on
    axis 1 -> (bits, ok, n_ok)."""
    dev = _device(mesh, device)
    return ShardedDecoder(mesh, make_batch_harq_decoder(
        cfg, n_cell_id, cfi, prbs, subframes, rnti, geoms, scheme, n_iter,
        tuning, dev))


def make_sharded_pusch_decoder(mesh, alloc: pusch.PuschAlloc, rnti: int,
                               subframe: int, n_cell_id: int,
                               n_iter: int = 6,
                               noise_var: float | None = None,
                               tuning: DecoderTuning | None = None,
                               device=None) -> ShardedDecoder:
    """Time-sharded UL-SCH decoder: the local (B / n_time, 14, m_sc, 2) IQ
    grids -> (bits, ok, n_ok)."""
    dev = _device(mesh, device)
    return ShardedDecoder(mesh, make_pusch_batch_decoder(
        alloc, rnti, subframe, n_cell_id, n_iter, noise_var, tuning, dev))


def make_sharded_mimo_sic_decoder(mesh, cfg: PhyConfig, n_cell_id: int,
                                  cfi: int, prbs: tuple[int, ...],
                                  subframe: int, rnti: int,
                                  geom: PdschGeometry, scheme: str,
                                  n_iter: int = 6,
                                  tuning: DecoderTuning | None = None,
                                  tm: int = 3, cb_index: int = 0,
                                  device=None) -> ShardedDecoder:
    """Time-sharded 2x2 SIC decoder: every SIC stage (front, CW0's turbo,
    the re-encode and cancel, CW1's turbo) is batch-local, so the CW0-fail
    MMSE fallback and each tail's retry are shard-local.  The local
    (2 rx, B / n_time, n_samps, 2) IQ -> (bits (2B / n_time, TBS) with
    rows b-major in (subframe, codeword), ok, n_ok)."""
    dev = _device(mesh, device)
    return ShardedDecoder(mesh, make_mimo_sic_batch_decoder(
        cfg, n_cell_id, cfi, prbs, subframe, rnti, geom, scheme, n_iter,
        tuning, tm, cb_index, dev))


def make_sharded_mimo_decoder(mesh, cfg: PhyConfig, n_cell_id: int, cfi: int,
                              prbs: tuple[int, ...], subframe: int, rnti: int,
                              geom: PdschGeometry, scheme: str,
                              n_iter: int = 6,
                              tuning: DecoderTuning | None = None,
                              tm: int = 3, cb_index: int = 0,
                              device=None) -> ShardedDecoder:
    """Time-sharded 2x2 MMSE decoder, with the contract of
    :func:`make_sharded_mimo_sic_decoder`; ``tuning.mimo_detector="sic"``
    returns the SIC decoder (a profile that selects SIC never decodes with
    MMSE)."""
    tuning = tuning or DecoderTuning()
    if tuning.mimo_detector == "sic":
        return make_sharded_mimo_sic_decoder(
            mesh, cfg, n_cell_id, cfi, prbs, subframe, rnti, geom, scheme,
            n_iter, tuning, tm, cb_index, device)
    dev = _device(mesh, device)
    return ShardedDecoder(mesh, make_mimo_batch_decoder(
        cfg, n_cell_id, cfi, prbs, subframe, rnti, geom, scheme, n_iter,
        tuning, tm, cb_index, dev))


def make_sharded_acquire_decoder(mesh, cfg: PhyConfig, n_cell_id: int,
                                 cfi: int, prbs: tuple[int, ...],
                                 subframe: int, rnti: int,
                                 geom: PdschGeometry, scheme: str,
                                 n_iter: int = 6,
                                 tuning: DecoderTuning | None = None,
                                 device=None) -> ShardedAcquireDecoder:
    """The halo PSS acquisition and the DL decoder
    (``make_sharded_acquire_decoder_pallas``): the local (B / n_time,
    n_samps, 2) IQ, also read as one contiguous capture over the ``time``
    shards, -> (bits, ok, n_ok, pss_peak), pss_peak the global max of
    |PSS matched filter| with the replica of root ``n_cell_id % 3``."""
    dev = _device(mesh, device)
    taps = torch.as_tensor(pss_time_filters(cfg)[n_cell_id % 3], device=dev)
    return ShardedAcquireDecoder(mesh, make_batch_decoder(
        cfg, n_cell_id, cfi, prbs, subframe, rnti, geom, scheme, n_iter,
        tuning, dev), taps)
