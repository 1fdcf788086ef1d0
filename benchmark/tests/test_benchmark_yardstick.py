"""The frozen yardstick: its counts give PERF.md's bounds at the headline
shapes, its transmitters send what the port's generators sent when they
were copied, and its plain reference fronts and decoder compute what the
port's exact (f32) decode computes."""

import numpy as np
import pytest
import torch

from benchmark import counts, spec

HEADLINE_C, HEADLINE_N = 13 * 256, 5824 + 3


def ms(seconds: float) -> float:
    return round(seconds * 1e3, 4)


def test_k12_bounds_at_the_headline_shape():
    b, f32, bf16 = counts.turbo_half_work(HEADLINE_C, HEADLINE_N, 128, 16,
                                          "bf16")
    assert ms(b / counts.HBM_BYTES_PER_S) == 0.0406
    assert ms(f32 / counts.F32_OPS_PER_S
              + bf16 / counts.BF16X2_OPS_PER_S) == 0.0421
    assert ms(counts.bound_s((b, f32, bf16))) == 0.0421
    assert ms(counts.bound_s(counts.turbo_half_work(
        HEADLINE_C, HEADLINE_N, 128, 16, "f32"))) == 0.0753


@pytest.mark.parametrize("config, in_bytes, bound_ms", [
    ("dl20_mcs28", 2, 0.0233), ("dl20_mcs28", 4, 0.0465),
    ("ul20_64qam", 2, 0.0200)])
def test_k3_bounds_at_the_headline_shapes(config, in_bytes, bound_ms):
    cfg = spec.config(config)
    n, npad = spec.system(cfg).demap_columns(cfg)
    assert ms(counts.bound_s(counts.demap_work(
        256, n, npad, cfg["qm"], in_bytes, in_bytes))) == bound_ms


def _port_signal(config: str, tb: np.ndarray) -> np.ndarray:
    from lteax_torch.phy.channels.pdsch import pdsch_prepare_cbs
    if config == "dl20_mcs28":
        from lteax_torch.sim.dl_gen import DlCell, _clean_samples
        cell = DlCell()
        return _clean_samples(cell, np.stack(
            [pdsch_prepare_cbs(t, cell.geom) for t in tb]))
    from lteax_torch.sim.ul_gen import UlCell, pusch_add_dmrs, \
        pusch_encode_cbs
    cell = UlCell()
    cbs = np.stack([pdsch_prepare_cbs(t, cell.alloc.geom) for t in tb])
    return pusch_add_dmrs(pusch_encode_cbs(
        cbs, cell.alloc, cell.rnti, cell.subframe, cell.n_cell_id),
        cell.alloc, cell.n_cell_id, cell.subframe)


def _noisy(sig: np.ndarray, snr_db: float, rng) -> np.ndarray:
    nv = 10 ** (-snr_db / 10)
    x = sig + (rng.standard_normal(sig.shape)
               + 1j * rng.standard_normal(sig.shape)) * np.sqrt(nv / 2)
    return np.stack([x.real, x.imag], axis=-1).astype(np.float32)


@pytest.mark.parametrize("config", ["dl20_mcs28", "ul20_64qam"])
def test_frozen_chain_against_the_port(config):
    """The frozen transmitter equals the port's generator; the reference
    front equals the port's exact front; the reference decodes every
    block at 25 dB to the bits sent."""
    cfg = spec.config(config)
    system = spec.system(cfg)
    rng = np.random.default_rng(7)
    tb = rng.integers(0, 2, (2, cfg["tbs"]))
    sig = system.transmit(cfg, tb)
    assert np.abs(sig - _port_signal(config, tb)).max() < 1e-5
    iq = _noisy(sig, 25.0, rng)
    d_ref = system.reference_front(cfg, iq)
    exact = {k: v for k, v in cfg["tuning"].items()
             if k not in ("mdtype", "demap_in", "ofdm_dft")}
    dec = system.decoder(cfg, {**exact, "mdtype": "f32", "demap_in": "f32",
                               "ofdm_dft": "fft"}, "cpu")
    d_port = dec.front(torch.from_numpy(iq)).double().numpy()
    assert (np.linalg.norm(d_port - d_ref) / np.linalg.norm(d_ref)) < 1e-5
    from benchmark import reference
    bits, ok = reference.decode(d_ref, system.geometry(cfg), cfg["n_iter"],
                                cfg["tuning"]["ext_scale"])
    assert ok.all() and np.array_equal(bits, tb)
