"""The frozen yardstick: its counts give PERF.md's bounds at the headline
shapes, its transmitters send what the port's generators sent when they
were copied, its plain reference fronts and decoder compute what the
port's exact (f32) decode computes, and its primitives of a 2-port,
two-codeword DL cell equal the port's."""

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


# (cell, subframe, cfi) -> sha256 of crs_grid's indices and values and of
# pdsch_re_idx, and pdsch_c_init at RNTI 4660, at their defaults (codeword
# 0, CRS port 0, one CRS port), as they were before codeword 1 and port 1
# were added
ONE_PORT = {
    (214, 1, 1): (
        "167da9590389b91bc1f44b51c31fecab449ef41a9c5a9c617dbd47703ec13cf4",
        "0f84b42db14d56eff9291a626bf408f82dd06771ee009d8ac11e33a50b4d4178",
        "418c68bf8ee845f34d9e6c5650421d3edb18eddb57bf63b51d7ccf892ec84a20",
        76350166),
    (150, 0, 2): (
        "044f57f94e3e9f3b207eb030f96f1a11b1510324cfc80679a601b2a2919a6bb1",
        "273994f5e300f86e06107e77ab6b19798406824135051a5d397ea90a5388b533",
        "74b97be9a2e9722a8d0f2e3366f12f05c8c06eca697bf826873c68ff3b2a0548",
        76349590),
    (7, 5, 3): (
        "424bfc4463d8794af635440377f0753c67991bef7a6b6eccb163c09714a28877",
        "bfd93349b3954cf7dbfc01856f261c792732905f067df1fc2641a3609146c3fa",
        "eb999cdf8be7999e3a951d0d34f6e69954660afb9555371c3c8b6bb39542541d",
        76352007),
}


@pytest.mark.parametrize("cell, sf, cfi", sorted(ONE_PORT))
def test_two_port_primitives_against_the_port(cell, sf, cfi):
    """Codeword 1's scrambler, port 1's CRS and a 2-port cell's PDSCH REs
    equal the port's; the defaults give the one-port arrays unchanged."""
    import hashlib

    from lteax_torch.phy import seq
    from lteax_torch.phy.config import PhyConfig
    from lteax_torch.phy.grid import crs_flat_idx, pdsch_flat_idx
    from lteax_torch.sim.dl_gen import crs_grid_values

    from benchmark import lte
    digest = lambda a: hashlib.sha256(np.ascontiguousarray(a).tobytes()
                                      ).hexdigest()
    num = lte.Numerology(100)
    idx, val = lte.crs_grid(num, cell, sf)
    assert (digest(idx), digest(val), digest(lte.pdsch_re_idx(
        num, cell, cfi, sf)), lte.pdsch_c_init(4660, sf, cell)) == \
        ONE_PORT[(cell, sf, cfi)]
    for q in (0, 1):
        assert lte.pdsch_c_init(4660, sf, cell, q) == seq.pdsch_c_init(
            4660, sf, cell, codeword=q)
    for ports in (1, 2):
        cfg = PhyConfig(n_rb_dl=100, n_ant=ports)
        for port in range(ports):
            idx, val = lte.crs_grid(num, cell, sf, port)
            assert np.array_equal(idx.ravel(),
                                  crs_flat_idx(cfg, cell, port))
            assert np.array_equal(val.ravel(),
                                  crs_grid_values(cfg, cell, sf, port))
        assert np.array_equal(
            lte.pdsch_re_idx(num, cell, cfi, sf, crs_ports=ports),
            pdsch_flat_idx(cfg, cell, cfi, tuple(range(100)), sf))
    assert len(lte.pdsch_re_idx(num, cell, cfi, sf, crs_ports=2)) < len(
        lte.pdsch_re_idx(num, cell, cfi, sf))
