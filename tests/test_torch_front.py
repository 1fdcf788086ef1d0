"""The port's DL front against the JAX reference on the same IQ: OFDM grid,
channel estimate, noise estimate, MMSE equalizer outputs and the de-matched
(B*C, 3, K+4) LLRs of ``_pdsch_stages(..., planar_boundary=False)``.

Tolerance rtol 1e-5 / atol 1e-5 on quantities of order one: pocketfft
(torch) and XLA's FFT sum in different orders.  The LLRs carry the 1/nv
scale (hundreds at 25 dB), so their atol is 1e-5 of the largest LLR; their
zeros (untransmitted positions, non-PDSCH columns) must sit in the same
places exactly."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lteax.phy import chest as chest_ref
from lteax.phy.channels import pdsch as pdsch_ref
from lteax.phy.config import PhyConfig as RefPhyConfig
from lteax.phy.ofdm import samples_to_subframe as s2s_ref
from lteax.phy.tuning import DecoderTuning as RefTuning
from lteax.shard.pipeline import _pdsch_stages

from lteax_torch.phy import chest
from lteax_torch.phy.config import PhyConfig
from lteax_torch.phy.ofdm import samples_to_subframe
from lteax_torch.pipeline import make_batch_decoder
from lteax_torch.sim.dl_gen import DlCell, dl_subframes

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def signal():
    cell = DlCell(n_rb_dl=15, mcs=28)
    iq, _ = dl_subframes(cell, 2, snr_db=25.0, seed=1)
    return cell, iq


def test_ofdm_chest_noise_mmse(signal):
    cell, iq = signal
    cfg, cid, sf = cell.cfg, cell.n_cell_id, cell.subframe
    cfg_r = RefPhyConfig(n_rb_dl=cell.n_rb_dl)
    x = iq[..., 0] + 1j * iq[..., 1]
    grid_r = s2s_ref(jnp.asarray(x.astype(np.complex64)), cfg_r, dft="fft")
    h_r = chest_ref.estimate_channel(grid_r, cfg_r, cid, sf, port=0)
    nv_r = chest_ref.estimate_noise_var(grid_r, cfg_r, cid, sf)

    grid = samples_to_subframe(torch.complex(*map(torch.from_numpy,
                                                  (iq[..., 0], iq[..., 1]))),
                               cfg)
    h = chest.estimate_channel(grid, cfg, cid, sf)
    nv = chest.estimate_noise_var(grid, cfg, cid, sf)
    np.testing.assert_allclose(grid.numpy(), np.asarray(grid_r), **TOL)
    np.testing.assert_allclose(h.numpy(), np.asarray(h_r), **TOL)
    np.testing.assert_allclose(nv.numpy(), np.asarray(nv_r), **TOL)

    # full-grid MMSE front, pipeline.py:219-223, on the reference's arrays
    hf = h_r.reshape(2, -1)
    p = jnp.abs(hf) ** 2
    nvb = nv_r[:, None]
    xr = grid_r.reshape(2, -1) * jnp.conj(hf) / (p + nvb)
    xr = xr / jnp.maximum(p / (p + nvb), 1e-12)
    dec = make_batch_decoder(*cell.decoder_args(), device="cpu")
    got = dec.equalize(torch.from_numpy(iq))
    for g, r in zip(got, (jnp.real(xr), jnp.imag(xr), p / nvb)):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), **TOL)


def test_dematched_llrs_match_reference_front(signal, monkeypatch):
    # the reference front reads the OFDM DFT choice from the environment
    monkeypatch.setenv("LTEAX_OFDM_DFT", "fft")
    cell, iq = signal
    geom = cell.geom
    geom_r = pdsch_ref.pdsch_geometry(geom.tbs, geom.n_re, geom.qm, geom.rv)
    front_r, _ = _pdsch_stages(
        RefPhyConfig(n_rb_dl=cell.n_rb_dl), cell.n_cell_id, cell.cfi,
        cell.prbs, cell.subframe, cell.rnti, geom_r, cell.scheme, 6,
        RefTuning(mdtype="f32", demap_in="f32"), True, planar_boundary=False)
    ref = np.asarray(front_r(jnp.asarray(iq))).reshape(-1, 3, geom.k + 4)

    got = make_batch_decoder(*cell.decoder_args(), device="cpu").front(
        torch.from_numpy(iq)).numpy()
    assert got.shape == ref.shape == (2 * geom.info.c, 3, geom.k + 4)
    np.testing.assert_array_equal(got == 0, ref == 0)
    np.testing.assert_allclose(got, ref, rtol=1e-5,
                               atol=1e-5 * np.abs(ref).max())


@pytest.mark.parametrize("port", [0, 1, 2, 3])
def test_chest_every_port(port):
    """The CRS estimate of each antenna port (ports 2/3 have 2 pilot
    symbols, 0/1 have 4) and the port-0 noise estimate, on one grid."""
    cfg, cfg_r = PhyConfig(n_rb_dl=15), RefPhyConfig(n_rb_dl=15)
    rng = np.random.default_rng(port)
    g = (rng.standard_normal((2, cfg.n_sym_subframe, cfg.n_sc))
         + 1j * rng.standard_normal((2, cfg.n_sym_subframe, cfg.n_sc))
         ).astype(np.complex64)
    for cid, sf in ((301, 0), (7, 5)):
        h = chest.estimate_channel(torch.from_numpy(g), cfg, cid, sf, port)
        h_r = chest_ref.estimate_channel(jnp.asarray(g), cfg_r, cid, sf, port)
        np.testing.assert_allclose(h.numpy(), np.asarray(h_r), **TOL)
    nv = chest.estimate_noise_var(torch.from_numpy(g), cfg, 301, 0)
    nv_r = chest_ref.estimate_noise_var(jnp.asarray(g), cfg_r, 301, 0)
    np.testing.assert_allclose(nv.numpy(), np.asarray(nv_r), **TOL)


def test_equalisers_and_precoders():
    """SISO, SFBC and SFBC+FSTD combining and the two transmit precoders,
    against the reference's elementwise formulas."""
    rng = np.random.default_rng(11)
    c = lambda *s: (rng.standard_normal(s) + 1j * rng.standard_normal(s)
                    ).astype(np.complex64)
    y, h0, h1, h2, h3 = (c(3, 240) for _ in range(5))
    nv = np.float32(0.07)
    t = lambda a: torch.from_numpy(a)
    pairs = [
        (chest.equalize_res(t(y), t(h0), t(h1), nv, 1),
         chest_ref.equalize_res(jnp.asarray(y), jnp.asarray(h0),
                                jnp.asarray(h1), nv, 1)),
        (chest.equalize_res(t(y), t(h0), t(h1), nv, 2),
         chest_ref.equalize_res(jnp.asarray(y), jnp.asarray(h0),
                                jnp.asarray(h1), nv, 2)),
        (chest.combine_sfbc_fstd(*map(t, (y, h0, h1, h2, h3)), nv),
         chest_ref.combine_sfbc_fstd(*map(jnp.asarray, (y, h0, h1, h2, h3)),
                                     nv)),
        (chest.precode_sfbc(t(y)), chest_ref.precode_sfbc(jnp.asarray(y))),
        (chest.precode_sfbc_fstd(t(y)),
         chest_ref.precode_sfbc_fstd(jnp.asarray(y))),
    ]
    for got, ref in pairs:
        assert len(got) == len(ref)
        for g, r in zip(got, ref):
            np.testing.assert_allclose(g.numpy(), np.asarray(r), **TOL)
