"""Milestone config #3 (10 MHz, 50 PRB, 2 ports, MMSE chest, EVA) in the
port, on the CPU: the three gates of ``lteax_torch.bench.config3`` (the
noise estimate within a factor 2 under EVA, the MMSE estimate's MSE below
LS's under EVA, a noiseless 2-port SFBC loopback through the cell
generator and ``scan`` reporting the MIB, SIB1 and SIB2 with no SI CRC
failure), and the port's LS, noise and MMSE estimates of one received EVA
grid against the reference's (``lteax.phy.chest``) on the same grid:
within 1e-5 of the largest |H| (the Wiener matrix is the same host
inverse; torch and XLA sum the f32 products in other orders)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lteax.phy import chest as chest_ref
from lteax.phy.config import PhyConfig as RefPhyConfig

from lteax_torch.bench import config3
from lteax_torch.phy import chest


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_noise_estimate_under_eva():
    out = config3.noise_estimate("cpu")
    assert out["ok"], out


def test_mmse_beats_ls_under_eva():
    out = config3.chest_mse("cpu")
    assert out["ok"], out


def test_sfbc_loopback_reports_mib_and_sibs():
    out = config3.sfbc_loopback("cpu")
    assert out["ok"], out
    assert out["n_ant"] == 2 and out["sib_crc_fails"] == 0


def test_estimates_match_the_reference_on_one_grid():
    cfg, cfg_r = config3.CFG, RefPhyConfig(n_rb_dl=config3.N_RB)
    y, _, _ = config3.faded(np.random.default_rng(4), config3.crs_samples())
    grid = config3.received_grid(y, "cpu")
    grid_r = jnp.asarray(grid.numpy())
    cid, sf = config3.CID, config3.SF
    nv = float(chest.estimate_noise_var(grid, cfg, cid, sf))
    nv_r = float(chest_ref.estimate_noise_var(grid_r, cfg_r, cid, sf))
    assert abs(nv - nv_r) <= 1e-5 * nv_r
    h_ls = chest.estimate_channel(grid, cfg, cid, sf, 0).numpy()
    h_ls_r = np.asarray(chest_ref.estimate_channel(grid_r, cfg_r, cid, sf, 0))
    np.testing.assert_allclose(h_ls, h_ls_r, rtol=0,
                               atol=1e-5 * np.abs(h_ls_r).max())
    h = chest.estimate_channel_mmse(grid, cfg, cid, sf, 0, nv).numpy()
    h_r = np.asarray(chest_ref.estimate_channel_mmse(grid_r, cfg_r, cid, sf,
                                                     0, nv_r))
    assert h.shape == h_r.shape == (cfg.n_sym_subframe, cfg.n_sc)
    np.testing.assert_allclose(h, h_r, rtol=0, atol=1e-5 * np.abs(h_r).max())
