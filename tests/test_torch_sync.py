"""The port's cell-search pieces against ``lteax.phy.sync`` and the TPU
PSS kernels (interpret mode, ``mdtype="f32"``; the bf16 default is held to
the TPU kernels' bf16 mode in tests/test_torch_pss_bf16.py).

Tolerances: |corr|^2 within 2e-5 of the peak against the TPU kernel in f32
and against the FFT path (direct k-ordered sums vs matmul / FFT sums);
the fused detect's root and index exactly, its per-row peaks within 1e-6
of the batch's largest peak and its mean within rtol 1e-5 (summation
order: a 2048-term f32 sum of O(1) terms carries ~1e-6 of absolute
rounding, so a noise-only row's smaller peak is held to the batch's
scale)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lteax.kernels.pss import (pss_corr_mag_pallas, pss_detect_pallas,
                               pss_reduce_combine as combine_ref)
from lteax.phy import sync as sync_ref
from lteax.phy.config import PhyConfig as RefPhyConfig
from lteax.phy.ofdm import samples_to_subframe as s2s_ref

from lteax_torch.kernels import pss
from lteax_torch.phy import sync
from lteax_torch.phy.config import PhyConfig
from lteax_torch.phy.grid import pss_sym, sss_sym, sync_sc
from lteax_torch.sim.cell_gen import Cell, capture

CFG6_R = RefPhyConfig(n_rb_dl=6)       # the reference's own class


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain correlator is a loop of 2048 small ops; the suite runs
    files in parallel processes, and torch's own thread pool on top of them
    oversubscribes the cores (about 3x slower under load)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pss_capture(cfg, seed=3):
    """The shapes of tests/test_ofdm_sync.py: 2 rows of noise with a
    root-1 / root-2 replica at known offsets."""
    rng = np.random.default_rng(seed)
    filt = sync.pss_time_filters(cfg)
    L = 8 * cfg.n_fft + 37
    o1, o2 = 2 * cfg.n_fft, 3 * cfg.n_fft + 11
    x = (rng.standard_normal((2, L))
         + 1j * rng.standard_normal((2, L))).astype(np.complex64) * 0.05
    x[0, o1:o1 + cfg.n_fft] += filt[1]
    x[1, o2:o2 + cfg.n_fft] += filt[2]
    return x, filt, (o1, o2)


def test_corr_plain_matches_tpu_kernel_and_fft():
    cfg = PhyConfig(n_rb_dl=6)
    x, filt, (o1, o2) = _pss_capture(cfg)
    before = pss.CORR_LAUNCHES
    got = sync.pss_correlate(torch.from_numpy(x), cfg, mdtype="f32").numpy()
    assert pss.CORR_LAUNCHES == before
    assert got.shape == (2, 3, x.shape[1]) and got.dtype == np.float32
    tpu = np.asarray(pss_corr_mag_pallas(jnp.asarray(x), filt, mdtype="f32",
                                         interpret=True))
    fft = np.asarray(sync_ref.pss_correlate(jnp.asarray(x), CFG6_R,
                                            use_pallas=False))
    for ref in (tpu, fft):
        np.testing.assert_allclose(got, ref, atol=2e-5 * float(ref.max()))
    assert got[0, 1].argmax() == o1 and got[1, 2].argmax() == o2


@pytest.mark.mid
def test_detect_plain_matches_tpu_kernel():
    """n_rb 100, C=2, 2 subframes (tests/test_ofdm_sync.py's fused-detect
    shape), with a PSS subframe in row 0 and noise only in row 1."""
    cfg = PhyConfig(n_rb_dl=100)
    filt = sync.pss_time_filters(cfg)
    rng = np.random.default_rng(2)
    c, l = 2, 2 * cfg.n_samps_subframe
    x = (rng.standard_normal((c, l))
         + 1j * rng.standard_normal((c, l))).astype(np.complex64)
    x[0, 20000:20000 + cfg.n_fft] += 8 * filt[1]
    before = pss.DETECT_LAUNCHES
    nid2, idx, peak, mean = pss.pss_reduce_combine(
        *pss.pss_detect(torch.from_numpy(x), filt, mdtype="f32"))
    assert pss.DETECT_LAUNCHES == before
    nid2_r, idx_r, peak_r, mean_r = combine_ref(
        *pss_detect_pallas(jnp.asarray(x), filt, mdtype="f32",
                           interpret=True))
    np.testing.assert_array_equal(nid2.numpy(), np.asarray(nid2_r))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(idx_r))
    assert abs(int(idx[0]) - 20000) <= 16 and nid2[0] == 1
    peak_r = np.asarray(peak_r)
    np.testing.assert_allclose(peak.numpy(), peak_r, rtol=0,
                               atol=1e-6 * float(peak_r.max()))
    np.testing.assert_allclose(mean.numpy(), np.asarray(mean_r), rtol=1e-5)


def test_detect_plain_equals_full_reductions():
    """The tile partials combine to the full-array reductions: same root,
    same first-argmax index, bit-equal peak, for any tail length."""
    cfg = PhyConfig(n_rb_dl=6)
    x, filt, _ = _pss_capture(cfg, seed=5)
    xt = torch.from_numpy(np.concatenate([x, x[:, :1024]], axis=1))
    p = pss.pss_corr_mag(xt, filt)
    nid2, idx, peak, mean = pss.pss_reduce_combine(*pss.pss_detect(xt, filt))
    nid_full = p.amax(-1).argmax(-1)
    pr = p[torch.arange(2), nid_full]
    assert torch.equal(nid2, nid_full)
    assert torch.equal(idx, pr.argmax(-1))
    assert torch.equal(peak, pr.amax(-1))
    np.testing.assert_allclose(mean.numpy(), p.mean(dim=(1, 2)).numpy(),
                               rtol=1e-5)


@pytest.fixture(scope="module")
def cfo_capture():
    cell = Cell(n_rb_dl=6, n_cell_id=137, n_ant=2)
    return capture(cell, 0.03, sfn0=3, offset=777, cfo_hz=-2100.0,
                   snr_db=15.0, seed=4, device="cpu").iq


def test_coarse_timing_and_cfo(cfo_capture):
    cfg = PhyConfig(n_rb_dl=6)
    t0, cfo = sync.coarse_timing_and_cfo(torch.from_numpy(cfo_capture), cfg)
    t0_r, cfo_r = sync_ref.coarse_timing_and_cfo(jnp.asarray(cfo_capture),
                                                 CFG6_R)
    assert int(t0) == int(t0_r)
    assert abs(float(cfo) - float(cfo_r)) < 0.05
    assert abs(float(cfo) + 2100.0) < 100.0
    y = sync.apply_cfo(torch.from_numpy(cfo_capture), cfo, cfg.fs).numpy()
    y_r = np.asarray(sync_ref.apply_cfo(jnp.asarray(cfo_capture),
                                        jnp.float32(float(cfo)), cfg.fs))
    np.testing.assert_allclose(y, y_r, atol=2e-4)


@pytest.mark.mid
def test_find_pss_and_sss_detect(cfo_capture):
    cfg = PhyConfig(n_rb_dl=6)
    x = torch.from_numpy(cfo_capture)
    nid2, idx, peak = sync.find_pss(x, cfg, mdtype="f32")
    nid2_r, idx_r, peak_r = sync_ref.find_pss(jnp.asarray(cfo_capture), CFG6_R)
    assert (int(nid2), int(idx)) == (int(nid2_r), int(idx_r))
    assert int(nid2) == 137 % 3
    np.testing.assert_allclose(float(peak), float(peak_r), rtol=1e-4)
    start = int(idx) - cfg.symbol_starts_subframe[pss_sym(cfg)]
    start += 5 * cfg.n_samps_subframe if start < 0 else 0
    seg = cfo_capture[start:start + cfg.n_samps_subframe]
    g_r = np.asarray(s2s_ref(jnp.asarray(seg), CFG6_R, dft="fft"))
    scs = sync_sc(cfg)
    nid1, half, score = sync.sss_detect(
        torch.from_numpy(g_r[sss_sym(cfg), scs]),
        torch.from_numpy(g_r[pss_sym(cfg), scs]), int(nid2))
    nid1_r, half_r, score_r = sync_ref.sss_detect(
        jnp.asarray(g_r[sss_sym(cfg), scs]), jnp.asarray(g_r[pss_sym(cfg), scs]),
        int(nid2))
    assert (int(nid1), bool(half)) == (int(nid1_r), bool(half_r))
    assert int(nid1) == 137 // 3
    np.testing.assert_allclose(float(score), float(score_r), rtol=1e-5)


def test_sweep_detect_finds_inserted_pss():
    """The band-sweep path (fused detect + combine) on the reference's
    synthesis at 1.4 MHz: root 1 near each carrier's inserted PSS."""
    from lteax_torch.bench import scan_throughput
    cfg = PhyConfig(n_rb_dl=6)
    x, want = scan_throughput.sweep_signal(cfg, 4, 10 * cfg.n_samps_subframe)
    nid2, idx, ratio = scan_throughput.detect(torch.from_numpy(x), cfg)
    assert nid2.tolist() == [1] * 4
    assert np.all(np.abs(idx.numpy() - want) <= 2)
    assert torch.all(ratio > 30.0)
