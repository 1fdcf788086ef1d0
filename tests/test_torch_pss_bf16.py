"""The port's bf16 PSS routine (the default ``mdtype``) against the TPU
kernels in their bf16 mode (interpret mode on the CPU), and the pieces the
CUDA kernel is built from: the Toeplitz operand and its shared-memory image.

Tolerances.  The plain bf16 version and the TPU kernel multiply the same
bf16-rounded inputs exactly and accumulate in f32, in another order (taps in
order here, chunk matmuls there): |corr|^2 within 1e-4 of each carrier's
peak (``pss.BF16_TOL``, the limit the CUDA kernel is held to as well), the
root and peak index equal.  Against the f32 routine the bf16 rounding of
the inputs (2^-9 relative each) moves the peak by up to 1e-2 of itself."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lteax.kernels.pss import (pss_corr_mag_pallas, pss_detect_pallas,
                               pss_reduce_combine as combine_ref)

from lteax_torch.bench import scan_throughput
from lteax_torch.kernels import pss
from lteax_torch.phy import sync
from lteax_torch.phy.config import PhyConfig
from lteax_torch.shard.scanner import batched_prescan

N_RBS = [6, 15]          # 1.4 and 3 MHz: 128- and 256-tap replicas


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain correlator is a loop of small ops; the suite runs files in
    parallel processes (see tests/test_torch_sync.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _capture(cfg, c=3, n_fft_len=23, seed=7):
    """c rows of noise; row r carries root r % 3 at a known offset."""
    rng = np.random.default_rng(seed)
    filt = sync.pss_time_filters(cfg)
    nf = cfg.n_fft
    length = n_fft_len * nf + 37
    x = (rng.standard_normal((c, length))
         + 1j * rng.standard_normal((c, length))).astype(np.complex64) * 0.05
    offs = [2 * nf + 11 + 5 * nf * r for r in range(c)]
    for r, o in enumerate(offs):
        x[r, o:o + nf] += filt[r % 3]
    return x, filt, offs


@pytest.mark.parametrize("n_rb", N_RBS, ids=lambda n: f"{n}prb")
def test_corr_bf16_plain_matches_tpu_kernel(n_rb):
    cfg = PhyConfig(n_rb_dl=n_rb)
    x, filt, offs = _capture(cfg)
    before = (pss.CORR_LAUNCHES, pss.CORR_BF16_LAUNCHES)
    got = pss.pss_corr_mag(torch.from_numpy(x), filt).numpy()
    assert (pss.CORR_LAUNCHES, pss.CORR_BF16_LAUNCHES) == before
    assert got.shape == (3, 3, x.shape[1]) and got.dtype == np.float32
    ref = np.asarray(pss_corr_mag_pallas(jnp.asarray(x), filt, mdtype="bf16",
                                         interpret=True))
    peak = ref.max(axis=(1, 2), keepdims=True)
    assert np.max(np.abs(got - ref) / peak) <= pss.BF16_TOL
    np.testing.assert_array_equal(got.reshape(3, -1).argmax(1),
                                  ref.reshape(3, -1).argmax(1))
    for r, o in enumerate(offs):
        assert got[r, r % 3].argmax() == o
    # the default is the bf16 routine, and it is not the f32 one
    f32 = pss.pss_corr_mag(torch.from_numpy(x), filt, mdtype="f32").numpy()
    np.testing.assert_array_equal(
        got, pss.pss_corr_mag(torch.from_numpy(x), filt, "bf16").numpy())
    assert not np.array_equal(got, f32)
    np.testing.assert_allclose(got, f32, atol=1e-2 * float(f32.max()))


@pytest.mark.parametrize("n_rb", N_RBS, ids=lambda n: f"{n}prb")
def test_detect_bf16_plain_matches_tpu_kernel(n_rb):
    cfg = PhyConfig(n_rb_dl=n_rb)
    x, filt, offs = _capture(cfg)
    parts = pss.pss_detect(torch.from_numpy(x), filt)
    assert parts[3] == pss.TILE_BF16
    assert parts[0].shape == (3, 3, -(-x.shape[1] // pss.TILE_BF16))
    nid2, idx, peak, mean = pss.pss_reduce_combine(*parts)
    nid2_r, idx_r, peak_r, mean_r = combine_ref(
        *pss_detect_pallas(jnp.asarray(x), filt, mdtype="bf16",
                           interpret=True))
    np.testing.assert_array_equal(nid2.numpy(), np.asarray(nid2_r))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(idx_r))
    assert nid2.tolist() == [0, 1, 2] and idx.tolist() == offs
    peak_r = np.asarray(peak_r)
    np.testing.assert_allclose(peak.numpy(), peak_r, rtol=0,
                               atol=pss.BF16_TOL * float(peak_r.max()))
    np.testing.assert_allclose(mean.numpy(), np.asarray(mean_r), rtol=1e-4)


def test_detect_bf16_plain_equals_full_reductions():
    """The bf16 tile partials combine to the full-array reductions of the
    bf16 correlator: same root, same first-argmax index, bit-equal peak,
    with more than one tile and a ragged tail."""
    cfg = PhyConfig(n_rb_dl=6)
    x, filt, _ = _capture(cfg, c=2, n_fft_len=150, seed=5)
    assert x.shape[1] > pss.TILE_BF16
    xt = torch.from_numpy(x)
    p = pss.pss_corr_mag(xt, filt)
    nid2, idx, peak, mean = pss.pss_reduce_combine(*pss.pss_detect(xt, filt))
    nid_full = p.amax(-1).argmax(-1)
    pr = p[torch.arange(2), nid_full]
    assert torch.equal(nid2, nid_full)
    assert torch.equal(idx, pr.argmax(-1))
    assert torch.equal(peak, pr.amax(-1))
    np.testing.assert_allclose(mean.numpy(), p.mean(dim=(1, 2)).numpy(),
                               rtol=1e-5)


@pytest.mark.parametrize("call", [
    lambda x, f: pss.pss_corr_mag(x, f, mdtype="f16"),
    lambda x, f: pss.pss_detect(x, f, mdtype="tf32"),
    lambda x, f: pss.pss_corr_mag_plain(x, f, mdtype=""),
    lambda x, f: pss.pss_detect_plain(x, f, mdtype="F32"),
    lambda x, f: sync.pss_correlate(x, PhyConfig(n_rb_dl=6), mdtype="f64"),
    lambda x, f: scan_throughput.detect(x, PhyConfig(n_rb_dl=6), "int8"),
    lambda x, f: batched_prescan(x, PhyConfig(n_rb_dl=6), mdtype="fp8"),
], ids=["corr", "detect", "corr_plain", "detect_plain", "sync", "sweep",
        "prescan"])
def test_unknown_mdtype_raises(call):
    filt = sync.pss_time_filters(PhyConfig(n_rb_dl=6))
    x = torch.zeros((2, 1000), dtype=torch.complex64)
    with pytest.raises(ValueError, match="mdtype"):
        call(x, filt)


@pytest.mark.parametrize("n_rb", [6, 15, 100], ids=lambda n: f"{n}prb")
def test_toeplitz_operand_and_image(n_rb):
    """The kernel's GEMM, written out in numpy: frames of 64 samples as rows
    of interleaved (re, im), times the operand's chunks shifted by one row
    each, gives the plain version's correlation; and the shared-memory
    image is that operand as K-major 8-element groups."""
    cfg = PhyConfig(n_rb_dl=n_rb)
    filt = sync.pss_time_filters(cfg)
    nf, f = filt.shape[1], pss.FRAME
    length = 5 * f + 13
    rng = np.random.default_rng(n_rb)
    x = torch.from_numpy((rng.standard_normal((2, length)) + 1j
                          * rng.standard_normal((2, length))
                          ).astype(np.complex64))
    hb = pss._round_bf16(torch.from_numpy(filt)).numpy()
    b = pss.toeplitz_operand_np(hb)                  # (nch, 3, 2F, 2F)
    nch = nf // f + 1
    assert b.shape == (nch, 3, 2 * f, 2 * f)
    t = -(-length // f)
    xr = torch.view_as_real(pss._round_bf16(x)).numpy()
    rows = np.zeros((2, t + nch, 2 * f), np.float64)
    rows.reshape(2, -1)[:, :2 * length] = xr.reshape(2, -1)
    acc = sum(np.einsum("btk,rkn->brtn", rows[:, c:c + t],
                        b[c].astype(np.float64)) for c in range(nch))
    mag = (acc[..., 0::2] ** 2 + acc[..., 1::2] ** 2).reshape(2, 3, t * f)
    ref = pss.pss_corr_mag_plain(x, filt).numpy()
    np.testing.assert_allclose(mag[..., :length], ref,
                               atol=pss.BF16_TOL * float(ref.max()))
    img = pss._toeplitz_image(np.ascontiguousarray(filt))
    assert img.dtype == torch.bfloat16
    assert img.shape == (nch, 3, 2 * f // 8, 2 * f, 8)
    # bf16-representable already: nothing is lost going into the image
    back = img.to(torch.float32).numpy().transpose(0, 1, 2, 4, 3)
    np.testing.assert_array_equal(back.reshape(b.shape), b)


@pytest.mark.parametrize("mdtype", pss.MDTYPES)
def test_device_operands_are_kept_per_replica_content(mdtype):
    """Equal replicas share one operand, whichever array carries them;
    replicas changed in place get a new one."""
    filt = sync.pss_time_filters(PhyConfig(n_rb_dl=6)).copy()
    nf = filt.shape[1]
    get = lambda f: pss._operand(mdtype, f.tobytes(), nf, "cpu")
    a = get(filt)
    assert get(filt) is a and get(filt.copy()) is a
    want = lambda f: (pss._toeplitz_planes(f) if mdtype == "f32"
                      else pss._toeplitz_image(f))
    assert torch.equal(a, want(filt))
    filt[1] *= 2
    b = get(filt)
    assert b is not a and not torch.equal(a, b)
    assert torch.equal(b, want(filt))


def test_prescan_and_sweep_run_the_default():
    """``batched_prescan`` and the sweep's ``detect`` take ``mdtype`` and
    default to bf16: same detections either way on a clean capture, ratios
    apart by the bf16 rounding only."""
    cfg = PhyConfig(n_rb_dl=6)
    x, _, offs = _capture(cfg, c=2)
    xt = torch.from_numpy(x)
    pre = batched_prescan(xt, cfg)
    assert pre == batched_prescan(xt, cfg, mdtype="bf16")
    pre32 = batched_prescan(xt, cfg, mdtype="f32")
    for d, e, o in zip(pre, pre32, offs):
        assert (d["detected"], d["n_id_2"]) == (e["detected"], e["n_id_2"])
        assert d["detected"] and abs(d["pss_idx"] - o) <= 16
        assert d["peak_ratio"] == pytest.approx(e["peak_ratio"], rel=1e-2)
        assert d["peak_ratio"] != e["peak_ratio"]
    nid2, idx, ratio = scan_throughput.detect(xt, cfg)
    nid2_32, idx_32, ratio_32 = scan_throughput.detect(xt, cfg, "f32")
    assert nid2.tolist() == nid2_32.tolist() == [0, 1]
    assert idx.tolist() == idx_32.tolist() == offs
    np.testing.assert_allclose(ratio.numpy(), ratio_32.numpy(), rtol=1e-2)
