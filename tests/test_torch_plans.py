"""Every numpy plan the port copies from a jax-importing ``lteax`` module
equals its original, array for array; the jax-free DL signal generator
gives the reference encoder's symbols and IQ."""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lteax.phy import chest as chest_ref
from lteax.phy import mod as mod_ref
from lteax.phy import seq as seq_ref
from lteax.phy.channels import pdsch as pdsch_ref
from lteax.phy.config import PhyConfig
from lteax.phy.fec import crc as crc_ref
from lteax.phy.fec import ratematch as rm_ref
from lteax.phy.fec import turbo as turbo_ref
from lteax.phy.ofdm import subframe_to_samples as s2s_ref

from lteax_torch.phy import chest, mod, seq
from lteax_torch.phy.channels import pdsch
from lteax_torch.phy.fec import crc, ratematch, turbo
from lteax_torch.phy.ofdm import subframe_to_samples
from lteax_torch.sim import dl_gen

CFGS = [PhyConfig(n_rb_dl=6), PhyConfig(n_rb_dl=15), PhyConfig(n_rb_dl=100)]


@pytest.mark.parametrize("n,kind", [(40, "24A"), (5800, "24B"),
                                    (18312, "24A"), (200, "16"), (64, "8")])
def test_crc_matrix(n, kind):
    np.testing.assert_array_equal(crc.crc_matrix(n, kind),
                                  crc_ref.crc_matrix(n, kind))


@pytest.mark.parametrize("c_init,n", [(0x1234 * 2 ** 14 + 512 + 214, 9000),
                                      (1, 31), (2 ** 31 - 1, 1200)])
def test_scrambling_symbols(c_init, n):
    np.testing.assert_array_equal(seq.scrambling_symbols_np(c_init, n),
                                  seq_ref.scrambling_symbols_np(c_init, n))


@pytest.mark.parametrize("cid,ns,l,nrb", [(214, 2, 0, 100), (0, 19, 4, 6),
                                          (503, 7, 0, 15)])
def test_crs_values(cid, ns, l, nrb):
    np.testing.assert_array_equal(seq.crs_values(cid, ns, l, nrb),
                                  seq_ref.crs_values(cid, ns, l, nrb))


@pytest.mark.parametrize("d_len,e_len,rv", [(5828, 6516, 0), (44, 132, 2),
                                            (5572, 3000, 1), (1028, 5000, 3)])
def test_turbo_rm_indices(d_len, e_len, rv):
    np.testing.assert_array_equal(ratematch.turbo_rm_indices(d_len, e_len, rv),
                                  rm_ref.turbo_rm_indices(d_len, e_len, rv))


@pytest.mark.parametrize("tbs,n_re,qm,rv", [(75376, 15000, 6, 0),
                                            (11064, 2250, 6, 0),
                                            (1800, 900, 4, 2),
                                            (296, 900, 2, 0)])
def test_pdsch_geometry_and_rm_maps(tbs, n_re, qm, rv):
    g, gr = (pdsch.pdsch_geometry(tbs, n_re, qm, rv),
             pdsch_ref.pdsch_geometry(tbs, n_re, qm, rv))
    assert (g.tbs, g.n_re, g.qm, g.rv, g.info, g.e_list, g.k, g.g) == \
        (gr.tbs, gr.n_re, gr.qm, gr.rv, gr.info, gr.e_list, gr.k, gr.g)
    np.testing.assert_array_equal(pdsch._global_rm_idx(g),
                                  pdsch_ref._global_rm_idx(gr))
    inv, inj = pdsch._global_rm_inv(g)
    inv_r, inj_r = pdsch_ref._global_rm_inv(gr)
    assert inj == inj_r
    np.testing.assert_array_equal(inv, inv_r)


@pytest.mark.parametrize("scheme", ["qpsk", "16qam", "64qam"])
def test_pam_axis(scheme):
    lv, bit1 = mod._pam_axis(scheme)
    lv_r, bit1_r = mod_ref._pam_axis(scheme)
    assert lv.dtype == lv_r.dtype
    np.testing.assert_array_equal(lv, lv_r)
    np.testing.assert_array_equal(bit1, bit1_r)


@pytest.mark.parametrize("scheme", ["bpsk", "qpsk", "16qam", "64qam"])
def test_constellation_and_modulate(scheme):
    np.testing.assert_array_equal(mod.constellation(scheme),
                                  mod_ref.constellation(scheme))
    m = mod.BITS_PER_SYM[scheme]
    bits = np.random.default_rng(1).integers(0, 2, (3, 40 * m))
    np.testing.assert_array_equal(
        mod.modulate(bits, scheme),
        np.asarray(mod_ref.modulate(jnp.asarray(bits), scheme)))


def test_trellis_and_wiring():
    for a, b in zip(turbo._trellis(), turbo_ref._trellis()):
        np.testing.assert_array_equal(a, b)
    assert turbo._unrolled_wiring() == turbo_ref._unrolled_wiring()


def test_cuda_source_wiring():
    """csrc/turbo.cu writes the ACS and combine wiring out as straight-line
    code; parse it back and hold it to ``_unrolled_wiring``."""
    src = (Path(__file__).resolve().parents[1] / "lteax_torch" / "kernels"
           / "csrc" / "turbo.cu").read_text()
    fwd, bwd, out0, out1 = turbo_ref._unrolled_wiring()

    def acs(fn, var):
        body = src.split(f"void {fn}(")[1].split("\n}")[0]
        pat = (rf"n(\d) = fmaxf\({var}\[(\d)\] \+ g\[(\d)\], "
               rf"{var}\[(\d)\] \+ g\[(\d)\]\);")
        rows = re.findall(pat, body)
        assert [int(r[0]) for r in rows] == list(range(8))
        return tuple(tuple(int(x) for x in (r[1], r[3], r[2], r[4]))
                     for r in rows)

    assert acs("acs_fwd", "a") == fwd
    assert acs("acs_bwd", "b") == bwd
    body = src.split("float combine(")[1].split("\n}")[0]
    groups = {int(gc): set(re.findall(r"a\[(\d)\] \+ b\[(\d)\]", expr))
              for gc, expr in re.findall(r"float m(\d) = (.*);", body)}
    want = {gc: set() for gc in range(4)}
    for s in range(8):
        for ns, gc in (out0[s], out1[s]):
            want[gc].add((str(s), str(ns)))
    assert groups == want


@pytest.mark.parametrize("k", [40, 1024, 5824])
def test_turbo_encode(k):
    bits = np.random.default_rng(k).integers(0, 2, (3, k))
    ref = np.stack([np.asarray(turbo_ref.turbo_encode(jnp.asarray(b), k))
                    for b in bits])
    np.testing.assert_array_equal(turbo.turbo_encode(bits, k), ref)


@pytest.mark.parametrize("cfg", CFGS, ids=lambda c: f"{c.n_rb_dl}prb")
def test_chest_plans(cfg):
    for shift in range(6):
        np.testing.assert_array_equal(chest._freq_interp_matrix(cfg, shift),
                                      chest_ref._freq_interp_matrix(cfg, shift))
    syms = (0, 4, 7, 11)
    np.testing.assert_array_equal(chest._time_interp_matrix(cfg, syms),
                                  chest_ref._time_interp_matrix(cfg, syms))
    for cid, sf in ((214, 1), (7, 0)):
        np.testing.assert_array_equal(
            chest._crs_ref_values(cfg, cid, 0, sf),
            chest_ref._crs_ref_values(cfg, cid, 0, sf))


@pytest.mark.parametrize("n_rb,mcs", [(6, 17), (15, 28)])
def test_dl_gen_matches_reference_encoder(n_rb, mcs):
    """Same codeblocks -> identical symbols; same grid -> same IQ within
    FFT rounding (pocketfft vs XLA's FFT sum in different orders)."""
    cell = dl_gen.DlCell(n_rb_dl=n_rb, mcs=mcs)
    geom, cfg = cell.geom, cell.cfg
    geom_r = pdsch_ref.pdsch_geometry(geom.tbs, geom.n_re, geom.qm, geom.rv)
    tb = np.random.default_rng(3).integers(0, 2, (2, geom.tbs)).astype(np.int32)
    cbs = np.stack([dl_gen.pdsch_prepare_cbs(t, geom) for t in tb])
    cbs_r = np.stack([pdsch_ref.pdsch_prepare_cbs(t, geom_r) for t in tb])
    np.testing.assert_array_equal(cbs, cbs_r)
    syms = dl_gen.pdsch_encode_cbs(cbs, geom, cell.rnti, cell.subframe,
                                   cell.n_cell_id, cell.scheme)
    syms_r = np.stack([np.asarray(pdsch_ref.pdsch_encode_cbs(
        jnp.asarray(c), geom_r, cell.rnti, cell.subframe, cell.n_cell_id,
        cell.scheme)) for c in cbs_r])
    np.testing.assert_array_equal(syms, syms_r)

    grid = np.zeros((2, cfg.n_sym_subframe, cfg.n_sc), np.complex64)
    grid.reshape(2, -1)[:, cell.re_idx] = syms
    x = subframe_to_samples(torch.from_numpy(grid), cfg).numpy()
    x_r = np.asarray(s2s_ref(jnp.asarray(grid), cfg))
    np.testing.assert_allclose(x, x_r, rtol=1e-5, atol=1e-5)

    iq, tb_out = dl_gen.dl_subframes(cell, 3, snr_db=30.0, seed=5,
                                     max_unique=2)
    assert iq.shape == (3, cfg.n_samps_subframe, 2) and iq.dtype == np.float32
    np.testing.assert_array_equal(tb_out[2], tb_out[0])    # tiled


@pytest.mark.parametrize("kind,n", [("24A", 1000), ("24B", 5800)])
def test_check_crc_matches_reference(kind, n):
    """The port's float32 0/1 CRC matmul decides as the reference does."""
    rng = np.random.default_rng(n)
    bits = np.stack([crc_ref.attach_crc_np(b, kind)
                     for b in rng.integers(0, 2, (4, n))]).astype(np.int8)
    bits[1, 7] ^= 1                                    # corrupt one block
    pay, ok = crc.check_crc(torch.from_numpy(bits), kind)
    pay_r, ok_r = crc_ref.check_crc(jnp.asarray(bits), kind)
    np.testing.assert_array_equal(pay.numpy(), np.asarray(pay_r))
    np.testing.assert_array_equal(ok.numpy(), np.asarray(ok_r))
    assert ok.tolist() == [True, False, True, True]
