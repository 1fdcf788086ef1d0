"""Every numpy plan and every module the port copies from ``lteax`` equals
its original, array for array (the port imports nothing of ``lteax``, so
these tests are what holds the two together); the jax-free DL and UL signal
generators give the reference encoders' symbols and grids.

The two packages' ``PhyConfig`` / ``SegmentInfo`` / ``PdschGeometry`` are
different classes that key ``lru_cache``d plans: each side gets its own,
built from the same arguments."""

import dataclasses
import json
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
from lteax.phy.config import PhyConfig as RefPhyConfig
from lteax.phy.fec import crc as crc_ref
from lteax.phy.fec import ratematch as rm_ref
from lteax.phy.fec import turbo as turbo_ref
from lteax.phy.ofdm import subframe_to_samples as s2s_ref

from lteax_torch.phy import chest, mod, seq
from lteax_torch.phy.channels import pdsch
from lteax_torch.phy.config import PhyConfig
from lteax_torch.phy.fec import crc, ratematch, turbo
from lteax_torch.phy.ofdm import subframe_to_samples
from lteax_torch.sim import dl_gen

N_RBS = [6, 15, 100]


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
    assert dataclasses.asdict(g) == dataclasses.asdict(gr)
    assert (g.k, g.g) == (gr.k, gr.g)
    np.testing.assert_array_equal(pdsch._global_rm_idx(g),
                                  pdsch_ref._global_rm_idx(gr))
    # the port keeps one plan, the occurrence-rank cycles: one row, the
    # reference's injective inverse, when no bit is sent twice
    cyc = pdsch._global_rm_cycles(g)
    _same(cyc, pdsch_ref._global_rm_cycles(gr))
    inv_r, inj_r = pdsch_ref._global_rm_inv(gr)
    assert inj_r == (cyc.shape[0] == 1)
    if inj_r:
        np.testing.assert_array_equal(cyc[0], inv_r)


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
    """csrc/turbo.cu writes the ACS wiring out as the two tables
    TRELLIS_FWD and TRELLIS_BWD (the combine's branches are BWD's, read
    forwards); parse them back and hold them to ``_unrolled_wiring``."""
    src = _turbo_cu()
    fwd, bwd, out0, out1 = turbo_ref._unrolled_wiring()

    def table(name):
        body = re.search(rf"#define {name} (\{{.*?\}}\}})", src, re.S).group(1)
        rows = re.findall(r"\{(\d), (\d), (\d), (\d)\}", body)
        assert len(rows) == 8
        return tuple(tuple(int(x) for x in r) for r in rows)

    assert table("TRELLIS_FWD") == fwd
    assert table("TRELLIS_BWD") == bwd
    # the kernel takes both tables from these macros and nowhere else
    assert src.count("= TRELLIS_FWD;") == 2 and src.count("= TRELLIS_BWD;") == 2
    # what the kernel derives from BWD: state s goes to n0 under g0 on bit 0
    # and to n1 under g1 on bit 1, and a branch pair's codes sum to 3
    assert tuple((r[0], r[2]) for r in bwd) == out0
    assert tuple((r[1], r[3]) for r in bwd) == out1
    assert all(r[2] + r[3] == 3 for r in fwd + bwd)


def _turbo_cu() -> str:
    return (Path(__file__).resolve().parents[1] / "lteax_torch" / "kernels"
            / "csrc" / "turbo.cu").read_text()


def _lane_wiring(src: str) -> dict:
    """What csrc/turbo.cu derives by hand beside its two tables, parsed out
    of the source: which lane bit a step's exchange crosses, which lanes
    keep the bit-1 maxima, each lane's gamma code in the combine, which of
    a butterfly's two maxima is bit 0's, and the three folds' lane
    distances."""
    one = lambda pat: re.search(pat, src).groups()
    w = {}
    w["swap"] = tuple(map(int, one(
        r"p\.swap = \(ph == d\) \? (\d) : (\d);")))
    w["keeps1_from"] = int(one(r"const bool keeps1 = q >= (\d);")[0])
    a, b, c, d = map(int, one(
        r"const int mcode = keeps1 \? 3 - \(q == 3 \? (\d) : (\d)\) : "
        r"\(q == 0 \? (\d) : (\d)\);"))
    w["mcode"] = (c, d, 3 - b, 3 - a)              # lanes 0, 1, 2, 3
    w["bit0_below"] = int(one(r"p\.bit0_is_p = kFwd\[k\]\[2\] < (\d);")[0])
    w["fold"] = (
        int(one(r"__shfl_xor_sync\(all, keeps1 \? bit0 : bit1, (\d)\)")[0]),
        int(one(r"__shfl_xor_sync\(all, in_b, (\d)\)")[0]),
        int(one(r"__shfl_xor_sync\(all, in_c, (\d)\)")[0]))
    assert "if (q == 0 && t >= half + 2) *lp = in_c - got_c;" in src
    assert "in_b = fmaxf(keeps1 ? bit1 : bit0, got_a) + ga;" in src
    return w


def _emulate_lanes(u, v, a_init, b_init, win, acq, fwd, bwd, w):
    """The lane algorithm of csrc/turbo.cu in numpy float32, a window at a
    time over all codeblocks: 4 lanes a direction, each holding one
    butterfly's pair of metrics, one exchange a step, the combine folded
    across the lanes.  The kernel's pipelining (inputs and gammas ahead,
    the fold in three stages) changes no value and is left out."""
    c, n = u.shape
    n_w, half = -(-n // win), win // 2
    q = np.arange(4)
    swap2 = ((q & 1) << 1) | (q >> 1)
    pad = lambda x: np.pad(x, ((0, 0), (acq, n_w * win + acq - n)))
    up, vp = pad(u), pad(v)                        # position p at p + acq

    def phase(d, ph):
        k = swap2 if ph else q
        code = np.array([fwd[i][2] if d == 0 else
                         bwd[2 * i][2] if bwd[2 * i][0] == i else bwd[2 * i][3]
                         for i in k])
        return {"pair": k, "vneg": (code == 1) | (code == 2), "neg": code >= 2,
                "swap": w["swap"][0] if ph == d else w["swap"][1],
                "bit0_is_p": np.array([fwd[i][2] < w["bit0_below"]
                                       for i in k])}

    def gamma(code_vneg, code_neg, pos, pin=False):
        uu, vv = up[:, pos + acq, None], vp[:, pos + acq, None]
        g = np.float32(0.5) * (uu + np.where(code_vneg, -vv, vv))
        if pin:
            g = np.full_like(g, 256.0)
        return np.where(code_neg, -g, g)

    def step(r, p, g):
        """One trellis step of every lane's pair under its signed gamma."""
        lo = np.maximum(r[0] + g, r[1] - g)
        hi = np.maximum(r[0] - g, r[1] + g)
        bit = (q & p["swap"]) != 0
        got = np.where(bit, lo, hi)[:, q ^ p["swap"]]
        return np.where(bit, got, lo), np.where(bit, hi, got)

    state = lambda d, k, r: k + 4 * r if d else 2 * k + r
    mcode = np.array(w["mcode"])
    keeps1 = q >= w["keeps1_from"]
    l = np.zeros((c, n_w * win), np.float32)
    nii = np.zeros((2, c, n_w, 8), np.float32)
    for wi in range(n_w):
        base = wi * win
        phs = [[phase(d, ph) for ph in (0, 1)] for d in (0, 1)]
        regs, store = [], np.zeros((2, half, c, 4, 2), np.float32)
        for d in (0, 1):
            first = (acq if wi == 0 else 0) if d == 0 else \
                min(max(base + win + acq - n, 0), acq)
            ph = (acq - first) & 1
            k = phs[d][ph]["pair"]
            init = (b_init if d else a_init)[:, wi]
            r = (init[:, state(d, k, 0)], init[:, state(d, k, 1)])
            for t in range(first, acq):            # live positions only
                p = phs[d][ph]
                pos = base + win + acq - 1 - t if d else base - acq + t
                r = step(r, p, gamma(p["vneg"], p["neg"], pos))
                ph ^= 1
            assert ph == 0
            regs.append(r)
        t_pin = win - (n - base)                   # beta pins steps t < t_pin
        for t in range(win):
            new = []
            for d in (0, 1):
                p, r = phs[d][t & 1], regs[d]
                pos = base + (win - 1 - t if d else t)
                if t < half:                       # slot t, at the pair's place
                    store[d, t][:, p["pair"], 0] = r[0]
                    store[d, t][:, p["pair"], 1] = r[1]
                else:
                    if t == win - acq:
                        for i in (0, 1):
                            nii[d][:, wi, state(d, p["pair"], i)] = r[i]
                    o = store[1 - d, win - 1 - t][:, p["pair"]]
                    pm = np.maximum(r[0] + o[..., 0], r[1] + o[..., 1])
                    qm = np.maximum(r[0] + o[..., 1], r[1] + o[..., 0])
                    bit0 = np.where(p["bit0_is_p"], pm, qm)
                    bit1 = np.where(p["bit0_is_p"], qm, pm)
                    got = np.where(keeps1, bit0, bit1)[:, q ^ w["fold"][0]]
                    in_b = np.maximum(np.where(keeps1, bit1, bit0), got) \
                        + gamma((mcode == 1) | (mcode == 2), mcode >= 2, pos)
                    in_c = np.maximum(in_b, in_b[:, q ^ w["fold"][1]])
                    l[:, pos] = (in_c - in_c[:, q ^ w["fold"][2]])[:, 0]
                new.append(step(r, p, gamma(p["vneg"], p["neg"], pos,
                                            pin=d == 1 and t < t_pin)))
            regs = new
    return l[:, :n], nii[0], nii[1]


@pytest.mark.parametrize("c,n,win,acq", [
    (3, 43, 32, 8),          # K = 40: two windows, the last with 11 live
    (2, 43, 128, 16),        # one window, 43 of 128 positions live
    (3, 131, 64, 16),        # the last window has 3 live positions
    (2, 300, 32, 16),        # acq = win / 2, beta acquisition cut short
    (5, 387, 128, 16)])
def test_cuda_source_lane_algorithm(c, n, win, acq):
    """The kernel's lane algorithm, emulated in numpy with the tables and
    the hand-derived lane wiring parsed out of csrc/turbo.cu, equals
    ``half_iteration_plain`` bit for bit: what pins the combine's wiring
    (its gamma codes, which lane keeps which bit, the folds' lane
    distances) and the exchange pattern where no card is at hand."""
    from lteax_torch.kernels import turbo_mlm as tm
    src = _turbo_cu()
    fwd, bwd, _, _ = turbo._unrolled_wiring()
    w = _lane_wiring(src)
    assert w == {"swap": (1, 2), "keeps1_from": 2, "mcode": (0, 1, 2, 3),
                 "bit0_below": 2, "fold": (3, 1, 3)}
    n_w = -(-n // win)
    rng = np.random.default_rng(n + win)
    f32 = lambda x: torch.from_numpy(x.astype(np.float32))
    u, v = f32(rng.standard_normal((c, n)) * 6), f32(rng.standard_normal((c, n)) * 6)
    a0, b0 = tm._pin_boundaries(f32(rng.standard_normal((c, n_w, 8))),
                                f32(rng.standard_normal((c, n_w, 8))))
    ref = tm.half_iteration_plain(u, v, a0, b0, win, acq)
    got = _emulate_lanes(u.numpy(), v.numpy(), a0.numpy(), b0.numpy(), win,
                         acq, fwd, bwd, w)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g, r.numpy())
    # a wrong fold distance or gamma code does not pass
    for bad in ({**w, "fold": (3, 2, 3)}, {**w, "mcode": (0, 1, 3, 2)},
                {**w, "swap": (2, 1)}):
        worse = _emulate_lanes(u.numpy(), v.numpy(), a0.numpy(), b0.numpy(),
                               win, acq, fwd, bwd, bad)
        assert not np.array_equal(worse[0], ref[0].numpy())


@pytest.mark.parametrize("f", [64, 128])
@pytest.mark.parametrize("n_rb", N_RBS, ids=lambda n: f"{n}prb")
def test_pss_chunk_matrices(n_rb, f):
    """The port's copy of the Toeplitz chunk matrices equals the
    reference's, at the frame length the port's kernel uses (64) and at
    the reference's (128)."""
    from lteax.kernels import pss as pss_ref
    from lteax_torch.kernels import pss
    from lteax_torch.phy.sync import pss_time_filters
    filt = pss_time_filters(PhyConfig(n_rb_dl=n_rb))
    ref = pss_ref._chunk_matrices(tuple(map(tuple, filt)), filt.shape[1], f)
    got = pss._chunk_matrices(filt, f)
    assert got.dtype == ref.dtype
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("k", [40, 1024, 5824])
def test_turbo_encode(k):
    bits = np.random.default_rng(k).integers(0, 2, (3, k))
    ref = np.stack([np.asarray(turbo_ref.turbo_encode(jnp.asarray(b), k))
                    for b in bits])
    np.testing.assert_array_equal(turbo.turbo_encode(bits, k), ref)


@pytest.mark.parametrize("n_rb", N_RBS, ids=lambda n: f"{n}prb")
def test_chest_plans(n_rb):
    cfg, cfg_r = PhyConfig(n_rb_dl=n_rb), RefPhyConfig(n_rb_dl=n_rb)
    for shift in range(6):
        np.testing.assert_array_equal(
            chest._freq_interp_matrix(cfg, shift),
            chest_ref._freq_interp_matrix(cfg_r, shift))
    syms = (0, 4, 7, 11)
    np.testing.assert_array_equal(chest._time_interp_matrix(cfg, syms),
                                  chest_ref._time_interp_matrix(cfg_r, syms))
    for cid, sf in ((214, 1), (7, 0)):
        np.testing.assert_array_equal(
            chest._crs_ref_values(cfg, cid, 0, sf),
            chest_ref._crs_ref_values(cfg_r, cid, 0, sf))


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
    x_r = np.asarray(s2s_ref(jnp.asarray(grid),
                             RefPhyConfig(n_rb_dl=n_rb)))
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


# -- the scanner slice's plans: sync sequences and filters, resampler bank,
#    convolutional code, PBCH masks, CRC16 --------------------------------

@pytest.mark.parametrize("n_rb", N_RBS, ids=lambda n: f"{n}prb")
def test_pss_time_filters(n_rb):
    from lteax.phy import sync as sync_ref
    from lteax_torch.phy import sync
    got = sync.pss_time_filters(PhyConfig(n_rb_dl=n_rb))
    ref = sync_ref.pss_time_filters(RefPhyConfig(n_rb_dl=n_rb))
    assert got.dtype == ref.dtype
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("n_id_2", [0, 1, 2])
def test_pss_sequence_and_sss_bank(n_id_2):
    np.testing.assert_array_equal(seq.pss_sequence(n_id_2),
                                  seq_ref.pss_sequence(n_id_2))
    for half in (False, True):
        got, ref = seq.sss_bank(n_id_2, half), seq_ref.sss_bank(n_id_2, half)
        assert got.dtype == ref.dtype
        np.testing.assert_array_equal(got, ref)
    assert [seq.sss_m0_m1(i) for i in range(168)] == \
        [seq_ref.sss_m0_m1(i) for i in range(168)]


@pytest.mark.parametrize("p,q", [(192, 125), (2, 3), (25, 24), (1, 10),
                                 (2, 1), (5, 4), (125, 192)])
def test_polyphase_bank_and_frame_weight(p, q):
    from lteax.kernels import polyphase as poly_ref
    from lteax_torch.kernels import polyphase
    np.testing.assert_array_equal(polyphase.design_polyphase(p, q),
                                  poly_ref.design_polyphase(p, q))
    np.testing.assert_array_equal(polyphase._frame_weight(p, q, 12),
                                  poly_ref._frame_weight(p, q, 12))


def test_conv_trellis_tables():
    from lteax.phy.fec import conv as conv_ref
    from lteax_torch.phy.fec import conv
    np.testing.assert_array_equal(conv._taps(), conv_ref._taps())
    for a, b in zip(conv.trellis_tables(), conv_ref.trellis_tables()):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("d_len,e_len", [(40, 1920), (40, 1728), (40, 480),
                                         (73, 216), (57, 144)])
def test_conv_rm_indices(d_len, e_len):
    np.testing.assert_array_equal(ratematch.conv_rm_indices(d_len, e_len),
                                  rm_ref.conv_rm_indices(d_len, e_len))


def test_pbch_ant_masks_and_crc16():
    from lteax.phy.channels import pbch as pbch_ref
    from lteax_torch.phy.channels import pbch
    assert pbch.ANT_MASKS.keys() == pbch_ref.ANT_MASKS.keys()
    for k in pbch.ANT_MASKS:
        np.testing.assert_array_equal(pbch.ANT_MASKS[k], pbch_ref.ANT_MASKS[k])
    np.testing.assert_array_equal(crc.crc_matrix(24, "16"),
                                  crc_ref.crc_matrix(24, "16"))


# -- the modules the port copies from the JAX package (it imports none of
#    them): configuration, grid maps, tables, segmentation, IQ files, EARFCN
#    helpers, the MIB, the channel model, checkpoint and metrics -----------

def _same(a, b):
    """Nested tuples / arrays / scalars equal, dtypes included."""
    if isinstance(a, (tuple, list)):
        assert type(a) is type(b) and len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    elif isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray) and a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    else:
        assert a == b and type(a) is type(b)


@pytest.mark.parametrize("n_rb", [6, 15, 25, 50, 75, 100],
                         ids=lambda n: f"{n}prb")
@pytest.mark.parametrize("n_ant", [1, 2, 4], ids=lambda n: f"{n}ant")
def test_phy_config_fields(n_rb, n_ant):
    from lteax.phy import config as config_ref
    from lteax_torch.phy import config
    cfg = PhyConfig(n_rb_dl=n_rb, n_ant=n_ant)
    cfg_r = RefPhyConfig(n_rb_dl=n_rb, n_ant=n_ant)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(cfg_r)
    for f in ("n_fft", "fs", "n_sc", "n_sym_slot", "n_sym_subframe",
              "cp_lengths_slot", "n_samps_slot", "n_samps_subframe",
              "n_samps_frame", "symbol_starts_subframe", "sc_to_fft_bin"):
        _same(getattr(cfg, f), getattr(cfg_r, f))
    assert config.subframe_grid_shape(cfg) == \
        config_ref.subframe_grid_shape(cfg_r)
    assert hash(cfg) == hash(PhyConfig(n_rb_dl=n_rb, n_ant=n_ant))


def test_phy_config_rejects_what_the_original_rejects():
    for kw in (dict(n_rb_dl=7), dict(n_ant=3)):
        with pytest.raises(Exception) as e_ref:
            RefPhyConfig(**kw)
        with pytest.raises(type(e_ref.value)):
            PhyConfig(**kw)


GRID_CELLS = [(6, 0, 1), (6, 301, 4), (15, 150, 2), (25, 7, 1), (50, 503, 2),
              (100, 214, 1), (100, 335, 4)]


@pytest.mark.parametrize("n_rb,cid,n_ant", GRID_CELLS)
def test_grid_index_functions(n_rb, cid, n_ant):
    from lteax.phy import grid as grid_ref
    from lteax_torch.phy import grid
    cfg = PhyConfig(n_rb_dl=n_rb, n_ant=n_ant)
    cfg_r = RefPhyConfig(n_rb_dl=n_rb, n_ant=n_ant)
    both = lambda name, *a: _same(getattr(grid, name)(cfg, *a),
                                  getattr(grid_ref, name)(cfg_r, *a))
    for name in ("pss_sym", "sss_sym", "sync_sc", "central72_sc"):
        both(name)
    for name in ("crs_reserved_mask", "pbch_flat_idx", "pcfich_reg_indices",
                 "pcfich_flat_idx"):
        both(name, cid)
    for port in range(n_ant):
        _same(grid.crs_symbols(port, cfg), grid_ref.crs_symbols(port, cfg_r))
        both("crs_flat_idx", cid, port)
        for l in (0, 1, 4):
            for ns in (0, 7, 19):
                assert grid._crs_v(port, l, ns) == grid_ref._crs_v(port, l, ns)
    for l in range(3):
        both("regs_in_symbol", l, cid)
    for ng in (1 / 6, 0.5, 1.0, 2.0):
        both("n_phich_groups", ng)
        both("phich_reg_indices", cid, ng)
        both("phich_flat_idx", cid, ng, 0)
    max_cfi = 3 if n_rb > 10 else 4
    for cfi in range(1 if n_rb > 10 else 2, max_cfi + 1):
        both("pdcch_reg_list", cid, cfi, 1.0)
        both("pdcch_flat_idx", cid, cfi, 1.0)
        prb_sets = (tuple(range(n_rb)), tuple(range(1, n_rb, 2)), (n_rb // 2,))
        for prbs in prb_sets:
            for sf in (0, 1, 5, 9):
                both("pdsch_flat_idx", cid, cfi, prbs, sf)


def test_qpp_tables_whole():
    from lteax.phy.tables import turbo_qpp as qpp_ref
    from lteax_torch.phy.tables import turbo_qpp as qpp
    assert qpp.QPP_TABLE == qpp_ref.QPP_TABLE and len(qpp.QPP_TABLE) == 188
    _same(qpp.VALID_K, qpp_ref.VALID_K)
    for k in qpp.VALID_K.tolist():
        _same(qpp.qpp_interleaver(k), qpp_ref.qpp_interleaver(k))
    for k in (40, 1008, 6144):
        _same(qpp.qpp_deinterleaver(k), qpp_ref.qpp_deinterleaver(k))
    for b in (1, 40, 41, 513, 2049, 6144):
        assert qpp.smallest_valid_k(b) == qpp_ref.smallest_valid_k(b)
    for bad, fn, fn_r in ((41, qpp.qpp_interleaver, qpp_ref.qpp_interleaver),
                          (6145, qpp.smallest_valid_k,
                           qpp_ref.smallest_valid_k)):
        with pytest.raises(Exception) as e_ref:
            fn_r(bad)
        with pytest.raises(type(e_ref.value)):
            fn(bad)


def test_tbs_tables_whole():
    from lteax.phy.tables import tbs as tbs_ref
    from lteax.phy.tables import tbs_full as full_ref
    from lteax_torch.phy.tables import tbs, tbs_full
    for name in (n for n in dir(full_ref) if n.isupper()):
        _same(getattr(tbs_full, name), getattr(full_ref, name))
    for mcs in range(29):
        assert tbs.mcs_to_qm_itbs(mcs) == tbs_ref.mcs_to_qm_itbs(mcs)
        for n_prb in range(1, 111):
            assert tbs.get_tbs_for_mcs(mcs, n_prb) == \
                tbs_ref.get_tbs_for_mcs(mcs, n_prb)
    for i_tbs in range(27):
        for n_prb in (1, 6, 25, 100, 110):
            assert tbs.get_tbs(i_tbs, n_prb) == tbs_ref.get_tbs(i_tbs, n_prb)
            assert tbs.get_tbs_provenance(i_tbs, n_prb) == \
                tbs_ref.get_tbs_provenance(i_tbs, n_prb)
        for n_1a in (2, 3):
            assert tbs.tbs_1a(i_tbs, n_1a) == tbs_ref.tbs_1a(i_tbs, n_1a)
    for n_bits in (100, 1000, 10000):
        assert tbs.pick_mcs_for_size(n_bits, 25) == \
            tbs_ref.pick_mcs_for_size(n_bits, 25)
    for mod in (tbs, tbs_ref):
        with pytest.raises(ValueError):
            mod.pick_mcs_for_size(20000, 25)


def test_segment_info_and_bits():
    from lteax.phy.fec import segmentation as seg_ref
    from lteax_torch.phy.fec import segmentation as seg
    sizes = [*range(40, 7000, 97), 6144, 6145, 12288, 12289, 36696, 75400,
             149776]
    rng = np.random.default_rng(0)
    for b in sizes:
        info, info_r = seg.segment_info(b), seg_ref.segment_info(b)
        assert dataclasses.asdict(info) == dataclasses.asdict(info_r)
        assert info.k_list == info_r.k_list and info.uniform == info_r.uniform
        assert seg.k_buckets(info) == seg_ref.k_buckets(info_r)
        if b > 20000 or b % 3:
            continue
        bits = rng.integers(0, 2, b).astype(np.int32)
        if info.uniform:
            blocks = seg.segment_bits(bits, info)
            _same(blocks, seg_ref.segment_bits(bits, info_r))
            _same(seg.desegment_bits(blocks, info),
                  seg_ref.desegment_bits(blocks, info_r))
        gen = seg.segment_bits_general(bits, info)
        _same(gen, seg_ref.segment_bits_general(bits, info_r))
        _same(seg.desegment_bits_general(gen, info),
              seg_ref.desegment_bits_general(gen, info_r))


@pytest.mark.parametrize("fmt", ["fc32", "sc8"])
def test_iq_files_round_trip(fmt, tmp_path):
    from lteax.io import iq as iq_ref
    from lteax_torch.io import iq
    rng = np.random.default_rng(4)
    x = ((rng.standard_normal(1000) + 1j * rng.standard_normal(1000)) * 0.2
         ).astype(np.complex64)
    assert np.abs(x.real).max() < 1 and np.abs(x.imag).max() < 1
    a, b = str(tmp_path / "port.bin"), str(tmp_path / "ref.bin")
    iq.write_iq(a, x, fmt)
    iq_ref.write_iq(b, x, fmt)
    assert Path(a).read_bytes() == Path(b).read_bytes()
    for kw in ({}, dict(count=100), dict(count=64, offset_samples=17)):
        got = iq.read_iq(a, fmt, **kw)
        _same(got, iq_ref.read_iq(b, fmt, **kw))
    back = iq.read_iq(a, fmt)
    if fmt == "fc32":
        np.testing.assert_array_equal(back, x)
    else:
        # written as round(127 x), read back over 128: half a step each way
        np.testing.assert_allclose(back, x * (127 / 128), atol=0.71 / 128)
    _same(iq.to_iq_f32(x), iq_ref.to_iq_f32(x))
    _same(iq.from_iq_f32(iq.to_iq_f32(x)), x)
    for mod in (iq, iq_ref):
        with pytest.raises(ValueError):
            mod.write_iq(a, x, "fc64")
        with pytest.raises(ValueError):
            mod.read_iq(a, "fc64")


@pytest.mark.parametrize("name", ["iq_reader.cc", "iq_tcp.cc"])
def test_native_sources_are_the_originals(name):
    """The port builds its own copy of the reference's C++ readers."""
    root = Path(__file__).resolve().parents[1]
    assert (root / "lteax_torch" / "native" / name).read_bytes() == \
        (root / "lteax" / "native" / name).read_bytes()


def test_iq_stagings_behave_as_the_originals():
    from lteax.io import iq as iq_ref
    from lteax_torch.io import iq
    rng = np.random.default_rng(5)
    x = ((rng.standard_normal((3, 700)) + 1j * rng.standard_normal((3, 700)))
         * 0.6).astype(np.complex64)
    b = iq.to_iq_bf16(x)
    assert isinstance(b, torch.Tensor) and b.shape == (3, 700, 2)
    np.testing.assert_array_equal(
        b.float().numpy(), np.asarray(iq_ref.to_iq_bf16(x), np.float32))
    for scale in (127.0, 90.0):
        _same(iq.to_iq_sc8(x, scale), iq_ref.to_iq_sc8(x, scale))
    _same(iq.chunk_subframes(x[0], 128, 3),
          iq_ref.chunk_subframes(x[0], 128, 3))
    assert iq.chunk_subframes(x[0], 128, 3).shape == (5, 128)


def test_earfcn_helpers():
    from lteax.stack import bands as bands_ref
    from lteax_torch.stack import bands
    assert [dataclasses.asdict(b) for b in bands.BANDS] == \
        [dataclasses.asdict(b) for b in bands_ref.BANDS]
    for earfcn in (0, 300, 599, 1575, 2525, 3100, 6300, 9500, 38000, 40000):
        assert bands.band_of_dl_earfcn(earfcn) == \
            bands_ref.band_of_dl_earfcn(earfcn)
        assert bands.dl_earfcn_to_freq_mhz(earfcn) == \
            bands_ref.dl_earfcn_to_freq_mhz(earfcn)
    for band in (1, 3, 7, 20, 38):
        assert bands.is_tdd_band(band) == bands_ref.is_tdd_band(band)
        assert bands.band_dl_earfcns(band) == bands_ref.band_dl_earfcns(band)
        e = bands.band_dl_earfcns(band)[1]
        f = bands.dl_earfcn_to_freq_mhz(e)
        assert bands.dl_freq_to_earfcn(band, f) == \
            bands_ref.dl_freq_to_earfcn(band, f) == e
    assert bands.ul_earfcn_for_dl(300) == bands_ref.ul_earfcn_for_dl(300)
    with pytest.raises(Exception) as e_ref:
        bands_ref.band_of_dl_earfcn(70000)
    with pytest.raises(type(e_ref.value)):
        bands.band_of_dl_earfcn(70000)


@pytest.mark.parametrize("n_rb", [6, 15, 25, 50, 75, 100])
def test_mib_bits(n_rb):
    from lteax.stack import rrc as rrc_ref
    from lteax_torch.stack import rrc
    for ext, res, sfn in ((False, 1.0, 0), (True, 1 / 6, 1023),
                          (False, 0.5, 517), (True, 2.0, 256)):
        m = rrc.Mib(n_rb, ext, res, sfn)
        bits = rrc.pack_mib(m)
        _same(bits, rrc_ref.pack_mib(rrc_ref.Mib(n_rb, ext, res, sfn)))
        assert bits.shape == (24,)
        for mod4 in range(4):
            got = rrc.unpack_mib(bits, mod4)
            assert dataclasses.asdict(got) == dataclasses.asdict(
                rrc_ref.unpack_mib(bits, mod4))
        assert rrc.unpack_mib(bits, sfn & 3) == m


def test_awgn_on_the_same_generator():
    from lteax.sim import channel as channel_ref
    from lteax_torch.sim import channel
    x = np.exp(1j * np.arange(500)).astype(np.complex64) * 0.5
    for snr_db in (0.0, 17.5):
        _same(channel.awgn(np.random.default_rng(9), x, snr_db),
              channel_ref.awgn(np.random.default_rng(9), x, snr_db))
    assert channel.PROFILES == channel_ref.PROFILES
    for profile in channel.PROFILES:
        got = channel.fade_and_awgn(np.random.default_rng(2), x, profile,
                                    30.72e6, 20.0)
        _same(got, channel_ref.fade_and_awgn(np.random.default_rng(2), x,
                                             profile, 30.72e6, 20.0))


def test_checkpoint_and_metrics_behave_as_the_originals(tmp_path):
    from lteax.utils import checkpoint as ck_ref
    from lteax.utils import metrics as metrics_ref
    from lteax_torch.utils import checkpoint as ck
    from lteax_torch.utils import metrics
    files = []
    for mod, name in ((ck, "port.json"), (ck_ref, "ref.json")):
        c = mod.ScanCheckpoint(str(tmp_path / name))
        c.record("a", {"n_cell_id": 7})
        c.record("b", {"detected": False})
        c = mod.ScanCheckpoint(str(tmp_path / name))       # reload
        assert c.done("a") and not c.done("c")
        assert c.result("a") == {"n_cell_id": 7} and c.result("c") is None
        assert c.pending(["a", "c", "b", "d"]) == ["c", "d"]
        files.append((tmp_path / name).read_text())
    assert files[0] == files[1]
    snaps = []
    for mod in (metrics, metrics_ref):
        m = mod.Metrics()
        m.inc("subframes", 3)
        m.inc("subframes")
        m.gauge("snr_db", 12.5)
        snap = m.snapshot()
        assert snap["counters"] == {"subframes": 4.0}
        assert snap["gauges"] == {"snr_db": 12.5}
        assert m.rate("subframes") > 0 and m.rate("none") == 0
        snaps.append(set(snap))
        seen = []
        log = mod.EventLog(level="info")
        log.subscribe(seen.append)
        log.emit("cell_found", n_cell_id=3)
        log.emit("noise", level="debug")
        log.set_types({"scan"})
        log.emit("cell_found")
        log.emit("scan.cell", n_cell_id=4)
        recs = [json.loads(line) for line in seen]
        assert [(r["event"], r["n_cell_id"]) for r in recs] == \
            [("cell_found", 3), ("scan.cell", 4)]
        with pytest.raises(ValueError):
            log.set_level("loud")
        assert mod.throughput_meter(10 ** 6, 0.5)["mbit_per_s"] == 2.0
    assert snaps[0] == snaps[1]
    assert metrics.LEVELS == metrics_ref.LEVELS
    assert isinstance(metrics.METRICS, metrics.Metrics)
    assert isinstance(metrics.EVENTS, metrics.EventLog)


# -- the UL slice's plans --------------------------------------------------

@pytest.mark.parametrize("cid,ns,m_sc", [(214, 8, 1200), (214, 9, 1200),
                                         (0, 0, 36), (301, 5, 72),
                                         (503, 19, 180), (17, 18, 96)])
def test_dmrs_pusch(cid, ns, m_sc):
    from lteax.phy.channels import pusch as pusch_ref
    from lteax_torch.phy.channels import pusch
    for kw in ({}, dict(group_hopping=True), dict(delta_ss=7, n_dmrs=3)):
        _same(pusch.dmrs_pusch(cid, ns, m_sc, **kw),
              pusch_ref.dmrs_pusch(cid, ns, m_sc, **kw))
    assert pusch.group_hopping_pattern(cid, ns) == \
        pusch_ref.group_hopping_pattern(cid, ns)
    for u in (0, 13, 29):
        for v in (0, 1):
            _same(pusch.base_sequence(u, m_sc, v),
                  pusch_ref.base_sequence(u, m_sc, v))


@pytest.mark.parametrize("n_prb,qm", [(6, 2), (8, 2), (6, 4), (15, 6),
                                      (100, 6)])
def test_pusch_interleaver_taps_and_alloc(n_prb, qm):
    from lteax.phy.channels import pusch as pusch_ref
    from lteax_torch.phy.channels import pusch
    assert (pusch.DMRS_SYMS, pusch.N_DATA_SYMS) == \
        (pusch_ref.DMRS_SYMS, pusch_ref.N_DATA_SYMS)
    g = 12 * 12 * n_prb * qm
    idx = pusch.channel_interleaver_idx(g, qm)
    _same(idx, pusch_ref.channel_interleaver_idx(g, qm))
    assert sorted(idx.tolist()) == list(range(g))
    _same(pusch.chest_taps(12 * n_prb), pusch_ref.chest_taps(12 * n_prb))
    tbs = {6: 1192, 8: 1096, 15: 11064, 100: 75376}[n_prb]
    a = pusch.PuschAlloc(n_prb, 0, tbs, qm)
    a_r = pusch_ref.PuschAlloc(n_prb, 0, tbs, qm)
    assert (a.m_sc, a.n_re, a.scheme) == (a_r.m_sc, a_r.n_re, a_r.scheme)
    assert dataclasses.asdict(a.geom) == dataclasses.asdict(a_r.geom)
    for rnti, sf, cid in ((0x3D, 4, 214), (0xFFFF, 9, 503)):
        assert pusch.pusch_c_init(rnti, sf, cid) == \
            int(pusch_ref._c_init(rnti, sf, cid))
    with pytest.raises(ValueError):
        pusch.channel_interleaver_idx(g + qm, qm)


@pytest.mark.parametrize("n_prb,qm,tbs", [(6, 2, 712), (8, 2, 1096),
                                          (6, 4, 1192), (15, 6, 11064),
                                          (100, 6, 75376)])
def test_ul_rm_inv_planar_and_sign_planes(n_prb, qm, tbs):
    from lteax.kernels import demap as demap_ref
    from lteax.shard.pipeline import _ul_rm_inv_planar
    from lteax_torch.kernels import demap
    from lteax_torch.pipeline import ul_rm_inv_planar
    m_sc = 12 * n_prb
    geom = pdsch.pdsch_geometry(tbs, 12 * m_sc, qm, 0)
    geom_r = pdsch_ref.pdsch_geometry(tbs, 12 * m_sc, qm, 0)
    npad = -(-(12 * m_sc) // 128) * 128
    got = ul_rm_inv_planar(geom, qm, m_sc, npad)
    assert got.shape[0] == 1                  # injective: one cycle
    got = got[0]
    _same(got, _ul_rm_inv_planar(geom_r, qm, m_sc, npad))
    # transmitted positions read inside the planes, each once; the rest
    # read the appended zero column, never a pad column
    inside = got[got < qm * npad]
    assert len(np.unique(inside)) == len(inside) == geom.g
    assert (inside % npad < 12 * m_sc).all()
    assert (got[got >= qm * npad] == qm * npad).all()
    c_init = 0x3D * 2 ** 14 + 4 * 512 + 214
    _same(demap.planar_sgn_np(c_init, geom.g, qm, npad),
          demap_ref.planar_sgn_np(c_init, geom_r.g, qm, npad))


@pytest.mark.parametrize("rv", [0, 1, 2, 3])
@pytest.mark.parametrize("d_len,e_len", [(5828, 6516), (44, 100),
                                         (1028, 2000), (6148, 7000)])
def test_turbo_rm_indices_every_rv(d_len, e_len, rv):
    np.testing.assert_array_equal(ratematch.turbo_rm_indices(d_len, e_len, rv),
                                  rm_ref.turbo_rm_indices(d_len, e_len, rv))


@pytest.mark.parametrize("m_sc", [72, 96, 180, 1200])
def test_ul_dft_and_chest_denoise(m_sc):
    """torch.fft against the reference's fft forms: rtol/atol 1e-5 on
    unit-power values (the two FFTs sum in different orders)."""
    from lteax.phy.channels import pusch as pusch_ref
    from lteax_torch.phy.channels import pusch
    rng = np.random.default_rng(m_sc)
    x = ((rng.standard_normal((3, m_sc)) + 1j * rng.standard_normal((3, m_sc)))
         / np.sqrt(2)).astype(np.complex64)
    mp = pytest.MonkeyPatch()
    mp.setenv("LTEAX_UL_DFT", "fft")
    try:
        for inverse in (False, True):
            got = pusch.ul_dft(torch.from_numpy(x), inverse).numpy()
            ref = np.asarray(pusch_ref._ul_dft(jnp.asarray(x), inverse))
            np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
    finally:
        mp.undo()
    taps = torch.from_numpy(pusch.chest_taps(m_sc))
    np.testing.assert_allclose(
        pusch.chest_denoise(torch.from_numpy(x), taps).numpy(),
        np.asarray(pusch_ref.chest_denoise(jnp.asarray(x))),
        rtol=1e-5, atol=1e-5)
    back = pusch.ul_dft(pusch.ul_dft(torch.from_numpy(x), False), True)
    np.testing.assert_allclose(back.numpy(), x, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("mcs,rvs", [(9, (0, 2)), (9, (0, 1, 2, 3)),
                                     (17, (0, 2))])
def test_harq_transmissions_match_reference_encoder(mcs, rvs):
    """Each (re)transmission carries the reference encoder's symbols of the
    same codeblocks at its own subframe and rv."""
    cell = dl_gen.DlCell(n_rb_dl=6, n_cell_id=150, mcs=mcs, cfi=2)
    sfs = tuple(range(1, 1 + len(rvs)))
    iq, tb, cells = dl_gen.harq_transmissions(cell, sfs, rvs, 3, 30.0, seed=8,
                                              max_unique=2)
    assert iq.shape[:2] == (len(rvs), 3)
    np.testing.assert_array_equal(tb[2], tb[0])
    cbs = np.stack([dl_gen.pdsch_prepare_cbs(t, cell.geom) for t in tb[:2]])
    for c in cells:
        g = c.geom
        geom_r = pdsch_ref.pdsch_geometry(g.tbs, g.n_re, g.qm, g.rv)
        syms = dl_gen.pdsch_encode_cbs(cbs, g, c.rnti, c.subframe,
                                       c.n_cell_id, c.scheme)
        syms_r = np.stack([np.asarray(pdsch_ref.pdsch_encode_cbs(
            jnp.asarray(cb), geom_r, c.rnti, c.subframe, c.n_cell_id,
            c.scheme)) for cb in cbs])
        np.testing.assert_array_equal(syms, syms_r)


def test_mimo_codebooks_and_cdd_sign():
    from lteax.phy import mimo as mimo_ref
    from lteax_torch.phy import mimo
    for mine, ref in ((mimo.CODEBOOK_2TX_1L, mimo_ref.CODEBOOK_2TX_1L),
                      (mimo.CODEBOOK_2TX_2L, mimo_ref.CODEBOOK_2TX_2L)):
        assert len(mine) == len(ref)
        for a, r in zip(mine, ref):
            assert a.dtype == r.dtype
            np.testing.assert_array_equal(a, r)
    for n in (1, 2, 7, 14400):
        got, ref = mimo._cdd_sign(n), mimo_ref._cdd_sign(n)
        assert got.dtype == ref.dtype
        np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("k", [40, 6144])
def test_rsc_matrix(k):
    from lteax.phy.fec import reencode as reencode_ref
    from lteax_torch.phy.fec import reencode
    got, ref = reencode._rsc_matrix(k), reencode_ref._rsc_matrix(k)
    assert got.dtype == ref.dtype and got.shape == (k, k + 6)
    np.testing.assert_array_equal(got, ref)
    for s in range(8):
        assert reencode._rsc_tails_np(s) == reencode_ref._rsc_tails_np(s)
        for b in (0, 1):
            assert reencode._rsc_step_np(s, b) == reencode_ref._rsc_step_np(s, b)


@pytest.mark.parametrize("n_rb", N_RBS, ids=lambda n: f"{n}prb")
def test_wiener_matrices(n_rb):
    """The MMSE chest's correlations and host-inverted Wiener matrices."""
    cfg, cfg_r = PhyConfig(n_rb_dl=n_rb, n_ant=2), \
        RefPhyConfig(n_rb_dl=n_rb, n_ant=2)
    for shift, tau, nv in ((0, 5.0, 3e-3), (3, 5.0, 1e-2), (5, 2.5, 3e-3)):
        for a, r in zip(chest._mmse_pilot_corr(cfg, shift, tau),
                        chest_ref._mmse_pilot_corr(cfg_r, shift, tau)):
            np.testing.assert_array_equal(a, r)
        got = chest._wiener_matrix(cfg, shift, tau, nv)
        ref = chest_ref._wiener_matrix(cfg_r, shift, tau, nv)
        assert got.dtype == ref.dtype == np.complex64
        np.testing.assert_array_equal(got, ref)


# -- SI and paging: RRC codecs, DCI 1A / 1C, PCFICH, PDCCH plans -------------

def _sib_bodies(m):
    """SIB3..SIB13 bodies with their optional fields set, built with the
    RRC module ``m`` (the reference's or the port's; test_stack.py's)."""
    return (
        m.Sib3(q_hyst_db=8, s_non_intra_search=None, p_max=23,
               s_intra_search=12, allowed_meas_bandwidth=5,
               presence_antenna_port1=True, neigh_cell_config=2,
               speed_state=m.SpeedStateReselectionPars(
                   m.MobilityStateParameters(1, 2, 3, 16), 0, 2),
               t_resel_eutra_sf=m.SpeedStateScaleFactors(1, 2)),
        m.Sib4(neigh_cells=(m.IntraFreqNeighCell(503, -24),
                            m.IntraFreqNeighCell(7, 24)),
               black_cells=(m.PhysCellIdRange(100, 12),
                            m.PhysCellIdRange(400, None)),
               csg_pci_range=m.PhysCellIdRange(0, 504)),
        m.Sib5(carriers=(
            m.InterFreqCarrier(dl_earfcn=6400, p_max=10,
                               cell_resel_priority=3, q_offset_freq_db=-6,
                               neigh_cells=(m.InterFreqNeighCell(44, 2),),
                               black_cells=(m.PhysCellIdRange(5, 8),)),
            m.InterFreqCarrier(dl_earfcn=65535))),
        m.Sib6(carriers_fdd=(m.UtraCarrierFdd(10713, cell_resel_priority=2,
                                              q_qual_min=-24),),
               carriers_tdd=(m.UtraCarrierTdd(11504),), t_resel_utra_s=3,
               t_resel_utra_sf=m.SpeedStateScaleFactors(0, 1)),
        m.Sib7(t_resel_geran_s=2, carriers=(
            m.GeranCarrierInfo(freqs=m.GeranCarrierFreqs(
                512, 1, explicit_arfcns=(1, 2, 1023)),
                cell_resel_priority=1, q_rx_lev_min=45, p_max_geran=39),
            m.GeranCarrierInfo(freqs=m.GeranCarrierFreqs(
                0, 0, equally_spaced=(8, 31))),
            m.GeranCarrierInfo(freqs=m.GeranCarrierFreqs(
                99, 0, bitmap=b"\xa5\x5a")))),
        m.Sib8(cdma_eutra_sync=True, system_time=(1 << 39) - 5,
               search_window_size=9,
               pre_reg_hrpd=m.PreRegistrationInfoHrpd(True, 200, (1, 2)),
               cell_resel_hrpd=m.CellReselParamsCdma(
                   band_class_list=(m.BandClassInfoCdma(17, 4, 63, 0),),
                   neigh_cell_list=(m.NeighCellCdma(
                       1, (m.NeighCellsPerBandclassCdma(2047, (0, 511)),)),),
                   t_resel_s=5),
               params_1xrtt=True,
               csfb_1xrtt=m.CsfbRegistrationParam1xrtt(
                   sid=0x7FFF, nid=0xFFFF, home_reg=True, power_up_reg=True,
                   registration_zone=0xABC, zone_timer=5),
               long_code_state_1xrtt=(1 << 42) - 3),
        m.Sib9(hnb_name=b"cell-one"),
        m.Sib10(message_identifier=0x1100, serial_number=0x3000,
                warning_type=b"\x01\x80",
                warning_security_info=bytes(range(50))),
        m.Sib11(message_identifier=0x1102, serial_number=0x3001,
                last_segment=False, segment_number=2,
                warning_segment=b"quake warning segment",
                data_coding_scheme=b"\x01"),
        m.Sib12(message_identifier=0x1112, serial_number=0x3000,
                last_segment=False, segment_number=3,
                warning_segment=b"CMAS presidential alert",
                data_coding_scheme=b"\x01"),
        m.Sib13(areas=(m.MbsfnAreaInfo(
            mbsfn_area_id=5, non_mbsfn_region_length=2,
            notification_indicator=3, mcch_repetition_period_rf=128,
            mcch_offset=7, mcch_modification_period_rf=1024,
            sf_alloc_info=0b101010, signalling_mcs=13),
            m.MbsfnAreaInfo(mbsfn_area_id=200)),
            notification=m.MbmsNotificationConfig(4, 10, 6)))


def _asdicts(pairs):
    return [(k, dataclasses.asdict(v)) for k, v in pairs]


def test_rrc_sib1_sib2_paging_codecs():
    """The reference's own SIB1, SIB2 and Paging bits unpack in the port to
    the same messages, and the port packs the same bits."""
    from lteax.stack import rrc as rrc_ref
    from lteax_torch.stack import rrc
    sib1 = lambda m: m.Sib1(mcc=(2, 6, 2), mnc=(0, 1, 5), tac=0xBEEF,
                            cell_identity=0xABCDEF1, cell_barred=True,
                            q_rx_lev_min=-64, freq_band_indicator=20,
                            si_window_ms=40,
                            scheduling=(m.SchedulingInfo(16, (3, 4)),
                                        m.SchedulingInfo(32, (5,))))
    b = rrc_ref.pack_sib1(sib1(rrc_ref))
    _same(rrc.pack_sib1(sib1(rrc)), b)
    assert dataclasses.asdict(rrc.unpack_sib1(b)) == \
        dataclasses.asdict(rrc_ref.unpack_sib1(b))
    s2_ref = rrc_ref.Sib2(number_of_ra_preambles=11, t300=2, ul_bandwidth=5)
    s2 = rrc.Sib2(number_of_ra_preambles=11, t300=2, ul_bandwidth=5)
    b = rrc_ref.pack_sib2(s2_ref)
    _same(rrc.pack_sib2(s2), b)
    assert _asdicts(rrc.unpack_si_list(b)) == \
        _asdicts(rrc_ref.unpack_si_list(b))
    assert dataclasses.asdict(rrc.unpack_si(b)[1]) == \
        dataclasses.asdict(s2_ref)
    for ids, sim in (((0xDEADBEEF, 0x12345678), True),
                     (((0xA5 << 32) | 0xDEADBEEF,), False)):
        b = rrc_ref.pack_paging(rrc_ref.Paging(ue_identities=ids,
                                               system_info_modification=sim))
        _same(rrc.pack_paging(rrc.Paging(ue_identities=ids,
                                         system_info_modification=sim)), b)
        assert dataclasses.asdict(rrc.unpack_paging(b)) == \
            dataclasses.asdict(rrc_ref.unpack_paging(b))
    assert rrc.unpack_paging(rrc.pack_paging(rrc.Paging())) is None
    assert rrc.unpack_sib1(rrc.pack_sib2(s2)) is None
    _same(rrc.pad_to(b, 200), rrc_ref.pad_to(b, 200))


@pytest.mark.parametrize("split", [1, 3, 12])
def test_rrc_sibs_codecs(split):
    """SIB2..SIB13 in SystemInformation messages of ``split`` SIBs: the
    same bits from both packers, the same bodies from both unpackers."""
    from lteax.stack import rrc as rrc_ref
    from lteax_torch.stack import rrc
    ref = (rrc_ref.Sib2(),) + _sib_bodies(rrc_ref)
    got = (rrc.Sib2(),) + _sib_bodies(rrc)
    for i in range(0, len(ref), split):
        b = rrc_ref.pack_si(*ref[i:i + split])
        _same(rrc.pack_si(*got[i:i + split]), b)
        padded = rrc_ref.pad_to(b, len(b) + 37)
        assert _asdicts(rrc.unpack_si_list(padded)) == \
            _asdicts(rrc_ref.unpack_si_list(padded))
        assert [k for k, _ in rrc.unpack_si_list(b)] == \
            [k for k, _ in rrc_ref.unpack_si_list(b)]


def test_uper_primitives():
    from lteax.stack import uper as uper_ref
    from lteax_torch.stack import uper
    outs = []
    for m in (uper_ref, uper):
        w = m.UperWriter()
        w.bit(1)
        w.cint(37, 3, 250)
        w.enum(2, 5)
        w.length(7, 1, 16)
        w.bitstring(0xBEEF, 16)
        w.small_index(9)
        w.open_type([1, 0, 1])
        outs.append(w.array())
    _same(outs[1], outs[0])
    r = uper.UperReader(outs[0])
    assert (r.bit(), r.cint(3, 250), r.enum(5), r.length(1, 16),
            r.bitstring(16), r.small_index()) == (1, 37, 2, 7, 0xBEEF, 9)


@pytest.mark.parametrize("n_rb", [6, 15, 25, 50, 75, 100])
def test_dci_1a_1c_codecs(n_rb):
    """Pack and unpack over a grid of allocations and fields: the same
    sizes, RIVs, bits and messages as the reference's."""
    from lteax.phy.channels import dci as dci_ref
    from lteax_torch.phy.channels import dci
    assert dci.dci_1a_size(n_rb) == dci_ref.dci_1a_size(n_rb)
    assert dci.dci_1c_size(n_rb) == dci_ref.dci_1c_size(n_rb)
    assert dci._n_rb_step(n_rb) == dci_ref._n_rb_step(n_rb)
    assert dci.TBS_1C == dci_ref.TBS_1C
    rng = np.random.default_rng(n_rb)
    for _ in range(12):
        l_crb = int(rng.integers(1, n_rb + 1))
        start = int(rng.integers(0, n_rb - l_crb + 1))
        assert dci.riv_encode(n_rb, start, l_crb) == \
            dci_ref.riv_encode(n_rb, start, l_crb)
        f = dict(rb_start=start, l_crb=l_crb, mcs=int(rng.integers(32)),
                 rv=int(rng.integers(4)), harq=int(rng.integers(8)),
                 ndi=int(rng.integers(2)), tpc=int(rng.integers(4)),
                 distributed=bool(rng.integers(2)))
        b = dci_ref.dci_1a_pack(dci_ref.Dci1A(**f), n_rb)
        _same(dci.dci_1a_pack(dci.Dci1A(**f), n_rb), b)
        got = dci.dci_1a_unpack(b, n_rb)
        assert dataclasses.asdict(got) == dataclasses.asdict(
            dci_ref.dci_1a_unpack(b, n_rb))
        assert got.n_prb_1a == dci_ref.dci_1a_unpack(b, n_rb).n_prb_1a
        ndl = n_rb // dci._n_rb_step(n_rb)
        l1c = int(rng.integers(1, ndl + 1))
        f = dict(rb_start=int(rng.integers(0, ndl - l1c + 1)), l_crb=l1c,
                 i_tbs=int(rng.integers(32)),
                 gap=int(rng.integers(2)) if n_rb >= 50 else 0)
        b = dci_ref.dci_1c_pack(dci_ref.Dci1C(**f), n_rb)
        _same(dci.dci_1c_pack(dci.Dci1C(**f), n_rb), b)
        got = dci.dci_1c_unpack(b, n_rb)
        assert dataclasses.asdict(got) == dataclasses.asdict(
            dci_ref.dci_1c_unpack(b, n_rb))
        assert got.tbs() == dci_ref.dci_1c_unpack(b, n_rb).tbs()
        noise = rng.integers(0, 2, len(b)).astype(np.int32)
        for unpack, unpack_ref in ((dci.dci_1c_unpack, dci_ref.dci_1c_unpack),
                                   (dci.dci_1a_unpack, dci_ref.dci_1a_unpack)):
            bits = noise if unpack is dci.dci_1c_unpack else \
                rng.integers(0, 2, dci.dci_1a_size(n_rb)).astype(np.int32)
            a, r = unpack(bits, n_rb), unpack_ref(bits, n_rb)
            assert (a is None) == (r is None)
            if a is not None:
                assert dataclasses.asdict(a) == dataclasses.asdict(r)


@pytest.mark.parametrize("cid", [0, 77, 404, 503])
def test_pcfich_codewords_and_scrambling(cid):
    from lteax.phy.channels import pcfich as pcfich_ref
    from lteax_torch.phy.channels import pcfich
    _same(pcfich.cfi_codewords(), pcfich_ref.cfi_codewords())
    for sf in (0, 5, 9):
        assert pcfich._c_init(cid, sf) == pcfich_ref._c_init(cid, sf)
        for cfi in (1, 2, 3):
            np.testing.assert_array_equal(
                pcfich.pcfich_encode(cfi, cid, sf),
                np.asarray(pcfich_ref.pcfich_encode(cfi, cid, sf)))


@pytest.mark.parametrize("n_rb,n_ant,cid", [(6, 1, 77), (6, 4, 1),
                                            (15, 2, 150), (100, 2, 404)])
def test_pdcch_plans_and_encoder(n_rb, n_ant, cid):
    """Quadruplet permutation, CCE count, search spaces, and the encoded
    per-port symbols of an SI-RNTI and a P-RNTI grant."""
    from lteax.phy.channels import pdcch as pdcch_ref
    from lteax_torch.phy.channels import dci, pdcch
    from lteax_torch.phy.grid import pdcch_reg_list
    cfg, cfg_r = PhyConfig(n_rb_dl=n_rb, n_ant=n_ant), \
        RefPhyConfig(n_rb_dl=n_rb, n_ant=n_ant)
    for cfi in (1, 2, 3):
        for ng in (1 / 6, 1.0, 2.0):
            n = pdcch.n_cce(cfg, cid, cfi, ng)
            assert n == pdcch_ref.n_cce(cfg_r, cid, cfi, ng)
            m = len(pdcch_reg_list(cfg, cid, cfi, ng))
            _same(pdcch.quad_permutation(m, cid),
                  pdcch_ref.quad_permutation(m, cid))
            for rnti, sf in ((0xFFFF, None), (0x4601, 3)):
                assert pdcch.search_candidates(n, rnti, sf) == \
                    pdcch_ref.search_candidates(n, rnti, sf)
    _same(pdcch.rnti_mask(0xFFFE), pdcch_ref.rnti_mask(0xFFFE))
    cfi = 4 if n_rb <= 10 else 2             # control symbols
    dcis = [(dci.dci_1c_pack(dci.Dci1C(0, 2, 9), n_rb), 0xFFFF, 0, 4)]
    if pdcch.n_cce(cfg, cid, cfi, 1.0) >= 8:
        dcis.append((dci.dci_1a_pack(dci.Dci1A(0, 3, 5, 1), n_rb), 0xFFFE,
                     4, 4))
    got = pdcch.pdcch_encode(dcis, cfg, cid, cfi, 1.0, 5, n_ant=n_ant)
    ref = np.asarray(pdcch_ref.pdcch_encode(dcis, cfg_r, cid, cfi, 1.0, 5,
                                            n_ant=n_ant))
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)
    phys = torch.from_numpy(got[0])
    logical = pdcch.unpermute_to_logical(phys, cfg, cid, cfi, 1.0).numpy()
    np.testing.assert_array_equal(logical, np.asarray(
        pdcch_ref.unpermute_to_logical(jnp.asarray(got[0]), cfg_r, cid, cfi,
                                       1.0)))


@pytest.mark.parametrize("d_total,e_len", [(540, 1656), (1308, 1584),
                                           (900, 700)])
def test_unmatch_inv_cycles(d_total, e_len):
    idx = np.random.default_rng(e_len).integers(0, d_total, e_len
                                                ).astype(np.int32)
    _same(ratematch.unmatch_inv_cycles(idx, d_total),
          rm_ref.unmatch_inv_cycles(idx, d_total))


# -- UE-specific control, PHICH, UCI on PUSCH, the 1-PRB base sequence -------

def test_pucch_phi_m12_table():
    """The length-12 base-sequence phase table (36.211 Table 5.5.1.2-1)."""
    from lteax.phy.channels import pucch as pucch_ref
    from lteax_torch.phy.channels import pucch
    _same(pucch.PHI_M12, pucch_ref.PHI_M12)
    assert len(pucch.PHI_M12) == 30 and {len(r) for r in pucch.PHI_M12} == {12}


@pytest.mark.parametrize("cid,sf", [(0, 0), (137, 5), (503, 9)])
def test_phich_tables(cid, sf):
    """The orthogonal sequences, the scrambler init and the port's
    despread matrix (each column the per-call decode's weights)."""
    from lteax.phy.channels import phich as phich_ref
    from lteax_torch.phy.channels import phich
    _same(phich.W_SEQS, phich_ref.W_SEQS)
    assert phich.N_SF == phich_ref.N_SF
    assert phich._c_init(cid, sf) == phich_ref._c_init(cid, sf)
    m = phich.despread_matrix(cid, sf)
    eye = np.eye(12, dtype=np.complex64)
    for s in range(8):
        want = [phich_ref.phich_group_decode(e, cid, sf, s) for e in eye]
        np.testing.assert_allclose(m[:, s].real, want, rtol=0, atol=1e-6)


def test_dci_and_uci_constants():
    from lteax.phy.channels import dci as dci_ref
    from lteax.phy.channels import pusch as pusch_ref
    from lteax_torch.phy.channels import dci, pusch
    assert dci.AMBIGUOUS_SIZES == dci_ref.AMBIGUOUS_SIZES
    assert dci.TBS_1C == dci_ref.TBS_1C
    assert (pusch.RI_COLS, pusch.ACK_COLS) == (pusch_ref.RI_COLS,
                                               pusch_ref.ACK_COLS)
    assert dataclasses.asdict(pusch.PuschUci()) == \
        dataclasses.asdict(pusch_ref.PuschUci())
    for n in (1, 2):
        for n_coded in (3, 8, 30):
            _same(pusch._hypothesis_signs(n, n_coded), np.stack(
                [1.0 - 2.0 * pusch_ref._uci_word(
                    tuple((h >> i) & 1 for i in range(n)), n_coded)
                 for h in range(2 ** n)]).astype(np.float32))
