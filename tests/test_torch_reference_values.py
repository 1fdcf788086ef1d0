"""The reference's last tuning values in the port, against the JAX
reference in interpret mode (``lteax.phy.tuning.DecoderTuning``):

- ``fused: false`` and acq > win/2: the unfused K2 kernel
  (``half_iteration_pallas(fused=False)``, the body ``_make_kernel``) bit
  for bit (l, a_next, b_next) in f32, bf16 and bf16_f32store, at win 36
  (renormalised every 4 steps over the whole window) and at acq 96 of
  win 128;
- ``blane_unroll`` 1 and 2: the layout kernel's bf16 renormalisation
  (``half_iteration_blane(unroll=...)``) bit for bit;
- DL decodes under ``fused: false`` (``SHIPPED`` with cuFFT), under
  ``layout_glue: false`` (bf16, the natural path) and under
  ``blane_unroll: 2`` (the layout path), each against the reference's
  turbo stage on the port's own de-matched LLRs: bits, CRC flags and the
  iteration count equal;
- ``pallas_demap: false``: the XLA-order demap stage (``demodulate_maxlog``
  divided by the effective noise, times the descramble signs, rounded to
  the LLR dtype, ``soft_dematch``) against the reference's functions on
  the same symbols, exactly in 16QAM and 64QAM and within 2 f32 ulp of
  the largest LLR in QPSK, where XLA:CPU contracts the difference of
  squared distances into a fused multiply-add; the DL (bf16), UL (f32),
  TM3 MMSE and HARQ (bf16) fronts against the reference's XLA fronts, within
  the OFDM / SC-FDMA FFTs' rounding (one bf16 ulp of the largest LLR,
  or 1e-5 of it in f32, zeros in the same places), and each front off
  the demap kernel's rounding;
- ``planar_int8`` with ``ul_planar_boundary`` / ``mimo_planar_boundary``
  off: that front's LLRs stay unquantized, and the decode equals the
  reference's turbo stage for the front without its planar boundary.

Torch runs on one thread; the reference at 6 PRB, B = 2, K <= 640 in the
kernels and the DL decodes (K 736 in UL, 1760 in TM3), three iterations.
Its cost is compiles: a kernel form ~8 s, a turbo stage 10-20 s."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lteax.kernels.turbo_mlm import (_pin_boundaries, half_iteration_blane,
                                     half_iteration_pallas)
from lteax.phy import mod as mod_ref
from lteax.phy.channels import pdsch as pdsch_ref
from lteax.phy.channels import pusch as pusch_ref
from lteax.phy.config import PhyConfig as RefPhyConfig
from lteax.phy.tuning import DecoderTuning as RefTuning
from lteax.shard.pipeline import _mimo_stages, _pdsch_stages, _pusch_stages

import lteax_torch.kernels.turbo_mlm as tm
from lteax_torch.phy import seq
from lteax_torch.phy.channels import pusch
from lteax_torch.phy.channels.pdsch import _global_rm_cycles
from lteax_torch.phy.tuning import SHIPPED, DecoderTuning
from lteax_torch.pipeline import (XlaDemap, make_batch_decoder,
                                  make_batch_harq_decoder,
                                  make_mimo_batch_decoder,
                                  make_pusch_batch_decoder)
from lteax_torch.sim import ul_gen
from lteax_torch.sim.dl_gen import (DlCell, dl_subframes, harq_decoder_args,
                                    harq_transmissions)
from lteax_torch.sim.mimo_gen import MimoCell, decoder_rows, mimo_subframes

torch.set_num_threads(1)

WIN, ACQ = 128, 16
N_ITER = 3
REF = dict(mdtype="bf16", demap_in="bf16", ofdm_dft="fft", ul_dft="fft",
           print_iters=True)
SHIPPED_FFT = dataclasses.replace(SHIPPED, ofdm_dft="fft")


@pytest.fixture(scope="module", autouse=True)
def _fft_reference():
    """The reference reads its DFT forms (and ``blane_unroll``) from the
    environment when it traces."""
    mp = pytest.MonkeyPatch()
    mp.setenv("LTEAX_OFDM_DFT", "fft")
    mp.setenv("LTEAX_UL_DFT", "fft")
    yield
    mp.undo()


def _half_inputs(k: int, win: int, c: int = 3):
    n = k + 3
    n_w = -(-n // win)
    rng = np.random.default_rng(k + win)
    u = (rng.standard_normal((c, n)) * 6.0).astype(np.float32)
    v = (rng.standard_normal((c, n)) * 6.0).astype(np.float32)
    a0 = (-np.abs(rng.standard_normal((c, n_w, 8))) * 3).astype(np.float32)
    b0 = (-np.abs(rng.standard_normal((c, n_w, 8))) * 3).astype(np.float32)
    a0, b0 = (np.array(x) for x in _pin_boundaries(jnp.asarray(a0),
                                                   jnp.asarray(b0)))
    return u, v, a0, b0


def _port_half(u, v, a0, b0, win, acq, mdtype, **kw):
    before = tm.LAUNCHES, dict(tm.FORM_LAUNCHES)
    out = tm.half_iteration(*map(torch.from_numpy, (u, v, a0, b0)), win, acq,
                            mdtype, **kw)
    assert (tm.LAUNCHES, tm.FORM_LAUNCHES) == before   # the plain version
    return [x.float().numpy() for x in out]


# (mdtype, win, acq, K): K = 640 leaves 125 dead steps in the last window;
# win 36 renormalises every 4 steps over the window (the fused kernel:
# every 2 over its half); acq 96 > win/2 is the unfused kernel's alone;
# win 34 has an odd half window (17) and acq = win
UNFUSED_CASES = [("f32", 128, 16, 640), ("bf16", 128, 16, 640),
                 ("bf16_f32store", 128, 16, 640), ("bf16", 36, 16, 200),
                 ("bf16_f32store", 128, 96, 640), ("f32", 34, 34, 200)]


@pytest.mark.parametrize("mdtype,win,acq,k", UNFUSED_CASES)
def test_unfused_half_iteration_matches_reference(mdtype, win, acq, k):
    u, v, a0, b0 = _half_inputs(k, win)
    ref = half_iteration_pallas(jnp.asarray(u), jnp.asarray(v),
                                jnp.asarray(a0), jnp.asarray(b0), win, acq,
                                k + 3, fused=False, mdtype=mdtype,
                                interpret=True)
    got = _port_half(u, v, a0, b0, win, acq, mdtype, fused=False)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g, np.asarray(r, np.float32))
    if acq <= win // 2:
        # a form of its own: the fused kernel's L rounds apart
        fused = _port_half(u, v, a0, b0, win, acq, mdtype)
        assert not np.array_equal(fused[0], got[0])


@pytest.mark.parametrize("unroll", [1, 2])
def test_layout_kernel_renorm_at_blane_unroll(unroll):
    k = 640
    u, v, a0, b0 = _half_inputs(k, WIN)
    c, n = u.shape
    n_w = a0.shape[1]
    lay = lambda x: np.pad(x, ((0, 0), (0, n_w * WIN - n))).reshape(
        c, n_w, WIN).transpose(2, 1, 0)                  # (win, n_w, c)
    l_r, a_r, b_r = half_iteration_blane(
        jnp.asarray(lay(u)), jnp.asarray(lay(v)),
        jnp.asarray(a0.transpose(1, 2, 0)), jnp.asarray(b0.transpose(1, 2, 0)),
        WIN, ACQ, n, tl=c, mdtype="bf16", pinpad=True, unroll=unroll,
        interpret=True)
    l_r = np.asarray(l_r, np.float32).transpose(2, 1, 0).reshape(c, -1)[:, :n]
    l, a, b = _port_half(u, v, a0, b0, WIN, ACQ, "bf16", unroll=unroll)
    np.testing.assert_array_equal(l, l_r)
    np.testing.assert_array_equal(a, np.asarray(a_r).transpose(2, 0, 1))
    np.testing.assert_array_equal(b, np.asarray(b_r).transpose(2, 0, 1))
    assert not np.array_equal(l, _port_half(u, v, a0, b0, WIN, ACQ,
                                            "bf16")[0])
    assert tm.renorm_unroll("bf16", WIN, unroll) == unroll
    assert tm.renorm_unroll("bf16", WIN, 16) is None
    assert tm.renorm_unroll("f32", WIN, unroll) is None


def _check_decode(port_out, ref_out, it_stats):
    bits, ok, it = port_out
    bits_r, ok_r, it_r = ref_out
    np.testing.assert_array_equal(bits.numpy(), np.asarray(bits_r))
    np.testing.assert_array_equal(ok.numpy(), np.asarray(ok_r))
    assert it == int(it_r) == it_stats


DL = DlCell(n_rb_dl=6, mcs=28)
DL_ARGS = (DL.n_cell_id, DL.cfi, DL.prbs, DL.subframe, DL.rnti)
DL_GEOM_R = pdsch_ref.pdsch_geometry(DL.geom.tbs, DL.geom.n_re, DL.geom.qm,
                                     DL.geom.rv)
# the decodes' cell: QPSK, K = 528, two iterations with early stop at 1 dB
DEC = DlCell(n_rb_dl=6, mcs=5)
DEC_GEOM_R = pdsch_ref.pdsch_geometry(DEC.geom.tbs, DEC.geom.n_re,
                                      DEC.geom.qm, DEC.geom.rv)

# (the reference's keys, the form the port's decode runs): fused: false
# with early stop (its natural path; the unfused kernel freezes),
# layout_glue: false without (the natural path, where the layout path
# would run), blane_unroll: 2 without (the layout path)
DECODE_CASES = {
    "fused_false": ({"fused": False}, "bf16_unfused"),
    "layout_glue_false": ({"layout_glue": False, "earlystop": False},
                          "bf16"),
    "blane_unroll_2": ({"blane_unroll": 2, "earlystop": False}, "bf16_u2")}


@pytest.mark.parametrize("case", list(DECODE_CASES))
def test_dl_decode_under_value_matches_reference(monkeypatch, case):
    """The port's decode under the value (``from_dict``, cuFFT) and the
    reference's turbo stage under it, on the port's de-matched LLRs; every
    half-iteration of the port's decode takes the value's form."""
    keys, form = DECODE_CASES[case]
    # the reference's stages read blane_unroll from the environment
    monkeypatch.setenv("LTEAX_BLANE_UNROLL", str(keys.get("blane_unroll",
                                                          16)))
    iq, tb = dl_subframes(DEC, 2, snr_db=1.0, seed=5)
    _, turbo_r = _pdsch_stages(
        RefPhyConfig(n_rb_dl=DEC.n_rb_dl), *DEC.decoder_args()[1:6],
        DEC_GEOM_R, DEC.scheme, N_ITER, RefTuning(**REF, **keys), True,
        planar_boundary=False)
    tuning = DecoderTuning.from_dict({**keys, "ofdm_dft": "fft"})
    port = make_batch_decoder(*DEC.decoder_args(), n_iter=N_ITER,
                              tuning=tuning, device="cpu")
    d = port.front(torch.from_numpy(iq))
    seen = []
    real = tm.half_iteration

    def spy(*args, **kw):
        seen.append(tm._form(args[6], *tm.resolve_form(
            *args[6:10], kw["fused"]), fused=kw["fused"],
            unroll=tm.renorm_unroll(args[6], WIN, kw["unroll"])
            if kw["fused"] else None))
        return real(*args, **kw)

    monkeypatch.setattr(tm, "half_iteration", spy)
    out = port.turbo(d)
    assert seen and set(seen) == {form}
    ref = jax.jit(turbo_r)(jnp.asarray(
        d.float().numpy().reshape(2, -1, 3, DEC.geom.k + 4), jnp.bfloat16))
    _check_decode(out, ref, port.last_stats.n_iter)
    assert out[1].all() and np.array_equal(out[0].numpy(), tb)


@pytest.mark.parametrize("mcs", [5, 13, 28])
def test_xla_demap_stage_matches_reference(mcs):
    """The XLA-order demap on the same symbols and effective noise as the
    reference's ``demodulate_maxlog`` * signs, rounded, ``soft_dematch``:
    f32 LLRs exact in 16QAM / 64QAM, within 2 ulp of the largest in QPSK
    (XLA:CPU's fused multiply-add); the de-matched bf16 LLRs likewise."""
    cell = DlCell(n_rb_dl=6, mcs=mcs)
    g = cell.geom
    g_r = pdsch_ref.pdsch_geometry(g.tbs, g.n_re, g.qm, g.rv)
    rng = np.random.default_rng(mcs)
    m = g.g // g.qm
    x = (rng.standard_normal((2, m)) + 1j * rng.standard_normal((2, m))
         ).astype(np.complex64)
    eff = rng.uniform(0.01, 0.5, (2, m)).astype(np.float32)
    sgn = seq.scrambling_symbols_np(seq.pdsch_c_init(cell.rnti, 0, 7), g.g)
    llr_r = np.asarray(mod_ref.demodulate_maxlog(jnp.asarray(x), cell.scheme,
                                                 jnp.asarray(eff))
                       * jnp.asarray(sgn))
    tol = 0.0 if g.qm > 2 else 2 * np.spacing(np.abs(llr_r).max())
    for dt in (torch.float32, torch.bfloat16):
        xla = XlaDemap(cell.scheme, sgn, _global_rm_cycles(g), g.k + 4, dt,
                       torch.device("cpu"))
        llr = xla.llrs(torch.from_numpy(x), torch.from_numpy(eff))
        assert llr.dtype == dt
        if dt == torch.float32:
            np.testing.assert_allclose(llr.numpy(), llr_r, rtol=0, atol=tol)
            llr_in = jnp.asarray(llr.numpy())
        else:
            want = jnp.asarray(llr_r).astype(jnp.bfloat16)
            diff = np.abs(llr.float().numpy() - np.asarray(want, np.float32))
            assert diff.max() <= (0 if g.qm > 2 else np.abs(llr_r).max()
                                  * 2.0 ** -7)
            llr_in = jnp.asarray(llr.float().numpy(), jnp.bfloat16)
        d_r = pdsch_ref.soft_dematch(llr_in, g_r, False)
        np.testing.assert_array_equal(
            xla.dematch(llr).float().numpy(),
            np.asarray(d_r, np.float32).reshape(-1, 3, g.k + 4))


def _close(got: torch.Tensor, ref, bf16: bool):
    """De-matched LLRs within the FFTs' rounding: zeros in the same places,
    within one bf16 ulp of the largest (bf16) or 1e-5 of it (f32)."""
    got = got.float().numpy()
    ref = np.asarray(ref, np.float32).reshape(got.shape)
    np.testing.assert_array_equal(got == 0, ref == 0)
    scale = np.abs(ref).max()
    assert np.abs(got - ref).max() <= scale * (2.0 ** -7 if bf16 else 1e-5)


UL = (6, 2, 712, 4, 214, 0x3D)          # 6 PRB QPSK


def _ul_cell():
    n_prb, qm, tbs, sf, cid, rnti = UL
    alloc = pusch.PuschAlloc(n_prb=n_prb, rb_start=0, mcs_tbs=tbs, qm=qm)
    alloc_r = pusch_ref.PuschAlloc(n_prb=n_prb, rb_start=0, mcs_tbs=tbs,
                                   qm=qm)
    return (ul_gen.UlCell(alloc=alloc, n_cell_id=cid, subframe=sf,
                          rnti=rnti), alloc_r)


TM3 = MimoCell(n_rb_dl=6, cfi=2, mcs=15)            # 16QAM, K = 1760
TM3_GEOM_R = pdsch_ref.pdsch_geometry(TM3.geom.tbs, TM3.geom.n_re,
                                      TM3.geom.qm, TM3.geom.rv)


def _tm3_stages(tuning: RefTuning):
    return _mimo_stages(
        RefPhyConfig(n_rb_dl=TM3.n_rb_dl, n_ant=2), TM3.n_cell_id, TM3.cfi,
        TM3.prbs, TM3.subframe, TM3.rnti, TM3_GEOM_R, TM3.scheme, N_ITER,
        tuning, True, tm=TM3.tm, cb_index=TM3.cb_index)


@pytest.mark.parametrize("front", ["dl", "ul", "tm3", "harq"])
def test_xla_demap_fronts_match_reference(front):
    """``pallas_demap: false`` fronts against the reference's XLA fronts
    (DL, TM3 and HARQ under SHIPPED's bf16 LLRs, UL in f32): within the
    FFTs' rounding, off the demap kernel's front, and the port's decode of
    them right."""
    if front == "harq":
        small = DlCell(n_rb_dl=6, n_cell_id=150, mcs=9, cfi=2)
        iq, tb, cells = harq_transmissions(small, (1, 2), (0, 2), 2, 3.0,
                                           seed=3)
        c0 = cells[0]
        fronts_r = [_pdsch_stages(
            RefPhyConfig(n_rb_dl=c0.n_rb_dl), c0.n_cell_id, c0.cfi, c0.prbs,
            c.subframe, c0.rnti, pdsch_ref.pdsch_geometry(
                c.geom.tbs, c.geom.n_re, c.geom.qm, c.geom.rv), c0.scheme,
            N_ITER, RefTuning(**REF, pallas_demap=False), True,
            planar_boundary=False)[0] for c in cells]
        front_r = lambda x: sum(jax.jit(f)(x[i])
                                for i, f in enumerate(fronts_r))
        make = lambda t: make_batch_harq_decoder(
            *harq_decoder_args(cells), n_iter=6, tuning=t, device="cpu")
        base, rows = SHIPPED_FFT, tb
    elif front == "dl":
        iq, tb = dl_subframes(DL, 2, snr_db=25.0, seed=3)
        front_r, _ = _pdsch_stages(
            RefPhyConfig(n_rb_dl=DL.n_rb_dl), *DL_ARGS, DL_GEOM_R, DL.scheme,
            N_ITER, RefTuning(**REF, pallas_demap=False), True)
        make = lambda t: make_batch_decoder(
            DL.cfg, *DL_ARGS, DL.geom, DL.scheme, n_iter=N_ITER, tuning=t,
            device="cpu")
        base, rows = SHIPPED_FFT, tb
    elif front == "ul":
        cell, alloc_r = _ul_cell()
        iq, tb = ul_gen.ul_subframes(cell, 2, snr_db=8.0, seed=0)
        front_r, _ = _pusch_stages(alloc_r, cell.rnti, cell.subframe,
                                   cell.n_cell_id, N_ITER, None,
                                   RefTuning(mdtype="f32", demap_in="f32",
                                             pallas_demap=False), True)
        make = lambda t: make_pusch_batch_decoder(
            *cell.decoder_args(), n_iter=N_ITER, tuning=t, device="cpu")
        base, rows = DecoderTuning(), tb
    else:
        iq, tb = mimo_subframes(TM3, 2, snr_db=25.0, seed=2)
        front_r, _ = _tm3_stages(RefTuning(**REF, pallas_demap=False))
        make = lambda t: make_mimo_batch_decoder(
            *TM3.decoder_args(), n_iter=N_ITER, tuning=t, device="cpu")
        base, rows = SHIPPED_FFT, decoder_rows(tb)
    port = make(dataclasses.replace(base, pallas_demap=False))
    assert not port.planar_int8
    assert all(f.xla is not None for f in (
        getattr(port, "dl_fronts", None) or [getattr(
            port, {"ul": "ul_front", "tm3": "mimo_front"}.get(front,
                                                              "dl_front"))]))
    x = torch.from_numpy(iq)
    d = port.front(x)
    bf16 = base.mdtype == "bf16"
    assert d.dtype == (torch.bfloat16 if bf16 else torch.float32)
    _close(d, jax.jit(front_r)(jnp.asarray(iq)), bf16)
    assert not torch.equal(d, make(base).front(x))
    bits, ok, _ = port.turbo(d)
    assert ok.all() and np.array_equal(bits.numpy(), rows)


REF_INT8 = dict(REF, planar_int8=True, earlystop=False)


@pytest.mark.parametrize("front", ["ul", "tm3"])
def test_planar_boundary_off_leaves_the_front_unquantized(front):
    """``planar_int8`` with the front's planar boundary off: the port's
    LLRs are its unquantized ones, and its decode equals the reference's
    turbo stage for that front (no planar input: nothing quantized) on
    them."""
    boundary = {"ul": "ul_planar_boundary", "tm3": "mimo_planar_boundary"}[
        front]
    int8 = dataclasses.replace(SHIPPED_FFT, planar_int8=True,
                               earlystop=False, **{boundary: False})
    if front == "ul":
        cell, alloc_r = _ul_cell()
        iq, tb = ul_gen.ul_subframes(cell, 2, snr_db=8.0, seed=0)
        _, turbo_r = _pusch_stages(alloc_r, cell.rnti, cell.subframe,
                                   cell.n_cell_id, N_ITER, None,
                                   RefTuning(**REF_INT8, **{boundary: False}),
                                   True)
        make = lambda t: make_pusch_batch_decoder(
            *cell.decoder_args(), n_iter=N_ITER, tuning=t, device="cpu")
        rows, k = tb, cell.alloc.geom.k
    else:
        iq, tb = mimo_subframes(TM3, 2, snr_db=25.0, seed=2)
        _, turbo_r = _tm3_stages(RefTuning(**REF_INT8, **{boundary: False}))
        make = lambda t: make_mimo_batch_decoder(
            *TM3.decoder_args(), n_iter=N_ITER, tuning=t, device="cpu")
        rows, k = decoder_rows(tb), TM3.geom.k
    port = make(int8)
    assert not port.planar_int8
    x = torch.from_numpy(iq)
    d = port.front(x)
    assert torch.equal(d, make(dataclasses.replace(
        int8, planar_int8=False)).front(x))
    assert not torch.equal(d, make(dataclasses.replace(
        int8, **{boundary: True})).front(x))
    out = port.turbo(d)
    ref = jax.jit(turbo_r)(jnp.asarray(
        d.float().numpy().reshape(len(rows), -1, 3, k + 4), jnp.bfloat16))
    _check_decode(out, ref, port.last_stats.n_iter)
    assert out[1].all() and np.array_equal(out[0].numpy(), rows)
