"""The port under the reference's shipped numerics (``phy.tuning.SHIPPED``:
bf16 trellis, bf16 demap staging) against the JAX reference in interpret
mode.

- The half-iteration, ``mdtype`` bf16 and bf16_f32store, pinned and frozen
  padding, and the f32 freeze: l, a_next and b_next bit for bit against
  the layout kernel
  (``half_iteration_blane``) and the natural one (``half_iteration_pallas``
  with ``fused=True``, the reference's path for small batches).  One f32
  operation on two bf16 values rounded to bf16 is the correctly rounded
  bf16 operation, so torch's per-operation bf16 and XLA's agree exactly.
- The demap with bf16 inputs and bf16 output: bit for bit at 16QAM and
  64QAM; at QPSK within one rounding of the output, because XLA:CPU
  contracts QPSK's ``d1 - d0`` into a fused multiply-add
  (``tests/test_torch_demap.py``), which may move the bf16 rounding by one
  ulp of the LLR.
- The turbo decoder (``turbo_decode_batch``) under bf16: bits and
  iteration count, on the reference's layout path (compacted retry, u
  pre-summed).  Its natural path (the extrinsic subtracted twice) runs in
  the decodes below, whose batches are smaller than their retry size.
  Under bf16_f32store (f32 extrinsic carry): on the layout path (no early
  stop) and on the natural path with the freeze.
- One DL, one UL, one TM3 MMSE and one HARQ (rv 0 + rv 2) decode under
  ``SHIPPED`` with the FFT in the OFDM demod (``SHIPPED_FFT``: the
  reference computes its shipped factored DFT in f32 on the CPU, so only
  the FFT fronts agree bit for bit) against the reference's stages at
  ``DecoderTuning(mdtype="bf16", demap_in="bf16", ofdm_dft="fft",
  ul_dft="fft")`` (planar stage boundaries off): TB bits, CRC flags and
  iteration count equal; the de-matched LLRs (bf16; HARQ's summed in bf16
  one transmission at a time) within one bf16 ulp of the largest LLR,
  their zeros in the same places (the f32 fronts already differ by FFT
  rounding, 1e-5 of the largest, and bf16 rounds that to the nearer of two
  values).  SIC's front (f32 demap, bf16 LLRs) to the same tolerance.
- DL, HARQ and TM3 MMSE decodes under ``SHIPPED`` itself (the bf16
  factored DFT) against the reference's shipped factored front (f32 on the
  CPU) at 25 dB: CRC flags equal, every block's bits the bits sent, the
  iteration counts equal (TM3: within one, ROADMAP §3).  The DL and TM3
  comparisons share the reference's jitted turbo stage with the FFT ones.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lteax.kernels.demap import demap_descr_planar_pallas
from lteax.kernels.turbo_mlm import (_pin_boundaries, half_iteration_blane,
                                     half_iteration_pallas,
                                     turbo_decode_batch_pallas)
from lteax.phy.channels import pdsch as pdsch_ref
from lteax.phy.channels import pusch as pusch_ref
from lteax.phy.config import PhyConfig as RefPhyConfig
from lteax.phy.tuning import DecoderTuning as RefTuning
from lteax.shard.pipeline import (_mimo_sic_programs, _mimo_stages,
                                  _pdsch_stages,
                                  make_batch_harq_decoder_pallas,
                                  make_pusch_batch_decoder as make_ref_ul)

import lteax_torch.kernels.demap as demap
import lteax_torch.kernels.turbo_mlm as tm
from lteax_torch.phy.channels import pusch
from lteax_torch.phy.tuning import SHIPPED, DecoderTuning
from lteax_torch.pipeline import (llr_dtypes, make_batch_decoder,
                                  make_mimo_batch_decoder,
                                  make_pusch_batch_decoder)
from lteax_torch.sim import ul_gen
from lteax_torch.sim.dl_gen import DlCell, dl_subframes
from lteax_torch.sim.mimo_gen import MimoCell, decoder_rows, mimo_subframes

torch.set_num_threads(1)

WIN, ACQ = 128, 16
REF_SHIPPED = dict(mdtype="bf16", demap_in="bf16", ofdm_dft="fft",
                   ul_dft="fft", ul_planar_boundary=False,
                   mimo_planar_boundary=False, print_iters=True)
SHIPPED_FFT = dataclasses.replace(SHIPPED, ofdm_dft="fft")


@pytest.fixture(scope="module", autouse=True)
def _fft_reference():
    """The reference reads its OFDM and UL DFT forms from the environment
    when it traces; the port's counterparts are the fft forms."""
    mp = pytest.MonkeyPatch()
    mp.setenv("LTEAX_OFDM_DFT", "fft")
    mp.setenv("LTEAX_UL_DFT", "fft")
    yield
    mp.undo()


def _half_inputs(k: int, c: int = 3, win: int = WIN):
    n = k + 3
    n_w = -(-n // win)
    rng = np.random.default_rng(k)
    u = (rng.standard_normal((c, n)) * 6.0).astype(np.float32)
    v = (rng.standard_normal((c, n)) * 6.0).astype(np.float32)
    a0 = (-np.abs(rng.standard_normal((c, n_w, 8))) * 3).astype(np.float32)
    b0 = (-np.abs(rng.standard_normal((c, n_w, 8))) * 3).astype(np.float32)
    a0, b0 = (np.array(x) for x in _pin_boundaries(jnp.asarray(a0),
                                                   jnp.asarray(b0)))
    return u, v, a0, b0


def _port_half(u, v, a0, b0, mdtype, pinpad, win=WIN):
    before = tm.LAUNCHES, dict(tm.FORM_LAUNCHES)
    out = tm.half_iteration(*map(torch.from_numpy, (u, v, a0, b0)), win, ACQ,
                            mdtype, pinpad)
    assert (tm.LAUNCHES, tm.FORM_LAUNCHES) == before   # the plain version
    assert out[0].dtype == (torch.float32 if mdtype == "f32"
                            else torch.bfloat16)
    return [x.float().numpy() for x in out]


# K = 1024: the last of 9 windows has 3 live positions (its frozen beta
# chain holds across 125 dead steps, past the NII export); K = 40: one
# window, 43 live; win 36: win/2 = 18, renormalised every 2 steps
@pytest.mark.parametrize("mdtype,pinpad,k,win", [
    ("bf16", True, 1024, WIN), ("bf16", False, 1024, WIN),
    ("bf16_f32store", False, 40, WIN), ("bf16", False, 200, 36),
    ("f32", False, 1024, WIN)])
def test_half_iteration_matches_layout_kernel(mdtype, pinpad, k, win):
    u, v, a0, b0 = _half_inputs(k, win=win)
    c, n = u.shape
    n_w = a0.shape[1]
    lay = lambda x: np.pad(x, ((0, 0), (0, n_w * win - n))).reshape(
        c, n_w, win).transpose(2, 1, 0)                  # (win, n_w, c)
    l_r, a_r, b_r = half_iteration_blane(
        jnp.asarray(lay(u)), jnp.asarray(lay(v)),
        jnp.asarray(a0.transpose(1, 2, 0)), jnp.asarray(b0.transpose(1, 2, 0)),
        win, ACQ, n, tl=c, mdtype=mdtype, pinpad=pinpad, interpret=True)
    assert l_r.dtype == (jnp.float32 if mdtype == "f32" else jnp.bfloat16)
    l_r = np.asarray(l_r, np.float32).transpose(2, 1, 0).reshape(c, -1)[:, :n]
    l, a, b = _port_half(u, v, a0, b0, mdtype, pinpad, win)
    np.testing.assert_array_equal(l, l_r)
    np.testing.assert_array_equal(a, np.asarray(a_r).transpose(2, 0, 1))
    np.testing.assert_array_equal(b, np.asarray(b_r).transpose(2, 0, 1))


@pytest.mark.parametrize("mdtype,pinpad,k", [("bf16", True, 40),
                                             ("bf16", False, 1024),
                                             ("f32", False, 1024)])
def test_half_iteration_matches_natural_kernel(mdtype, pinpad, k):
    """The reference's natural-tile kernel (its compacted retry's and small
    batches' form) has the same arithmetic: one plain version serves both."""
    u, v, a0, b0 = _half_inputs(k)
    ref = half_iteration_pallas(jnp.asarray(u), jnp.asarray(v),
                                jnp.asarray(a0), jnp.asarray(b0), WIN, ACQ,
                                k + 3, fused=True, pinpad=pinpad,
                                mdtype=mdtype, interpret=True)
    for g, r in zip(_port_half(u, v, a0, b0, mdtype, pinpad), ref):
        np.testing.assert_array_equal(g, np.asarray(r, np.float32))


@pytest.mark.parametrize("scheme", ["qpsk", "16qam", "64qam"])
def test_demap_bf16_matches_reference(scheme):
    m = {"qpsk": 2, "16qam": 4, "64qam": 6}[scheme]
    rng = np.random.default_rng(m)
    bsz, n = 3, 300
    bf = lambda x: np.asarray(jnp.asarray(x, jnp.bfloat16))
    xr = bf(rng.standard_normal((bsz, n)) * 0.8)
    xi = bf(rng.standard_normal((bsz, n)) * 0.8)
    inv_nv = bf(rng.uniform(1.0, 500.0, (bsz, n)))
    npad = -(-n // 128) * 128 + 128
    sgn = rng.choice(np.float32([-1.0, 1.0]), (m, npad))
    sgn[:, rng.random(npad) < 0.25] = 0.0
    sgn[:, n:] = 0.0
    ref = np.asarray(demap_descr_planar_pallas(
        jnp.asarray(xr), jnp.asarray(xi), jnp.asarray(inv_nv),
        jnp.asarray(sgn), scheme, out_dtype=jnp.bfloat16, interpret=True),
        np.float32)
    t = lambda x: torch.from_numpy(x.astype(np.float32)).to(torch.bfloat16)
    got = demap.demap_planar(t(xr), t(xi), t(inv_nv), torch.from_numpy(sgn),
                             scheme, torch.bfloat16)
    assert got.dtype == torch.bfloat16 and got.shape == ref.shape
    got = got.float().numpy()
    if scheme == "qpsk":
        # one bf16 ulp of the LLR (8 bits): the FMA's rounding apart
        np.testing.assert_array_equal(got == 0, ref == 0)
        assert np.all(np.abs(got - ref) <= np.abs(ref) * 2.0 ** -7)
    else:
        np.testing.assert_array_equal(got, ref)


def _llrs(k, c, sigmas, seed):
    """(c, 3, K+4) channel LLRs of CRC24B-carrying codeblocks (the
    reference's encoder), block i with noise sigmas[i]."""
    from lteax.phy.fec.crc import attach_crc_np
    from lteax.phy.fec.turbo import turbo_encode
    rng = np.random.default_rng(seed)
    bits = np.stack([attach_crc_np(p, "24B") for p in
                     rng.integers(0, 2, (c, k - 24)).astype(np.int32)])
    d = np.stack([np.asarray(turbo_encode(jnp.asarray(b), k)) for b in bits])
    llr = (1 - 2 * d.astype(np.float32)) * 2.0
    llr += (rng.standard_normal(llr.shape)
            * np.asarray(sigmas, np.float32)[:, None, None]).astype(np.float32)
    return llr.astype(np.float32), bits


@pytest.mark.mid
def test_decoder_bf16_matches_reference():
    """retry_m 2 < C: the reference's layout path; two blocks fail
    iteration 1 and finish in the compacted retry."""
    k, retry_m = 1024, 2
    llr, bits = _llrs(k, 6, [1.9, 1.9, 0.3, 0.3, 0.3, 0.3], seed=11)
    ref_bits, ref_it = turbo_decode_batch_pallas(
        jnp.asarray(llr), k, n_iter=6, win=WIN, acq=ACQ, early_crc="24B",
        mdtype="bf16", fused=True, nofreeze=False, pinpad=True,
        retry_m=retry_m, retry_levels=2, layout=True, return_n_iter=True,
        interpret=True)
    got, stats = tm.turbo_decode_batch(torch.from_numpy(llr), k, n_iter=6,
                                       win=WIN, acq=ACQ, early_crc="24B",
                                       retry_m=retry_m, retry_levels=2,
                                       mdtype="bf16")
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref_bits))
    assert stats.n_iter == int(ref_it)
    np.testing.assert_array_equal(got.numpy()[2:], bits[2:])
    assert stats.retries == [(1, 2)]


@pytest.mark.parametrize("early_crc,n_iter,pinpad", [
    (None, 3, True), ("24B", 6, False)], ids=["layout", "natural_freeze"])
def test_decoder_bf16_f32store_matches_reference(early_crc, n_iter, pinpad):
    """The bf16 trellis with the extrinsic carried in f32: without early
    stop on the reference's layout path (u pre-summed), with it (and no
    retry) on its natural path, there with frozen padding."""
    k = 1024
    llr, bits = _llrs(k, 4, [2.2, 1.9, 0.5, 0.5], seed=12)
    ref_bits, ref_it = turbo_decode_batch_pallas(
        jnp.asarray(llr), k, n_iter=n_iter, win=WIN, acq=ACQ,
        early_crc=early_crc, mdtype="bf16_f32store", fused=True,
        nofreeze=False, pinpad=pinpad, retry_m=0, retry_levels=2,
        layout=True, return_n_iter=True, interpret=True)
    got, stats = tm.turbo_decode_batch(torch.from_numpy(llr), k,
                                       n_iter=n_iter, win=WIN, acq=ACQ,
                                       early_crc=early_crc,
                                       mdtype="bf16_f32store", pinpad=pinpad)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref_bits))
    assert stats.n_iter == int(ref_it) == 3
    np.testing.assert_array_equal(got.numpy(), bits)


def _bf16_close(got: torch.Tensor, ref: np.ndarray):
    """De-matched bf16 LLRs: zeros in the same places, within one bf16 ulp
    of the largest."""
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    ref = np.asarray(ref, np.float32).reshape(got.shape)
    np.testing.assert_array_equal(got == 0, ref == 0)
    assert np.abs(got - ref).max() <= np.abs(ref).max() * 2.0 ** -7


def _check_decode(port_out, ref_out, it_stats):
    bits, ok, it = port_out
    bits_r, ok_r, it_r = ref_out
    np.testing.assert_array_equal(bits.numpy(), np.asarray(bits_r))
    np.testing.assert_array_equal(ok.numpy(), np.asarray(ok_r))
    assert it == int(it_r) == it_stats


DL = DlCell(n_rb_dl=15, mcs=28)
DL_ARGS = (DL.n_cell_id, DL.cfi, DL.prbs, DL.subframe, DL.rnti)
TM3 = MimoCell(n_rb_dl=6, cfi=2, mcs=28)


def _dl_stages(ofdm_dft: str):
    """The reference's DL front and turbo stages for ``DL`` at its shipped
    numerics with ``ofdm_dft`` (which it reads from the environment when
    the front traces)."""
    g = DL.geom
    return _pdsch_stages(RefPhyConfig(n_rb_dl=DL.n_rb_dl), *DL_ARGS,
                         pdsch_ref.pdsch_geometry(g.tbs, g.n_re, g.qm, g.rv),
                         DL.scheme, 6,
                         RefTuning(**dict(REF_SHIPPED, ofdm_dft=ofdm_dft)),
                         True, planar_boundary=False)


def _tm3_stages(ofdm_dft: str):
    g = TM3.geom
    return _mimo_stages(
        RefPhyConfig(n_rb_dl=TM3.n_rb_dl, n_ant=2), TM3.n_cell_id, TM3.cfi,
        TM3.prbs, TM3.subframe, TM3.rnti,
        pdsch_ref.pdsch_geometry(g.tbs, g.n_re, g.qm, g.rv), TM3.scheme, 6,
        RefTuning(**dict(REF_SHIPPED, ofdm_dft=ofdm_dft)), True, tm=TM3.tm,
        cb_index=TM3.cb_index)


@pytest.fixture(scope="module")
def dl_turbo_ref():
    """The reference's DL turbo stage, jitted once: its FFT-front and
    factored-front comparisons share it (it reads no DFT)."""
    return jax.jit(_dl_stages("fft")[1])


@pytest.fixture(scope="module")
def tm3_turbo_ref():
    """The reference's TM3 MMSE turbo stage, jitted once and shared."""
    return jax.jit(_tm3_stages("fft")[1])


def test_dl_decode_shipped_matches_reference(dl_turbo_ref):
    iq, tb = dl_subframes(DL, 2, snr_db=21.5, seed=1)
    d_r = jax.jit(_dl_stages("fft")[0])(jnp.asarray(iq))
    port = make_batch_decoder(DL.cfg, *DL_ARGS, DL.geom, DL.scheme, n_iter=6,
                              tuning=SHIPPED_FFT, device="cpu")
    d = port.front(torch.from_numpy(iq))
    _bf16_close(d, d_r)
    out = port.turbo(d)
    _check_decode(out, dl_turbo_ref(d_r), port.last_stats.n_iter)
    assert out[1].all() and np.array_equal(out[0].numpy(), tb)


def test_ul_decode_shipped_matches_reference():
    n_prb, qm, tbs = 6, 4, 1192
    alloc = pusch.PuschAlloc(n_prb=n_prb, rb_start=0, mcs_tbs=tbs, qm=qm)
    alloc_r = pusch_ref.PuschAlloc(n_prb=n_prb, rb_start=0, mcs_tbs=tbs,
                                   qm=qm)
    cell = ul_gen.UlCell(alloc=alloc, n_cell_id=301, subframe=2,
                         rnti=0x5DEF)
    iq, tb = ul_gen.ul_subframes(cell, 2, snr_db=12.0, seed=2)
    ref = make_ref_ul(alloc_r, cell.rnti, cell.subframe, cell.n_cell_id,
                      n_iter=6, tuning=RefTuning(**REF_SHIPPED),
                      interpret=True)
    port = make_pusch_batch_decoder(*cell.decoder_args(), n_iter=6,
                                    tuning=SHIPPED_FFT, device="cpu")
    out = port(torch.from_numpy(iq))
    _check_decode(out, ref(jnp.asarray(iq)), port.last_stats.n_iter)
    assert out[1].all() and np.array_equal(out[0].numpy(), tb)


def test_tm3_mmse_decode_shipped_matches_reference(tm3_turbo_ref):
    iq, tb = mimo_subframes(TM3, 2, snr_db=25.0, seed=2)
    d_r = jax.jit(_tm3_stages("fft")[0])(jnp.asarray(iq))
    port = make_mimo_batch_decoder(*TM3.decoder_args(), n_iter=6,
                                   tuning=SHIPPED_FFT, device="cpu")
    d = port.front(torch.from_numpy(iq))
    _bf16_close(d, d_r)
    out = port.turbo(d)
    _check_decode(out, tm3_turbo_ref(d_r), port.last_stats.n_iter)
    assert out[1].all() and np.array_equal(out[0].numpy(), decoder_rows(tb))


def test_harq_decode_shipped_matches_reference():
    from lteax_torch.pipeline import make_batch_harq_decoder
    from lteax_torch.sim.dl_gen import harq_decoder_args, harq_transmissions
    small = DlCell(n_rb_dl=6, n_cell_id=150, mcs=9, cfi=2)
    iq, tb, cells = harq_transmissions(small, (1, 2), (0, 2), 2, 3.0, seed=3)
    c0 = cells[0]
    cfg_r = RefPhyConfig(n_rb_dl=c0.n_rb_dl)
    geoms = tuple(pdsch_ref.pdsch_geometry(c.geom.tbs, c.geom.n_re, c.geom.qm,
                                           c.geom.rv) for c in cells)
    sfs = tuple(c.subframe for c in cells)
    ref = make_batch_harq_decoder_pallas(
        cfg_r, c0.n_cell_id, c0.cfi, c0.prbs, sfs, c0.rnti, geoms, c0.scheme,
        n_iter=6, tuning=RefTuning(**REF_SHIPPED), interpret=True)
    port = make_batch_harq_decoder(*harq_decoder_args(cells), n_iter=6,
                                   tuning=SHIPPED_FFT, device="cpu")
    d_r = 0
    for sf, g, x in zip(sfs, geoms, iq):
        front_r, _ = _pdsch_stages(cfg_r, c0.n_cell_id, c0.cfi, c0.prbs, sf,
                                   c0.rnti, g, c0.scheme, 6,
                                   RefTuning(**REF_SHIPPED), True,
                                   planar_boundary=False)
        d_r = d_r + jax.jit(front_r)(jnp.asarray(x))
    _bf16_close(port.front(torch.from_numpy(iq)), d_r)
    out = port(torch.from_numpy(iq))
    _check_decode(out, ref(jnp.asarray(iq)), port.last_stats.n_iter)
    assert out[1].all() and np.array_equal(out[0].numpy(), tb)


def _check_shipped_factored(port_out, ref_out, port_n_iter: int,
                            tb: np.ndarray, n_iter_slack: int = 0):
    """The port under ``SHIPPED`` (bf16 factored DFT) against the reference
    at its shipped front (f32 factored on the CPU): CRC flags equal, every
    block carries the bits sent (all pass at 25 dB), the iteration counts
    equal, or within ``n_iter_slack`` where ROADMAP §3 records the cell."""
    bits, ok, it = port_out
    _, ok_r, it_r = ref_out
    np.testing.assert_array_equal(ok.numpy(), np.asarray(ok_r))
    assert it == port_n_iter
    assert abs(int(it_r) - it) <= n_iter_slack
    assert ok.all() and np.array_equal(bits.numpy(), tb)


def test_dl_decode_shipped_matches_reference_factored(dl_turbo_ref,
                                                      monkeypatch):
    monkeypatch.setenv("LTEAX_OFDM_DFT", "factored")
    iq, tb = dl_subframes(DL, 2, snr_db=25.0, seed=7)
    ref = dl_turbo_ref(jax.jit(_dl_stages("factored")[0])(jnp.asarray(iq)))
    port = make_batch_decoder(DL.cfg, *DL_ARGS, DL.geom, DL.scheme, n_iter=6,
                              tuning=SHIPPED, device="cpu")
    assert port.dl_front.dft == "factored"
    _check_shipped_factored(port(torch.from_numpy(iq)), ref,
                            port.last_stats.n_iter, tb)


def test_harq_decode_shipped_matches_reference_factored(monkeypatch):
    from lteax_torch.pipeline import make_batch_harq_decoder
    from lteax_torch.sim.dl_gen import harq_decoder_args, harq_transmissions
    monkeypatch.setenv("LTEAX_OFDM_DFT", "factored")
    small = DlCell(n_rb_dl=6, n_cell_id=150, mcs=9, cfi=2)
    iq, tb, cells = harq_transmissions(small, (1, 2), (0, 2), 2, 25.0,
                                       seed=8)
    c0 = cells[0]
    geoms = tuple(pdsch_ref.pdsch_geometry(c.geom.tbs, c.geom.n_re,
                                           c.geom.qm, c.geom.rv)
                  for c in cells)
    ref = make_batch_harq_decoder_pallas(
        RefPhyConfig(n_rb_dl=c0.n_rb_dl), c0.n_cell_id, c0.cfi, c0.prbs,
        tuple(c.subframe for c in cells), c0.rnti, geoms, c0.scheme,
        n_iter=6, tuning=RefTuning(**dict(REF_SHIPPED, ofdm_dft="factored")),
        interpret=True)(jnp.asarray(iq))
    port = make_batch_harq_decoder(*harq_decoder_args(cells), n_iter=6,
                                   tuning=SHIPPED, device="cpu")
    assert {f.dft for f in port.dl_fronts} == {"factored"}
    _check_shipped_factored(port(torch.from_numpy(iq)), ref,
                            port.last_stats.n_iter, tb)


def test_tm3_mmse_decode_shipped_matches_reference_factored(tm3_turbo_ref,
                                                            monkeypatch):
    """A finding (ROADMAP §3): at this cell the port takes 4 iterations
    under ``SHIPPED`` and under ``"factored_hi"``, the reference 5 at
    either factored front.  The reference's turbo stage on the port's LLRs
    takes the port's 4, with its bits, under both forms: the fronts part in
    their last bits, where this cell sits on a knife edge (the IQ moved by
    about one f32 ulp moves the reference's count, ROADMAP §3;
    ``tests/torch_tm3_knife_edge.py``).  So the count is held within one;
    flags and bits exactly."""
    monkeypatch.setenv("LTEAX_OFDM_DFT", "factored")
    iq, tb = mimo_subframes(TM3, 2, snr_db=25.0, seed=9)
    d_r = jax.jit(_tm3_stages("factored")[0])(jnp.asarray(iq))
    ref = tm3_turbo_ref(d_r)
    for dft_form in ("factored", "factored_hi"):
        port = make_mimo_batch_decoder(
            *TM3.decoder_args(), n_iter=6, device="cpu",
            tuning=dataclasses.replace(SHIPPED, ofdm_dft=dft_form))
        assert port.mimo_front.dft == dft_form
        d = port.front(torch.from_numpy(iq))
        out = port.turbo(d)
        _check_shipped_factored(out, ref, port.last_stats.n_iter,
                                decoder_rows(tb), n_iter_slack=1)
        on_port = tm3_turbo_ref(jnp.asarray(
            d.float().numpy().reshape(d_r.shape), d_r.dtype))
        np.testing.assert_array_equal(out[0].numpy(), np.asarray(on_port[0]))
        np.testing.assert_array_equal(out[1].numpy(), np.asarray(on_port[1]))
        assert out[2] == int(on_port[2])


def test_sic_front_shipped_matches_reference():
    """SIC's front demaps in f32 (the reference's XLA demapper) and
    carries bf16 LLRs: CW0's de-matched and CW1's MMSE LLRs."""
    cell = MimoCell(n_rb_dl=6, cfi=2, mcs=15, tm=4, cb_index=0)
    g = cell.geom
    iq, _ = mimo_subframes(cell, 2, snr_db=15.5, cmat="corr", seed=3)
    f1 = _mimo_sic_programs(
        RefPhyConfig(n_rb_dl=cell.n_rb_dl, n_ant=2), cell.n_cell_id,
        cell.cfi, cell.prbs, cell.subframe, cell.rnti,
        pdsch_ref.pdsch_geometry(g.tbs, g.n_re, g.qm, g.rv), cell.scheme, 6,
        RefTuning(**REF_SHIPPED), True, tm=cell.tm,
        cb_index=cell.cb_index)[0]
    d0_r, llr1_r = jax.jit(f1)(jnp.asarray(iq))[:2]
    port = make_mimo_batch_decoder(
        *cell.decoder_args(), **cell.precoding, device="cpu",
        tuning=dataclasses.replace(SHIPPED_FFT, mimo_detector="sic"))
    f = port.front(torch.from_numpy(iq))
    _bf16_close(f.d0, d0_r)
    _bf16_close(f.llr1[..., :g.n_re].transpose(1, 2).reshape(2, -1), llr1_r)


def test_shipped_is_the_reference_default_numerics():
    """``SHIPPED`` carries the reference's ``DecoderTuning()`` in every
    numerics field the two share, the OFDM and UL DFT forms among them
    (the port's ``n_iter`` is its single-subframe decode's)."""
    ref = RefTuning()
    shared = [f.name for f in dataclasses.fields(DecoderTuning)
              if hasattr(ref, f.name)]
    assert len(shared) == len(dataclasses.fields(DecoderTuning)) - 1
    assert {"ofdm_dft", "ul_dft"} <= set(shared)
    assert (SHIPPED.ofdm_dft, SHIPPED.ul_dft) == ("factored", "fft")
    for name in shared:
        assert getattr(SHIPPED, name) == getattr(ref, name), name
    one = np.zeros((1, 8))
    assert llr_dtypes(SHIPPED, one) == (torch.bfloat16, torch.bfloat16)
    assert llr_dtypes(DecoderTuning(), one) == (torch.float32, torch.float32)
    # a wrapping rate match, or SIC's front: no staging, as the reference's
    # XLA demap there
    assert llr_dtypes(SHIPPED, np.zeros((4, 8)))[0] == torch.float32
    assert llr_dtypes(SHIPPED, one, kernel_front=False)[0] == torch.float32


@pytest.mark.parametrize("case", ["harq", "tm4_mmse", "tm4_sic",
                                  "dl_bf16_f32store_freeze"])
def test_decoders_decode_under_the_shipped_numerics(case):
    """The decoders the comparisons above leave out decode under
    ``SHIPPED`` (SIC's front stages no demap input: its reference demaps
    in f32 XLA) and under the other trellis forms, to the bits sent."""
    from lteax_torch.pipeline import make_batch_harq_decoder
    from lteax_torch.sim.dl_gen import harq_decoder_args, harq_transmissions
    if case == "harq":
        small = DlCell(n_rb_dl=6, n_cell_id=150, mcs=9, cfi=2)
        iq, tb, cells = harq_transmissions(small, (1, 2), (0, 2), 2, 6.0,
                                           seed=3)
        dec = make_batch_harq_decoder(*harq_decoder_args(cells),
                                      tuning=SHIPPED, device="cpu")
    elif case.startswith("tm4"):
        cell = MimoCell(n_rb_dl=6, cfi=2, mcs=15, tm=4, cb_index=0)
        iq, tb = mimo_subframes(cell, 2, snr_db=25.0, cmat="corr", seed=3)
        tb = decoder_rows(tb)
        dec = make_mimo_batch_decoder(
            *cell.decoder_args(), **cell.precoding, device="cpu",
            tuning=dataclasses.replace(SHIPPED,
                                       mimo_detector=case.split("_")[1]))
        front = dec.mimo_front
        assert front.llr_dtype == torch.bfloat16
        assert front.in_dtype == (torch.float32 if case == "tm4_sic"
                                  else torch.bfloat16)
    else:
        iq, tb = dl_subframes(DL, 2, snr_db=25.0, seed=4)
        dec = make_batch_decoder(
            *DL.decoder_args(), device="cpu",
            tuning=DecoderTuning(mdtype="bf16_f32store", pinpad=False,
                                 demap_in="bf16"))
    bits, ok, _ = dec(torch.from_numpy(iq))
    assert ok.all() and np.array_equal(bits.numpy(), tb)
