"""The reference's last turbo numerics in the port, against the JAX
reference in interpret mode: ``nofreeze``, ``combine_bf16`` and
``planar_int8`` (``phy.tuning.DecoderTuning``), and the profile of record
(``from_dict`` / ``to_dict`` / ``from_yaml``).

- The plain half-iteration bit for bit (l, a_next, b_next) against the
  layout kernel ``half_iteration_blane``: ``nofreeze`` under f32, bf16 and
  bf16_f32store; ``combine_bf16`` under bf16 (pinned, frozen and free
  padding) and bf16_f32store (where it changes nothing: one operand of
  each sum is an f32 store).  ``nofreeze`` against the natural kernel
  ``half_iteration_pallas`` too.
- ``turbo_decode_batch`` against ``turbo_decode_batch_pallas`` under each
  turbo knob: ``combine_bf16`` on the layout path (a compacted retry
  smaller than the batch: the knob stays out of the retry) and the natural
  one (early stop, no retry), ``nofreeze`` on the layout path (no early
  stop), which it reaches as every other: bits and iteration count equal;
  and which half-iterations get each knob on each path.
- DL, UL and TM3 MMSE decodes under ``SHIPPED`` with ``planar_int8`` (FFT
  fronts, no early stop: the layout path) against the reference's planar
  turbo stages, which quantize, on the port's own planar demap output
  (the fronts up to it are held to the reference by
  ``tests/test_torch_bf16.py``, within one bf16 ulp: an ulp can move an
  int8 level): TB bits, CRC flags and iteration count equal, and the
  de-matched LLRs the reference's quantization and dequantization of the
  planes, bit for bit.
- The profile: the port's YAML reader against PyYAML on the shipped
  profile, ``from_yaml`` and ``from_dict`` of the reference's
  ``to_dict()`` equal to ``SHIPPED``, every reference value resolved to
  the port's profile and an unknown key raising, the reference's defaults
  and fields held equal to the port's copy.

Torch runs on one thread; the reference runs at K <= 640, C <= 6, 6 PRB,
B <= 2, three iterations (six at the TM3 cell).  Its cost is compiles: a
kernel form ~8 s whatever the shape, a decode or stage 12-35 s, more with
more iterations; none is built twice."""

import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from lteax.kernels.turbo_mlm import (_pin_boundaries, half_iteration_blane,
                                     half_iteration_pallas,
                                     turbo_decode_batch_pallas)
from lteax.phy.channels import pdsch as pdsch_ref
from lteax.phy.channels import pusch as pusch_ref
from lteax.phy.config import PhyConfig as RefPhyConfig
from lteax.phy.tuning import DecoderTuning as RefTuning
from lteax.shard.pipeline import _mimo_stages, _pdsch_stages, _pusch_stages

import lteax_torch.kernels.turbo_mlm as tm
from lteax_torch.phy import tuning as tuning_mod
from lteax_torch.phy.channels import pusch
from lteax_torch.phy.tuning import SHIPPED, DecoderTuning, read_flat_yaml
from lteax_torch.pipeline import (make_batch_decoder,
                                  make_mimo_batch_decoder,
                                  make_pusch_batch_decoder, quantize_planar)
from lteax_torch.sim import ul_gen
from lteax_torch.sim.dl_gen import DlCell, dl_subframes
from lteax_torch.sim.mimo_gen import MimoCell, decoder_rows, mimo_subframes

torch.set_num_threads(1)

WIN, ACQ = 128, 16
PROFILE = Path(__file__).resolve().parents[1] / "configs" / \
    "tuning_default.yaml"


def _half_inputs(k: int, c: int = 3, win: int = WIN):
    n = k + 3
    n_w = -(-n // win)
    rng = np.random.default_rng(k + 17)
    u = (rng.standard_normal((c, n)) * 6.0).astype(np.float32)
    v = (rng.standard_normal((c, n)) * 6.0).astype(np.float32)
    a0 = (-np.abs(rng.standard_normal((c, n_w, 8))) * 3).astype(np.float32)
    b0 = (-np.abs(rng.standard_normal((c, n_w, 8))) * 3).astype(np.float32)
    a0, b0 = (np.array(x) for x in _pin_boundaries(jnp.asarray(a0),
                                                   jnp.asarray(b0)))
    return u, v, a0, b0


def _port_half(u, v, a0, b0, mdtype, pinpad, nofreeze, combine_bf16,
               win=WIN):
    before = tm.LAUNCHES, dict(tm.FORM_LAUNCHES)
    out = tm.half_iteration(*map(torch.from_numpy, (u, v, a0, b0)), win, ACQ,
                            mdtype, pinpad, nofreeze, combine_bf16)
    assert (tm.LAUNCHES, tm.FORM_LAUNCHES) == before   # the plain version
    return [x.float().numpy() for x in out]


# K = 640: the last of 6 windows has 3 live positions, 125 dead steps of
# its beta sweep (past the NII export)
K_HALF = 640
HALF_CASES = [
    ("f32", True, True, False), ("bf16", True, True, False),
    ("bf16_f32store", False, True, False), ("bf16", True, False, True),
    ("bf16", False, False, True), ("bf16_f32store", True, False, True)]


@pytest.mark.parametrize("mdtype,pinpad,nofreeze,combine_bf16", HALF_CASES)
def test_half_iteration_matches_layout_kernel(mdtype, pinpad, nofreeze,
                                              combine_bf16, win=WIN):
    u, v, a0, b0 = _half_inputs(K_HALF, win=win)
    c, n = u.shape
    n_w = a0.shape[1]
    lay = lambda x: np.pad(x, ((0, 0), (0, n_w * win - n))).reshape(
        c, n_w, win).transpose(2, 1, 0)                  # (win, n_w, c)
    l_r, a_r, b_r = half_iteration_blane(
        jnp.asarray(lay(u)), jnp.asarray(lay(v)),
        jnp.asarray(a0.transpose(1, 2, 0)), jnp.asarray(b0.transpose(1, 2, 0)),
        win, ACQ, n, tl=c, mdtype=mdtype, pinpad=pinpad, nofreeze=nofreeze,
        combine_bf16=combine_bf16, interpret=True)
    l_r = np.asarray(l_r, np.float32).transpose(2, 1, 0).reshape(c, -1)[:, :n]
    l, a, b = _port_half(u, v, a0, b0, mdtype, pinpad, nofreeze,
                         combine_bf16, win)
    np.testing.assert_array_equal(l, l_r)
    np.testing.assert_array_equal(a, np.asarray(a_r).transpose(2, 0, 1))
    np.testing.assert_array_equal(b, np.asarray(b_r).transpose(2, 0, 1))


def test_forms_are_forms_of_their_own():
    """``nofreeze`` differs from the pin and the freeze; the bf16 combine
    differs from the f32 one under bf16 and equals it under
    bf16_f32store."""
    u, v, a0, b0 = _half_inputs(K_HALF)
    run = lambda *f: _port_half(u, v, a0, b0, *f)[0]
    for mdtype in ("f32", "bf16"):
        free = run(mdtype, True, True, False)
        assert not np.array_equal(free, run(mdtype, True, False, False))
        assert not np.array_equal(free, run(mdtype, False, False, False))
    assert not np.array_equal(run("bf16", True, False, True),
                              run("bf16", True, False, False))
    np.testing.assert_array_equal(run("bf16_f32store", True, False, True),
                                  run("bf16_f32store", True, False, False))
    assert tm.resolve_form("bf16_f32store", True, True, True) == \
        (False, True, False)


@pytest.mark.parametrize("mdtype", ["bf16"])
def test_nofreeze_matches_natural_kernel(mdtype):
    u, v, a0, b0 = _half_inputs(K_HALF)
    ref = half_iteration_pallas(jnp.asarray(u), jnp.asarray(v),
                                jnp.asarray(a0), jnp.asarray(b0), WIN, ACQ,
                                K_HALF + 3, fused=True, nofreeze=True,
                                mdtype=mdtype, interpret=True)
    for g, r in zip(_port_half(u, v, a0, b0, mdtype, True, True, False),
                    ref):
        np.testing.assert_array_equal(g, np.asarray(r, np.float32))


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


# (knob, mdtype, early stop, retry_m): no early stop, or retry 2 < C = 6,
# is the reference's layout path (with the retry, two blocks fail the
# first iteration and finish in the compacted retry, which combines in
# f32; one retry level, so that the retry is the only branch after the
# first iteration), early stop without a retry its natural path.
# ``nofreeze`` reaches every half-iteration of every path alike in both
# packages (test_decoder_passes_the_knobs_where_the_reference_does), and
# its natural kernel form is held by test_nofreeze_matches_natural_kernel:
# one decode path holds it here; ``combine_bf16`` depends on the path.
DECODE_CASES = [("nofreeze", "bf16", None, 0),
                ("combine_bf16", "bf16", "24B", 2),
                ("combine_bf16", "bf16", "24B", 0)]
DECODE_K, DECODE_C = 512, 6


def _decode_llrs():
    return _llrs(DECODE_K, DECODE_C, [1.9, 1.9, 0.3, 0.3, 0.3, 0.3],
                 seed=21)


@pytest.mark.parametrize("knob,mdtype,early_crc,retry_m", DECODE_CASES,
                         ids=["nofreeze-layout", "combine-layout",
                              "combine-natural"])
def test_decoder_knob_matches_reference(knob, mdtype, early_crc, retry_m):
    k = DECODE_K
    # three iterations: the reference's retry runs eagerly, and costs more
    # with more iterations left (it still runs after the first)
    n_iter = 3
    llr, bits = _decode_llrs()
    ref_bits, ref_it = turbo_decode_batch_pallas(
        jnp.asarray(llr), k, n_iter=n_iter, win=WIN, acq=ACQ,
        early_crc=early_crc, mdtype=mdtype, fused=True, pinpad=True,
        retry_m=retry_m, retry_levels=1, layout=True, return_n_iter=True,
        interpret=True,
        **{"nofreeze": False, "combine_bf16": False, knob: True})
    got, stats = tm.turbo_decode_batch(
        torch.from_numpy(llr), k, n_iter=n_iter, win=WIN, acq=ACQ,
        early_crc=early_crc, retry_m=retry_m, retry_levels=1, mdtype=mdtype,
        **{knob: True})
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref_bits))
    assert stats.n_iter == int(ref_it)
    np.testing.assert_array_equal(got.numpy()[2:], bits[2:])
    if retry_m:
        assert stats.retries == [(1, 2)]


@pytest.mark.parametrize("early_crc,retry_m,comb_full", [
    (None, 0, True), ("24B", 2, True), ("24B", 0, False)],
    ids=["layout", "layout-retry", "natural"])
def test_decoder_passes_the_knobs_where_the_reference_does(
        monkeypatch, early_crc, retry_m, comb_full):
    """The knobs each half-iteration of a decode gets: ``nofreeze`` every
    one, on every path (the reference passes it to both kernels and to its
    compacted retry, ``turbo_mlm.py:1273-1289``, ``:1381-1389``,
    ``:1526-1535``); ``combine_bf16`` the full-batch ones of the layout
    path, never the compacted retry's (2 of the 6 rows) or the natural
    path's."""
    seen = []
    real = tm.half_iteration

    def spy(u, *args, **kw):
        seen.append((u.shape[0], *args[-2:]))     # rows, nofreeze, combine
        return real(u, *args, **kw)

    monkeypatch.setattr(tm, "half_iteration", spy)
    llr, _ = _decode_llrs()
    _, stats = tm.turbo_decode_batch(
        torch.from_numpy(llr), DECODE_K, n_iter=3,
        win=WIN, acq=ACQ, early_crc=early_crc, retry_m=retry_m,
        retry_levels=1, mdtype="bf16", nofreeze=True, combine_bf16=True)
    assert seen and all(nofreeze for _, nofreeze, _ in seen)
    assert [(rows, comb) for rows, _, comb in seen if rows == DECODE_C] \
        and all(comb == comb_full for rows, _, comb in seen
                if rows == DECODE_C)
    retry = [comb for rows, _, comb in seen if rows != DECODE_C]
    assert (len(retry) > 0) == bool(retry_m) and not any(retry)
    assert bool(stats.retries) == bool(retry_m)


def _check_decode(port_out, ref_out, it_stats):
    bits, ok, it = port_out
    bits_r, ok_r, it_r = ref_out
    np.testing.assert_array_equal(bits.numpy(), np.asarray(bits_r))
    np.testing.assert_array_equal(ok.numpy(), np.asarray(ok_r))
    assert it == int(it_r) == it_stats


# the planar stages of the reference quantize on its layout path, which a
# decode without early stop takes at any batch size (the compacted retry's
# own numerics are held by test_decoder_knob_matches_reference)
REF_INT8 = dict(mdtype="bf16", demap_in="bf16", ofdm_dft="fft",
                ul_dft="fft", planar_int8=True, print_iters=True,
                earlystop=False)
INT8 = dataclasses.replace(SHIPPED, ofdm_dft="fft", planar_int8=True,
                           earlystop=False)
N_ITER_INT8 = 3


@pytest.fixture(scope="module", autouse=True)
def _fft_reference():
    """The reference reads its DFT forms (and ``combine_bf16``) from the
    environment when it traces."""
    mp = pytest.MonkeyPatch()
    mp.setenv("LTEAX_OFDM_DFT", "fft")
    mp.setenv("LTEAX_UL_DFT", "fft")
    yield
    mp.undo()


def _dequantized(planes, dl_inv, d_len, carry):
    """Planar LLRs quantized and dequantized as the reference's layout
    statics do (``turbo_mlm.py:1337-1357``), de-matched."""
    p2f = jnp.asarray(planes.float().numpy().reshape(planes.shape[0], -1))
    qs = jnp.maximum(jnp.max(jnp.abs(p2f)), 1e-20) / 127.0
    q = jnp.clip(jnp.round(p2f / qs), -127, 127).astype(jnp.int8)
    ext = jnp.concatenate([q, jnp.zeros((q.shape[0], 1), jnp.int8)], -1)
    g = ext[:, jnp.asarray(dl_inv.numpy())].astype(carry) * qs.astype(carry)
    return np.asarray(g, np.float32).reshape(-1, 3, d_len)


def _as_reference_planes(planes):
    """The port's planar LLRs (B', qm, npad) as the reference's planar stage
    boundary carries them, (B', qm * npad) bf16: its turbo stage then
    quantizes the same planes the port does."""
    return jnp.asarray(planes.float().numpy().reshape(planes.shape[0], -1),
                       jnp.bfloat16)


def test_quantize_planar_matches_reference():
    rng = np.random.default_rng(3)
    x = (rng.standard_normal((2, 4, 256)) * 7).astype(np.float32)
    x[:, :, 200:] = 0.0
    x[0, 0, :3] = [0.5 * 7, -1.5, 2.5]          # ties of the scale below
    q, qs = quantize_planar(torch.from_numpy(x))
    p2f = jnp.asarray(x)
    qs_r = jnp.maximum(jnp.max(jnp.abs(p2f)), 1e-20) / 127.0
    q_r = jnp.clip(jnp.round(p2f / qs_r), -127, 127).astype(jnp.int8)
    assert q.dtype == torch.int8 and float(qs) == float(qs_r)
    np.testing.assert_array_equal(q.numpy(), np.asarray(q_r))
    z, zs = quantize_planar(torch.zeros(3, 5))
    assert float(zs) == float(np.float32(1e-20) / np.float32(127.0))
    assert not z.any()


DL = DlCell(n_rb_dl=6, mcs=28)
DL_ARGS = (DL.n_cell_id, DL.cfi, DL.prbs, DL.subframe, DL.rnti)


def test_dl_decode_planar_int8_matches_reference(monkeypatch):
    """DL under ``planar_int8`` and ``combine_bf16`` (which the reference's
    stages read from ``LTEAX_COMBINE_BF16`` when they trace) on the
    layout path: the de-matched LLRs are the port's planes quantized and
    dequantized as the reference does, bit for bit; bits, flags and
    iterations equal."""
    monkeypatch.setenv("LTEAX_COMBINE_BF16", "1")
    g = DL.geom
    iq, tb = dl_subframes(DL, 2, snr_db=21.0, seed=5)
    _, turbo_r = _pdsch_stages(
        RefPhyConfig(n_rb_dl=DL.n_rb_dl), *DL_ARGS,
        pdsch_ref.pdsch_geometry(g.tbs, g.n_re, g.qm, g.rv), DL.scheme,
        N_ITER_INT8, RefTuning(**REF_INT8), True)
    port = make_batch_decoder(DL.cfg, *DL_ARGS, g, DL.scheme,
                              n_iter=N_ITER_INT8, tuning=dataclasses.replace(
                                  INT8, combine_bf16=True), device="cpu")
    assert port.planar_int8 and port.tail.int8_carry(2) == torch.bfloat16
    x = torch.from_numpy(iq)
    planes = port.dl_front.planes(x)
    d = port.front(x)
    assert d.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        d.float().numpy(), _dequantized(planes, port.dl_front.grid_inv[0],
                                        g.k + 4, jnp.bfloat16))
    out = port.turbo(d)
    _check_decode(out, jax.jit(turbo_r)(_as_reference_planes(planes)),
                  port.last_stats.n_iter)
    assert out[1].all() and np.array_equal(out[0].numpy(), tb)


def test_ul_decode_planar_int8_matches_reference():
    n_prb, qm, tbs = 6, 4, 1192
    alloc = pusch.PuschAlloc(n_prb=n_prb, rb_start=0, mcs_tbs=tbs, qm=qm)
    alloc_r = pusch_ref.PuschAlloc(n_prb=n_prb, rb_start=0, mcs_tbs=tbs,
                                   qm=qm)
    cell = ul_gen.UlCell(alloc=alloc, n_cell_id=301, subframe=2,
                         rnti=0x5DEF)
    iq, tb = ul_gen.ul_subframes(cell, 2, snr_db=12.0, seed=6)
    _, turbo_r = _pusch_stages(alloc_r, cell.rnti, cell.subframe,
                                     cell.n_cell_id, N_ITER_INT8, None,
                                     RefTuning(**REF_INT8), True)
    port = make_pusch_batch_decoder(*cell.decoder_args(),
                                    n_iter=N_ITER_INT8, tuning=INT8,
                                    device="cpu")
    assert port.planar_int8
    x = torch.from_numpy(iq)
    planes = port.ul_front.planes(x)
    d = port.front(x)
    np.testing.assert_array_equal(
        d.float().numpy(), _dequantized(planes, port.ul_front.ul_inv[0],
                                        alloc.geom.k + 4, jnp.bfloat16))
    out = port.turbo(d)
    _check_decode(out, jax.jit(turbo_r)(_as_reference_planes(planes)),
                  port.last_stats.n_iter)
    assert out[1].all() and np.array_equal(out[0].numpy(), tb)


def test_tm3_mmse_decode_planar_int8_matches_reference():
    """TM3 MMSE under ``planar_int8``: both codewords' planes share one
    scale, as the reference's planar boundary (each codeword-subframe a
    planar row) quantizes them.  At this cell (25 dB, seed 2) the
    quantization costs a codeword: subframe 0's first fails in six
    iterations, at the reference as at the port, where both decode without
    it (``tests/test_torch_bf16.py``)."""
    tm3 = MimoCell(n_rb_dl=6, cfi=2, mcs=28)
    g = tm3.geom
    iq, tb = mimo_subframes(tm3, 1, snr_db=25.0, seed=2)
    _, turbo_r = _mimo_stages(
        RefPhyConfig(n_rb_dl=tm3.n_rb_dl, n_ant=2), tm3.n_cell_id, tm3.cfi,
        tm3.prbs, tm3.subframe, tm3.rnti,
        pdsch_ref.pdsch_geometry(g.tbs, g.n_re, g.qm, g.rv), tm3.scheme, 6,
        RefTuning(**REF_INT8), True, tm=tm3.tm, cb_index=tm3.cb_index)
    port = make_mimo_batch_decoder(*tm3.decoder_args(), n_iter=6,
                                   tuning=INT8, device="cpu")
    assert port.planar_int8
    x = torch.from_numpy(iq)
    planes = port.mimo_front.planes(x)
    d = port.front(x)
    np.testing.assert_array_equal(
        d.float().numpy(), _dequantized(planes, port.mimo_front.rm_inv[0],
                                        g.k + 4, jnp.bfloat16))
    out = port.turbo(d)
    _check_decode(out, jax.jit(turbo_r)(_as_reference_planes(planes)),
                  port.last_stats.n_iter)
    ok = out[1].numpy()
    assert ok.tolist() == [False, True]
    np.testing.assert_array_equal(out[0].numpy()[ok], decoder_rows(tb)[ok])


def test_flat_yaml_reader_matches_pyyaml():
    text = PROFILE.read_text()
    assert read_flat_yaml(text) == yaml.safe_load(text)
    odd = ("# a profile\ntuning:\n  a: 1\n  b: -2.5e-3\n  c: 0.5\n"
           "  d: null\n  f: true\n  g: false\n  i: fft  # comment\n"
           "  j: -7\ntop: 3\n")
    assert read_flat_yaml(odd) == yaml.safe_load(odd)
    # what the reader does not resolve raises, never reads otherwise
    for bad in ("tuning:\n  - 1\n", "tuning: [1, 2]\n", "a:\n  b:\n    c: 1\n",
                "  a: 1\n", "tuning:\n  a: yes\n", "tuning:\n  a: True\n",
                "tuning:\n  a: 'x'\n", "tuning:\n  a: 1e5\n",
                "tuning:\n  a: 012\n"):
        with pytest.raises(ValueError):
            read_flat_yaml(bad)


def test_profile_of_record_is_shipped():
    assert DecoderTuning.from_yaml(PROFILE) == SHIPPED
    assert DecoderTuning.from_dict(RefTuning().to_dict()) == SHIPPED
    assert DecoderTuning.from_dict({}) == SHIPPED
    for t in (DecoderTuning(), SHIPPED, SHIPPED_KNOBS,
              DecoderTuning(n_iter=3, retry_m_dl=0)):
        assert DecoderTuning.from_dict(t.to_dict()) == t
    for f in ("nofreeze", "combine_bf16", "planar_int8"):
        assert getattr(DecoderTuning(), f) is getattr(SHIPPED, f) is False


SHIPPED_KNOBS = dataclasses.replace(SHIPPED, nofreeze=True,
                                    combine_bf16=True, planar_int8=True)


def test_reference_defaults_copy():
    """The port's copy of the reference's fields and defaults, and the port
    fields that are reference keys, held to the reference."""
    ref = RefTuning().to_dict()
    assert tuning_mod.REFERENCE_DEFAULTS == ref
    port = {f.name for f in dataclasses.fields(DecoderTuning)}
    assert port - set(ref) == {"n_iter"}


# (reference keys, the port's profile, or None where from_dict raises and
# names the first key: an unknown key only)
PROFILE_CASES = [
    ({"tb": 8, "gb": 2, "print_iters": True, "blane_flat": False,
      "blane_flat_mimo": False, "struct_dematch": True, "blane_unroll": 8},
     SHIPPED),
    ({"ul_planar_boundary": False, "mimo_planar_boundary": False}, SHIPPED),
    ({"nofreeze": True, "combine_bf16": True, "planar_int8": True},
     SHIPPED_KNOBS),
    ({"mdtype": "f32", "demap_in": "f32", "ofdm_dft": "fft",
      "layout_glue": False, "planar_int8": True, "blane_unroll": 2},
     DecoderTuning()),
    ({"retry_m": 32, "retry_m_dl": None, "retry_m_mimo": None},
     dataclasses.replace(SHIPPED, retry_m=32, retry_m_dl=32,
                         retry_m_mimo=32)),
    ({"pallas_demap": False},
     dataclasses.replace(SHIPPED, pallas_demap=False)),
    # the unfused kernel freezes: no pin
    ({"fused": False}, dataclasses.replace(SHIPPED, fused=False,
                                           pinpad=False)),
    ({"fused": False, "mdtype": "f32"},
     dataclasses.replace(SHIPPED, mdtype="f32", fused=False, pinpad=False)),
    ({"layout_glue": False},
     dataclasses.replace(SHIPPED, layout_glue=False)),
    ({"layout_glue": False, "mdtype": "bf16_f32store"},
     dataclasses.replace(SHIPPED, mdtype="bf16_f32store",
                         layout_glue=False)),
    ({"blane_unroll": 2}, dataclasses.replace(SHIPPED, blane_unroll=2)),
    ({"blane_unroll": 1, "win": 36},
     dataclasses.replace(SHIPPED, win=36, blane_unroll=1)),
    ({"planar_int8": True, "ul_planar_boundary": False},
     dataclasses.replace(SHIPPED, planar_int8=True,
                         ul_planar_boundary=False)),
    ({"planar_int8": True, "mimo_planar_boundary": False},
     dataclasses.replace(SHIPPED, planar_int8=True,
                         mimo_planar_boundary=False)),
    ({"nope": 1}, None),
    # acq > win/2: the unfused kernel, whatever fused says
    ({"acq": 96}, dataclasses.replace(SHIPPED, acq=96, fused=False,
                                      pinpad=False)),
]
# the cases' ids as they were while rows 5-13 raised (the names kept)
PROFILE_IDS = ([f"keys{i}-want{i}" for i in range(5)]
               + [f"keys{i}-None" for i in range(5, 15)] + ["keys15-want15"])


@pytest.mark.parametrize("keys,want", PROFILE_CASES, ids=PROFILE_IDS)
def test_from_dict_resolves_or_names_the_key(keys, want):
    if want is not None:
        assert DecoderTuning.from_dict(keys) == want
        return
    with pytest.raises(ValueError, match=list(keys)[0]):
        DecoderTuning.from_dict(keys)


# every value the reference's DecoderTuning takes, by key (its fields'
# documented options, and numbers around its defaults)
REFERENCE_VALUES = {
    "win": [128, 64, 36, 32], "acq": [16, 32, 64, 96, 128], "tb": [8, 16],
    "gb": [None, 1, 2, 4], "mdtype": ["f32", "bf16", "bf16_f32store"],
    "fused": [True, False], "nofreeze": [True, False],
    "pinpad": [True, False], "earlystop": [True, False],
    "ext_scale": [0.75, 1.0], "retry_m": [0, 64, 128],
    "retry_m_dl": [None, 0, 64], "retry_m_mimo": [None, 0, 192],
    "retry_levels": [1, 2, 3], "layout_glue": [True, False],
    "mimo_chest": ["ls", "mmse"], "mimo_denoise": [True, False],
    "mimo_chest_nv": [3e-3, 1e-2], "mimo_detector": ["mmse", "sic"],
    "struct_dematch": [True, False], "pallas_demap": [True, False],
    "print_iters": [True, False], "blane_flat": [True, False],
    "blane_flat_mimo": [True, False],
    "blane_unroll": [1, 2, 3, 4, 6, 8, 16, 32],
    "combine_bf16": [True, False], "demap_in": ["f32", "bf16"],
    "ul_planar_boundary": [True, False],
    "mimo_planar_boundary": [True, False],
    "ofdm_dft": ["fft", "factored", "factored_hi"],
    "planar_int8": [True, False], "ul_dft": ["fft", "factored", "matmul"]}


@pytest.mark.parametrize("key", sorted(REFERENCE_VALUES))
def test_from_dict_reads_every_reference_value(key):
    """Each value of each reference key, under each trellis and with and
    without planar_int8 (and acq at win 36 beside win 128), resolves to a
    profile (only unknown keys raise), and ``to_dict`` reads back to it."""
    assert set(REFERENCE_VALUES) == set(tuning_mod.REFERENCE_DEFAULTS)
    for value in REFERENCE_VALUES[key]:
        for mdtype in ("f32", "bf16", "bf16_f32store"):
            for int8 in (False, True):
                for win in ((128, 36) if key == "acq" and value <= 36
                            else (128,)):
                    d = {"mdtype": mdtype, "planar_int8": int8, "win": win,
                         key: value}
                    t = DecoderTuning.from_dict(d)
                    assert DecoderTuning.from_dict(t.to_dict()) == t
                    fused = d.get("fused", True) and t.acq <= t.win // 2
                    assert t.fused == fused
                    assert t.pinpad == (d.get("pinpad", True) and fused)


def test_blane_unroll_cadence_matches_reference_kernels():
    """The bf16 renormalisation steps from_dict reads an unroll by: the
    port's own period wherever the reference's kernel keeps it."""
    for win in (128, 36, 64):
        period = tm.renorm_period(win)
        port = tuple(t for t in range(win // 2) if (t + 1) % period == 0)
        assert tuning_mod._blane_renorms(win, 16) == port
        assert tuning_mod._blane_renorms(win, 4) == port
    assert tuning_mod._blane_renorms(128, 2) != tuning_mod._blane_renorms(
        128, 4)
