"""The port's 2x2 MIMO pieces and its MMSE decoder against the JAX
reference (``lteax.phy.mimo``, ``mod``, ``chest``, ``fec.reencode``, the
``bench/mimo_throughput.py`` signal recipe, and ``lteax.shard.pipeline.
_mimo_stages`` in interpret mode, f32 trellis, f32 demap staging, fft OFDM,
``mimo_planar_boundary=False``) on the same numpy inputs.

Tolerances:
- precoders, effective channels, ``modulate_arith``, ``equalize_mrc``:
  1e-6 relative (the same complex64 formulas, rounding apart);
- ``mmse_demix_2layers``: 1e-5 of the largest value on random channels
  at a noise of 0.05 (measured up to 9.9e-6: XLA's complex division and
  |h|^2 round otherwise than torch's, and the 2x2 inverse and the bias
  correction amplify that by the channel's conditioning);
- the re-encode: exact, against the reference and the numpy encoder;
- the generator: bits equal, IQ within 1e-5 (pocketfft and XLA's FFT sum
  in different orders);
- de-matched LLRs of the MMSE front: within 1e-5 of the largest, zeros in
  the same places (the DL front's tolerance);
- the whole decoder: TB bits, CRC flags and iteration count equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lteax.phy import chest as chest_ref
from lteax.phy import mimo as mimo_ref
from lteax.phy import mod as mod_ref
from lteax.phy import seq as seq_ref
from lteax.phy.channels import pdsch as pdsch_ref
from lteax.phy.config import PhyConfig as RefPhyConfig
from lteax.phy.fec import reencode as reencode_ref
from lteax.phy.grid import crs_flat_idx as crs_flat_idx_ref
from lteax.phy.grid import crs_symbols as crs_symbols_ref
from lteax.phy.ofdm import subframe_to_samples as s2s_ref
from lteax.phy.tuning import DecoderTuning as RefTuning
from lteax.shard.pipeline import _mimo_stages

from lteax_torch.phy import chest, mimo, mod
from lteax_torch.phy.config import PhyConfig
from lteax_torch.phy.fec.reencode import turbo_reencode_batch
from lteax_torch.phy.fec.turbo import turbo_encode
from lteax_torch.phy.tuning import DecoderTuning
from lteax_torch.pipeline import (MimoBatchDecoder, make_mimo_batch_decoder,
                                  make_mimo_sic_batch_decoder)
from lteax_torch.sim.mimo_gen import (MimoCell, channel_matrix,
                                      decoder_rows, mimo_subframes)

torch.set_num_threads(1)

REF_TUNING = dict(mdtype="f32", demap_in="f32", mimo_planar_boundary=False,
                  print_iters=True, retry_m_mimo=2)
# TM3: 64QAM, TBS 4392 (K 4416) per codeword; TM4: 16QAM, TBS 1736
TM3 = MimoCell(n_rb_dl=6, cfi=2, mcs=28)
TM4 = MimoCell(n_rb_dl=6, cfi=2, mcs=15, tm=4, cb_index=1)
B = 2


@pytest.fixture(scope="module", autouse=True)
def _fft_reference():
    """The reference front reads its OFDM DFT form from the environment."""
    mp = pytest.MonkeyPatch()
    mp.setenv("LTEAX_OFDM_DFT", "fft")
    yield
    mp.undo()


def _ref_args(cell: MimoCell):
    g = cell.geom
    return (RefPhyConfig(n_rb_dl=cell.n_rb_dl, n_ant=2), cell.n_cell_id,
            cell.cfi, cell.prbs, cell.subframe, cell.rnti,
            pdsch_ref.pdsch_geometry(g.tbs, g.n_re, g.qm, g.rv), cell.scheme)


def _ref_stages(cell: MimoCell):
    f1, f2 = _mimo_stages(*_ref_args(cell), 6, RefTuning(**REF_TUNING), True,
                          tm=cell.tm, cb_index=cell.cb_index)
    return jax.jit(f1), jax.jit(f2)


def _rand_channel(rng, m, corr_len=24):
    """Smooth random per-RE channel (2 rx, 2 tx, m) (tests/test_mimo.py)."""
    taps = (rng.standard_normal((2, 2, m // corr_len + 2))
            + 1j * rng.standard_normal((2, 2, m // corr_len + 2)))
    idx = np.arange(m) / corr_len
    lo = np.floor(idx).astype(int)
    frac = idx - lo
    h = taps[..., lo] * (1 - frac) + taps[..., lo + 1] * frac
    return (h / np.sqrt(2)).astype(np.complex64)


def _close(got, ref, tol):
    ref = np.asarray(ref)
    np.testing.assert_allclose(np.asarray(got), ref, rtol=tol,
                               atol=tol * np.abs(ref).max())


@pytest.mark.parametrize("tm,cb", [(3, None), (4, 0), (4, 1), (4, 2)])
def test_precode_and_demix_match_reference(tm, cb):
    rng = np.random.default_rng(5 + (cb or 0))
    m = 480
    x = (rng.standard_normal((2, m)) + 1j * rng.standard_normal((2, m))
         ).astype(np.complex64)
    h = _rand_channel(rng, m)
    xt, ht = torch.from_numpy(x), torch.from_numpy(h)
    if tm == 3:
        p, p_r = mimo.precode_tm3(xt), mimo_ref.precode_tm3(jnp.asarray(x))
        heff, heff_r = mimo.heff_tm3(ht), mimo_ref.heff_tm3(jnp.asarray(h))
    else:
        p = mimo.precode_tm4(xt, cb)
        p_r = mimo_ref.precode_tm4(jnp.asarray(x), cb)
        heff = mimo.heff_tm4(ht, cb)
        heff_r = mimo_ref.heff_tm4(jnp.asarray(h), cb)
    for a, r in zip(p, p_r):
        _close(a.numpy(), r, 1e-6)
    _close(heff.numpy(), heff_r, 1e-6)
    # noiseless: the demix inverts the precoded channel
    y = torch.stack([ht[r, 0] * p[0] + ht[r, 1] * p[1] for r in range(2)])
    x_hat, eff = mimo.mmse_demix_2layers(y, heff, 1e-7)
    err = (x_hat - xt).abs().numpy()
    assert np.median(err) < 1e-4 and err.max() < 0.05
    assert float(eff.median()) < 1e-4
    # noisy, against the reference on the same input
    y = y + torch.from_numpy(((rng.standard_normal((2, m)) + 1j
                               * rng.standard_normal((2, m))) * 0.15
                              ).astype(np.complex64))
    got = mimo.mmse_demix_2layers(y, heff, 0.05)
    ref = mimo_ref.mmse_demix_2layers(jnp.asarray(y.numpy()),
                                      jnp.asarray(heff.numpy()), 0.05)
    for a, r in zip(got, ref):
        assert a.dtype == (torch.complex64 if a.is_complex() else
                           torch.float32)
        _close(a.numpy(), r, 1e-5)
    assert torch.equal(mimo.layer_map_2cw(xt[0], xt[1]), xt)


def test_one_layer_precoder_and_codebook_range():
    d = torch.from_numpy((np.arange(12) + 1j).astype(np.complex64))
    for cb in range(4):
        for a, r in zip(mimo.precode_tm4_1layer(d, cb),
                        mimo_ref.precode_tm4_1layer(jnp.asarray(d.numpy()),
                                                    cb)):
            _close(a.numpy(), r, 1e-6)
    x = torch.zeros((2, 8), dtype=torch.complex64)
    with pytest.raises(ValueError, match="0, 1 or 2"):
        mimo.precode_tm4(x, 3)
    with pytest.raises(ValueError, match="0, 1 or 2"):
        mimo.heff_tm4(torch.zeros((2, 2, 8), dtype=torch.complex64), 3)


@pytest.mark.parametrize("scheme", ["bpsk", "qpsk", "16qam", "64qam"])
def test_modulate_arith_and_mrc_match_reference(scheme):
    rng = np.random.default_rng(len(scheme))
    m = mod.BITS_PER_SYM[scheme]
    bits = rng.integers(0, 2, (3, 60 * m)).astype(np.int32)
    got = mod.modulate_arith(torch.from_numpy(bits), scheme)
    assert got.dtype == torch.complex64 and got.shape == (3, 60)
    _close(got.numpy(), mod_ref.modulate_arith(jnp.asarray(bits), scheme),
           1e-6)
    np.testing.assert_allclose(got.numpy(), mod.modulate(bits, scheme),
                               rtol=1e-6, atol=1e-6)
    y = (rng.standard_normal((3, 2, 60)) + 1j * rng.standard_normal(
        (3, 2, 60))).astype(np.complex64)
    h = (rng.standard_normal((3, 2, 60)) + 1j * rng.standard_normal(
        (3, 2, 60))).astype(np.complex64)
    nv = np.float32(0.02)
    for a, r in zip(chest.equalize_mrc(torch.from_numpy(y),
                                       torch.from_numpy(h), nv),
                    chest_ref.equalize_mrc(jnp.asarray(y), jnp.asarray(h),
                                           nv)):
        _close(a.numpy(), r, 1e-6)


@pytest.mark.parametrize("k", [40, 512, 6144])
def test_reencode_is_exact(k):
    bits = np.random.default_rng(k).integers(0, 2, (3, k)).astype(np.int8)
    got = turbo_reencode_batch(torch.from_numpy(bits), k)
    assert got.shape == (3, 3, k + 4) and got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), turbo_encode(bits, k))
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(reencode_ref.turbo_reencode_batch(
            jnp.asarray(bits), k)))


def _reference_samples(cell: MimoCell, b: int, snr_db: float, cmat: str,
                       seed: int):
    """bench/mimo_throughput.py:60-109 with the reference's modules (the
    construction of tests/test_shard_pallas.py::_make_mimo_samples)."""
    cfg, cid, cfi, prbs, sf, rnti, geom, scheme = _ref_args(cell)
    rng = np.random.default_rng(seed)
    b_uniq = min(b, 16)
    tb_bits = rng.integers(0, 2, size=(2, b_uniq, geom.tbs)).astype(np.int32)
    d = [jax.vmap(lambda cb, q=q: pdsch_ref.pdsch_encode_cbs(
            cb, geom, rnti, sf, cid, scheme, codeword=q))(
            jnp.asarray(np.stack([pdsch_ref.pdsch_prepare_cbs(
                tb_bits[q, i], geom) for i in range(b_uniq)])))
         for q in range(2)]
    lm = mimo_ref.layer_map_2cw(d[0], d[1])
    p0, p1 = (mimo_ref.precode_tm3(lm) if cell.tm == 3
              else mimo_ref.precode_tm4(lm, cell.cb_index))
    ports = np.zeros((2, b_uniq, cfg.n_sym_subframe * cfg.n_sc), np.complex64)
    for p in range(2):
        vals = [seq_ref.crs_values(cid, 2 * sf + sym // cfg.n_sym_slot,
                                   sym % cfg.n_sym_slot, cfg.n_rb_dl)
                for sym in crs_symbols_ref(p, cfg)]
        ports[p][:, crs_flat_idx_ref(cfg, cid, p)] = np.concatenate(vals)
    re_idx = np.asarray(cell.re_idx)
    ports[0][:, re_idx] = np.asarray(p0)
    ports[1][:, re_idx] = np.asarray(p1)
    tx = np.stack([np.asarray(s2s_ref(jnp.asarray(ports[p].reshape(
        b_uniq, cfg.n_sym_subframe, cfg.n_sc)), cfg)) for p in range(2)])
    nv = 10 ** (-snr_db / 10.0)
    rx = np.einsum("rt,tbn->rbn", channel_matrix(cmat), tx)
    rx = rx + (rng.standard_normal(rx.shape)
               + 1j * rng.standard_normal(rx.shape)) * np.sqrt(nv / 2)
    reps = -(-b // b_uniq)
    rx = np.tile(rx, (1, reps, 1))[:, :b]
    return (np.stack([rx.real, rx.imag], -1).astype(np.float32),
            np.tile(tb_bits, (1, reps, 1))[:, :b])


def test_generator_matches_reference_recipe():
    """TM4 cb 1 on the correlated channel, 18 subframes from 16 distinct
    (the tiling included)."""
    iq, tb = mimo_subframes(TM4, 18, snr_db=20.0, cmat="corr", seed=4)
    iq_r, tb_r = _reference_samples(TM4, 18, 20.0, "corr", 4)
    assert iq.shape == (2, 18, TM4.cfg.n_samps_subframe, 2)
    assert iq.dtype == np.float32 and tb.shape == (2, 18, TM4.geom.tbs)
    np.testing.assert_array_equal(tb, tb_r)
    np.testing.assert_allclose(iq, iq_r, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(iq[:, 16], iq[:, 0])
    rows = decoder_rows(tb)
    np.testing.assert_array_equal(rows[1], tb[1, 0])
    np.testing.assert_array_equal(rows[4], tb[0, 2])
    assert np.array_equal(channel_matrix("1,0,0,0,0,0,1,0"),
                          np.eye(2, dtype=np.complex64))
    with pytest.raises(ValueError):
        channel_matrix("1,2,3")


@pytest.fixture(scope="module")
def tm3_case():
    """One TM3 batch through the reference's two stages."""
    iq, tb = mimo_subframes(TM3, B, snr_db=25.0, seed=2)
    f1, f2 = _ref_stages(TM3)
    d_r = f1(jnp.asarray(iq))
    return iq, tb, np.asarray(d_r), f2(d_r)


def _front_close(got: torch.Tensor, ref: np.ndarray, cell: MimoCell):
    g = cell.geom
    ref = ref.reshape(-1, 3, g.k + 4)
    assert got.shape == ref.shape == (2 * B * g.info.c, 3, g.k + 4)
    np.testing.assert_array_equal(got.numpy() == 0, ref == 0)
    _close(got.numpy(), ref, 1e-5)


def test_tm3_front_matches_reference(tm3_case):
    iq, _, d_r, _ = tm3_case
    dec = make_mimo_batch_decoder(*TM3.decoder_args(), device="cpu")
    _front_close(dec.front(torch.from_numpy(iq)), d_r, TM3)


def test_tm4_front_matches_reference():
    iq, _ = mimo_subframes(TM4, B, snr_db=22.0, cmat="corr", seed=3)
    f1, _ = _ref_stages(TM4)
    dec = make_mimo_batch_decoder(*TM4.decoder_args(), **TM4.precoding,
                                  device="cpu")
    _front_close(dec.front(torch.from_numpy(iq)),
                 np.asarray(f1(jnp.asarray(iq))), TM4)


def test_tm3_decoder_matches_reference(tm3_case):
    iq, tb, _, (bits_r, ok_r, it_r) = tm3_case
    dec = make_mimo_batch_decoder(*TM3.decoder_args(), n_iter=6,
                                  tuning=DecoderTuning(retry_m_mimo=2),
                                  device="cpu")
    assert isinstance(dec, MimoBatchDecoder)
    bits, ok, it = dec(torch.from_numpy(iq))
    assert bits.dtype == torch.int8 and bits.shape == (2 * B, TM3.geom.tbs)
    np.testing.assert_array_equal(bits.numpy(), np.asarray(bits_r))
    np.testing.assert_array_equal(ok.numpy(), np.asarray(ok_r))
    assert it == int(it_r) and it == dec.last_stats.n_iter
    assert ok.all() and np.array_equal(bits.numpy(), decoder_rows(tb))


def test_factories_validate_their_inputs():
    args = list(TM3.decoder_args())
    one_port = list(args)
    one_port[0] = PhyConfig(n_rb_dl=6)
    for make in (make_mimo_batch_decoder, make_mimo_sic_batch_decoder):
        with pytest.raises(ValueError, match="2-port"):
            make(*one_port, device="cpu")
        with pytest.raises(ValueError, match="tm 5"):
            make(*args, tm=5, device="cpu")
        with pytest.raises(ValueError, match="0, 1 or 2"):
            make(*args, tm=4, cb_index=3, device="cpu")
    # a rate match that wraps the circular buffer is a valid input: its
    # de-match is one gather per cycle
    wrap = MimoCell(n_rb_dl=6, cfi=2, mcs=0)
    assert wrap.geom.g > 3 * (wrap.geom.k + 4)
    assert make_mimo_batch_decoder(*wrap.decoder_args(), device="cpu"
                                   ).mimo_front.rm_inv.shape[0] > 1
    dec = make_mimo_batch_decoder(*args, device="cpu")
    iq, _ = mimo_subframes(TM3, 1, seed=0)
    with pytest.raises(ValueError, match="2 receive antennas"):
        dec(torch.from_numpy(iq[:1]))
    with pytest.raises(ValueError):
        DecoderTuning(mimo_detector="zf")
    with pytest.raises(ValueError):
        DecoderTuning(mimo_chest="dft")
