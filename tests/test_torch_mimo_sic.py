"""The port's 2x2 SIC decoder, stage by stage, and the non-default chest
knobs of the MIMO front, against the JAX reference (``lteax.shard.
pipeline._mimo_sic_programs`` and ``_mimo_stages`` in interpret mode, f32
trellis, f32 demap staging, fft OFDM, ``mimo_planar_boundary=False``).

The batch: 6 PRB, cfi 2, MCS 15 (16QAM, TBS 1736, K 1760), TM4 codebook
0 on the correlated channel ("corr") at 15.5 dB, four subframes (seed 3).
CW0 fails in subframes 1 and 3, so their CW1 falls back to the MMSE LLRs;
in subframes 0 and 2 CW0 decodes, and the cancellation decodes CW1 where
the MMSE decoder does not.  The retry size is 0 on both sides (the
compacted retry is held to the reference by the MMSE and DL tests; here it
would double the reference's compile time).

Tolerances:
- the SIC front (CW0's de-matched LLRs, CW1's MMSE LLRs): within 1e-5 of
  the largest, zeros in the same places (the DL front's tolerance; the
  reference demaps this front with the XLA demapper, LLR / eff, the port
  with the demap kernel, LLR * (1 / eff): one rounding apart);
- y, heff, the noise: within 1e-5 relative;
- CW0's raw codeblock bits, TB bits and CRC flags: equal (the failed
  codeblocks' bits too);
- CW1's de-matched LLRs after the cancel, on the reference's CW0 bits:
  within 1e-5 of the largest, zeros in the same places;
- the decoder: TB bits (failed ones too) and CRC flags equal;
- the D4 fronts (``mimo_denoise``, ``mimo_chest="mmse"``): within 1e-5 of
  the largest LLR, zeros in the same places.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lteax.phy.channels import pdsch as pdsch_ref
from lteax.phy.config import PhyConfig as RefPhyConfig
from lteax.phy.tuning import DecoderTuning as RefTuning
from lteax.shard.pipeline import _mimo_sic_programs, _mimo_stages

from lteax_torch.phy.tuning import DecoderTuning
from lteax_torch.pipeline import (MimoSicBatchDecoder,
                                  make_mimo_batch_decoder)
from lteax_torch.sim.mimo_gen import MimoCell, decoder_rows, mimo_subframes

torch.set_num_threads(1)

CELL = MimoCell(n_rb_dl=6, cfi=2, mcs=15, tm=4, cb_index=0)
B, SNR_DB, SEED = 4, 15.5, 3
REF_TUNING = dict(mdtype="f32", demap_in="f32", mimo_planar_boundary=False,
                  print_iters=True, retry_m_mimo=0)


def _ref_args():
    g = CELL.geom
    return (RefPhyConfig(n_rb_dl=CELL.n_rb_dl, n_ant=2), CELL.n_cell_id,
            CELL.cfi, CELL.prbs, CELL.subframe, CELL.rnti,
            pdsch_ref.pdsch_geometry(g.tbs, g.n_re, g.qm, g.rv), CELL.scheme)


@pytest.fixture(scope="module", autouse=True)
def _fft_reference():
    """The reference front reads its OFDM DFT form from the environment."""
    mp = pytest.MonkeyPatch()
    mp.setenv("LTEAX_OFDM_DFT", "fft")
    yield
    mp.undo()


@pytest.fixture(scope="module")
def iq():
    x, tb = mimo_subframes(CELL, B, snr_db=SNR_DB, cmat="corr", seed=SEED)
    return x, tb


@pytest.fixture(scope="module")
def ref(iq):
    """The reference's four SIC stages, each fed the one before."""
    f1, f2, f3, f4 = map(jax.jit, _mimo_sic_programs(
        *_ref_args(), 6, RefTuning(**REF_TUNING), True, tm=CELL.tm,
        cb_index=CELL.cb_index))
    d0, llr1m, y, heff, nvar = f1(jnp.asarray(iq[0]))
    bits0, tb0, ok0 = f2(d0)
    d1 = f3(bits0, ok0, llr1m, y, heff, nvar)
    tb1, ok1, _ = f4(d1)
    out = dict(d0=d0, llr1m=llr1m, y=y, heff=heff, nvar=nvar, bits0=bits0,
               tb0=tb0, ok0=ok0, d1=d1, tb1=tb1, ok1=ok1)
    return {k: np.array(v) for k, v in out.items()}


@pytest.fixture(scope="module")
def port():
    return make_mimo_batch_decoder(
        *CELL.decoder_args(), **CELL.precoding, n_iter=6, device="cpu",
        tuning=DecoderTuning(mimo_detector="sic", retry_m_mimo=0))


def _llr_close(got: torch.Tensor, ref: np.ndarray):
    got = got.numpy().reshape(ref.shape)
    np.testing.assert_array_equal(got == 0, ref == 0)
    np.testing.assert_allclose(got, ref, rtol=1e-5,
                               atol=1e-5 * np.abs(ref).max())


def _interleaved(planar: torch.Tensor) -> torch.Tensor:
    """Planar (B, qm, npad) -> (B, G) in codeword bit order."""
    n_re = CELL.geom.n_re
    return planar[..., :n_re].transpose(1, 2).reshape(planar.shape[0], -1)


def test_sic_front_matches_reference(iq, ref, port):
    assert isinstance(port, MimoSicBatchDecoder)
    f = port.front(torch.from_numpy(iq[0]))
    g = CELL.geom
    assert f.d0.shape == (B * g.info.c, 3, g.k + 4)
    _llr_close(f.d0, ref["d0"])
    _llr_close(_interleaved(f.llr1), ref["llr1m"])
    for name in ("y", "heff", "nvar"):
        r = ref[name]
        np.testing.assert_allclose(getattr(f, name).numpy(), r, rtol=1e-5,
                                   atol=1e-5 * np.abs(r).max())


def test_sic_stages_match_reference(iq, ref, port):
    f = port.front(torch.from_numpy(iq[0]))
    cb0, tb0, ok0, _ = port.turbo0(f.d0)
    np.testing.assert_array_equal(ok0.numpy(), ref["ok0"])
    assert ok0.any() and not ok0.all()           # the fallback is exercised
    np.testing.assert_array_equal(tb0.numpy(), ref["tb0"])
    np.testing.assert_array_equal(cb0.numpy(), ref["bits0"])
    # the cancel on the reference's CW0 decode, then on the port's own
    d1 = port.cancel(torch.from_numpy(ref["bits0"]),
                     torch.from_numpy(ref["ok0"]), f)
    _llr_close(d1, ref["d1"])
    _llr_close(port.cancel(cb0, ok0, f), ref["d1"])


def test_sic_decoder_matches_reference_and_beats_mmse(iq, ref, port):
    bits, ok, it = port(torch.from_numpy(iq[0]))
    want_bits = np.stack([ref["tb0"], ref["tb1"]], 1).reshape(2 * B, -1)
    want_ok = np.stack([ref["ok0"], ref["ok1"]], 1).reshape(-1)
    np.testing.assert_array_equal(ok.numpy(), want_ok)
    np.testing.assert_array_equal(bits.numpy(), want_bits)
    sent = decoder_rows(iq[1])
    np.testing.assert_array_equal(bits.numpy()[want_ok], sent[want_ok])
    s0, s1 = port.tail_stats
    assert it == max(s0.n_iter, s1.n_iter) == port.last_stats.n_iter
    assert port.last_stats.syncs == s0.syncs + s1.syncs
    mmse = make_mimo_batch_decoder(*CELL.decoder_args(), **CELL.precoding,
                                   tuning=DecoderTuning(retry_m_mimo=0),
                                   device="cpu")
    ok_mmse = mmse(torch.from_numpy(iq[0]))[1]
    assert int(ok.sum()) > int(ok_mmse.sum())


@pytest.mark.parametrize("knob", [{"mimo_denoise": True},
                                  {"mimo_chest": "mmse"}],
                         ids=["denoise", "mmse_chest"])
def test_d4_fronts_match_reference(iq, knob):
    f1, _ = _mimo_stages(*_ref_args(), 6, RefTuning(**REF_TUNING, **knob),
                         True, tm=CELL.tm, cb_index=CELL.cb_index)
    d_r = np.asarray(jax.jit(f1)(jnp.asarray(iq[0])))
    dec = make_mimo_batch_decoder(*CELL.decoder_args(), **CELL.precoding,
                                  tuning=DecoderTuning(**knob), device="cpu")
    d = dec.front(torch.from_numpy(iq[0]))
    _llr_close(d, d_r)
    plain = make_mimo_batch_decoder(*CELL.decoder_args(), **CELL.precoding,
                                    device="cpu").front(
        torch.from_numpy(iq[0]))
    assert not torch.allclose(d, plain)          # the knob changed the front
