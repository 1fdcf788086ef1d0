"""The factored DFT (``lteax_torch.phy.dft``), the OFDM demod's factored
forms (``phy.ofdm.samples_to_subframe``), the UL transform's forms
(``phy.channels.pusch.ul_dft``) and the tuning's DFT forms
(``phy.tuning``) against numpy and the JAX reference on the CPU.

- ``dft_factored`` (f32 products, the reference's HIGHEST): forward,
  inverse and unitary within 1e-5 of the peak of a float64 ``np.fft`` and
  of the reference's ``lteax.phy.dft.dft_factored``, at every bandwidth's
  n_fft, the UL sizes and a prime length (the dense fallback).
- ``"factored"`` rounds each real matmul's operands to bf16, as the TPU's
  single pass; XLA:CPU ignores the matmul precision, so the reference's CPU
  ``"factored"`` is the f32 transform.  It is held to a float64 numpy model
  of the rounding (operands rounded to bf16 by round to nearest even, exact
  arithmetic after), stage by stage: the first matmul's f32 output within
  1e-6 of its peak from the model's (measured <= 1.2e-7), and the whole
  demod, its second matmul's operand rounded from the port's own f32 first
  stage, within 1e-5 of the peak (measured <= 1.1e-7).  Where an f32 sum
  lies within its own rounding error of a bf16 tie, the f32 first stage
  and the exact one round one bf16 ulp apart; such operands must stay
  under 1e-3 of the second matmul's (measured 0 to 1.4e-4; a wrong
  rounding mode moves half of them).  Each moves the outputs of its row by
  up to 4.9e-4 of the peak (75 PRB, measured), so the model end to end is
  no f32-class yardstick, on the TPU either.  Against the reference's CPU
  front, bf16 class: RMS within 5e-3 of the output's RMS (measured 2.5e-3
  at 6 PRB, 2.8e-3 at 100).  ``"factored_hi"`` within 1e-5 of the peak of the
  reference's ``"factored_hi"`` and ``"fft"``.
- ``ul_dft``'s ``"factored"`` and ``"matmul"`` within 1e-5 of the peak of
  the reference's ``_ul_dft`` under ``LTEAX_UL_DFT``; the single-subframe
  and batch UL decodes under each form decode the bits sent.
- DL, HARQ and TM3 MMSE decodes under ``SHIPPED`` against the reference's
  at its shipped numerics with the factored OFDM DFT (f32 on the CPU) at
  25 dB: CRC flags and iteration counts equal, every passing block's bits
  the bits sent.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lteax.phy import dft as dft_ref
from lteax.phy.channels import pusch as pusch_ref
from lteax.phy.config import PhyConfig as RefPhyConfig
from lteax.phy.ofdm import samples_to_subframe as s2s_ref

from lteax_torch.phy import dft, ofdm
from lteax_torch.phy.channels import pusch
from lteax_torch.phy.config import PhyConfig
from lteax_torch.phy.tuning import (OFDM_DFTS, SHIPPED, UL_DFTS,
                                    DecoderTuning)
from lteax_torch.pipeline import (make_mimo_batch_decoder,
                                  make_pusch_batch_decoder)
from lteax_torch.sim import ul_gen
from lteax_torch.sim.mimo_gen import MimoCell

torch.set_num_threads(1)

TOL = 1e-5               # of the peak: f32 against float64 or f32
STAGE_A_TOL = 1e-6       # of the first stage's peak
FLIP_LIMIT = 1e-3        # bf16 operands rounded apart (<= 1.4e-4 measured)
BF16_RMS_TOL = 5e-3      # the bf16 class against the reference's CPU front
N_OFDM = (128, 256, 512, 1024, 1536, 2048)
N_UL = (12, 36, 72, 180, 300, 600, 1200)
N_PRIME = 139
FORMS = {"forward": (False, False), "inverse": (True, False),
         "unitary": (False, True), "unitary_inverse": (True, True)}


def _noise(shape, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return ((rng.standard_normal(shape) + 1j * rng.standard_normal(shape))
            / np.sqrt(2)).astype(np.complex64)


def _of_peak(got, want) -> float:
    return float(np.abs(got - want).max() / np.abs(want).max())


def _rms_of_rms(got, want) -> float:
    return float(np.sqrt(np.mean(np.abs(got - want) ** 2)
                         / np.mean(np.abs(want) ** 2)))


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("n", N_OFDM + N_UL + (N_PRIME,))
def test_dft_factored_matches_numpy_and_reference(n, form):
    inverse, unitary = FORMS[form]
    x = _noise((3, n), n)
    got = dft.dft_factored(torch.from_numpy(x), inverse, unitary)
    assert got.dtype == torch.complex64 and got.shape == x.shape
    got = got.numpy()
    x64 = x.astype(np.complex128)
    want = np.fft.ifft(x64) if inverse else np.fft.fft(x64)
    if unitary:
        want = want * (np.sqrt(n) if inverse else 1 / np.sqrt(n))
    assert _of_peak(got, want) <= TOL
    ref = np.asarray(dft_ref.dft_factored(jnp.asarray(x), inverse, unitary))
    assert _of_peak(got, ref) <= TOL


def _bf16(x: np.ndarray) -> np.ndarray:
    """f32 values rounded to bf16 by round to nearest even, as float64."""
    u = np.asarray(x, np.float32).view(np.uint32).astype(np.uint64)
    u = (u + 0x7FFF + ((u >> 16) & 1)) >> 16 << 16
    return u.astype(np.uint32).view(np.float32).astype(np.float64)


def _cbf16(z: np.ndarray) -> np.ndarray:
    return _bf16(z.real) + 1j * _bf16(z.imag)


def _model(blocks: np.ndarray, cfg, a_f32: np.ndarray):
    """The factored demod in float64 over bf16-rounded operands -> (the
    first stage (..., k2, n1), the sub-carriers (..., n_sc)).  The second
    matmul's operand is rounded from ``a_f32``, an f32 first stage."""
    n = cfg.n_fft
    n1, n2, w1, w2, tw = dft_ref._consts(n, False)
    v = blocks.reshape(*blocks.shape[:-1], n2, n1)
    a = _cbf16(w2) @ _cbf16(v) * tw.astype(np.complex128)
    c = (_cbf16(a_f32) @ _cbf16(w1)).reshape(*blocks.shape[:-1], n)
    bins = cfg.sc_to_fft_bin
    return a, c[..., (bins % n2) * n1 + bins // n2] / np.sqrt(n)


@pytest.mark.parametrize("n_rb", [6, 15, 25, 50, 75, 100])
def test_factored_demod_matches_its_rounding_model(n_rb):
    cfg = PhyConfig(n_rb_dl=n_rb)
    s = _noise((2, cfg.n_samps_subframe), n_rb)
    got = ofdm.samples_to_subframe(torch.from_numpy(s), cfg, "factored")
    assert got.dtype == torch.complex64
    got = got.numpy()
    blocks = s[..., ofdm._symbol_sample_idx(cfg)]
    # the port's own first stage, from the module's public pieces
    n1, n2, w1, w2, tw = dft.plan(cfg.n_fft, False, True, torch.device("cpu"))
    v = torch.from_numpy(blocks).reshape(*blocks.shape[:-1], n2, n1)
    a = (dft.cmatmul(w2, v, True) * tw).numpy()
    a64, own = _model(blocks, cfg, a)
    assert _of_peak(a, a64) <= STAGE_A_TOL
    assert _of_peak(got, own) <= TOL
    flips = np.mean(_cbf16(a) != _cbf16(a64.astype(np.complex64)))
    assert flips <= FLIP_LIMIT


@pytest.mark.parametrize("n_rb", [6, 100])
def test_factored_demod_matches_reference(n_rb):
    cfg, cfg_r = PhyConfig(n_rb_dl=n_rb), RefPhyConfig(n_rb_dl=n_rb)
    s = _noise((2, cfg.n_samps_subframe), 1000 + n_rb)
    ref = {d: np.asarray(s2s_ref(jnp.asarray(s), cfg_r, dft=d))
           for d in OFDM_DFTS}
    got = {d: ofdm.samples_to_subframe(torch.from_numpy(s), cfg, d).numpy()
           for d in ("factored", "factored_hi")}
    assert _rms_of_rms(got["factored"], ref["factored"]) <= BF16_RMS_TOL
    assert _of_peak(got["factored_hi"], ref["factored_hi"]) <= TOL
    assert _of_peak(got["factored_hi"], ref["fft"]) <= TOL


def test_unknown_dft_forms_raise():
    cfg = PhyConfig(n_rb_dl=6)
    x = torch.zeros(cfg.n_samps_subframe, dtype=torch.complex64)
    with pytest.raises(ValueError, match="dft"):
        ofdm.samples_to_subframe(x, cfg, "matmul")
    with pytest.raises(ValueError, match="ul_dft"):
        pusch.ul_dft(torch.zeros(12, dtype=torch.complex64), True,
                     "factored_hi")
    for field, bad in (("ofdm_dft", "matmul"), ("ofdm_dft", "FFT"),
                       ("ul_dft", "factored_hi"), ("ul_dft", None)):
        with pytest.raises(ValueError, match=field):
            DecoderTuning(**{field: bad})
    assert (DecoderTuning().ofdm_dft, DecoderTuning().ul_dft) == ("fft", "fft")


@pytest.mark.parametrize("mode", ["factored", "matmul"])
@pytest.mark.parametrize("m_sc", [12, 72, 300, 1200])
def test_ul_dft_forms_match_reference(m_sc, mode, monkeypatch):
    monkeypatch.setenv("LTEAX_UL_DFT", mode)
    x = _noise((3, m_sc), m_sc)
    for inverse in (False, True):
        got = pusch.ul_dft(torch.from_numpy(x), inverse, mode).numpy()
        ref = np.asarray(pusch_ref._ul_dft(jnp.asarray(x), inverse))
        assert _of_peak(got, ref) <= TOL


@pytest.mark.parametrize("mode", UL_DFTS)
def test_ul_decodes_under_each_ul_dft(mode):
    """The UL signal precoded and de-precoded by ``mode``: the
    single-subframe decode (with and without UCI) and the batch decoder
    decode the bits sent."""
    alloc = pusch.PuschAlloc(n_prb=6, rb_start=0, mcs_tbs=1192, qm=4)
    cell = ul_gen.UlCell(alloc=alloc, n_cell_id=301, subframe=2, rnti=0x5DEF)
    iq, tb = ul_gen.ul_subframes(cell, 2, snr_db=20.0, seed=5, dft=mode)
    grid = torch.complex(*map(torch.from_numpy, (iq[..., 0], iq[..., 1])))
    args = (cell.rnti, cell.subframe, cell.n_cell_id)
    bits, ok, _ = pusch.pusch_decode(grid, alloc, *args, dft=mode)
    assert ok.all() and np.array_equal(bits.numpy(), tb)
    bits, ok, _ = make_pusch_batch_decoder(
        *cell.decoder_args(), tuning=DecoderTuning(ul_dft=mode),
        device="cpu")(torch.from_numpy(iq))
    assert ok.all() and np.array_equal(bits.numpy(), tb)
    uci = pusch.PuschUci(n_ack=2, n_ri=1)
    iq, tb = ul_gen.ul_subframes(cell, 1, snr_db=20.0, seed=6, uci=uci,
                                 ack=(1, 0), ri=(1,), dft=mode)
    grid = torch.complex(*map(torch.from_numpy, (iq[0, ..., 0],
                                                 iq[0, ..., 1])))
    bits, ok, _, ack, ri = pusch.pusch_decode_uci(grid, alloc, *args, uci,
                                                  noise_var=1e-2, dft=mode)
    assert bool(ok) and np.array_equal(bits.numpy(), tb[0])
    assert (ack, ri) == ((1, 0), (1,))


def test_sic_front_takes_the_tuning_dft():
    """SIC's front is the MMSE decoder's :class:`MimoFront`: the tuning's
    OFDM DFT reaches it as well."""
    cell = MimoCell(n_rb_dl=6, cfi=2, mcs=15, tm=4, cb_index=0)
    dec = make_mimo_batch_decoder(
        *cell.decoder_args(), **cell.precoding, device="cpu",
        tuning=dataclasses.replace(SHIPPED, mimo_detector="sic"))
    assert dec.mimo_front.dft == "factored"
