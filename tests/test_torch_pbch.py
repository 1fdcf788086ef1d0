"""The port's PBCH chain against the reference: convolutional encoder,
batched tail-biting Viterbi, conv rate match / de-match, CRC16 with the
antenna masks, the 40 ms PBCH encoder and the 12-hypothesis blind decode.
Bits and flags must be equal; de-matched LLRs agree to float rounding
(the reference scatter-adds, the port sums the repeats in send order)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lteax.phy.channels import pbch as pbch_ref
from lteax.phy.fec import conv as conv_ref
from lteax.phy.fec import crc as crc_ref
from lteax.phy.fec import ratematch as rm_ref
from lteax.phy.fec.viterbi import viterbi_decode_tb_batch as viterbi_ref
from lteax.phy.mod import demodulate_maxlog as demod_ref
from lteax.stack import rrc

from lteax_torch.phy.channels import pbch
from lteax_torch.phy.fec import conv, crc, ratematch
from lteax_torch.phy.fec.viterbi import viterbi_decode_tb_batch
from lteax_torch.phy.mod import demodulate_maxlog, modulate


def test_conv_encode():
    bits = np.random.default_rng(0).integers(0, 2, (5, 40))
    np.testing.assert_array_equal(conv.conv_encode(bits),
                                  np.asarray(conv_ref.conv_encode(
                                      jnp.asarray(bits))))


@pytest.mark.parametrize("sigma", [0.0, 0.8, 1.6])
def test_viterbi_batch_matches_reference(sigma):
    """Noisy codewords, and a tie-heavy batch (zeros, integer LLRs) where
    the first-maximum rule decides."""
    rng = np.random.default_rng(int(sigma * 10))
    bits = rng.integers(0, 2, (16, 40))
    d = conv.conv_encode(bits).astype(np.float32)
    llr = (1.0 - 2.0 * d) + sigma * rng.standard_normal(d.shape)
    llr = llr.astype(np.float32)
    llr[:3] = 0.0
    llr[3:6] = np.round(llr[3:6])
    got = viterbi_decode_tb_batch(torch.from_numpy(llr), 40).numpy()
    ref = np.asarray(viterbi_ref(jnp.asarray(llr), 40))
    np.testing.assert_array_equal(got, ref)
    if sigma == 0.0:
        np.testing.assert_array_equal(got[6:], bits[6:])


@pytest.mark.parametrize("e_len", [1920, 480, 100])
def test_conv_rate_match_and_unmatch(e_len):
    rng = np.random.default_rng(e_len)
    d = rng.integers(0, 2, (2, 3, 40))
    idx = ratematch.conv_rm_indices(40, e_len)
    np.testing.assert_array_equal(
        ratematch.rate_match(d, idx),
        np.asarray(rm_ref.rate_match(jnp.asarray(d), idx)))
    e = rng.standard_normal((2, e_len)).astype(np.float32)
    got = ratematch.rate_unmatch(torch.from_numpy(e), idx, 40).numpy()
    ref = np.asarray(rm_ref.rate_unmatch(jnp.asarray(e), idx, 40))
    assert got.shape == ref.shape == (2, 3, 40)
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("n_ant", [1, 2, 4])
def test_crc16_masks(n_ant):
    rng = np.random.default_rng(n_ant)
    mask = pbch.ANT_MASKS[n_ant]
    msg = rng.integers(0, 2, (3, 24))
    got = crc.attach_crc_np(msg, "16", mask_bits=mask)
    ref = np.stack([crc_ref.attach_crc_np(m, "16", mask_bits=mask)
                    for m in msg])
    np.testing.assert_array_equal(got, ref)
    got[2, 30] ^= 1
    for a in (1, 2, 4):
        _, ok = crc.check_crc(torch.from_numpy(got), "16",
                              mask_bits=pbch.ANT_MASKS[a])
        _, ok_r = crc_ref.check_crc(jnp.asarray(got), "16",
                                    mask_bits=pbch_ref.ANT_MASKS[a])
        np.testing.assert_array_equal(ok.numpy(), np.asarray(ok_r))
        assert ok.tolist() == [a == n_ant, a == n_ant, False]


@pytest.mark.parametrize("n_ant", [1, 2, 4])
def test_pbch_encode_40ms(n_ant):
    mib = rrc.pack_mib(rrc.Mib(n_rb_dl=50, phich_duration_extended=False,
                               phich_resource=0.5, sfn=612))
    np.testing.assert_array_equal(
        pbch.pbch_encode_40ms(mib, n_ant, 301),
        np.asarray(pbch_ref.pbch_encode_40ms(jnp.asarray(mib), n_ant, 301)))


@pytest.mark.parametrize("n_ant", [1, 2, 4])
def test_blind_decode_on_reference_llrs(n_ant):
    """Every quarter of a 40 ms codeword, QPSK at ~3 dB, demodulated by the
    reference; both decoders resolve the same (n_ant, quarter, MIB)."""
    cid = 77 + n_ant
    rng = np.random.default_rng(n_ant)
    mib = rrc.pack_mib(rrc.Mib(n_rb_dl=100, phich_duration_extended=True,
                               phich_resource=2.0, sfn=256 + 4 * n_ant))
    quarters = pbch.pbch_encode_40ms(mib, n_ant, cid)
    for q in range(4):
        sym = modulate(quarters[q], "qpsk")
        y = (sym + 0.5 * (rng.standard_normal(sym.shape)
                          + 1j * rng.standard_normal(sym.shape))
             ).astype(np.complex64)
        llr = np.array(demod_ref(jnp.asarray(y), "qpsk", 0.5))
        np.testing.assert_allclose(
            demodulate_maxlog(torch.from_numpy(y), "qpsk", 0.5).numpy(), llr,
            rtol=1e-6, atol=1e-5)
        ref = pbch_ref.pbch_blind_decode({a: jnp.asarray(llr)
                                          for a in (1, 2, 4)}, cid)
        got = pbch.pbch_blind_decode({a: torch.from_numpy(llr)
                                      for a in (1, 2, 4)}, cid)
        assert got[1:] == tuple(ref[1:]) == (n_ant, q, True)
        np.testing.assert_array_equal(got[0], np.asarray(ref[0]))
        np.testing.assert_array_equal(got[0], mib)


def test_blind_decode_garbage_fails_cleanly():
    llr = torch.from_numpy(np.random.default_rng(9).standard_normal(480)
                           .astype(np.float32) * 0.01)
    assert pbch.pbch_blind_decode({a: llr for a in (1, 2, 4)}, 5) == \
        (None, 0, 0, False)
