"""UCI on PUSCH (HARQ-ACK and RI multiplexed with UL-SCH data) in the port
against the reference (``lteax.phy.channels.pusch``), on the CPU.

- the plans: ``uci_q_prime``, ``uci_layout``, ``alloc_geom_uci`` and
  ``_uci_word`` equal to the reference's;
- the jax-free encoder ``sim.ul_gen.pusch_encode_cbs_uci``: the reference
  encoder's grids within float rounding;
- ``_uci_ml_decode``: the reference's hypothesis on random LLRs;
- ``pusch_decode_uci`` at 6 PRB QPSK and 25 PRB 16QAM with 2 ACK and 1 or
  2 RI bits, on a clean subframe and on one whose transport block fails:
  CRC flags, ACK and RI equal to the reference's; the bits of the block
  that passes equal to the reference's and to the bits sent.  (The
  reference decodes with its XLA turbo, the port with the turbo kernel's
  plain version; a failing block's bits may end otherwise, see
  ``test_torch_pusch_decode.py``, whose stage-by-stage checks cover the
  decode tail this path shares.)
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lteax.phy.channels import pusch as pusch_ref

from lteax_torch.phy.channels import pusch
from lteax_torch.phy.channels.pdsch import pdsch_prepare_cbs
from lteax_torch.sim import ul_gen

RNTI, SF, CID = 0x3D, 4, 214


@pytest.fixture(autouse=True, scope="module")
def _setup():
    """One torch thread; the reference's fft UL DFT (the port's form)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    mp = pytest.MonkeyPatch()
    mp.setenv("LTEAX_UL_DFT", "fft")
    yield
    mp.undo()
    torch.set_num_threads(n)


def _allocs(n_prb, qm, tbs):
    return (pusch.PuschAlloc(n_prb, 0, tbs, qm),
            pusch_ref.PuschAlloc(n_prb, 0, tbs, qm))


def _ucis(**kw):
    return pusch.PuschUci(**kw), pusch_ref.PuschUci(**kw)


PLAN_CASES = [(6, 2, 712), (15, 6, 11064), (25, 4, 4968), (100, 6, 75376)]
UCI_CASES = [dict(n_ack=1), dict(n_ri=2), dict(n_ack=2, n_ri=1),
             dict(n_ack=2, n_ri=2, beta_ack=5.0, beta_ri=2.5)]


@pytest.mark.parametrize("n_prb,qm,tbs", PLAN_CASES)
@pytest.mark.parametrize("kw", UCI_CASES, ids=["ack1", "ri2", "ack2ri1",
                                               "ack2ri2-beta"])
def test_uci_plans_match_the_reference(n_prb, qm, tbs, kw):
    alloc, alloc_r = _allocs(n_prb, qm, tbs)
    uci, uci_r = _ucis(**kw)
    q = []
    for n, beta in ((uci.n_ack, uci.beta_ack), (uci.n_ri, uci.beta_ri)):
        q.append(pusch.uci_q_prime(n, alloc, beta))
        assert q[-1] == pusch_ref.uci_q_prime(n, alloc_r, beta)
    q_ack, q_ri = q
    for got, ref in zip(pusch.uci_layout(alloc.m_sc, qm, q_ri, q_ack),
                        pusch_ref.uci_layout(alloc.m_sc, qm, q_ri, q_ack)):
        assert got.dtype == ref.dtype
        np.testing.assert_array_equal(got, ref)
    g, g_r = pusch.alloc_geom_uci(alloc, uci), pusch_ref.alloc_geom_uci(
        alloc_r, uci_r)
    assert (g.tbs, g.n_re, g.qm, g.rv, g.e_list) == \
        (g_r.tbs, g_r.n_re, g_r.qm, g_r.rv, g_r.e_list)
    assert dataclasses.asdict(g.info) == dataclasses.asdict(g_r.info)


def test_uci_words_and_ml_decode_match_the_reference():
    rng = np.random.default_rng(3)
    for bits in ((0,), (1,), (0, 0), (0, 1), (1, 0), (1, 1)):
        for n in (1, 5, 12, 37):
            np.testing.assert_array_equal(pusch._uci_word(bits, n),
                                          pusch_ref._uci_word(bits, n))
    for n_bits in (1, 2):
        for n in (6, 24, 90):
            llr = (rng.standard_normal(n) * 3.0).astype(np.float32)
            assert pusch._uci_ml_decode(torch.from_numpy(llr), n_bits) == \
                pusch_ref._uci_ml_decode(jnp.asarray(llr), n_bits)


def _uci_grids(alloc, uci, ack, ri, snrs, seed):
    rng = np.random.default_rng(seed)
    geom = pusch.alloc_geom_uci(alloc, uci)
    tb = rng.integers(0, 2, (len(snrs), alloc.mcs_tbs)).astype(np.int32)
    cbs = np.stack([pdsch_prepare_cbs(t, geom) for t in tb])
    g = ul_gen.pusch_encode_cbs_uci(cbs, alloc, RNTI, SF, CID, uci, ack, ri)
    clean = g
    g = ul_gen.pusch_add_dmrs(g, alloc, CID, SF)
    sig = np.sqrt(10 ** (-np.asarray(snrs) / 10) / 2)[:, None, None]
    g = g + sig * (rng.standard_normal(g.shape)
                   + 1j * rng.standard_normal(g.shape))
    return clean, cbs, g.astype(np.complex64), tb


# id -> (n_prb, qm, TBS, n_ri, ACK bits, RI bits, (clean, failing) SNR dB)
DECODE_CASES = {"6prb-qpsk": (6, 2, 712, 1, (1, 0), (1,), (20.0, 1.0)),
                "25prb-16qam": (25, 4, 4968, 2, (0, 1), (1, 1), (25.0, 3.0))}


@pytest.mark.parametrize("case", list(DECODE_CASES))
def test_encoder_and_decode_match_the_reference(case):
    n_prb, qm, tbs, n_ri, ack, ri, snrs = DECODE_CASES[case]
    alloc, alloc_r = _allocs(n_prb, qm, tbs)
    uci, uci_r = _ucis(n_ack=len(ack), n_ri=n_ri)
    clean, cbs, g, tb = _uci_grids(alloc, uci, ack, ri, snrs, seed=n_prb)
    ref_enc = np.asarray(pusch_ref.pusch_encode_cbs_uci(
        jnp.asarray(cbs[0]), alloc_r, RNTI, SF, CID, uci_r, ack, ri))
    np.testing.assert_allclose(clean[0], ref_enc, rtol=0, atol=1e-5)
    oks = []
    for b in range(len(snrs)):
        tb_p, ok_p, cb_p, ack_p, ri_p = pusch.pusch_decode_uci(
            torch.from_numpy(g[b]), alloc, RNTI, SF, CID, uci)
        tb_r, ok_r, cb_r, ack_r, ri_r = pusch_ref.pusch_decode_uci(
            jnp.asarray(g[b]), alloc_r, RNTI, SF, CID, uci_r)
        assert bool(ok_p) == bool(ok_r)
        np.testing.assert_array_equal(cb_p.numpy(), np.asarray(cb_r))
        assert (ack_p, ri_p) == (ack_r, ri_r)
        assert isinstance(ack_p, tuple) and len(ack_p) == len(ack)
        if bool(ok_p):
            np.testing.assert_array_equal(tb_p.numpy(), np.asarray(tb_r))
            np.testing.assert_array_equal(tb_p.numpy(), tb[b])
            assert (ack_p, ri_p) == (ack, ri)
        oks.append(bool(ok_p))
    assert oks == [True, False]                 # clean, then a failing block


def test_dmrs_cyclic_shift_and_iterations_as_the_reference():
    """``pusch_decode_uci(..., n_dmrs=3, n_iter=5)``, the reference's
    arguments, on a clean 6-PRB subframe: flags, bits, ACK and RI as the
    reference's and as sent."""
    alloc, alloc_r = _allocs(6, 2, 712)
    uci, uci_r = _ucis(n_ack=2, n_ri=1)
    rng = np.random.default_rng(4)
    geom = pusch.alloc_geom_uci(alloc, uci)
    tb = rng.integers(0, 2, alloc.mcs_tbs).astype(np.int32)
    g = ul_gen.pusch_encode_cbs_uci(pdsch_prepare_cbs(tb, geom), alloc, RNTI,
                                    SF, CID, uci, (1, 1), (0,))
    g = ul_gen.pusch_add_dmrs(g, alloc, CID, SF, n_dmrs=3)
    g = (g + 0.05 * (rng.standard_normal(g.shape)
                     + 1j * rng.standard_normal(g.shape))).astype(
                         np.complex64)
    tb_p, ok_p, cb_p, ack_p, ri_p = pusch.pusch_decode_uci(
        torch.from_numpy(g), alloc, RNTI, SF, CID, uci, n_dmrs=3, n_iter=5)
    tb_r, ok_r, cb_r, ack_r, ri_r = pusch_ref.pusch_decode_uci(
        jnp.asarray(g), alloc_r, RNTI, SF, CID, uci_r, n_dmrs=3, n_iter=5)
    assert bool(ok_p) and bool(ok_r)
    np.testing.assert_array_equal(cb_p.numpy(), np.asarray(cb_r))
    np.testing.assert_array_equal(tb_p.numpy(), np.asarray(tb_r))
    np.testing.assert_array_equal(tb_p.numpy(), tb)
    assert (ack_p, ri_p) == (ack_r, ri_r) == ((1, 1), (0,))
