"""The port's single-subframe PUSCH decode (``pusch.pusch_decode``) against
the reference's (``lteax.phy.channels.pusch.pusch_decode``), on the CPU.

Gridded subframes from the port's UL generator at 6 PRB QPSK and 25 PRB
16QAM, each row at its own SNR so that some decode and some fail; the
reference runs with its fft transform precoding (``LTEAX_UL_DFT=fft``).
The reference decodes with its XLA turbo (frozen dead positions), the port
with the turbo kernel's plain version (pinned padding), both at win 32 and
6 iterations: CRC flags equal, and the bits of every block that passes
equal (and equal to the bits sent).

A block that fails is chaotic: a last-bit difference in the front (torch's
and XLA's FFTs round differently) or the other padding form can end it on
other bits (4 of 4968 at 25 PRB 16QAM 3 dB, even with the reference's
pinned turbo).  So the decode is also held stage by stage: the front (LS,
denoiser, MMSE, IDFT, max-log demap, descramble, de-interleave) of every
block within 1e-5 of the largest LLR against the reference's receiver
steps, and the tail of a failing block on the same LLRs (de-match, turbo,
CRC24A) bit for bit against the reference's de-match and its own
pinned-padding Pallas turbo (interpret mode, win 32, 6 iterations).

Then the 1-PRB allocation, which uses the length-12 base sequence:
``base_sequence(u, 12)`` equals the reference's for all 30 u, and a 1-PRB
subframe decodes to the bits sent, as the reference's decode does.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lteax.kernels.turbo_mlm import turbo_decode_batch_pallas
from lteax.phy import seq as seq_ref
from lteax.phy.channels import pdsch as pdsch_ref
from lteax.phy.channels import pusch as pusch_ref
from lteax.phy.fec import crc as crc_ref
from lteax.phy.mod import demodulate_maxlog as demod_ref

from lteax_torch.phy.channels import pdsch, pusch
from lteax_torch.phy.channels.pdsch import pdsch_prepare_cbs
from lteax_torch.pipeline import make_pusch_batch_decoder
from lteax_torch.sim import ul_gen

RNTI, SF, CID = 0x3D, 4, 214
# id -> (n_prb, qm, TBS, per-row SNR dB)
CASES = {"6prb-qpsk": (6, 2, 712, (20.0, 2.5, 1.5, 0.5)),
         "25prb-16qam": (25, 4, 4968, (25.0, 5.0, 4.0, 3.0))}


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


def pinned_reference_turbo(llr_d, k, n_iter=6, win=32, acq=16):
    """The reference's Pallas turbo with pinned padding, in interpret mode,
    with the signature of ``lteax.phy.fec.turbo.turbo_decode_batch``."""
    return turbo_decode_batch_pallas(
        llr_d, k, n_iter=n_iter, win=win, acq=acq, early_crc=None,
        mdtype="f32", fused=True, nofreeze=False, pinpad=True, retry_m=0,
        layout=False, interpret=True)


def grids(alloc, snrs, seed, encode=None):
    """(B, 14, m_sc) complex64 noisy grids and their TB bits (B, TBS)."""
    rng = np.random.default_rng(seed)
    tb = rng.integers(0, 2, (len(snrs), alloc.mcs_tbs)).astype(np.int32)
    geom = alloc.geom
    cbs = np.stack([pdsch_prepare_cbs(t, geom) for t in tb])
    g = (encode or ul_gen.pusch_encode_cbs)(cbs, alloc, RNTI, SF, CID)
    g = ul_gen.pusch_add_dmrs(g, alloc, CID, SF)
    sig = np.sqrt(10 ** (-np.asarray(snrs) / 10) / 2)[:, None, None]
    g = g + sig * (rng.standard_normal(g.shape)
                   + 1j * rng.standard_normal(g.shape))
    return g.astype(np.complex64), tb


def reference_front(grid, alloc_r):
    """The first half of ``lteax.phy.channels.pusch.pusch_decode`` (its
    defaults: estimated noise, denoised LS), from the reference's own
    functions: (14, m_sc) -> descrambled, de-interleaved LLRs (G,)."""
    m_sc, dmrs = alloc_r.m_sc, pusch_ref.DMRS_SYMS
    ls = [grid[sym] * jnp.conj(jnp.asarray(pusch_ref.dmrs_pusch(
        CID, 2 * SF + i, m_sc))) for i, sym in enumerate(dmrs)]
    nv = jnp.maximum(jnp.mean(jnp.abs(ls[0] - ls[1]) ** 2) / 2.0, 1e-6)
    h0, h1 = (pusch_ref.chest_denoise(h) for h in ls)
    data = [s for s in range(14) if s not in dmrs]
    w = jnp.clip(jnp.asarray([(s - dmrs[0]) / (dmrs[1] - dmrs[0])
                              for s in data], jnp.float32), 0.0, 1.0)[:, None]
    h = (1 - w) * h0[None, :] + w * h1[None, :]
    p = jnp.abs(h) ** 2
    x_f = grid[jnp.asarray(data)] * jnp.conj(h) / (p + nv)
    x_f = x_f / jnp.maximum(p / (p + nv), 1e-12)
    x_t = pusch_ref._ul_dft(x_f, inverse=True)
    eff = jnp.mean(nv / jnp.maximum(p, 1e-12), axis=-1,
                   keepdims=True) * jnp.ones_like(p)
    llr = demod_ref(x_t.reshape(-1), alloc_r.scheme, eff.reshape(-1))
    g = alloc_r.geom.g
    c = seq_ref.gold_sequence(RNTI * 2 ** 14 + SF * 512 + CID, g)
    llr = llr * (1.0 - 2.0 * c).astype(llr.dtype)
    return llr[jnp.asarray(pusch_ref._inv((g, alloc_r.qm)))]


def reference_tail(llr, geom_r):
    """The reference's de-match, pinned-padding turbo and CRC tail on
    descrambled codeword LLRs (G,) -> (tb bits, tb ok)."""
    d = pdsch_ref.soft_dematch(jnp.asarray(llr), geom_r)
    bits = pinned_reference_turbo(d, geom_r.k)
    if geom_r.info.cb_crc:
        bits, _ = crc_ref.check_crc(bits, "24B")
    tb, ok = crc_ref.check_crc(pdsch_ref.desegment_device(bits, geom_r.info),
                               "24A")
    return np.asarray(tb), bool(ok)


@pytest.fixture(scope="module", params=list(CASES))
def case(request):
    n_prb, qm, tbs, snrs = CASES[request.param]
    alloc = pusch.PuschAlloc(n_prb, 0, tbs, qm)
    alloc_r = pusch_ref.PuschAlloc(n_prb, 0, tbs, qm)
    g, tb = grids(alloc, snrs, seed=n_prb)
    got = [x.numpy() for x in pusch.pusch_decode(torch.from_numpy(g), alloc,
                                                 RNTI, SF, CID)]
    return alloc, alloc_r, g, tb, got


def test_flags_and_passing_bits_match_the_reference(case):
    alloc, alloc_r, g, tb, (bits, ok, cb_oks) = case
    xla = jax.jit(jax.vmap(lambda x: pusch_ref.pusch_decode(
        x, alloc_r, RNTI, SF, CID)))(jnp.asarray(g))
    xla = [np.asarray(x) for x in xla]
    assert bits.dtype == np.int8 and bits.shape == tb.shape
    assert ok.any() and not ok.all(), ok            # some pass, some fail
    np.testing.assert_array_equal(ok, xla[1])
    np.testing.assert_array_equal(cb_oks, xla[2])
    np.testing.assert_array_equal(bits[ok], xla[0][ok])
    np.testing.assert_array_equal(bits[ok], tb[ok])


def test_front_and_failing_tail_match_the_reference(case):
    alloc, alloc_r, g, tb, (bits, ok, _) = case
    geom = alloc.geom
    front = pusch._descramble(pusch._equalize_llrs(
        torch.from_numpy(g), alloc.scheme, alloc.m_sc, SF, CID, None, True),
        RNTI, SF, CID)[..., pusch._inv_interleaver(geom.g, alloc.qm)]
    one = jax.jit(lambda x: reference_front(x, alloc_r))
    for b in range(len(g)):
        ref = np.asarray(one(jnp.asarray(g[b])))
        np.testing.assert_allclose(front[b].numpy(), ref, rtol=0,
                                   atol=1e-5 * np.abs(ref).max())
    # the tail of the first failing block, on the port's LLRs
    b = np.flatnonzero(~ok)[0]
    tb_p, ok_p, _ = pdsch.decode_codeword(front[b], geom)
    tb_r, ok_r = reference_tail(front[b].numpy(), alloc_r.geom)
    assert not bool(ok_p) and not ok_r
    np.testing.assert_array_equal(tb_p.numpy(), tb_r)
    np.testing.assert_array_equal(tb_p.numpy(), bits[b])


def test_static_noise_prior_and_no_denoise_as_the_reference():
    """A pinned ``noise_var`` and ``denoise=False``, at 6 PRB, one clean
    subframe: the reference's bits and flags."""
    alloc = pusch.PuschAlloc(6, 0, 712, 2)
    alloc_r = pusch_ref.PuschAlloc(6, 0, 712, 2)
    g, tb = grids(alloc, (15.0,), seed=9)
    got = pusch.pusch_decode(torch.from_numpy(g[0]), alloc, RNTI, SF, CID,
                             noise_var=0.03, denoise=False)
    ref = jax.jit(lambda x: pusch_ref.pusch_decode(
        x, alloc_r, RNTI, SF, CID, noise_var=0.03, denoise=False))(
            jnp.asarray(g[0]))
    assert bool(got[1]) and bool(ref[1])
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(ref[0]))
    np.testing.assert_array_equal(got[0].numpy(), tb[0])


def test_one_prb_base_sequences_and_decode():
    for u in range(30):
        np.testing.assert_array_equal(pusch.base_sequence(u, 12),
                                      pusch_ref.base_sequence(u, 12))
    for mod in (pusch, pusch_ref):
        with pytest.raises(NotImplementedError):
            mod.base_sequence(0, 24)
    alloc = pusch.PuschAlloc(1, 0, 16, 2)             # 1 PRB, MCS 0
    alloc_r = pusch_ref.PuschAlloc(1, 0, 16, 2)
    np.testing.assert_array_equal(
        pusch.dmrs_pusch(CID, 2 * SF, 12), pusch_ref.dmrs_pusch(CID, 2 * SF,
                                                                12))
    g, tb = grids(alloc, (12.0, 12.0), seed=1)
    bits, ok, _ = pusch.pusch_decode(torch.from_numpy(g), alloc, RNTI, SF, CID)
    assert ok.all()
    np.testing.assert_array_equal(bits.numpy(), tb)
    ref = jax.jit(lambda x: pusch_ref.pusch_decode(x, alloc_r, RNTI, SF,
                                                   CID))(jnp.asarray(g[0]))
    assert bool(ref[1])
    np.testing.assert_array_equal(np.asarray(ref[0]), tb[0])
    # the batch decoder takes the same 1-PRB allocation
    dec = make_pusch_batch_decoder(alloc, RNTI, SF, CID, device="cpu")
    iq = torch.from_numpy(np.stack([g.real, g.imag], -1).astype(np.float32))
    bits_b, ok_b, _ = dec(iq)
    assert ok_b.all()
    np.testing.assert_array_equal(bits_b.numpy(), tb)


def test_dmrs_cyclic_shift_and_iterations_as_the_reference():
    """``n_dmrs=3`` (the grant's DM-RS cyclic shift) and ``n_iter=5``, the
    reference's arguments: the generator's DM-RS as the reference's, the
    decode's flags and bits as the reference's, and the shift honoured (a
    receiver at shift 0 loses the block)."""
    alloc = pusch.PuschAlloc(6, 0, 712, 2)
    alloc_r = pusch_ref.PuschAlloc(6, 0, 712, 2)
    rng = np.random.default_rng(21)
    tb = rng.integers(0, 2, (1, alloc.mcs_tbs)).astype(np.int32)
    g = ul_gen.pusch_encode_cbs(pdsch_prepare_cbs(tb[0], alloc.geom)[None],
                                alloc, RNTI, SF, CID)
    g = ul_gen.pusch_add_dmrs(g, alloc, CID, SF, n_dmrs=3)
    ref_dmrs = pusch_ref.pusch_add_dmrs(g[0], alloc_r, CID, SF, n_dmrs=3)
    np.testing.assert_array_equal(g[0], ref_dmrs)
    g = (g + 0.05 * (rng.standard_normal(g.shape)
                     + 1j * rng.standard_normal(g.shape))).astype(
                         np.complex64)
    got = pusch.pusch_decode(torch.from_numpy(g[0]), alloc, RNTI, SF, CID,
                             n_dmrs=3, n_iter=5)
    ref = jax.jit(lambda x: pusch_ref.pusch_decode(
        x, alloc_r, RNTI, SF, CID, n_dmrs=3, n_iter=5))(jnp.asarray(g[0]))
    assert bool(got[1]) and bool(ref[1])
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(ref[0]))
    np.testing.assert_array_equal(got[0].numpy(), tb[0])
    assert not bool(pusch.pusch_decode(torch.from_numpy(g[0]), alloc, RNTI,
                                       SF, CID, n_iter=5)[1])
