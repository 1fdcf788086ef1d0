"""The wrapping rate de-match and the single-subframe PDSCH decode against
the JAX reference (``lteax.phy.channels.pdsch``), on the CPU.

A rate match wraps when G > 3(K+4)C: the circular buffer is sent more
than once and the de-match sums the repeats.  The geometry is the first
row of ``docs/bler_awgn.csv``: 6 PRB, MCS 4, TBS 408, QPSK on
n_re = 12 * 6 * 11 = 792 REs (G = 1584 > 3 * 436): two cycles.

- ``soft_dematch`` / ``soft_dematch_harq``: within 1e-6 of the largest
  LLR (both sides add the cycles in the order they were sent; XLA may
  fuse the sums otherwise, one rounding at most);
- ``pdsch_decode_llrs``: TB bits, the TB CRC flag and the codeblock flags
  equal to the reference's (whose turbo is the XLA ``turbo_decode_batch``,
  win 32, 6 iterations), clean and at sigma 0.65 and 1.1;
- each planar cycle plan of ``lteax_torch.pipeline`` (DL, UL, MIMO) gives
  the reference's ``soft_dematch`` of the same LLRs;
- the DL batch decoder at 6 PRB MCS 0 (TBS 152, G = 1656 over
  3 * (176 + 4) = 540: four cycles), B=2, retry 0, at -1 dB (both decode)
  and -2 dB (one fails),
  against ``make_batch_decoder_pallas``'s stages in interpret mode (f32
  trellis, fft OFDM): TB bits, CRC flags and ``n_iter`` equal.  The reference
  demaps wrapping input with its XLA demapper (LLR / eff), the port with
  the demap kernel (LLR * (1 / eff)): the fronts agree within 1e-5 of the
  largest LLR, zeros in the same places.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lteax.phy.channels import pdsch as pdsch_ref
from lteax.phy.config import PhyConfig as RefPhyConfig
from lteax.phy.tuning import DecoderTuning as RefTuning
from lteax.shard.pipeline import _pdsch_stages

from lteax_torch.phy.channels import pdsch
from lteax_torch.phy.grid import pdsch_flat_idx
from lteax_torch.phy.tuning import DecoderTuning
from lteax_torch.pipeline import (_gather_dematch, _plan, dl_demap_plans,
                                  make_batch_decoder, rm_inv_planar,
                                  ul_rm_inv_planar)
from lteax_torch.sim.dl_gen import DlCell, dl_subframes

TBS, N_RE, QM = 408, 792, 2
RNTI, SF, CID = 0x1234, 1, 150


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs files in parallel processes; torch's own thread pool
    on top of them oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _geoms(rv=0, tbs=TBS, n_re=N_RE, qm=QM):
    return (pdsch.pdsch_geometry(tbs, n_re, qm, rv),
            pdsch_ref.pdsch_geometry(tbs, n_re, qm, rv))


def _llrs(g: int, seed: int) -> np.ndarray:
    return (np.random.default_rng(seed).standard_normal(g) * 4.0
            ).astype(np.float32)


def test_the_geometry_wraps():
    geom, _ = _geoms()
    assert geom.info.c == 1 and geom.g > 3 * (geom.k + 4)
    assert pdsch._global_rm_cycles(geom).shape[0] == 2


@pytest.mark.parametrize("rv", [0, 2])
def test_soft_dematch_matches_reference(rv):
    geom, geom_r = _geoms(rv)
    llr = _llrs(geom.g, rv)
    got = pdsch.soft_dematch(torch.from_numpy(llr), geom).numpy()
    ref = np.asarray(pdsch_ref.soft_dematch(jnp.asarray(llr), geom_r))
    assert got.shape == ref.shape == (1, 3, geom.k + 4)
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=1e-6 * np.abs(ref).max())


def test_soft_dematch_harq_matches_reference():
    pairs = [_geoms(rv) for rv in (0, 2)]
    llrs = [_llrs(N_RE * QM, 10 + rv) for rv in (0, 2)]
    got = pdsch.soft_dematch_harq([torch.from_numpy(x) for x in llrs],
                                  [p[0] for p in pairs]).numpy()
    ref = np.asarray(pdsch_ref.soft_dematch_harq(
        [jnp.asarray(x) for x in llrs], [p[1] for p in pairs]))
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=1e-6 * np.abs(ref).max())


@pytest.mark.parametrize("sigma", [0.3, 0.65, 1.1])
def test_pdsch_decode_llrs_matches_reference(sigma):
    """BPSK-equivalent LLRs 2y/sigma^2 of the scrambled codeword bits."""
    geom, geom_r = _geoms()
    rng = np.random.default_rng(int(sigma * 100))
    tb = rng.integers(0, 2, TBS).astype(np.int32)
    e = pdsch.pdsch_encode_bits(tb, geom)
    np.testing.assert_array_equal(e, np.asarray(pdsch_ref.pdsch_encode_bits(
        tb, geom_r)))
    c = pdsch.seq.gold_sequence_np(pdsch.seq.pdsch_c_init(RNTI, SF, CID),
                                   geom.g)
    y = (1.0 - 2.0 * ((e + c) % 2)) + sigma * rng.standard_normal(geom.g)
    llr = (2.0 * y / sigma ** 2).astype(np.float32)
    bits, ok, cb_oks = pdsch.pdsch_decode_llrs(torch.from_numpy(llr), geom,
                                               RNTI, SF, CID)
    bits_r, ok_r, cb_r = pdsch_ref.pdsch_decode_llrs(jnp.asarray(llr),
                                                     geom_r, RNTI, SF, CID)
    np.testing.assert_array_equal(bits, np.asarray(bits_r))
    assert ok == ok_r
    np.testing.assert_array_equal(cb_oks, np.asarray(cb_r))
    if sigma < 0.5:
        assert ok and np.array_equal(bits, tb)


def test_pdsch_decode_device_is_batched():
    """A batch of two decodes as the two single ones, on the device."""
    geom, _ = _geoms()
    llr = torch.from_numpy(np.stack([_llrs(geom.g, s) for s in (3, 4)]))
    tb, ok, cb = pdsch.pdsch_decode_device(llr, geom, RNTI, SF, CID)
    assert tb.shape == (2, TBS) and ok.shape == (2,) and cb.shape == (2, 1)
    for b in range(2):
        one = pdsch.pdsch_decode_device(llr[b], geom, RNTI, SF, CID)
        assert torch.equal(one[0], tb[b]) and bool(one[1]) == bool(ok[b])


def _ref_dematch(llr_g: np.ndarray, geom_r) -> np.ndarray:
    return np.asarray(pdsch_ref.soft_dematch(jnp.asarray(llr_g), geom_r)
                      ).reshape(-1, 3, geom_r.k + 4)


@pytest.mark.parametrize("rv", [0, 3])
def test_dl_plan_matches_soft_dematch(rv):
    """The full-grid map: codeword bit g = s*qm + j at j*npad + re_idx[s]."""
    cfg = DlCell(n_rb_dl=6).cfg
    re_idx = pdsch_flat_idx(cfg, CID, 2, tuple(range(6)), SF)
    geom, geom_r = _geoms(rv, n_re=len(re_idx))
    sgn, grid_inv = dl_demap_plans(cfg, re_idx, geom, 0)
    npad = sgn.shape[1]
    assert grid_inv.shape[0] == pdsch._global_rm_cycles(geom).shape[0] > 1
    llr = _llrs(geom.g, rv)
    planar = np.zeros((QM, npad), np.float32)
    planar[:, re_idx] = llr.reshape(-1, QM).T
    got = _gather_dematch(torch.from_numpy(planar)[None],
                          _plan(grid_inv, torch.device("cpu")), geom.k + 4)
    np.testing.assert_allclose(got.numpy(), _ref_dematch(llr, geom_r),
                               rtol=0, atol=1e-6 * np.abs(llr).max())


def test_ul_plan_matches_soft_dematch():
    """The UL map: e position p = k*(12 qm) + sym*qm + j at
    j*npad + sym*m_sc + k (the channel interleaver's transpose)."""
    m_sc, qm = 12 * 6, 2
    geom, geom_r = _geoms(0, tbs=408, n_re=12 * m_sc, qm=qm)
    npad = -(-(12 * m_sc) // 128) * 128
    plan = ul_rm_inv_planar(geom, qm, m_sc, npad)
    assert plan.shape[0] > 1
    llr = _llrs(geom.g, 7)
    p = np.arange(geom.g)
    k, sym, j = p // (12 * qm), (p % (12 * qm)) // qm, p % qm
    planar = np.zeros(qm * npad, np.float32)
    planar[j * npad + sym * m_sc + k] = llr
    got = _gather_dematch(torch.from_numpy(planar).reshape(1, qm, npad),
                          _plan(plan, torch.device("cpu")), geom.k + 4)
    np.testing.assert_allclose(got.numpy(), _ref_dematch(llr, geom_r),
                               rtol=0, atol=1e-6 * np.abs(llr).max())


def test_mimo_plan_matches_soft_dematch():
    """The extracted-RE map: codeword bit g = s*qm + j at j*npad + s."""
    geom, geom_r = _geoms(2)
    npad = -(-geom.n_re // 128) * 128
    plan = rm_inv_planar(geom, npad)
    assert plan.shape[0] == 2
    llr = _llrs(geom.g, 8)
    planar = np.zeros((QM, npad), np.float32)
    planar[:, :geom.n_re] = llr.reshape(-1, QM).T
    got = _gather_dematch(torch.from_numpy(planar)[None],
                          _plan(plan, torch.device("cpu")), geom.k + 4)
    np.testing.assert_allclose(got.numpy(), _ref_dematch(llr, geom_r),
                               rtol=0, atol=1e-6 * np.abs(llr).max())


WRAP_CELL = DlCell(n_rb_dl=6, n_cell_id=150, mcs=0, cfi=2)


@pytest.fixture(scope="module")
def wrap_decoders():
    mp = pytest.MonkeyPatch()
    # the reference's DL stages read the OFDM DFT choice from the
    # environment
    mp.setenv("LTEAX_OFDM_DFT", "fft")
    c, geom = WRAP_CELL, WRAP_CELL.geom
    geom_r = pdsch_ref.pdsch_geometry(geom.tbs, geom.n_re, geom.qm, geom.rv)
    args = (c.n_cell_id, c.cfi, c.prbs, c.subframe, c.rnti)
    # make_batch_decoder_pallas's stages, the front kept apart to compare
    front_r, turbo_r = _pdsch_stages(
        RefPhyConfig(n_rb_dl=c.n_rb_dl), *args, geom_r, c.scheme, 6,
        RefTuning(mdtype="f32", demap_in="f32", retry_m_dl=0,
                  print_iters=True), True)
    ref = jax.jit(lambda s: turbo_r(front_r(s)))
    port = make_batch_decoder(c.cfg, *args, geom, c.scheme, n_iter=6,
                              tuning=DecoderTuning(retry_m_dl=0),
                              device="cpu")
    yield jax.jit(front_r), ref, port
    mp.undo()


@pytest.mark.parametrize("snr_db,seed", [(-1.0, 1), (-2.0, 1)])
def test_wrapping_batch_decode_matches_reference(wrap_decoders, snr_db,
                                                 seed):
    front_r, ref, port = wrap_decoders
    geom = WRAP_CELL.geom
    assert geom.qm == 2 and pdsch._global_rm_cycles(geom).shape[0] == 4
    assert port.dl_front.grid_inv.shape[0] == \
        pdsch._global_rm_cycles(geom).shape[0]
    iq, tb = dl_subframes(WRAP_CELL, 2, snr_db=snr_db, seed=seed)
    d = port.front(torch.from_numpy(iq)).numpy()
    d_r = np.asarray(front_r(jnp.asarray(iq))).reshape(d.shape)
    np.testing.assert_array_equal(d == 0, d_r == 0)
    np.testing.assert_allclose(d, d_r, rtol=0, atol=1e-5 * np.abs(d_r).max())
    bits_r, ok_r, it_r = ref(jnp.asarray(iq))
    bits, ok, it = port(torch.from_numpy(iq))
    np.testing.assert_array_equal(bits.numpy(), np.asarray(bits_r))
    np.testing.assert_array_equal(ok.numpy(), np.asarray(ok_r))
    assert it == int(it_r)
    # -1 dB: both decode in 2 iterations; -2 dB: one fails, 6 iterations
    assert (ok.tolist(), it) == {-1.0: ([True, True], 2),
                                 -2.0: ([False, True], 6)}[snr_db]
    assert np.array_equal(bits.numpy()[ok.numpy()], tb[ok.numpy()])
