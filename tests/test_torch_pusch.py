"""The port's UL-SCH batch decoder against the JAX reference
(``lteax.shard.pipeline.make_pusch_batch_decoder`` in interpret mode, f32
trellis, f32 demap staging, fft transform precoding) on the same gridded
subframes, at 6-15 PRB in QPSK, 16QAM and 64QAM.

Front: the de-matched (B*C, 3, K+4) LLRs agree within 1e-5 of the largest
LLR (``torch.fft`` and XLA's FFT round differently in the last bits) with
their zeros exactly in the same places.  Whole decoder: TB bits, CRC flags
and the iteration count are equal.  The 8 PRB case has 12 * m_sc = 1152, a
multiple of 128, so its planes have no pad column and the zero slot must be
the appended column.  The port's UL signal generator gives the reference
encoder's grids to float tolerance."""

from functools import lru_cache

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lteax.kernels.demap import planar_sgn_np as planar_sgn_ref
from lteax.phy.channels import pusch as pusch_ref
from lteax.phy.fec import crc as crc_ref
from lteax.phy.tuning import DecoderTuning as RefTuning
from lteax.shard.pipeline import (_pusch_stages, _ul_rm_inv_planar,
                                  make_pusch_batch_decoder as make_ref)

from lteax_torch.phy.channels import pusch
from lteax_torch.phy.tuning import DecoderTuning
from lteax_torch.pipeline import PuschBatchDecoder, make_pusch_batch_decoder
from lteax_torch.sim import ul_gen
from lteax_torch.sim.dl_gen import pdsch_prepare_cbs

torch.set_num_threads(1)

B = 2
RETRY_M = 2
# id -> (n_prb, qm, TBS, subframe, cell, RNTI, SNR dB, seed)
CASES = {
    "6prb-qpsk": (6, 2, 712, 4, 214, 0x3D, 8.0, 0),
    "8prb-qpsk-nopad": (8, 2, 1096, 9, 17, 0x1234, 10.0, 1),
    "6prb-16qam": (6, 4, 1192, 2, 301, 0x5DEF, 16.0, 2),
    "15prb-64qam": (15, 6, 11064, 0, 503, 0xFFF3, 28.0, 3),
}
# 15 PRB 64QAM near its threshold -> expected compacted retries [(full
# iterations, failing codeblocks)]: two codeblocks finish in the retry after
# iteration 1; one needs a second full-batch iteration before compacting
RETRY_CASES = {(21.5, 6): [(1, 2)], (19.0, 6): [(2, 1)]}


@pytest.fixture(scope="module", autouse=True)
def _fft_reference():
    """The reference reads its UL DFT form from the environment when it
    traces; the port's counterpart is the fft form."""
    mp = pytest.MonkeyPatch()
    mp.setenv("LTEAX_UL_DFT", "fft")
    yield
    mp.undo()


def _cell(case):
    n_prb, qm, tbs, sf, cid, rnti, snr_db, seed = case
    alloc = pusch.PuschAlloc(n_prb=n_prb, rb_start=0, mcs_tbs=tbs, qm=qm)
    alloc_r = pusch_ref.PuschAlloc(n_prb=n_prb, rb_start=0, mcs_tbs=tbs,
                                   qm=qm)
    cell = ul_gen.UlCell(alloc=alloc, n_cell_id=cid, subframe=sf, rnti=rnti)
    iq, tb = ul_gen.ul_subframes(cell, B, snr_db=snr_db, seed=seed)
    return cell, alloc_r, iq, tb


def _ref_tuning(**kw):
    # ul_planar_boundary moves the de-match into the TPU decode's layout
    # gathers; off, the stage boundary is the port's (B, C, 3, K+4)
    return RefTuning(mdtype="f32", demap_in="f32", retry_m=RETRY_M,
                     ul_planar_boundary=False, **kw)


@pytest.mark.parametrize("case", CASES.values(), ids=CASES.keys())
def test_front_matches_reference(case):
    cell, alloc_r, iq, _ = _cell(case)
    geom = cell.alloc.geom
    front_r, _ = _pusch_stages(alloc_r, cell.rnti, cell.subframe,
                               cell.n_cell_id, 6, None, _ref_tuning(), True)
    ref = np.asarray(front_r(jnp.asarray(iq))).reshape(-1, 3, geom.k + 4)
    got = make_pusch_batch_decoder(*cell.decoder_args(), device="cpu").front(
        torch.from_numpy(iq)).numpy()
    assert got.shape == ref.shape == (B * geom.info.c, 3, geom.k + 4)
    assert (ref == 0).any() and (ref != 0).any()
    np.testing.assert_array_equal(got == 0, ref == 0)
    np.testing.assert_allclose(got, ref, rtol=1e-5,
                               atol=1e-5 * np.abs(ref).max())


def test_front_with_static_noise_prior():
    """``noise_var`` pins the prior instead of the DM-RS residual estimate."""
    cell, alloc_r, iq, _ = _cell(CASES["6prb-16qam"])
    geom = cell.alloc.geom
    front_r, _ = _pusch_stages(alloc_r, cell.rnti, cell.subframe,
                               cell.n_cell_id, 6, 0.05, _ref_tuning(), True)
    ref = np.asarray(front_r(jnp.asarray(iq))).reshape(-1, 3, geom.k + 4)
    got = make_pusch_batch_decoder(*cell.decoder_args(), noise_var=0.05,
                                   device="cpu").front(
        torch.from_numpy(iq)).numpy()
    np.testing.assert_array_equal(got == 0, ref == 0)
    np.testing.assert_allclose(got, ref, rtol=1e-5,
                               atol=1e-5 * np.abs(ref).max())


@lru_cache(maxsize=None)
def _ref_decoder(n_prb, qm, tbs, sf, cid, rnti):
    """The reference's decoder of a geometry (jitted in interpret mode),
    built once: the retry cases share its compile."""
    alloc_r = pusch_ref.PuschAlloc(n_prb=n_prb, rb_start=0, mcs_tbs=tbs,
                                   qm=qm)
    return make_ref(alloc_r, rnti, sf, cid, n_iter=6,
                    tuning=_ref_tuning(print_iters=True), interpret=True)


def _decode_both(case):
    cell, alloc_r, iq, tb = _cell(case)
    ref = _ref_decoder(*case[:6])
    port = make_pusch_batch_decoder(
        *cell.decoder_args(), n_iter=6,
        tuning=DecoderTuning(retry_m=RETRY_M), device="cpu")
    bits_r, ok_r, it_r = ref(jnp.asarray(iq))
    bits, ok, it = port(torch.from_numpy(iq))
    assert bits.dtype == torch.int8 and bits.shape == tb.shape
    np.testing.assert_array_equal(bits.numpy(), np.asarray(bits_r))
    np.testing.assert_array_equal(ok.numpy(), np.asarray(ok_r))
    assert it == int(it_r)
    return port, bits, ok, tb


@pytest.mark.mid
@pytest.mark.parametrize("case", CASES.values(), ids=CASES.keys())
def test_decoder_matches_reference(case):
    _, bits, ok, tb = _decode_both(case)
    assert ok.all() and np.array_equal(bits.numpy(), tb)


@pytest.mark.mid
@pytest.mark.parametrize("snr_db,seed", list(RETRY_CASES))
def test_decoder_matches_reference_through_the_retry(snr_db, seed):
    port, bits, ok, tb = _decode_both((15, 6, 11064, 4, 214, 0x3D, snr_db,
                                       seed))
    assert port.last_stats.retries == RETRY_CASES[(snr_db, seed)]
    assert ok.all() and np.array_equal(bits.numpy(), tb)


def test_decoder_at_low_snr_fails_as_the_reference_does():
    """Far below the threshold: no CRC passes, every iteration runs."""
    case = (*CASES["6prb-16qam"][:6], 2.0, 7)
    cell, alloc_r, iq, _ = _cell(case)
    ref = make_ref(alloc_r, cell.rnti, cell.subframe, cell.n_cell_id,
                   n_iter=3, tuning=_ref_tuning(print_iters=True),
                   interpret=True)
    port = make_pusch_batch_decoder(
        *cell.decoder_args(), n_iter=3,
        tuning=DecoderTuning(retry_m=RETRY_M), device="cpu")
    _, ok_r, it_r = ref(jnp.asarray(iq))
    _, ok, it = port(torch.from_numpy(iq))
    assert not ok.any() and not np.asarray(ok_r).any()
    assert it == int(it_r) == 3


@pytest.mark.parametrize("case", CASES.values(), ids=CASES.keys())
def test_ul_gen_matches_reference_encoder(case):
    """Same codeblocks -> the reference's grid with its DM-RS, within FFT
    rounding of unit-power symbols."""
    cell, alloc_r, _, _ = _cell(case)
    alloc = cell.alloc
    tb = np.random.default_rng(11).integers(0, 2, (2, alloc.mcs_tbs)).astype(
        np.int32)
    cbs = np.stack([pdsch_prepare_cbs(t, alloc.geom) for t in tb])
    got = ul_gen.pusch_add_dmrs(
        ul_gen.pusch_encode_cbs(cbs, alloc, cell.rnti, cell.subframe,
                                cell.n_cell_id),
        alloc, cell.n_cell_id, cell.subframe)
    ref = np.stack([pusch_ref.pusch_add_dmrs(np.asarray(
        pusch_ref.pusch_encode_cbs(jnp.asarray(c), alloc_r, cell.rnti,
                                   cell.subframe, cell.n_cell_id)),
        alloc_r, cell.n_cell_id, cell.subframe) for c in cbs])
    assert got.shape == ref.shape == (2, 14, alloc.m_sc)
    assert got.dtype == np.complex64
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
    for sym in pusch.DMRS_SYMS:
        np.testing.assert_array_equal(got[:, sym], ref[:, sym])


def test_ul_subframes_shapes_and_tiling():
    cell = ul_gen.UlCell(alloc=pusch.PuschAlloc(6, 0, 712, 2))
    iq, tb = ul_gen.ul_subframes(cell, 5, snr_db=30.0, seed=2, max_unique=2)
    assert iq.shape == (5, 14, 72, 2) and iq.dtype == np.float32
    assert tb.shape == (5, 712)
    np.testing.assert_array_equal(tb[2], tb[0])
    np.testing.assert_array_equal(tb[4], tb[0])
    assert not np.array_equal(tb[1], tb[0])
    assert not np.array_equal(iq[2], iq[0])            # its own noise


def test_from_plans_takes_the_reference_plans():
    """The decoder built from the reference's own plan arrays decodes the
    same bits as the one built from parameters."""
    cell, alloc_r, iq, tb = _cell(CASES["15prb-64qam"])
    alloc, geom_r = cell.alloc, alloc_r.geom
    sf, cid, m_sc, qm = cell.subframe, cell.n_cell_id, alloc.m_sc, alloc.qm
    d0, d1 = pusch_ref.DMRS_SYMS
    w = np.clip(np.asarray([(s - d0) / (d1 - d0) for s in range(14)
                            if s not in (d0, d1)], np.float32), 0, 1)[:, None]
    npad = -(-(12 * m_sc) // 128) * 128
    c_init = cell.rnti * 2 ** 14 + sf * 512 + cid
    dec = PuschBatchDecoder.from_plans(
        alloc,
        np.conj(pusch_ref.dmrs_pusch(cid, 2 * sf, m_sc)),
        np.conj(pusch_ref.dmrs_pusch(cid, 2 * sf + 1, m_sc)),
        w, pusch_ref.chest_taps(m_sc),
        planar_sgn_ref(c_init, geom_r.g, qm, npad),
        _ul_rm_inv_planar(geom_r, qm, m_sc, npad),
        crc_ref.crc_matrix(geom_r.info.b - 24, "24A"),
        crc_ref.crc_matrix(geom_r.k - 24, "24B"), device="cpu")
    own = make_pusch_batch_decoder(*cell.decoder_args(), device="cpu")
    x = torch.from_numpy(iq)
    out, out_own = dec(x), own(x)
    assert torch.equal(dec.front(x), own.front(x))
    assert torch.equal(out[0], out_own[0]) and torch.equal(out[1], out_own[1])
    assert out[2] == out_own[2]
    assert out[1].all() and np.array_equal(out[0].numpy(), tb)


def test_short_allocations_and_wrong_devices_raise():
    with pytest.raises(NotImplementedError):
        pusch.dmrs_pusch(214, 8, 24)              # 2 PRB: no length-24 table
    # 1 PRB: the length-12 phase table, as in the reference
    np.testing.assert_array_equal(pusch.dmrs_pusch(214, 8, 12),
                                  pusch_ref.dmrs_pusch(214, 8, 12))
    # a rate below 1/3 wraps the circular buffer: no raise, the planar
    # de-match sums one gather per cycle
    wrap = make_pusch_batch_decoder(pusch.PuschAlloc(6, 0, 504, 2), 0x3D, 4,
                                    214, device="cpu")
    assert wrap.ul_front.ul_inv.shape[0] > 1
    cell = ul_gen.UlCell(alloc=pusch.PuschAlloc(6, 0, 712, 2))
    dec = make_pusch_batch_decoder(*cell.decoder_args(), device="meta")
    with pytest.raises(ValueError):
        dec(torch.zeros((1, 14, 72, 2)))
