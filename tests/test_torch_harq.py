"""The port's HARQ incremental-redundancy decoder against the JAX reference
(``lteax.shard.pipeline.make_batch_harq_decoder_pallas`` in interpret mode,
f32 trellis, f32 demap staging, fft OFDM) on the same IQ: 6 PRB, MCS 9
(QPSK), cfi 2, cell 150, rv 0 in subframe 1 and rv 2 in subframe 2, four
transport blocks at 3 dB, where rv 0 alone decodes none of them.

Summed d-domain LLRs: within 1e-5 of the largest LLR (the DL front's
tolerance: pocketfft and XLA's FFT sum in different orders), zeros in the
same places.  Whole decoder: TB bits, CRC flags and iteration count equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lteax.phy import seq as seq_ref
from lteax.phy.channels import pdsch as pdsch_ref
from lteax.phy.config import PhyConfig as RefPhyConfig
from lteax.phy.fec import crc as crc_ref
from lteax.phy.grid import pdsch_flat_idx as pdsch_flat_idx_ref
from lteax.phy.tuning import DecoderTuning as RefTuning
from lteax.shard.pipeline import (_pdsch_stages, make_batch_decoder_pallas,
                                  make_batch_harq_decoder_pallas)

from lteax_torch.phy.tuning import DecoderTuning
from lteax_torch.pipeline import (BatchDecoder, HarqBatchDecoder,
                                  make_batch_decoder, make_batch_harq_decoder)
from lteax_torch.sim.dl_gen import (DlCell, dl_subframes, harq_decoder_args,
                                    harq_transmissions)

torch.set_num_threads(1)

CELL = DlCell(n_rb_dl=6, n_cell_id=150, mcs=9, cfi=2)
SUBFRAMES, RVS = (1, 2), (0, 2)
B = 4
SNR_DB = 3.0      # below the rv 0 threshold: 0/4 alone, 4/4 combined
REF_TUNING = dict(mdtype="f32", demap_in="f32", retry_m_dl=2)


@pytest.fixture(scope="module", autouse=True)
def _fft_reference():
    """The reference front reads its OFDM DFT form from the environment."""
    mp = pytest.MonkeyPatch()
    mp.setenv("LTEAX_OFDM_DFT", "fft")
    yield
    mp.undo()


@pytest.fixture(scope="module")
def signal():
    iq, tb, cells = harq_transmissions(CELL, SUBFRAMES, RVS, B, SNR_DB,
                                       seed=3)
    return iq, tb, cells


def _ref_args(cells):
    """The reference factory's arguments, with its own config and geometry
    classes built from the same numbers."""
    c0 = cells[0]
    geoms = tuple(pdsch_ref.pdsch_geometry(c.geom.tbs, c.geom.n_re, c.geom.qm,
                                           c.geom.rv) for c in cells)
    return (RefPhyConfig(n_rb_dl=c0.n_rb_dl), c0.n_cell_id, c0.cfi, c0.prbs,
            tuple(c.subframe for c in cells), c0.rnti, geoms, c0.scheme)


def test_transmissions_share_the_transport_blocks(signal):
    iq, tb, cells = signal
    cfg = CELL.cfg
    assert iq.shape == (2, B, cfg.n_samps_subframe, 2)
    assert iq.dtype == np.float32 and tb.shape == (B, CELL.geom.tbs)
    assert [(c.subframe, c.rv, c.geom.rv) for c in cells] == \
        [(1, 0, 0), (2, 2, 2)]
    assert cells[0].geom.k == cells[1].geom.k
    assert not np.array_equal(iq[0], iq[1])


def test_summed_llrs_match_reference_fronts(signal):
    iq, _, cells = signal
    cfg_r, cid, cfi, prbs, sfs, rnti, geoms_r, scheme = _ref_args(cells)
    ref = 0
    for sf, g, x in zip(sfs, geoms_r, iq):
        front_r, _ = _pdsch_stages(cfg_r, cid, cfi, prbs, sf, rnti, g, scheme,
                                   6, RefTuning(**REF_TUNING), True,
                                   planar_boundary=False)
        ref = ref + np.asarray(front_r(jnp.asarray(x)))
    k, c = cells[0].geom.k, cells[0].geom.info.c
    ref = ref.reshape(-1, 3, k + 4)
    got = make_batch_harq_decoder(*harq_decoder_args(cells),
                                  device="cpu").front(
        torch.from_numpy(iq)).numpy()
    assert got.shape == ref.shape == (B * c, 3, k + 4)
    np.testing.assert_array_equal(got == 0, ref == 0)
    np.testing.assert_allclose(got, ref, rtol=1e-5,
                               atol=1e-5 * np.abs(ref).max())


@pytest.mark.mid
def test_decoder_matches_reference_and_rv0_alone_fails(signal):
    iq, tb, cells = signal
    ref_args = _ref_args(cells)
    ref = make_batch_harq_decoder_pallas(
        *ref_args, n_iter=6, interpret=True,
        tuning=RefTuning(print_iters=True, **REF_TUNING))
    port = make_batch_harq_decoder(*harq_decoder_args(cells), n_iter=6,
                                   tuning=DecoderTuning(retry_m_dl=2),
                                   device="cpu")
    bits_r, ok_r, it_r = ref(jnp.asarray(iq))
    bits, ok, it = port(torch.from_numpy(iq))
    assert bits.dtype == torch.int8 and bits.shape == tb.shape
    np.testing.assert_array_equal(bits.numpy(), np.asarray(bits_r))
    np.testing.assert_array_equal(ok.numpy(), np.asarray(ok_r))
    assert it == int(it_r)
    assert ok.all() and np.array_equal(bits.numpy(), tb)

    # rv 0 alone, on the first transmission's IQ: none decodes, on both sides
    cfg_r, cid, cfi, prbs, sfs, rnti, geoms_r, scheme = ref_args
    ref0 = make_batch_decoder_pallas(
        cfg_r, cid, cfi, prbs, sfs[0], rnti, geoms_r[0], scheme, n_iter=6,
        interpret=True, tuning=RefTuning(print_iters=True, **REF_TUNING))
    port0 = make_batch_decoder(*cells[0].decoder_args(), n_iter=6,
                               tuning=DecoderTuning(retry_m_dl=2),
                               device="cpu")
    _, ok0_r, it0_r = ref0(jnp.asarray(iq[0]))
    _, ok0, it0 = port0(torch.from_numpy(iq[0]))
    assert not ok0.any() and not np.asarray(ok0_r).any()
    assert it0 == int(it0_r) == 6


def test_three_transmissions_sum_in_order():
    """rv 0 + rv 2 + rv 3: the front is the sum of the three single fronts."""
    iq, _, cells = harq_transmissions(CELL, (1, 2, 3), (0, 2, 3), 2, 10.0,
                                      seed=4)
    dec = make_batch_harq_decoder(*harq_decoder_args(cells), device="cpu")
    x = torch.from_numpy(iq)
    want = sum(make_batch_decoder(*c.decoder_args(), device="cpu").front(xi)
               for c, xi in zip(cells, x))
    assert torch.equal(dec.front(x), want)


def test_factory_validates_inputs(signal):
    iq, _, cells = signal
    args = harq_decoder_args(cells)
    one = list(args)
    one[4], one[6] = args[4][:1], args[6][:1]
    with pytest.raises(ValueError, match=">= 2 transmissions"):
        make_batch_harq_decoder(*one, device="cpu")
    uneven = list(args)
    uneven[4] = args[4] + (3,)
    with pytest.raises(ValueError):
        make_batch_harq_decoder(*uneven, device="cpu")
    other_k = list(args)
    other_k[6] = (args[6][0], DlCell(n_rb_dl=6, n_cell_id=150, mcs=5, cfi=2,
                                     subframe=2, rv=2).geom)
    assert other_k[6][0].k != other_k[6][1].k
    with pytest.raises(ValueError):
        make_batch_harq_decoder(*other_k, device="cpu")
    dec = make_batch_harq_decoder(*args, device="cpu")
    with pytest.raises(ValueError, match="transmissions given"):
        dec(torch.from_numpy(iq[:1]))


def test_wrapping_transmissions_combine():
    """Transmissions whose rate match wraps the circular buffer (6 PRB MCS
    0: four cycles each) de-match as sums of cycle gathers and combine in
    the d domain: rv 0 + rv 2 at -3 dB decode 4/4, rv 0 alone 2/4."""
    cell = DlCell(n_rb_dl=6, n_cell_id=150, mcs=0, cfi=2)
    assert cell.geom.g > 3 * (cell.geom.k + 4)
    iq, tb, cells = harq_transmissions(cell, (1, 2), (0, 2), 4, -3.0, seed=3)
    dec = make_batch_harq_decoder(*harq_decoder_args(cells), device="cpu")
    assert [f.grid_inv.shape[0] for f in dec.dl_fronts] == [4, 4]
    bits, ok, _ = dec(torch.from_numpy(iq))
    assert ok.all() and np.array_equal(bits.numpy(), tb)
    _, ok1, _ = make_batch_decoder(*cells[0].decoder_args(),
                                   device="cpu")(torch.from_numpy(iq[0]))
    assert ok1.tolist() == [False, False, True, True]


# -- decoders built from the reference's own plan arrays --------------------

def _ref_dl_plans(cell: DlCell):
    """Sign planes and de-match map of one transmission as the reference's
    ``_pdsch_stages`` builds them, from the reference's own tables."""
    cfg_r = RefPhyConfig(n_rb_dl=cell.n_rb_dl)
    g = cell.geom
    geom_r = pdsch_ref.pdsch_geometry(g.tbs, g.n_re, g.qm, g.rv)
    re_idx = np.asarray(pdsch_flat_idx_ref(cfg_r, cell.n_cell_id, cell.cfi,
                                           cell.prbs, cell.subframe),
                        dtype=np.int64)
    qm = geom_r.qm
    n_grid = cfg_r.n_sym_subframe * cfg_r.n_sc
    npad = -(-n_grid // 128) * 128
    if npad == n_grid:
        npad += 128
    c_init = cell.rnti * 2 ** 14 + cell.subframe * 512 + cell.n_cell_id
    sgn = np.zeros((qm, npad), np.float32)
    sgn[:, re_idx] = seq_ref.scrambling_symbols_np(
        c_init, geom_r.g).reshape(-1, qm).T
    inv_g, injective = pdsch_ref._global_rm_inv(geom_r)
    assert injective
    g_idx = inv_g.astype(np.int64)
    grid_inv = (g_idx % qm) * npad + re_idx[np.minimum(g_idx // qm,
                                                       len(re_idx) - 1)]
    grid_inv[inv_g == geom_r.g] = qm * npad
    m24b = crc_ref.crc_matrix(geom_r.k - 24, "24B") \
        if geom_r.info.cb_crc else None
    return sgn, grid_inv, crc_ref.crc_matrix(geom_r.info.b - 24, "24A"), m24b


def _same_outputs(a, b):
    return torch.equal(a[0], b[0]) and torch.equal(a[1], b[1]) and \
        a[2] == b[2]


def test_dl_from_plans_takes_the_reference_plans():
    cell = DlCell(n_rb_dl=15, mcs=28)          # C=2, CRC24B in play
    iq, tb = dl_subframes(cell, 2, snr_db=25.0, seed=1)
    sgn, grid_inv, m24a, m24b = _ref_dl_plans(cell)
    assert m24b is not None
    dec = BatchDecoder.from_plans(cell.cfg, cell.n_cell_id, cell.subframe,
                                  cell.geom, cell.scheme, sgn, grid_inv,
                                  m24a, m24b, device="cpu")
    own = make_batch_decoder(*cell.decoder_args(), device="cpu")
    x = torch.from_numpy(iq)
    out = dec(x)
    assert torch.equal(dec.front(x), own.front(x))
    assert _same_outputs(out, own(x))
    assert out[1].all() and np.array_equal(out[0].numpy(), tb)


def test_harq_from_plans_takes_the_reference_plans(signal):
    iq, tb, cells = signal
    plans = [_ref_dl_plans(c) for c in cells]
    c0 = cells[0]
    dec = HarqBatchDecoder.from_plans(
        c0.cfg, c0.n_cell_id, tuple(c.subframe for c in cells), c0.geom,
        c0.scheme, [p[0] for p in plans], [p[1] for p in plans],
        plans[0][2], plans[0][3], device="cpu")
    own = make_batch_harq_decoder(*harq_decoder_args(cells), device="cpu")
    x = torch.from_numpy(iq)
    out = dec(x)
    assert torch.equal(dec.front(x), own.front(x))
    assert _same_outputs(out, own(x))
    assert out[1].all() and np.array_equal(out[0].numpy(), tb)
    with pytest.raises(ValueError):
        HarqBatchDecoder.from_plans(
            c0.cfg, c0.n_cell_id, (1, 2), c0.geom, c0.scheme, [plans[0][0]],
            [p[1] for p in plans], plans[0][2], plans[0][3], device="cpu")
