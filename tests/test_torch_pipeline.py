"""The whole DL slice — IQ to TB bits — against the JAX production decoder
(``make_batch_decoder_pallas`` in interpret mode, f32 trellis, f32 demap
staging, fft OFDM): identical TB bits, CRC flags and iteration count, at
15 PRB MCS 28 (64QAM, C=2 codeblocks of K=5568, B=2 subframes, retry_m=2).

The SNRs are chosen so that one case decodes in one iteration, one finishes
two failing codeblocks in the compacted retry after iteration 1, and one
needs a second full-batch iteration before compacting."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lteax.phy.channels import pdsch as pdsch_ref
from lteax.phy.config import PhyConfig as RefPhyConfig
from lteax.phy.tuning import DecoderTuning as RefTuning
from lteax.shard.pipeline import make_batch_decoder_pallas

from lteax_torch.phy.tuning import DecoderTuning
from lteax_torch.pipeline import make_batch_decoder
from lteax_torch.sim.dl_gen import DlCell, dl_subframes

CELL = DlCell(n_rb_dl=15, mcs=28)
# (snr_db, seed) -> expected compacted retries [(full iterations, failing)]
CASES = {(25.0, 0): [], (21.5, 1): [(1, 2)], (20.5, 1): [(2, 2)]}


@pytest.fixture(scope="module")
def decoders():
    mp = pytest.MonkeyPatch()
    # pipeline.py:179 reads the OFDM DFT choice from the environment
    mp.setenv("LTEAX_OFDM_DFT", "fft")
    geom = CELL.geom
    geom_r = pdsch_ref.pdsch_geometry(geom.tbs, geom.n_re, geom.qm, geom.rv)
    args = (CELL.n_cell_id, CELL.cfi, CELL.prbs, CELL.subframe, CELL.rnti)
    ref = make_batch_decoder_pallas(
        RefPhyConfig(n_rb_dl=CELL.n_rb_dl), *args, geom_r, CELL.scheme,
        n_iter=6, interpret=True,
        tuning=RefTuning(mdtype="f32", demap_in="f32", retry_m_dl=2,
                         print_iters=True))
    port = make_batch_decoder(CELL.cfg, *args, geom, CELL.scheme, n_iter=6,
                              tuning=DecoderTuning(retry_m_dl=2),
                              device="cpu")
    yield ref, port
    mp.undo()


@pytest.mark.mid
@pytest.mark.parametrize("snr_db,seed", list(CASES))
def test_slice_matches_reference(decoders, snr_db, seed):
    ref, port = decoders
    iq, tb = dl_subframes(CELL, 2, snr_db=snr_db, seed=seed)
    assert CELL.geom.info.c == 2 and CELL.scheme == "64qam"
    bits_r, ok_r, it_r = ref(jnp.asarray(iq))
    bits, ok, it = port(torch.from_numpy(iq))
    assert bits.dtype == torch.int8 and bits.shape == (2, CELL.geom.tbs)
    np.testing.assert_array_equal(bits.numpy(), np.asarray(bits_r))
    np.testing.assert_array_equal(ok.numpy(), np.asarray(ok_r))
    assert it == int(it_r)
    assert port.last_stats.retries == CASES[(snr_db, seed)]
    assert ok.all() and np.array_equal(bits.numpy(), tb)


def test_decoder_rejects_iq_on_another_device():
    dec = make_batch_decoder(*CELL.decoder_args(), device="meta")
    with pytest.raises(ValueError):
        dec(torch.zeros((1, CELL.cfg.n_samps_subframe, 2)))


@pytest.mark.parametrize("kw", [dict(mdtype="f16"), dict(demap_in="int8"),
                                dict(acq=130), dict(win=127)])
def test_tuning_rejects_unported_numerics(kw):
    with pytest.raises((NotImplementedError, ValueError)):
        DecoderTuning(**kw)


@pytest.mark.parametrize("kw", [dict(mdtype="bf16"),
                                dict(mdtype="bf16_f32store"),
                                dict(pinpad=False), dict(acq=100)])
def test_tuning_accepts_reference_numerics(kw):
    """The reference's trellis forms construct (they raised until the bf16
    trellis and the freeze were ported; acq > win/2, the unfused kernel's,
    until it was)."""
    t = DecoderTuning(**kw)
    assert all(getattr(t, k) == v for k, v in kw.items())
