"""The port's IQ stagings against ``lteax.io.iq``: bf16 pairs bit for bit
(the reference rounds with ml_dtypes, the port with torch: both to the
nearest, ties to even), int8 pairs and subframe chunks equal, the CPU
feed of ``prefetch_to_device`` in order; and the DL front on bf16 and on
int8 pairs against the reference's front on the same pairs (15 PRB,
B = 2), within 1e-5 of the largest LLR as ``tests/test_torch_front.py``
holds the f32 front."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lteax.io import iq as iq_ref
from lteax.phy.channels import pdsch as pdsch_ref
from lteax.phy.config import PhyConfig as RefPhyConfig
from lteax.phy.tuning import DecoderTuning as RefTuning
from lteax.shard.pipeline import _pdsch_stages

from lteax_torch.bench.timing import stage_iq
from lteax_torch.io import iq
from lteax_torch.pipeline import make_batch_decoder
from lteax_torch.sim.dl_gen import DlCell, dl_subframes


def _signal(n: int, seed: int, amp: float = 0.7) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return ((rng.standard_normal(n) + 1j * rng.standard_normal(n)) * amp
            ).astype(np.complex64)


def test_to_iq_bf16_bits_equal_reference():
    x = _signal(20000, 0)
    # ties: f32 values exactly half-way between two bf16 values
    ties = np.array([1 + 2 ** -8, 1 + 3 * 2 ** -8, -(1 + 2 ** -8)], np.float32)
    x[:3] = ties + 1j * ties[::-1]
    got = iq.to_iq_bf16(x)
    ref = iq_ref.to_iq_bf16(x)
    assert got.dtype == torch.bfloat16 and got.shape == (20000, 2)
    np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                  ref.view(np.uint16).view(np.int16))
    assert got[0, 0].item() == 1.0          # tie to even: down
    assert got[1, 0].item() == 1 + 2 ** -6  # tie to even: up


@pytest.mark.parametrize("scale", [127.0, 40.0])
def test_to_iq_sc8_and_chunks_equal_reference(scale):
    x = _signal(3 * 1920 + 77, 1, amp=1.5)   # some components clip
    got = iq.to_iq_sc8(x, scale)
    np.testing.assert_array_equal(got, iq_ref.to_iq_sc8(x, scale))
    assert got.dtype == np.int8
    for start in (0, 5, 1919):
        np.testing.assert_array_equal(iq.chunk_subframes(x, 1920, start),
                                      iq_ref.chunk_subframes(x, 1920, start))


def test_prefetch_on_the_cpu_yields_batches_in_order():
    batches = [np.full((3, 2), k, np.float32) for k in range(5)]
    got = list(iq.prefetch_to_device(iter(batches), device="cpu"))
    assert len(got) == 5
    for k, t in enumerate(got):
        assert isinstance(t, torch.Tensor) and t.device.type == "cpu"
        np.testing.assert_array_equal(t.numpy(), batches[k])
    assert list(iq.prefetch_to_device([], device="cpu")) == []
    t = torch.ones(4)
    assert next(iq.prefetch_to_device([t], device="cpu")) is t
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            next(iq.prefetch_to_device(batches))


@pytest.fixture(scope="module")
def fronts():
    mp = pytest.MonkeyPatch()
    mp.setenv("LTEAX_OFDM_DFT", "fft")
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    cell = DlCell(n_rb_dl=15, mcs=28)
    iq_f32, _ = dl_subframes(cell, 2, snr_db=25.0, seed=1)
    geom = cell.geom
    geom_r = pdsch_ref.pdsch_geometry(geom.tbs, geom.n_re, geom.qm, geom.rv)
    front_r, _ = _pdsch_stages(
        RefPhyConfig(n_rb_dl=cell.n_rb_dl), cell.n_cell_id, cell.cfi,
        cell.prbs, cell.subframe, cell.rnti, geom_r, cell.scheme, 6,
        RefTuning(mdtype="f32", demap_in="f32"), True, planar_boundary=False)
    dec = make_batch_decoder(*cell.decoder_args(), device="cpu")
    yield cell, iq_f32, front_r, dec
    torch.set_num_threads(n)
    mp.undo()


@pytest.mark.parametrize("fmt", ["bf16", "sc8"])
def test_dl_front_on_staged_pairs_matches_reference(fronts, fmt):
    cell, iq_f32, front_r, dec = fronts
    x = iq.from_iq_f32(iq_f32)
    if fmt == "bf16":
        pairs_r = iq_ref.to_iq_bf16(x)
        staged = stage_iq(iq_f32, fmt)
    else:
        scale = 127.0 / float(np.abs(iq_f32).max())
        pairs_r = iq_ref.to_iq_sc8(x, scale)
        staged = stage_iq(iq_f32, fmt)
        np.testing.assert_array_equal(staged.numpy(), pairs_r)
    assert staged.dtype == {"bf16": torch.bfloat16, "sc8": torch.int8}[fmt]
    ref = np.asarray(front_r(jnp.asarray(pairs_r))).reshape(
        -1, 3, cell.geom.k + 4)
    got = dec.front(staged).numpy()
    assert got.shape == ref.shape == (2 * cell.geom.info.c, 3,
                                      cell.geom.k + 4)
    np.testing.assert_array_equal(got == 0, ref == 0)
    np.testing.assert_allclose(got, ref, rtol=1e-5,
                               atol=1e-5 * np.abs(ref).max())
    bits, ok, _ = dec(staged)
    assert ok.all()
