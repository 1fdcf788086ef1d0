"""The port's multi-device layer (``lteax_torch.shard``) against the
reference's (``lteax.shard``) on the same mesh shapes, 1x4 and 2x2, and the
same seeded inputs.

The port runs as 4 gloo ranks on the CPU (``mesh.spawn``, started once for
the module; each rank runs ``tests/torch_shard_ranks.py``); the reference
runs once per module under ``shard_map`` over 4 of the 8 virtual CPU
devices of ``tests/conftest.py``, its Pallas kernels in interpret mode, at
the port's numerics: ``DecoderTuning(mdtype="f32", demap_in="f32",
ofdm_dft="fft")`` with the UL and MIMO planar boundaries off and
``LTEAX_OFDM_DFT`` / ``LTEAX_UL_DFT`` pinned to ``fft``.

Exact: the halo exchange, the DL, acquire and UL decoders' TB bits, CRC
flags and ``n_ok``, and the sharded prescan's detections (root, index,
flag) and its detection count.  Within 1e-5 of the largest magnitude: the
overlap-save correlation and ``pss_peak`` (the reference's XLA
convolution against the port's FFT product, each in f32); the prescan's
peak ratio within 1e-4
relative, as ``tests/test_torch_scan.py`` holds it.  The HARQ, TM3 MMSE
and TM4 SIC sharded decoders are held to the port's single-device
decoders, which their own tests pin to the reference, and to the bits
sent."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import PartitionSpec as P

from lteax.phy.channels import pdsch as pdsch_ref
from lteax.phy.channels import pusch as pusch_ref
from lteax.phy.config import PhyConfig as RefPhyConfig
from lteax.phy.tuning import DecoderTuning as RefTuning
from lteax.shard import halo as halo_ref
from lteax.shard import pipeline as pipe_ref
from lteax.shard import scanner as scanner_ref
from lteax.shard.mesh import TIME_AXIS as REF_TIME
from lteax.shard.mesh import make_mesh as make_ref_mesh

import torch_shard_ranks
from lteax_torch.io.iq import to_iq_f32
from lteax_torch.phy.channels.pusch import PuschAlloc
from lteax_torch.phy.config import PhyConfig
from lteax_torch.phy.tuning import DecoderTuning
from lteax_torch.pipeline import (make_batch_harq_decoder,
                                  make_mimo_batch_decoder)
from lteax_torch.shard.mesh import make_mesh, process_group, spawn
from lteax_torch.sim import cell_gen
from lteax_torch.sim.dl_gen import (DlCell, dl_subframes, harq_decoder_args,
                                    harq_transmissions)
from lteax_torch.sim.mimo_gen import MimoCell, decoder_rows, mimo_subframes
from lteax_torch.sim.ul_gen import UlCell, ul_subframes

MESHES = ((1, 4), (2, 2))
IDS = ["1x4", "2x2"]
B = 4
TOL = 1e-5          # of the largest magnitude: the correlation, pss_peak
HALO = 3
DL = DlCell(n_rb_dl=6, n_cell_id=150, mcs=9, cfi=3)
UL = UlCell(alloc=PuschAlloc(n_prb=6, rb_start=0, mcs_tbs=712, qm=2))
HARQ_SNR_DB = 3.0                  # rv 0 alone decodes none, rv 0 + rv 2 all
TM3 = MimoCell(n_rb_dl=6, cfi=2, mcs=6)
TM4 = MimoCell(n_rb_dl=6, cfi=2, mcs=15, tm=4, cb_index=0)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(12)
    dl_iq, dl_tb = dl_subframes(DL, B, snr_db=15.0, seed=1)
    ul_iq, ul_tb = ul_subframes(UL, B, snr_db=10.0, seed=2)
    harq_iq, harq_tb, harq_cells = harq_transmissions(
        DL, (1, 2), (0, 2), B, snr_db=HARQ_SNR_DB, seed=3)
    tm3_iq, tm3_tb = mimo_subframes(TM3, B, 25.0, "bench", seed=4)
    sic_iq, sic_tb = mimo_subframes(TM4, B, 20.0, "corr", seed=5)
    live = [cell_gen.generate(cell_gen.Cell(n_rb_dl=6, n_cell_id=cid), 10,
                              device="cpu") for cid in (30, 101)]
    n = len(live[0])
    dead = (0.01 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
            ).astype(np.complex64)
    k = 31
    return {
        "meshes": MESHES, "cfg": PhyConfig(n_rb_dl=6), "halo": HALO,
        "halo_x": np.arange(64, dtype=np.float32),
        "corr_x": (rng.standard_normal(512) + 1j * rng.standard_normal(512)
                   ).astype(np.complex64),
        "corr_taps": (rng.standard_normal(k) + 1j * rng.standard_normal(k)
                      ).astype(np.complex64),
        "dl_cell": DL, "dl_iq": dl_iq, "dl_tb": dl_tb,
        "ul_cell": UL, "ul_iq": ul_iq, "ul_tb": ul_tb,
        "harq_cells": harq_cells, "harq_iq": harq_iq, "harq_tb": harq_tb,
        "tm3_cell": TM3, "tm3_iq": tm3_iq, "tm3_tb": decoder_rows(tm3_tb),
        "tm4_cell": TM4, "sic_iq": sic_iq, "sic_tb": decoder_rows(sic_tb),
        "captures": np.stack([live[0], dead, live[1]]),
    }


@pytest.fixture(scope="module")
def ranks(inputs):
    """The port: 4 gloo ranks on the CPU, every case on both meshes."""
    return [r.value for r in spawn(torch_shard_ranks.run, 4, "cpu", None,
                                   inputs)]


def _ref_time_map(mesh, fn, x):
    return np.asarray(jax.jit(shard_map(
        lambda xs: fn(xs[0])[None], mesh=mesh,
        in_specs=(P(REF_TIME, None),), out_specs=P(REF_TIME, None)))(x))


@pytest.fixture(scope="module")
def ref(inputs):
    """The reference's sharded functions on both meshes, once."""
    mp = pytest.MonkeyPatch()
    mp.setenv("LTEAX_OFDM_DFT", "fft")
    mp.setenv("LTEAX_UL_DFT", "fft")
    tuning = RefTuning(mdtype="f32", demap_in="f32", ofdm_dft="fft",
                       ul_planar_boundary=False, mimo_planar_boundary=False)
    cfg_r = RefPhyConfig(n_rb_dl=6)
    g = DL.geom
    dl_args = (cfg_r, DL.n_cell_id, DL.cfi, DL.prbs, DL.subframe, DL.rnti,
               pdsch_ref.pdsch_geometry(g.tbs, g.n_re, g.qm, g.rv),
               DL.scheme)
    a = UL.alloc
    alloc_r = pusch_ref.PuschAlloc(n_prb=a.n_prb, rb_start=a.rb_start,
                                   mcs_tbs=a.mcs_tbs, qm=a.qm)
    caps = inputs["captures"]
    pad = np.concatenate([caps, np.zeros((1, caps.shape[1]), np.complex64)])
    out = {}
    for shape in MESHES:
        mesh = make_ref_mesh(*shape, devices=jax.devices()[:4])
        nt = shape[1]
        r = {"halo": _ref_time_map(
                mesh, lambda x: halo_ref.exchange_right_halo(x, HALO, REF_TIME),
                jnp.asarray(inputs["halo_x"].reshape(nt, -1))),
             "corr": _ref_time_map(
                mesh, lambda x: halo_ref.overlap_save_correlate(
                    x, jnp.asarray(inputs["corr_taps"]), REF_TIME),
                jnp.asarray(inputs["corr_x"].reshape(nt, -1)))}
        x = jnp.asarray(inputs["dl_iq"])
        for name, make in (
                ("dl", pipe_ref.make_sharded_decoder_pallas),
                ("acquire", pipe_ref.make_sharded_acquire_decoder_pallas)):
            res = make(mesh, *dl_args, n_iter=6, tuning=tuning,
                       interpret=True)(x)
            r[name] = [np.asarray(v) for v in res]
        res = pipe_ref.make_sharded_pusch_decoder(
            mesh, alloc_r, UL.rnti, UL.subframe, UL.n_cell_id, n_iter=6,
            tuning=tuning, interpret=True)(jnp.asarray(inputs["ul_iq"]))
        r["ul"] = [np.asarray(v) for v in res]
        r["prescan"] = scanner_ref.batched_prescan(caps, cfg_r, mesh)
        det = scanner_ref.make_sharded_pss_detector(mesh, cfg_r,
                                                    pad.shape[1])
        r["n_det"] = int(det(jnp.asarray(to_iq_f32(pad)))[-1])
        out[shape] = r
    mp.undo()
    return out


def _rows(x, coord, shape, axis=0):
    """The rows of the global ``x`` that the rank at ``coord`` holds."""
    m = x.shape[axis] // shape[1]
    i = coord[1]
    return x[(slice(None),) * axis + (slice(i * m, (i + 1) * m),)]


def _each_rank(ranks, shape):
    return [r[shape] for r in ranks]


@pytest.mark.parametrize("shape", MESHES, ids=IDS)
def test_halo_exchange_is_exact(ranks, ref, shape):
    for r in _each_rank(ranks, shape):
        np.testing.assert_array_equal(r["halo"], ref[shape]["halo"][
            r["coord"][1]])


@pytest.mark.parametrize("shape", MESHES, ids=IDS)
def test_overlap_save_correlation_within_tolerance(ranks, ref, inputs,
                                                   shape):
    want = ref[shape]["corr"]
    for r in _each_rank(ranks, shape):
        got = r["corr"]
        assert got.dtype == np.complex64 and got.shape == want[0].shape
        assert np.abs(got - want[r["coord"][1]]).max() <= \
            TOL * np.abs(want).max()
    # and the numpy definition on the unsharded signal
    x, taps = inputs["corr_x"], inputs["corr_taps"]
    xp = np.concatenate([x, np.zeros(len(taps) - 1, np.complex64)])
    ys = np.array([np.sum(xp[n:n + len(taps)] * np.conj(taps))
                   for n in range(len(x))])
    got = np.concatenate([r["corr"] for r in _each_rank(ranks, shape)
                          if r["coord"][0] == 0])
    assert np.abs(got - ys).max() <= TOL * np.abs(ys).max()


@pytest.mark.parametrize("kind", ["dl", "acquire", "ul"])
@pytest.mark.parametrize("shape", MESHES, ids=IDS)
def test_sharded_decoder_equals_the_reference(ranks, ref, inputs, shape,
                                              kind):
    bits_r, ok_r, n_ok_r = ref[shape][kind][:3]
    sent = inputs["ul_tb" if kind == "ul" else "dl_tb"]
    assert int(n_ok_r) == B and np.array_equal(bits_r, sent)
    for r in _each_rank(ranks, shape):
        got = r[kind]
        assert got["bits"].dtype == np.int8
        np.testing.assert_array_equal(got["bits"],
                                      _rows(bits_r, r["coord"], shape))
        np.testing.assert_array_equal(got["ok"],
                                      _rows(ok_r, r["coord"], shape))
        assert got["n_ok"] == int(n_ok_r)


@pytest.mark.parametrize("shape", MESHES, ids=IDS)
def test_pss_peak_within_tolerance(ranks, ref, shape):
    want = float(ref[shape]["acquire"][3])
    for r in _each_rank(ranks, shape):
        assert r["acquire"]["peak"] == pytest.approx(want, rel=TOL)


@pytest.mark.parametrize("shape", MESHES, ids=IDS)
def test_sharded_prescan_equals_the_reference(ranks, ref, shape):
    want = ref[shape]["prescan"]
    assert [d["detected"] for d in want] == [True, False, True]
    for r in _each_rank(ranks, shape):
        assert len(r["prescan"]) == len(want)
        for g, w in zip(r["prescan"], want):
            assert (g["detected"], g["n_id_2"], g["pss_idx"]) == \
                (w["detected"], w["n_id_2"], w["pss_idx"])
            assert g["peak_ratio"] == pytest.approx(w["peak_ratio"],
                                                    rel=1e-4)
        assert r["n_det"] == ref[shape]["n_det"]


def _single_device(inputs, kind):
    """The port's single-device decoder on the whole batch."""
    if kind == "harq":
        dec = make_batch_harq_decoder(*harq_decoder_args(
            inputs["harq_cells"]), device="cpu")
        return dec(torch.from_numpy(inputs["harq_iq"])), inputs["harq_tb"]
    cell = TM3 if kind == "tm3" else TM4
    tuning = DecoderTuning(mimo_detector="sic" if kind == "sic" else "mmse")
    dec = make_mimo_batch_decoder(*cell.decoder_args(), **cell.precoding,
                                  tuning=tuning, device="cpu")
    return dec(torch.from_numpy(inputs[f"{kind}_iq"])), inputs[f"{kind}_tb"]


@pytest.mark.parametrize("kind", ["harq", "tm3", "sic"])
@pytest.mark.parametrize("shape", MESHES, ids=IDS)
def test_sharded_equals_the_single_device_decoder(ranks, inputs, shape,
                                                  kind):
    (bits, ok, _), sent = _single_device(inputs, kind)
    n = len(sent)
    assert bool(ok.all()) and np.array_equal(bits.numpy(), sent)
    rows = 1 if kind == "harq" else 2          # MIMO: two codewords a row
    for r in _each_rank(ranks, shape):
        got = r[kind]
        np.testing.assert_array_equal(
            got["bits"], _rows(bits.numpy(), r["coord"], shape))
        np.testing.assert_array_equal(got["ok"],
                                      _rows(ok.numpy(), r["coord"], shape))
        assert got["n_ok"] == n and len(got["bits"]) == rows * B // shape[1]


@pytest.mark.parametrize("shape", MESHES, ids=IDS)
def test_sharded_harq_needs_both_transmissions(ranks, shape):
    for r in _each_rank(ranks, shape):
        assert r["harq_rv0"]["n_ok"] == 0 and not r["harq_rv0"]["ok"].any()
        assert r["harq"]["n_ok"] == B


def test_ranks_load_no_jax(ranks):
    assert [r["foreign"] for r in ranks] == [[]] * 4


def test_mesh_layout_and_size_check():
    """Ranks sit row-major on the (chan, time) mesh, and a shape that does
    not cover the group raises as the reference does."""
    with process_group(device="cpu"):
        mesh = make_mesh(device="cpu")
        assert mesh.mesh.tolist() == [[0]]
        assert mesh.mesh_dim_names == ("chan", "time")
        with pytest.raises(ValueError, match="2x1 mesh != 1 devices"):
            make_mesh(2, 1, device="cpu")
        with pytest.raises(ValueError, match="runs 'gloo'"):
            make_mesh(device="cpu", backend="nccl")


def test_ranks_hold_the_row_major_coordinates(ranks):
    for rank, r in enumerate(ranks):
        assert r[(1, 4)]["coord"] == (0, rank)
        assert r[(2, 2)]["coord"] == divmod(rank, 2)


def test_overlap_save_refuses_a_shard_shorter_than_the_halo():
    from lteax_torch.shard.halo import overlap_save_correlate
    with process_group(device="cpu"):
        mesh = make_mesh(device="cpu")
        with pytest.raises(ValueError, match="shorter than the halo"):
            overlap_save_correlate(torch.zeros(4, dtype=torch.complex64),
                                   torch.ones(8, dtype=torch.complex64), mesh)
        y = overlap_save_correlate(torch.ones(7, dtype=torch.complex64),
                                   torch.ones(8, dtype=torch.complex64), mesh)
        np.testing.assert_allclose(y.numpy(), [7, 6, 5, 4, 3, 2, 1],
                                   atol=1e-5)

