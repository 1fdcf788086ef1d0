"""The port's scanner against the reference's, on the CPU (plain kernel
versions): cell_gen grids against file_gen's (SI off and on), the capture
scan against ``lteax.apps.file_scan.scan(x, cfg, max_si_subframes=0)``
(the MIB-level result; the SI stage: ``tests/test_torch_si*.py``), the
batched prescan against ``lteax.apps.scanner``'s, cell_gen captures with SI
scanned to what they carry, and the port's multi-channel scanner end to
end.

Integer fields and the MIB must be equal.  Tolerances: CFO 1 Hz (CP
correlation sums in other orders and dtypes), RSRP and SNR 0.1 dB, EVM
0.05 percentage points, prescan peak ratio rtol 1e-4 (the reference's
PSS route is the FFT, the port's the direct correlator).  The reference's
OFDM demod is pinned to its FFT route (``LTEAX_OFDM_DFT=fft``)."""

import dataclasses
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lteax.apps import file_gen
from lteax.apps import scanner as scanner_ref
from lteax.apps.file_scan import scan as scan_ref
from lteax.kernels.polyphase import resample_poly as resample_ref
from lteax.phy.config import PhyConfig as RefPhyConfig

import lteax_torch.apps.file_scan as fs
from lteax_torch import host
from lteax_torch.apps import scanner
from lteax_torch.io.iq import write_iq
from lteax_torch.kernels.polyphase import resample_poly
from lteax_torch.phy.config import PhyConfig
from lteax_torch.phy.grid import (crs_flat_idx, pbch_flat_idx, pss_sym,
                                  sss_sym, sync_sc)
from lteax_torch.shard.scanner import batched_prescan
from lteax_torch.sim import cell_gen
from lteax_torch.sim.channel import awgn
from torch_compile_cache import compile_once

CFG, CFG_R = PhyConfig(n_rb_dl=6), RefPhyConfig(n_rb_dl=6)
INT_FIELDS = ("n_cell_id", "n_id_1", "n_id_2", "frame_start", "n_ant", "sfn")


@pytest.fixture(scope="module", autouse=True)
def _compile_once():
    """The reference's eager code compiles each program once
    (``torch_compile_cache``)."""
    with compile_once():
        yield


@pytest.fixture(autouse=True)
def _fft_dft(monkeypatch):
    monkeypatch.setenv("LTEAX_OFDM_DFT", "fft")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs files in parallel processes; torch's own thread pool
    on top of them oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _assert_same_scan(got, ref):
    for f in INT_FIELDS:
        assert getattr(got, f) == getattr(ref, f), f
    assert dataclasses.asdict(got.mib) == dataclasses.asdict(ref.mib)
    assert abs(got.cfo_hz - ref.cfo_hz) < 1.0
    assert abs(got.rsrp_dbfs - ref.rsrp_dbfs) < 0.1
    assert abs(got.snr_db - ref.snr_db) < 0.1
    assert abs(got.evm_pct - ref.evm_pct) < 0.05


@pytest.mark.parametrize("n_ant,sfn,sf", [(1, 0, 0), (2, 5, 0), (4, 6, 5),
                                          (4, 7, 3)])
def test_cell_gen_grid_matches_file_gen(n_ant, sfn, sf):
    cid = 250 + n_ant
    gc = file_gen.GenConfig(n_rb_dl=6, n_cell_id=cid, n_ant=n_ant,
                            cfi=3 if n_ant == 4 else 2)
    cell = cell_gen.Cell(n_rb_dl=6, n_cell_id=cid, n_ant=n_ant)
    from lteax.phy.channels import pbch as pbch_ref
    from lteax_torch.stack import rrc
    mib = rrc.pack_mib(cell.mib(sfn - sfn % 4))
    q_ref = np.asarray(pbch_ref.pbch_encode_40ms(jnp.asarray(mib), n_ant, cid))
    sib = np.zeros(40, np.int32)
    ref = file_gen.build_subframe_grid(gc, sfn, sf, q_ref, sib, sib).reshape(-1)
    got = cell_gen.build_subframe_grid(
        cell, sfn, sf, cell_gen.pbch.pbch_encode_40ms(mib, n_ant, cid)
    ).reshape(-1)
    cfg = CFG
    res = [crs_flat_idx(cfg, cid, p) for p in range(n_ant)]
    if sf in (0, 5):
        res += [s * cfg.n_sc + sync_sc(cfg) for s in (pss_sym(cfg),
                                                      sss_sym(cfg))]
    if sf == 0:
        res.append(pbch_flat_idx(cfg, cid))
    res = np.concatenate(res)
    np.testing.assert_allclose(got[res], ref[res], rtol=1e-6, atol=1e-6)
    rest = np.setdiff1d(np.arange(got.size), res)
    assert not np.any(got[rest])               # nothing else is written


@pytest.mark.parametrize("n_ant,si_dci", [(1, "1a"), (1, "1c"), (2, "1a"),
                                          (2, "1c"), (4, "1a"), (4, "1c")])
def test_cell_gen_si_grid_matches_file_gen(n_ant, si_dci):
    """With SI on, every RE of subframes 0, 5 (SIB1 in frame 6, the SI
    message in frame 7) and 9 (paging) equals file_gen's."""
    from lteax.phy.channels import pbch as pbch_ref
    from lteax.stack import rrc as rrc_ref
    from lteax_torch.stack import rrc
    cid = 300 + n_ant
    tmsi = (0x1234567, 0x0200000042)
    cfi = 3 if n_ant == 4 else 2
    cell = cell_gen.Cell(n_rb_dl=6, n_cell_id=cid, n_ant=n_ant, cfi=cfi,
                         si_dci=si_dci, paging_tmsi=tmsi)
    si = cell_gen.si_bits(cell)
    gc = file_gen.GenConfig(n_rb_dl=6, n_cell_id=cid, n_ant=n_ant, cfi=cfi,
                            si_dci=si_dci, paging_tmsi=tmsi, sib1_mcs=si.mcs)
    sib1_r = rrc_ref.pack_sib1(rrc_ref.Sib1(
        mcc=gc.mcc, mnc=gc.mnc, tac=gc.tac, cell_identity=gc.cell_identity,
        freq_band_indicator=gc.band,
        scheduling=(rrc_ref.SchedulingInfo(8, (3,)),)))
    sib2_r = rrc_ref.pack_si(rrc_ref.Sib2())
    paging_r = rrc_ref.pack_paging(rrc_ref.Paging(ue_identities=tmsi))
    for a, b in ((si.sib1, sib1_r), (si.sib2, sib2_r), (si.paging, paging_r)):
        np.testing.assert_array_equal(a, b)
    mib = rrc.pack_mib(cell.mib(4))
    q = cell_gen.pbch.pbch_encode_40ms(mib, n_ant, cid)
    q_ref = np.asarray(pbch_ref.pbch_encode_40ms(jnp.asarray(mib), n_ant, cid))
    for sfn, sf in ((6, 0), (6, 5), (7, 5), (6, 9)):
        ref = file_gen.build_subframe_grid(gc, sfn, sf, q_ref, sib1_r, sib2_r,
                                           paging_r)
        got = cell_gen.build_subframe_grid(cell, sfn, sf, q, si)
        np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)
        assert np.count_nonzero(got) > np.count_nonzero(
            cell_gen.build_subframe_grid(cell, sfn, sf, q))


def _file_gen(n_ant, cid, n_frames=4):
    return np.array(file_gen.generate(file_gen.GenConfig(
        n_rb_dl=6, n_cell_id=cid, n_ant=n_ant, n_frames=n_frames,
        cfi=3 if n_ant == 4 else 2)))


@pytest.mark.mid
@pytest.mark.parametrize("n_ant,cid,snr", [(1, 21, None), (2, 404, 12.0),
                                           (4, 77, 12.0)])
def test_scan_matches_reference(n_ant, cid, snr):
    x = _file_gen(n_ant, cid)
    if snr is not None:
        x = awgn(np.random.default_rng(cid), x, snr)
    ref = scan_ref(x, CFG_R, max_si_subframes=0)
    host.READS = 0
    got = fs.scan(torch.from_numpy(x), CFG, max_si_subframes=0)
    assert host.READS == 4
    _assert_same_scan(got, ref)
    assert (got.n_cell_id, got.n_ant, got.mib.n_rb_dl) == (cid, n_ant, 6)
    assert json.loads(got.to_json()).keys() == \
        json.loads(ref.to_json()).keys()


@pytest.mark.mid
def test_scan_matches_reference_cfo_and_sdr_rate():
    """CFO and the 5/4 SDR rate of tests/test_scanner.py: each side
    resamples back 4/5 with its own resampler, then scans."""
    x = _file_gen(2, 404, n_frames=6)
    n = np.arange(len(x))
    x = (x * np.exp(2j * np.pi * 1234.5 * n / CFG.fs)).astype(np.complex64)
    x_sdr = np.array(resample_ref(jnp.asarray(x), 5, 4))     # writable
    ref = scan_ref(np.asarray(resample_ref(jnp.asarray(x_sdr), 4, 5)), CFG_R,
                   max_si_subframes=0)
    got = fs.scan(resample_poly(torch.from_numpy(x_sdr), 4, 5), CFG,
                  max_si_subframes=0)
    _assert_same_scan(got, ref)
    assert abs(got.cfo_hz - 1234.5) < 50.0 and got.n_cell_id == 404


def test_scan_without_si_stops_at_the_mib():
    """``max_si_subframes=0`` on an SI-bearing capture: the MIB-level
    report, in the 4 reads of stages 1-5."""
    cell = cell_gen.Cell(n_rb_dl=6, n_cell_id=9, n_ant=1)
    cap = cell_gen.capture(cell, 0.03, sfn0=2, offset=300, snr_db=20.0,
                           device="cpu")
    host.READS = 0
    res = fs.scan(torch.from_numpy(cap.iq), CFG, max_si_subframes=0)
    assert host.READS == 4
    assert (res.n_cell_id, res.sfn) == (9, cap.sfn)
    assert res.sib1 is None and res.sib2 is None and not res.si_decodes


@pytest.mark.parametrize("n_ant,si_dci", [(1, "1c"), (4, "1a")])
def test_cell_gen_capture_scans_si(n_ant, si_dci):
    """A cell_gen capture with SI, CFO, noise and an SDR rate scans to the
    SIB1, SIB2 and paging it was made with (the port alone)."""
    tmsi = (0x0AB0000001,)
    cell = cell_gen.Cell(n_rb_dl=6, n_cell_id=61, n_ant=n_ant,
                         cfi=3 if n_ant == 4 else 2, si_dci=si_dci,
                         paging_tmsi=tmsi, tac=0x2BCD)
    cap = cell_gen.capture(cell, 0.04, sfn0=101, offset=4000,
                           cfo_hz=1500.0, snr_db=15.0, rate_hz=2.4e6, seed=4,
                           device="cpu")
    res = fs.scan(resample_poly(torch.from_numpy(cap.iq), 4, 5), CFG)
    assert (res.n_cell_id, res.n_ant, res.sfn) == (61, n_ant, cap.sfn)
    assert dataclasses.asdict(res.sib1) == dataclasses.asdict(cell.sib1())
    assert dataclasses.asdict(res.sib2) == dataclasses.asdict(cell.sib2())
    assert res.paging == [hex(t) for t in tmsi] and res.sib_crc_fails == 0


def test_cell_gen_capture_scans():
    """A cell_gen capture with SFN, offset, CFO, noise and an SDR rate
    scans to what it was made with."""
    # cfi 3, as file_gen's 4-port cells: the SI grant's 4 CCEs need it
    cell = cell_gen.Cell(n_rb_dl=6, n_cell_id=137, n_ant=4,
                         phich_resource=0.5, cfi=3)
    cap = cell_gen.capture(cell, 0.025, sfn0=1021, offset=5000,
                           cfo_hz=-3000.0, snr_db=12.0, rate_hz=2.4e6,
                           seed=1, device="cpu")
    assert cap.iq.shape == (60000,) and cap.sfn == 1022
    res = fs.scan(resample_poly(torch.from_numpy(cap.iq), 4, 5), CFG,
                  max_si_subframes=0)
    assert (res.n_cell_id, res.n_ant, res.sfn) == (137, 4, 1022)
    assert res.mib.phich_resource == 0.5
    # the coarse CP-correlation CFO leaves ~100 Hz at 1.4 MHz and 12 dB,
    # and the CRS noise estimate (symbols half a subframe apart) reads the
    # residual rotation as noise: the SNR reads low
    assert abs(res.cfo_hz + 3000.0) < 250.0 and 8.0 < res.snr_db < 13.0


@pytest.fixture(scope="module")
def two_channels(tmp_path_factory):
    d = tmp_path_factory.mktemp("scan")
    live = _file_gen(1, 44)
    rng = np.random.default_rng(1)
    dead = 0.01 * (rng.standard_normal(len(live))
                   + 1j * rng.standard_normal(len(live))).astype(np.complex64)
    paths = str(d / "live.fc32"), str(d / "dead.fc32")
    write_iq(paths[0], live)
    write_iq(paths[1], dead)
    return paths


@pytest.mark.mid
def test_prescan_matches_reference(two_channels):
    pl, pd = two_channels
    ref = scanner_ref.prescan_channels(
        [scanner_ref.Channel("300", pl), scanner_ref.Channel("301", pd)], CFG_R)
    chans = [scanner.Channel("300", pl), scanner.Channel("301", pd)]
    # the reference takes its f32 FFT route on the CPU: the port's f32
    # correlator is held to it closely, its bf16 default (inputs rounded
    # to 8 bits of mantissa, 2^-9 each) within 2e-3 of the ratio
    caps = [scanner._native(ch, CFG, "cpu") for ch in chans]
    caps = torch.stack([c[:min(len(c) for c in caps)] for c in caps])
    for got, rel in ((batched_prescan(caps, CFG, mdtype="f32"), 1e-4),
                     (scanner.prescan_channels(chans, CFG, device="cpu"),
                      2e-3)):
        assert [g["detected"] for g in got] == [True, False]
        for g, r in zip(got, ref):
            assert g.keys() == r.keys()
            assert (g["detected"], g["n_id_2"], g["pss_idx"]) == \
                (r["detected"], r["n_id_2"], r["pss_idx"])
            assert g["peak_ratio"] == pytest.approx(r["peak_ratio"], rel=rel)


def test_scan_channels_prescan_and_checkpoint(two_channels, tmp_path):
    pl, pd = two_channels
    chans = [scanner.Channel("300", pl), scanner.Channel("301", pd)]
    ck = str(tmp_path / "scan.json")
    host.READS = 0
    reps = scanner.scan_channels(chans, CFG, checkpoint_path=ck,
                                 prescan=True, device="cpu")
    # the prescan's, then the live scan's: 4 to the MIB, 2 for each of the
    # two paging attempts and 3 for each of the two SI subframes
    assert host.READS == 1 + 14
    assert reps[0]["sib1"]["tac"] == 0x1234 and reps[0]["sib2"] is not None
    assert reps[0]["n_cell_id"] == 44 and reps[0]["freq_mhz"] == 2140.0
    assert reps[0]["mib"]["n_rb_dl"] == 6
    assert reps[1]["mib"] is None and not reps[1]["prescan"]["detected"]
    again = scanner.scan_channels([scanner.Channel("300", "/nonexistent"),
                                   scanner.Channel("301", "/nonexistent")],
                                  CFG, checkpoint_path=ck, device="cpu")
    assert again == reps and host.READS == 15


def test_scanner_cli(two_channels, capsys):
    pl, _ = two_channels
    scanner.main([f"300={pl}", "--device", "cpu"])
    out = [json.loads(s) for s in capsys.readouterr().out.splitlines()]
    assert out[0]["n_cell_id"] == 44 and out[0]["channel"] == "300"
