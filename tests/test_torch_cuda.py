"""The port's CUDA kernels against their plain torch versions, on the card.

Marked ``cuda``: without a CUDA device every test skips.  On the card:
``python -m pytest --noconftest -m cuda tests/test_torch_cuda.py`` (the
repository's conftest imports jax, which the card's machine lacks; this
file imports none).  ``chip_smoke.py`` runs the same comparisons at the
main path's full shapes."""

import numpy as np
import pytest
import torch

import lteax_torch.kernels.demap as demap
import lteax_torch.kernels.turbo_mlm as tm
from lteax_torch.pipeline import make_batch_decoder
from lteax_torch.sim.dl_gen import DlCell, dl_subframes

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("scheme,m", [("qpsk", 2), ("16qam", 4),
                                      ("64qam", 6)])
def test_demap_kernel_matches_plain(dev, scheme, m):
    rng = np.random.default_rng(m)
    t = lambda x: torch.as_tensor(x, dtype=torch.float32, device=dev)
    xr, xi = t(rng.standard_normal((5, 1000))), t(rng.standard_normal((5, 1000)))
    inv_nv = t(rng.uniform(1, 500, (5, 1000)))
    sgn = t(rng.choice([-1.0, 0.0, 1.0], (m, 1024)))
    before = demap.LAUNCHES
    got = demap.demap_planar(xr, xi, inv_nv, sgn, scheme)
    assert demap.LAUNCHES == before + 1
    ref = demap.demap_planar_plain(xr, xi, inv_nv, sgn, scheme)
    assert torch.equal(got, ref)


@pytest.mark.parametrize("k,win,acq", [
    (40, 32, 8), (5824, 128, 16),
    (40, 128, 16),        # one window, 43 of 128 positions live
    (1152, 128, 16),      # the last window has 3 live positions
    (6144, 128, 16),      # the largest K: 49 windows, a ragged block grid
    (512, 64, 32)])       # acq = win / 2
def test_turbo_kernel_matches_plain(dev, k, win, acq):
    """Bit for bit, at a C (37) that is no multiple of anything the kernel
    groups by."""
    c, n = 37, k + 3
    n_w = -(-n // win)
    rng = np.random.default_rng(k)
    t = lambda x: torch.as_tensor(x, dtype=torch.float32, device=dev)
    u, v = t(rng.standard_normal((c, n)) * 6), t(rng.standard_normal((c, n)) * 6)
    a0, b0 = tm._pin_boundaries(t(rng.standard_normal((c, n_w, 8))),
                                t(rng.standard_normal((c, n_w, 8))))
    before = tm.LAUNCHES
    got = tm.half_iteration_raw(u, v, a0, b0, win, acq)
    assert tm.LAUNCHES == before + 1
    ref = tm.half_iteration_plain(u, v, a0, b0, win, acq)
    for g, r in zip(got, ref):
        assert torch.equal(g, r)


@pytest.mark.parametrize("mdtype,pinpad", [
    ("bf16", True), ("bf16_f32store", True), ("bf16", False),
    ("bf16_f32store", False), ("f32", False)])
@pytest.mark.parametrize("c,k,win,acq", [
    (37, 40, 32, 8), (37, 40, 128, 16), (37, 1152, 128, 16),
    (37, 5824, 128, 16), (37, 512, 64, 32),
    (37, 1024, 36, 16),      # win/2 = 18: renormalised every 2
    (38, 1152, 128, 16),     # an even C: the bf16 kernel's pairs all whole
    (1, 224, 32, 16),        # the SI shape: C = 1 (the pair's high half dead)
    (38, 1027, 128, 16),     # the last window's t_pin 122 (even) ...
    (37, 1026, 128, 16),     # ... and 123 (odd)
    (37, 1152, 128, 15)])    # an odd acq: the NII export at an odd step
def test_turbo_kernel_forms_match_plain(dev, mdtype, pinpad, c, k, win, acq):
    """The bf16 trellis (both bf16 mdtypes launch it) and the freeze, bit
    for bit, at an odd C (37, no multiple of anything the kernels group by)
    and an even one, at C = 1, and at last windows with 3 and 43 live
    positions and with dead steps of either parity."""
    n = k + 3
    n_w = -(-n // win)
    rng = np.random.default_rng(k + win)
    t = lambda x: torch.as_tensor(x, dtype=torch.float32, device=dev)
    u, v = t(rng.standard_normal((c, n)) * 6), t(rng.standard_normal((c, n)) * 6)
    a0, b0 = tm._pin_boundaries(t(rng.standard_normal((c, n_w, 8))),
                                t(rng.standard_normal((c, n_w, 8))))
    before = dict(tm.FORM_LAUNCHES)
    got = tm.half_iteration_raw(u, v, a0, b0, win, acq, mdtype, pinpad)
    form = tm._form(mdtype, pinpad)
    assert tm.FORM_LAUNCHES[form] == before[form] + 1
    ref = tm.half_iteration_plain(u, v, a0, b0, win, acq, mdtype, pinpad)
    assert got[0].dtype == (torch.float32 if mdtype == "f32"
                            else torch.bfloat16)
    for g, r in zip(got, ref):
        assert torch.equal(g, r)


@pytest.mark.parametrize("variant", sorted(tm.BF16_VARIANTS))
@pytest.mark.parametrize("pinpad", [True, False])
@pytest.mark.parametrize("c,k,win,acq", [(37, 1152, 128, 16),
                                         (3, 1024, 36, 16), (1, 224, 32, 16),
                                         (38, 1027, 128, 16)])
def test_turbo_bf16_variants_match_plain(dev, variant, pinpad, c, k, win,
                                         acq):
    """Each of the bf16 kernel's timing variants bit for bit, and none of
    them counted as a launch of the decoders' form."""
    n = k + 3
    n_w = -(-n // win)
    rng = np.random.default_rng(variant)
    t = lambda x: torch.as_tensor(x, dtype=torch.float32, device=dev)
    u, v = t(rng.standard_normal((c, n)) * 6), t(rng.standard_normal((c, n)) * 6)
    a0, b0 = tm._pin_boundaries(t(rng.standard_normal((c, n_w, 8))),
                                t(rng.standard_normal((c, n_w, 8))))
    before = dict(tm.FORM_LAUNCHES)
    got = tm.half_iteration_bf16_variant(u, v, a0, b0, win, acq, variant,
                                         pinpad)
    assert tm.FORM_LAUNCHES == before
    ref = tm.half_iteration_plain(u, v, a0, b0, win, acq, "bf16", pinpad)
    for g, r in zip(got, ref):
        assert torch.equal(g, r)


@pytest.mark.parametrize("in_dt,out_dt", [
    (torch.bfloat16, torch.bfloat16), (torch.bfloat16, torch.float32),
    (torch.float32, torch.bfloat16)])
@pytest.mark.parametrize("scheme,m", [("qpsk", 2), ("64qam", 6)])
def test_demap_kernel_forms_match_plain(dev, in_dt, out_dt, scheme, m):
    rng = np.random.default_rng(m)
    t = lambda x: torch.as_tensor(x, dtype=torch.float32, device=dev).to(in_dt)
    xr, xi = t(rng.standard_normal((5, 1000))), t(rng.standard_normal((5, 1000)))
    inv_nv = t(rng.uniform(1, 500, (5, 1000)))
    sgn = torch.as_tensor(rng.choice([-1.0, 0.0, 1.0], (m, 1024)),
                          dtype=torch.float32, device=dev)
    got = demap.demap_planar(xr, xi, inv_nv, sgn, scheme, out_dt)
    ref = demap.demap_planar_plain(xr, xi, inv_nv, sgn, scheme, out_dt)
    assert got.dtype == out_dt and torch.equal(got, ref)


@pytest.mark.parametrize("mdtype", ["f32", "bf16"])
@pytest.mark.parametrize("wpb", [4, 8, 24, 40])
def test_turbo_kernel_any_windows_per_block(dev, wpb, mdtype):
    """The block's window count is a launch parameter, not part of the
    result: one warp, two, and 46 windows in ragged pairs of blocks (24 and
    22 with two dead, 40 and 6 with two dead); in bf16 a window carries two
    codeblocks, and C = 5 leaves the last pair's high half dead."""
    c, n, win, acq = 5, 5827, 128, 16
    rng = np.random.default_rng(wpb)
    t = lambda x: torch.as_tensor(x, dtype=torch.float32, device=dev)
    u, v = t(rng.standard_normal((c, n)) * 6), t(rng.standard_normal((c, n)) * 6)
    a0, b0 = tm._pin_boundaries(t(rng.standard_normal((c, 46, 8))),
                                t(rng.standard_normal((c, 46, 8))))
    for g, r in zip(tm.half_iteration_kernel(u, v, a0, b0, win, acq, wpb,
                                             mdtype),
                    tm.half_iteration_plain(u, v, a0, b0, win, acq, mdtype)):
        assert torch.equal(g, r)
    with pytest.raises(ValueError):
        tm.half_iteration_kernel(u, v, a0, b0, win, acq, wpb + 1, mdtype)


def test_turbo_kernel_allocates_no_scratch(dev):
    """The alpha and beta stores live in shared memory: a launch allocates
    its three outputs and nothing else (a kernel with its stores in device
    memory would need 2 x win/2 x 8 floats per chain beside them)."""
    c, n, win, acq = 64, 5827, 128, 16
    u = torch.zeros((c, n), dtype=torch.float32, device=dev)
    a0 = torch.zeros((c, 46, 8), dtype=torch.float32, device=dev)
    tm.half_iteration_raw(u, u, a0, a0, win, acq)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    out = tm.half_iteration_raw(u, u, a0, a0, win, acq)
    torch.cuda.synchronize()
    grown = torch.cuda.max_memory_allocated() - base
    assert grown <= sum(o.numel() * 4 for o in out) + 3 * 512   # rounding


def test_kernels_refuse_wrong_dtype(dev):
    x = torch.zeros((2, 100), dtype=torch.float64, device=dev)
    sgn = torch.zeros((2, 128), dtype=torch.float32, device=dev)
    with pytest.raises(ValueError):
        demap.demap_planar(x, x, x, sgn, "qpsk")
    u = torch.zeros((2, 43), dtype=torch.float32, device=dev)
    ab = torch.zeros((2, 1, 8), dtype=torch.float32, device=dev)
    for bad in ((u.double(), u, ab, ab), (u, u, ab.half(), ab),
                (torch.zeros((43, 2), device=dev).T, u, ab, ab)):
        with pytest.raises(ValueError):
            tm.half_iteration_raw(*bad, 128, 16)


def test_decoder_on_card_matches_cpu(dev):
    cell = DlCell(n_rb_dl=15)
    iq, tb = dl_subframes(cell, 2, snr_db=21.5, seed=1)
    # no device named: the current CUDA device
    out_gpu = make_batch_decoder(*cell.decoder_args())(
        torch.from_numpy(iq).cuda())
    out_cpu = make_batch_decoder(*cell.decoder_args(), device="cpu")(
        torch.from_numpy(iq))
    assert torch.equal(out_gpu[0].cpu(), out_cpu[0])
    assert torch.equal(out_gpu[1].cpu(), out_cpu[1])
    assert out_gpu[2] == out_cpu[2]
    assert np.array_equal(out_cpu[0].numpy(), tb)


# -- the scanner slice's kernels: PSS correlator + detect, resampler -------

def _noise(shape, seed, dev):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(shape) + 1j * rng.standard_normal(shape))
    return torch.as_tensor(x.astype(np.complex64), device=dev)


@pytest.mark.parametrize("n_rb,c,l", [(6, 3, 5000), (100, 2, 40000)])
def test_pss_kernels_match_plain(dev, n_rb, c, l):
    from lteax_torch.phy.config import PhyConfig
    from lteax_torch.kernels import pss
    from lteax_torch.phy.sync import pss_time_filters
    filt = pss_time_filters(PhyConfig(n_rb_dl=n_rb))
    x = _noise((c, l), n_rb, dev)
    x[0, 1234:1234 + filt.shape[1]] += 20 * torch.as_tensor(filt[2],
                                                           device=dev)
    before = (pss.CORR_LAUNCHES, pss.DETECT_LAUNCHES)
    got = pss.pss_corr_mag(x, filt, "f32")
    parts = pss.pss_detect(x, filt, "f32")
    assert (pss.CORR_LAUNCHES, pss.DETECT_LAUNCHES) == \
        (before[0] + 1, before[1] + 1)
    assert torch.equal(got, pss.pss_corr_mag_plain(x, filt, "f32"))
    for g, r in zip(parts[:3], pss.pss_detect_plain(x, filt, "f32")):
        assert torch.equal(g, r)
    nid2, idx, _, _ = pss.pss_reduce_combine(*parts)
    assert int(nid2[0]) == 2 and abs(int(idx[0]) - 1234) <= 2


@pytest.mark.parametrize("n_rb,c,l", [
    (6, 3, 5000), (6, 1, 16384 + 777), (15, 2, 33001), (100, 2, 40001)])
def test_pss_bf16_kernels_match_plain(dev, n_rb, c, l):
    """The tensor-core routine (the default) against its plain version:
    within ``BF16_TOL`` of each carrier's peak, the root and index of the
    peak equal; odd lengths and carrier counts exercise the ragged tiles
    and the 8-byte row alignment."""
    from lteax_torch.phy.config import PhyConfig
    from lteax_torch.kernels import pss
    from lteax_torch.phy.sync import pss_time_filters
    filt = pss_time_filters(PhyConfig(n_rb_dl=n_rb))
    x = _noise((c, l), n_rb + c, dev)
    x[0, 1234:1234 + filt.shape[1]] += 20 * torch.as_tensor(filt[2],
                                                           device=dev)
    before = (pss.CORR_BF16_LAUNCHES, pss.DETECT_BF16_LAUNCHES,
              pss.CORR_LAUNCHES, pss.DETECT_LAUNCHES)
    got = pss.pss_corr_mag(x, filt)
    parts = pss.pss_detect(x, filt)
    assert (pss.CORR_BF16_LAUNCHES, pss.DETECT_BF16_LAUNCHES,
            pss.CORR_LAUNCHES, pss.DETECT_LAUNCHES) == \
        (before[0] + 1, before[1] + 1, before[2], before[3])
    ref = pss.pss_corr_mag_plain(x, filt)
    peak = ref.amax(dim=(1, 2), keepdim=True)
    assert float(((got - ref).abs() / peak).max()) <= pss.BF16_TOL
    assert torch.equal(got.flatten(1).argmax(1), ref.flatten(1).argmax(1))
    rp = pss.pss_detect_plain(x, filt)
    assert parts[3] == pss.TILE_BF16
    assert float((parts[0] - rp[0]).abs().max() / peak.max()) <= pss.BF16_TOL
    assert float(((parts[2] - rp[2]).abs() / rp[2]).max()) <= pss.BF16_TOL
    a = pss.pss_reduce_combine(*parts)
    b = pss.pss_reduce_combine(*rp, pss.TILE_BF16, l)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert int(a[0][0]) == 2 and abs(int(a[1][0]) - 1234) <= 2


def _one_frame(p, q):
    """A length that leaves exactly one output frame, with Q - 1 to spare."""
    from lteax_torch.kernels.polyphase import k_in
    return k_in(p, q) + 2 * q - 1


@pytest.mark.parametrize("c,l,p,q", [
    (3, 30011, 192, 125), (3, 30011, 125, 192), (3, 30011, 4, 5),
    (3, 30011, 2, 1),
    (1, 400_000, 192, 125),       # the scanner's launch: one channel
    (1, 500_000, 768, 625),       # 25 Msps to 30.72 Msps, two items a thread
    (2, 250_011, 1536, 625),      # 12.5 Msps to 30.72 Msps, four a thread
    (2, 100_003, 3072, 625),      # two phase groups of blocks
    (2, _one_frame(192, 125), 192, 125), (3, _one_frame(1536, 625), 1536, 625),
    (8, 300_007, 192, 125)])      # several tiles a block, the last ragged
def test_resample_kernel_matches_plain(dev, c, l, p, q):
    from lteax_torch.kernels import polyphase
    x = _noise((c, l), p + q, dev)
    before = polyphase.LAUNCHES
    got = polyphase.resample_poly(x, p, q)
    assert polyphase.LAUNCHES == before + 1
    assert torch.equal(got, polyphase.resample_poly_plain(x, p, q))
    if (c, l) == (8, 300_007):
        pl = polyphase.launch_plan(c, l, p, q, polyphase._sm_count(str(dev)))
        assert polyphase.n_frames_out(l, p, q) % pl.frames
        assert c * pl.tiles > pl.blocks


def test_resample_kernel_takes_unaligned_views(dev):
    """A view that starts 8 bytes off a 16-byte boundary, contiguous or not,
    gives what its contiguous copy gives."""
    from lteax_torch.kernels import polyphase
    x = _noise((2, 30012), 7, dev)
    flat = x.reshape(-1)[1:40001]
    assert flat.is_contiguous() and flat.data_ptr() % 16 == 8
    for v in (x[:, 1:], flat):
        assert torch.equal(polyphase.resample_poly(v, 192, 125),
                           polyphase.resample_poly(v.clone(), 192, 125))


def test_resample_bank_is_uploaded_once(dev):
    """The bank lives on the device per (P, Q, device): a second call at
    the same ratio uploads nothing."""
    from lteax_torch.kernels import polyphase
    polyphase._device_bank.cache_clear()
    x = _noise((1, 20000), 3, dev)
    a = polyphase.resample_poly(x, 192, 125)
    b = polyphase.resample_poly(x, 192, 125)
    info = polyphase._device_bank.cache_info()
    assert (info.misses, info.hits) == (1, 1) and torch.equal(a, b)
    polyphase.resample_poly(x, 768, 625)
    assert polyphase._device_bank.cache_info().misses == 2


def test_scanner_kernels_refuse_wrong_dtype(dev):
    from lteax_torch.kernels import polyphase, pss
    x = torch.zeros((2, 5000), dtype=torch.complex128, device=dev)
    filt = np.zeros((3, 128), np.complex64)
    for call in (lambda: pss.pss_corr_mag(x, filt),
                 lambda: pss.pss_detect(x, filt),
                 lambda: pss.pss_corr_mag(x, filt, "f32"),
                 lambda: pss.pss_detect(x, filt, "f32"),
                 lambda: polyphase.resample_poly(x, 192, 125)):
        with pytest.raises(ValueError):
            call()
    ok = torch.zeros((2, 5000), dtype=torch.complex64, device=dev)
    with pytest.raises(ValueError):
        pss.pss_corr_mag(ok, filt, "fp8")
    with pytest.raises(ValueError):             # the kernel has 12 taps
        polyphase.resample_poly(ok, 192, 125, taps_per_phase=8)


def test_pss_kernels_take_strided_input_as_a_copy(dev):
    """A non-contiguous capture is made contiguous by the wrapper, in both
    arithmetics: same result as on its contiguous copy."""
    from lteax_torch.kernels import pss
    from lteax_torch.phy.config import PhyConfig
    from lteax_torch.phy.sync import pss_time_filters
    filt = pss_time_filters(PhyConfig(n_rb_dl=6))
    x = _noise((2, 6000), 5, dev)[:, ::2]
    assert not x.is_contiguous()
    for mdtype in ("bf16", "f32"):
        assert torch.equal(pss.pss_corr_mag(x, filt, mdtype),
                           pss.pss_corr_mag(x.contiguous(), filt, mdtype))


def test_scan_on_card_matches_cpu(dev):
    from lteax_torch.phy.config import PhyConfig
    from lteax_torch.apps.file_scan import scan
    from lteax_torch.sim.cell_gen import Cell, capture
    cap = capture(Cell(n_rb_dl=6, n_cell_id=333, n_ant=2), 0.03, sfn0=9,
                  offset=100, cfo_hz=700.0, snr_db=10.0, seed=2,
                  device=dev)
    cfg = PhyConfig(n_rb_dl=6)
    g = scan(torch.from_numpy(cap.iq).to(dev), cfg, max_si_subframes=0)
    c = scan(torch.from_numpy(cap.iq), cfg, max_si_subframes=0)
    for f in ("n_cell_id", "frame_start", "n_ant", "sfn", "mib"):
        assert getattr(g, f) == getattr(c, f), f
    assert (g.n_cell_id, g.n_ant, g.sfn) == (333, 2, 10)
    assert abs(g.cfo_hz - c.cfo_hz) < 1.0
    assert abs(g.rsrp_dbfs - c.rsrp_dbfs) < 0.1
    assert abs(g.snr_db - c.snr_db) < 0.1


def test_si_scan_on_card_matches_cpu(dev):
    """The SI stage on the card: the same report as on the CPU, and the
    SIBs and paging the capture carries."""
    import dataclasses
    from lteax_torch.phy.config import PhyConfig
    from lteax_torch.apps.file_scan import scan
    from lteax_torch.sim.cell_gen import Cell, capture
    cell = Cell(n_rb_dl=6, n_cell_id=333, n_ant=2, si_dci="1c",
                paging_tmsi=(0x42,))
    cap = capture(cell, 0.04, sfn0=9, offset=100, cfo_hz=700.0, snr_db=15.0,
                  seed=2, device=dev)
    cfg = PhyConfig(n_rb_dl=6)
    g = scan(torch.from_numpy(cap.iq).to(dev), cfg)
    c = scan(torch.from_numpy(cap.iq), cfg)
    for f in ("n_cell_id", "frame_start", "n_ant", "sfn", "mib", "sib1",
              "sib2", "sibs", "paging", "sib_crc_fails"):
        assert getattr(g, f) == getattr(c, f), f
    assert dataclasses.asdict(g.sib1) == dataclasses.asdict(cell.sib1())
    assert g.sib2 == cell.sib2() and g.paging == ["0x42"]


def test_pdsch_decode_on_card_matches_cpu(dev):
    """The single-subframe decode of a wrapping TB (K1/K2 at win 32)."""
    from lteax_torch.phy.channels import pdsch
    geom = pdsch.pdsch_geometry(408, 792, 2, 0)
    llr = torch.as_tensor(np.random.default_rng(5).standard_normal(
        (3, geom.g)).astype(np.float32) * 3)
    before = tm.LAUNCHES
    got = pdsch.pdsch_decode_device(llr.to(dev), geom, 0xFFFF, 5, 77)
    assert tm.LAUNCHES == before + 12          # 6 iterations, 2 halves each
    ref = pdsch.pdsch_decode_device(llr, geom, 0xFFFF, 5, 77)
    for a, b in zip(got, ref):
        assert torch.equal(a.cpu(), b)


def _ul_grids(alloc, b, snr_db, seed, uci=None, ack=(), ri=()):
    from lteax_torch.sim.ul_gen import UlCell, ul_subframes
    cell = UlCell(alloc=alloc)
    iq, tb = ul_subframes(cell, b, snr_db=snr_db, seed=seed, uci=uci,
                          ack=ack, ri=ri)
    return cell, torch.from_numpy(iq[..., 0] + 1j * iq[..., 1]), tb


def test_pusch_decode_on_card_matches_cpu(dev):
    """The single-subframe UL decode: the turbo kernel at win 32, 6
    iterations (12 launches a call), no demap kernel; bits and flags equal
    to the CPU's and to the bits sent."""
    from lteax_torch.phy.channels import pusch
    alloc = pusch.PuschAlloc(15, 0, 11064, 6)
    cell, g, tb = _ul_grids(alloc, 2, 25.0, 7)
    args = (alloc, cell.rnti, cell.subframe, cell.n_cell_id)
    before = (demap.LAUNCHES, tm.LAUNCHES)
    got = pusch.pusch_decode(g.to(dev), *args)
    assert (demap.LAUNCHES, tm.LAUNCHES) == (before[0], before[1] + 12)
    ref = pusch.pusch_decode(g, *args)
    for a, b in zip(got, ref):
        assert torch.equal(a.cpu(), b)
    assert ref[1].all() and np.array_equal(ref[0].numpy(), tb)


def test_pusch_decode_uci_on_card_matches_cpu(dev):
    from lteax_torch.phy.channels import pusch
    alloc = pusch.PuschAlloc(15, 0, 11064, 6)
    uci = pusch.PuschUci(n_ack=2, n_ri=1)
    cell, g, tb = _ul_grids(alloc, 1, 25.0, 8, uci, (1, 0), (1,))
    args = (alloc, cell.rnti, cell.subframe, cell.n_cell_id, uci)
    before = tm.LAUNCHES
    got = pusch.pusch_decode_uci(g[0].to(dev), *args)
    assert tm.LAUNCHES == before + 12
    ref = pusch.pusch_decode_uci(g[0], *args)
    for a, b in zip(got[:3], ref[:3]):
        assert torch.equal(a.cpu(), b)
    assert got[3:] == ref[3:] == ((1, 0), (1,))
    assert bool(ref[1]) and np.array_equal(ref[0].numpy(), tb[0])


# -- the ACS probe kernel, the demap at the UL shape, UL-SCH and HARQ -------

@pytest.mark.parametrize("rounds", [0, 8, 64, 512])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_acs_probe_kernel_matches_plain(dev, dtype, rounds):
    """Bit for bit, infinities included (512 rounds saturate the positive
    lanes); an odd f32 length exercises the tail block."""
    from lteax_torch.kernels import acs_probe
    n = 256 * 128 + (0 if dtype == torch.bfloat16 else 77)
    x = torch.as_tensor(np.random.default_rng(rounds).standard_normal(n),
                        dtype=torch.float32).to(dtype).to(dev)
    before = acs_probe.LAUNCHES
    got = acs_probe.acs_chain(x, rounds)
    assert acs_probe.LAUNCHES == before + 1
    assert got.dtype == dtype and got.shape == x.shape
    assert torch.equal(got, acs_probe.acs_chain_plain(x, rounds))
    assert torch.equal(got.cpu(), acs_probe.acs_chain(x.cpu(), rounds))


def test_acs_probe_refuses_what_it_cannot_run(dev):
    from lteax_torch.kernels import acs_probe
    for bad in (torch.zeros(64, dtype=torch.float16, device=dev),
                torch.zeros(64, dtype=torch.float64, device=dev),
                torch.zeros(63, dtype=torch.bfloat16, device=dev),
                torch.zeros((8, 8), dtype=torch.float32, device=dev).T):
        with pytest.raises(ValueError):
            acs_probe.acs_chain(bad, 4)


@pytest.mark.parametrize("n_prb,scheme,m", [(100, "64qam", 6), (8, "qpsk", 2),
                                            (15, "16qam", 4)])
def test_demap_kernel_at_ul_shapes(dev, n_prb, scheme, m):
    """(B, 12 * m_sc) columns under (m, npad) sign planes: 14400 -> 14464
    at 100 PRB; 1152 has no pad column at 8 PRB.  Pad columns emit 0."""
    n = 144 * n_prb
    npad = -(-n // 128) * 128
    rng = np.random.default_rng(n_prb)
    t = lambda x: torch.as_tensor(x, dtype=torch.float32, device=dev)
    xr, xi = t(rng.standard_normal((3, n))), t(rng.standard_normal((3, n)))
    inv_nv = t(rng.uniform(1, 500, (3, n)))
    sgn = t(demap.planar_sgn_np(0x3D * 2 ** 14 + 4 * 512 + 214, n * m, m,
                                npad))
    got = demap.demap_planar(xr, xi, inv_nv, sgn, scheme)
    assert got.shape == (3, m, npad)
    assert torch.equal(got, demap.demap_planar_plain(xr, xi, inv_nv, sgn,
                                                     scheme))
    assert not got[..., n:].any() and got[..., :n].all()


def _card_vs_cpu(dec, dec_cpu, x, tb):
    """Bits, CRC flags and n_iter equal; fronts within 1e-4 of the largest
    LLR (cuFFT and pocketfft round differently)."""
    d_gpu, d_cpu = dec.front(x.to(dec.device)), dec_cpu.front(x)
    assert float((d_gpu.cpu() - d_cpu).abs().max()) <= \
        1e-4 * float(d_cpu.abs().max())
    out_gpu, out_cpu = dec.turbo(d_gpu), dec_cpu.turbo(d_cpu)
    assert torch.equal(out_gpu[0].cpu(), out_cpu[0])
    assert torch.equal(out_gpu[1].cpu(), out_cpu[1])
    assert out_gpu[2] == out_cpu[2]
    assert out_cpu[1].all() and np.array_equal(out_cpu[0].numpy(), tb)


def test_pusch_decoder_on_card_matches_cpu(dev):
    from lteax_torch.phy.channels.pusch import PuschAlloc
    from lteax_torch.pipeline import make_pusch_batch_decoder
    from lteax_torch.sim.ul_gen import UlCell, ul_subframes
    cell = UlCell(alloc=PuschAlloc(15, 0, 11064, 6))
    iq, tb = ul_subframes(cell, 2, snr_db=21.5, seed=6)
    before = (demap.LAUNCHES, tm.LAUNCHES)
    dec = make_pusch_batch_decoder(*cell.decoder_args())
    assert dec.device.type == "cuda"
    _card_vs_cpu(dec, make_pusch_batch_decoder(*cell.decoder_args(),
                                               device="cpu"),
                 torch.from_numpy(iq), tb)
    assert demap.LAUNCHES == before[0] + 1 and tm.LAUNCHES > before[1]


def test_harq_decoder_on_card_matches_cpu(dev):
    from lteax_torch.pipeline import make_batch_harq_decoder
    from lteax_torch.sim.dl_gen import harq_decoder_args, harq_transmissions
    cell = DlCell(n_rb_dl=6, n_cell_id=150, mcs=9, cfi=2)
    iq, tb, cells = harq_transmissions(cell, (1, 2), (0, 2), 4, 3.0, seed=3)
    before = demap.LAUNCHES
    dec = make_batch_harq_decoder(*harq_decoder_args(cells))
    _card_vs_cpu(dec, make_batch_harq_decoder(*harq_decoder_args(cells),
                                              device="cpu"),
                 torch.from_numpy(iq), tb)
    assert demap.LAUNCHES == before + 2          # one per transmission
    ok0 = make_batch_decoder(*cells[0].decoder_args())(
        torch.from_numpy(iq[0]).to(dev))[1]
    assert not ok0.any()                         # rv 0 alone decodes none


@pytest.mark.parametrize("detector", ["mmse", "sic"])
def test_mimo_decoder_on_card_matches_cpu(dev, detector):
    """TM3 at 25 PRB, MCS 28 (C=3), 4 subframes at 25 dB: as
    ``_card_vs_cpu``; the SIC front's two LLR sets each within 1e-4 of
    their largest."""
    from lteax_torch.phy.tuning import DecoderTuning
    from lteax_torch.pipeline import make_mimo_batch_decoder
    from lteax_torch.sim.mimo_gen import MimoCell, decoder_rows, mimo_subframes
    cell = MimoCell(n_rb_dl=25, mcs=28)
    iq, tb = mimo_subframes(cell, 4, snr_db=25.0, seed=7)
    t = DecoderTuning(mimo_detector=detector, retry_m_mimo=4)
    before = (demap.LAUNCHES, tm.LAUNCHES)
    dec = make_mimo_batch_decoder(*cell.decoder_args(), tuning=t)
    dec_cpu = make_mimo_batch_decoder(*cell.decoder_args(), tuning=t,
                                      device="cpu")
    x = torch.from_numpy(iq)
    if detector == "mmse":
        _card_vs_cpu(dec, dec_cpu, x, decoder_rows(tb))
    else:
        f_gpu, f_cpu = dec.front(x.to(dev)), dec_cpu.front(x)
        for a, b in ((f_gpu.d0, f_cpu.d0), (f_gpu.llr1, f_cpu.llr1)):
            assert float((a.cpu() - b).abs().max()) <= \
                1e-4 * float(b.abs().max())
        out_gpu, out_cpu = dec.turbo(f_gpu), dec_cpu.turbo(f_cpu)
        assert torch.equal(out_gpu[0].cpu(), out_cpu[0])
        assert torch.equal(out_gpu[1].cpu(), out_cpu[1])
        assert out_gpu[2] == out_cpu[2]
        assert out_cpu[1].all() and np.array_equal(out_cpu[0].numpy(),
                                                   decoder_rows(tb))
    assert demap.LAUNCHES == before[0] + (2 if detector == "mmse" else 3)
    assert tm.LAUNCHES > before[1]


def test_reencode_on_card_is_exact(dev):
    """The f32 0/1 matmul with TF32 off at K = 6144: equal to the numpy
    encoder."""
    from lteax_torch.phy.fec.reencode import turbo_reencode_batch
    from lteax_torch.phy.fec.turbo import turbo_encode
    bits = np.random.default_rng(1).integers(0, 2, (64, 6144)).astype(np.int8)
    got = turbo_reencode_batch(torch.from_numpy(bits).to(dev), 6144)
    np.testing.assert_array_equal(got.cpu().numpy(), turbo_encode(bits, 6144))
