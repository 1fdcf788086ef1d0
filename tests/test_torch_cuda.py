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


@pytest.mark.parametrize("k,win,acq", [(40, 32, 8), (5824, 128, 16)])
def test_turbo_kernel_matches_plain(dev, k, win, acq):
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


def test_kernels_refuse_wrong_dtype(dev):
    x = torch.zeros((2, 100), dtype=torch.float64, device=dev)
    sgn = torch.zeros((2, 128), dtype=torch.float32, device=dev)
    with pytest.raises(ValueError):
        demap.demap_planar(x, x, x, sgn, "qpsk")


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
    got = pss.pss_corr_mag(x, filt)
    parts = pss.pss_detect(x, filt)
    assert (pss.CORR_LAUNCHES, pss.DETECT_LAUNCHES) == \
        (before[0] + 1, before[1] + 1)
    assert torch.equal(got, pss.pss_corr_mag_plain(x, filt))
    for g, r in zip(parts[:3], pss.pss_detect_plain(x, filt)):
        assert torch.equal(g, r)
    nid2, idx, _, _ = pss.pss_reduce_combine(*parts)
    assert int(nid2[0]) == 2 and abs(int(idx[0]) - 1234) <= 2


@pytest.mark.parametrize("p,q", [(192, 125), (125, 192), (4, 5), (2, 1)])
def test_resample_kernel_matches_plain(dev, p, q):
    from lteax_torch.kernels import polyphase
    x = _noise((3, 30011), p + q, dev)
    before = polyphase.LAUNCHES
    got = polyphase.resample_poly(x, p, q)
    assert polyphase.LAUNCHES == before + 1
    assert torch.equal(got, polyphase.resample_poly_plain(x, p, q))


def test_scanner_kernels_refuse_wrong_dtype(dev):
    from lteax_torch.kernels import polyphase, pss
    x = torch.zeros((2, 5000), dtype=torch.complex128, device=dev)
    filt = np.zeros((3, 128), np.complex64)
    for call in (lambda: pss.pss_corr_mag(x, filt),
                 lambda: pss.pss_detect(x, filt),
                 lambda: polyphase.resample_poly(x, 192, 125)):
        with pytest.raises(ValueError):
            call()


def test_scan_on_card_matches_cpu(dev):
    from lteax_torch.phy.config import PhyConfig
    from lteax_torch.apps.file_scan import scan
    from lteax_torch.sim.cell_gen import Cell, capture
    cap = capture(Cell(n_rb_dl=6, n_cell_id=333, n_ant=2), 0.03, sfn0=9,
                  offset=100, cfo_hz=700.0, snr_db=10.0, seed=2)
    cfg = PhyConfig(n_rb_dl=6)
    g = scan(torch.from_numpy(cap.iq).to(dev), cfg, max_si_subframes=0)
    c = scan(torch.from_numpy(cap.iq), cfg, max_si_subframes=0)
    for f in ("n_cell_id", "frame_start", "n_ant", "sfn", "mib"):
        assert getattr(g, f) == getattr(c, f), f
    assert (g.n_cell_id, g.n_ant, g.sfn) == (333, 2, 10)
    assert abs(g.cfo_hz - c.cfo_hz) < 1.0
    assert abs(g.rsrp_dbfs - c.rsrp_dbfs) < 0.1
    assert abs(g.snr_db - c.snr_db) < 0.1


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
