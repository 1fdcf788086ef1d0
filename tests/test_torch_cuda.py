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
    out_gpu = make_batch_decoder(*cell.decoder_args(), device="cuda")(
        torch.from_numpy(iq).cuda())
    out_cpu = make_batch_decoder(*cell.decoder_args())(torch.from_numpy(iq))
    assert torch.equal(out_gpu[0].cpu(), out_cpu[0])
    assert torch.equal(out_gpu[1].cpu(), out_cpu[1])
    assert out_gpu[2] == out_cpu[2]
    assert np.array_equal(out_cpu[0].numpy(), tb)
