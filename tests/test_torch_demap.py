"""The port's plain demap equals the Pallas demap kernel (interpret mode)
exactly in f32, including the exact 0.0 where the descramble sign is 0.

One exception, from the reference's CPU compile and not from the port: for
QPSK each subset holds one level, so ``d1 - d0`` is ``(y-s1)^2 - (y-s0)^2``
and XLA:CPU contracts it into a fused multiply-add (skipping one rounding
of a square).  There the test bounds the difference by that one rounding.
The port keeps the written arithmetic, which its CUDA kernel (built with
-fmad=false) reproduces bit for bit on the card."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lteax.kernels.demap import demap_descr_planar_pallas

import lteax_torch.kernels.demap as demap


def _inputs(scheme, bsz=3, n=300, seed=0):
    m = {"qpsk": 2, "16qam": 4, "64qam": 6}[scheme]
    rng = np.random.default_rng(seed)
    xr = (rng.standard_normal((bsz, n)) * 0.8).astype(np.float32)
    xi = (rng.standard_normal((bsz, n)) * 0.8).astype(np.float32)
    inv_nv = rng.uniform(1.0, 500.0, (bsz, n)).astype(np.float32)
    npad = -(-n // 128) * 128 + 128          # >= 1 zeroed pad column
    sgn = rng.choice(np.float32([-1.0, 1.0]), (m, npad))
    sgn[:, rng.random(npad) < 0.25] = 0.0    # non-PDSCH columns
    sgn[:, n:] = 0.0
    return xr, xi, inv_nv, sgn


@pytest.mark.parametrize("scheme", ["qpsk", "16qam", "64qam"])
def test_plain_demap_matches_pallas(scheme):
    xr, xi, inv_nv, sgn = _inputs(scheme)
    ref = np.asarray(demap_descr_planar_pallas(
        jnp.asarray(xr), jnp.asarray(xi), jnp.asarray(inv_nv),
        jnp.asarray(sgn), scheme, out_dtype=jnp.float32, interpret=True))
    before = demap.LAUNCHES
    got = demap.demap_planar(*map(torch.from_numpy, (xr, xi, inv_nv, sgn)),
                             scheme).numpy()
    assert demap.LAUNCHES == before          # CPU tensors take the plain path
    assert got.shape == ref.shape == (3, len(sgn), sgn.shape[1])
    if scheme == "qpsk":
        n = xr.shape[1]
        # one rounding of a square (<= (|y| + 1)^2), carried through the
        # 1/nv scaling, plus one rounding of the scaled result
        sq = (np.abs(np.stack([xr, xi], 1)) + 1.0) ** 2
        bound = 2.0 ** -22 * np.abs(ref)
        bound[..., :n] += sq * inv_nv[:, None] * 2.0 ** -23
        assert np.all(np.abs(got - ref) <= bound)
        assert np.array_equal(got == 0, ref == 0)
    else:
        np.testing.assert_array_equal(got, ref)
    assert np.all(got[:, sgn == 0] == 0.0)


def test_demap_rejects_bad_sign_planes():
    xr, xi, inv_nv, sgn = _inputs("16qam")
    with pytest.raises(ValueError):
        demap.demap_planar(*map(torch.from_numpy, (xr, xi, inv_nv, sgn[:2])),
                           "16qam")
    with pytest.raises(ValueError):
        demap.demap_planar(*map(torch.from_numpy, (xr, xi, inv_nv, sgn)),
                           "bpsk")
