"""The resampler kernel's plain version against the reference resampler:
the XLA conv path (``resample_poly``) and the TPU kernel in interpret mode
(``resample_poly_pallas``), for the ratios of the reference's own test;
for the scanner's large-P ratios (768/625, 1536/625), where the XLA path
runs P convolutions, the reference's own dense frame weight
(``_frame_weight``) applied to numpy windows in float64.  atol 2e-5 on
unit-variance samples: they sum the 12 taps in different orders (the TPU
kernel as shifted matmuls over a zero-padded weight)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lteax.kernels.polyphase import _frame_weight as frame_weight_ref
from lteax.kernels.polyphase import resample_poly as resample_ref
from lteax.kernels.polyphase import resample_poly_pallas

from lteax_torch.kernels import polyphase

RATIOS = [(192, 125), (2, 3), (25, 24), (1, 10), (2, 1)]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs files in parallel processes; torch's own thread pool
    on top of them oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def stream():
    rng = np.random.default_rng(2)
    return (rng.standard_normal(50000)
            + 1j * rng.standard_normal(50000)).astype(np.complex64)


@pytest.mark.parametrize("p,q", RATIOS)
def test_plain_matches_reference(stream, p, q):
    before = polyphase.LAUNCHES
    got = polyphase.resample_poly(torch.from_numpy(stream), p, q).numpy()
    assert polyphase.LAUNCHES == before          # CPU: the plain version
    ref = np.asarray(resample_ref(jnp.asarray(stream), p, q))
    assert got.shape == ref.shape and got.dtype == np.complex64
    np.testing.assert_allclose(got, ref, atol=2e-5)
    tpu = np.asarray(resample_poly_pallas(jnp.asarray(stream), p, q,
                                          interpret=True))
    np.testing.assert_allclose(got, tpu, atol=2e-5)


@pytest.mark.parametrize("p,q", [(768, 625), (1536, 625)])
def test_plain_matches_reference_frame_weight(stream, p, q):
    """y[j*P + r] = x[j*Q : j*Q + K_in] @ W[:, r], W the reference's (K_in,
    P) frame weight; 12.5 and 25 Msps captures to 30.72 Msps."""
    w = frame_weight_ref(p, q, 12).astype(np.float64)
    nf = polyphase.n_frames_out(stream.size, p, q)
    win = np.lib.stride_tricks.sliding_window_view(
        stream.astype(np.complex128), w.shape[0])[::q][:nf]
    ref = (win @ w).reshape(-1)
    got = polyphase.resample_poly(torch.from_numpy(stream), p, q).numpy()
    assert got.shape == ref.shape == (nf * p,) and nf > 50
    np.testing.assert_allclose(got, ref, atol=2e-5)


def test_batch_equals_rows(stream):
    """(C, L) in one call equals C row-by-row calls, bit for bit; leading
    axes pass through."""
    x = torch.from_numpy(np.stack([stream[:20000], stream[5000:25000],
                                   stream[-20000:]]))
    batch = polyphase.resample_poly(x, 192, 125)
    for c in range(3):
        assert torch.equal(batch[c], polyphase.resample_poly(x[c], 192, 125))
    assert polyphase.resample_poly(x.reshape(3, 1, -1), 192, 125).shape == \
        (3, 1, batch.shape[-1])
    assert batch.shape[-1] == polyphase.n_frames_out(20000, 192, 125) * 192


def test_short_stream_is_empty():
    y = polyphase.resample_poly(torch.zeros(14, dtype=torch.complex64), 5, 4)
    assert y.shape == (0,)
