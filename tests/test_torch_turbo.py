"""The port's turbo half-iteration and decoder driver against the Pallas
reference (interpret mode): the half-iteration exactly (L, a_next,
b_next), the driver with identical bits and iteration count, including a
batch where the compacted retry runs on failing blocks.  The reference's
decode runs jitted, once compiled per configuration (:func:`_ref_decode`):
eager, its compacted retry traces and compiles anew at every call."""

from functools import lru_cache, partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lteax.kernels.turbo_mlm import (_pin_boundaries, half_iteration_pallas,
                                     turbo_decode_batch_pallas)
from lteax.phy.fec.crc import attach_crc_np
from lteax.phy.fec.turbo import turbo_encode

import lteax_torch.kernels.turbo_mlm as tm

torch.set_num_threads(1)


@lru_cache(maxsize=None)
def _ref_decode(**kw):
    """``turbo_decode_batch_pallas`` with the keyword arguments ``kw``
    (interpret mode, the iteration count returned), jitted: decodes of one
    configuration and shape share one compile."""
    return jax.jit(partial(turbo_decode_batch_pallas, return_n_iter=True,
                           interpret=True, **kw))


@pytest.mark.parametrize("k,win,acq", [(40, 32, 8), (1024, 128, 16),
                                       (5824, 128, 16)])
def test_half_iteration_matches_pallas(k, win, acq):
    n = k + 3
    n_w = -(-n // win)
    c = 5
    rng = np.random.default_rng(k)
    u = (rng.standard_normal((c, n)) * 6.0).astype(np.float32)
    v = (rng.standard_normal((c, n)) * 6.0).astype(np.float32)
    a0 = (-np.abs(rng.standard_normal((c, n_w, 8))) * 3).astype(np.float32)
    b0 = (-np.abs(rng.standard_normal((c, n_w, 8))) * 3).astype(np.float32)
    a0, b0 = (np.array(x) for x in _pin_boundaries(jnp.asarray(a0),
                                                   jnp.asarray(b0)))
    ref = half_iteration_pallas(jnp.asarray(u), jnp.asarray(v),
                                jnp.asarray(a0), jnp.asarray(b0), win, acq, n,
                                fused=True, pinpad=True, mdtype="f32",
                                interpret=True)
    before = tm.LAUNCHES
    got = tm.half_iteration(*map(torch.from_numpy, (u, v, a0, b0)), win, acq)
    assert tm.LAUNCHES == before             # CPU tensors take the plain path
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))


def test_pin_boundaries_matches_reference():
    rng = np.random.default_rng(2)
    a = rng.standard_normal((3, 4, 8)).astype(np.float32)
    b = rng.standard_normal((3, 4, 8)).astype(np.float32)
    got = tm._pin_boundaries(torch.from_numpy(a), torch.from_numpy(b))
    ref = _pin_boundaries(jnp.asarray(a), jnp.asarray(b))
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))


def _llrs(k, c, sigmas, seed):
    """(c, 3, K+4) channel LLRs of CRC24B-carrying codeblocks; block i gets
    noise of standard deviation sigmas[i] on amplitude-2 LLRs."""
    rng = np.random.default_rng(seed)
    bits = np.stack([attach_crc_np(p, "24B") for p in
                     rng.integers(0, 2, (c, k - 24)).astype(np.int32)])
    d = np.stack([np.asarray(turbo_encode(jnp.asarray(b), k)) for b in bits])
    llr = (1 - 2 * d.astype(np.float32)) * 2.0
    llr += (rng.standard_normal(llr.shape)
            * np.asarray(sigmas, np.float32)[:, None, None]).astype(np.float32)
    return llr.astype(np.float32), bits


# noisy: two blocks fail iteration 1 and finish in the compacted retry;
# threshold: more than retry_m fail, so a second full iteration runs first
CASES = {"noisy": [1.9, 1.9, 0.3, 0.3, 0.3, 0.3],
         "threshold": [1.95, 1.95, 1.9, 1.9, 1.85, 0.3]}


@pytest.mark.mid
@pytest.mark.parametrize("case", list(CASES))
def test_driver_matches_pallas(case):
    k = 1024
    llr, bits = _llrs(k, 6, CASES[case], seed=11)
    ref_bits, ref_it = _ref_decode(
        k=k, n_iter=6, win=128, acq=16, early_crc="24B", mdtype="f32",
        fused=True, nofreeze=False, pinpad=True, retry_m=2,
        retry_levels=2)(jnp.asarray(llr))
    got, stats = tm.turbo_decode_batch(torch.from_numpy(llr), k, n_iter=6,
                                       win=128, acq=16, early_crc="24B",
                                       retry_m=2, retry_levels=2)
    assert got.dtype == torch.int8 and got.shape == (6, k)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref_bits))
    assert stats.n_iter == int(ref_it)
    assert stats.syncs >= 1
    np.testing.assert_array_equal(got.numpy()[2:], bits[2:])
    if case == "noisy":
        assert stats.retries == [(1, 2)]     # the retry ran on 2 blocks
        assert stats.n_iter > 1
    else:                                    # compaction only after level 2
        assert stats.n_iter >= 2
        assert all(kk >= 2 for kk, _ in stats.retries)


@pytest.mark.mid
def test_driver_without_retry_or_early_stop():
    """retry_m >= C takes the full-batch early-stop loop; early_crc=None
    runs the fixed schedule.  Both against the reference."""
    k = 512
    llr, _ = _llrs(k, 3, [1.9, 0.3, 0.3], seed=4)
    for crc, retry_m in (("24B", 8), (None, 0)):
        ref_bits, ref_it = _ref_decode(
            k=k, n_iter=3, win=128, acq=16, early_crc=crc, mdtype="f32",
            fused=True, nofreeze=False, pinpad=True, retry_m=retry_m,
            retry_levels=2, layout=False)(jnp.asarray(llr))
        got, stats = tm.turbo_decode_batch(torch.from_numpy(llr), k,
                                           n_iter=3, early_crc=crc,
                                           retry_m=retry_m)
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref_bits))
        assert stats.n_iter == int(ref_it)


def test_driver_leaves_no_reference_cycles():
    """A decode frees its tensors on return, without waiting for Python's
    cycle collector (a self-referencing closure held every decode's
    working set until a collection: ~12 GB at B=256 on the card)."""
    import gc
    llr, _ = _llrs(256, 6, CASES["noisy"], seed=3)
    gc.collect()
    gc.disable()
    try:
        tm.turbo_decode_batch(torch.from_numpy(llr), 256, n_iter=4,
                              early_crc="24B", retry_m=2, retry_levels=2)
        assert gc.collect() == 0
    finally:
        gc.enable()
