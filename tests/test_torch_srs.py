"""The port's SRS (``lteax_torch.phy.channels.srs``) against the
reference's (``lteax.phy.channels.srs``), on the CPU at 25 PRB.

The sequence, the comb and ``srs_add`` are numpy copies and must be equal
(the sequence within 1e-6: the reference's base sequence is its own
copy).  The detector and the channel estimate run in torch where the
reference runs jax: powers and estimates within 1e-5 of their largest
value, peak delays equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lteax.phy.channels import srs as srs_ref

from lteax_torch.phy.channels import srs

N_RB = 25
TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("m_srs", [8, 16, 24])
def test_sequence_and_comb(m_srs):
    for u in (0, 13, 29):
        for n_cs in (0, 3, 7):
            got = srs.srs_sequence(u, m_srs, n_cs)
            want = srs_ref.srs_sequence(u, m_srs, n_cs)
            assert got.dtype == np.complex64
            assert np.max(np.abs(got - want)) <= 1e-6
    for k_tc in (0, 1):
        for off in (0, N_RB - m_srs):
            assert np.array_equal(srs.srs_subcarriers(N_RB, m_srs, k_tc, off),
                                  srs_ref.srs_subcarriers(N_RB, m_srs, k_tc,
                                                          off))
    with pytest.raises(ValueError):
        srs.srs_subcarriers(N_RB, m_srs, 0, N_RB - m_srs + 1)


def sounded_grid(rng, ues, m_srs, k_tc=0, off=0, snr_db=15.0):
    """UEs ``(u, n_cs, amp, delay)`` on one comb, each through a pure
    delay of ``delay`` samples (of 2048), plus AWGN."""
    grid = np.zeros((14, N_RB * 12), np.complex64)
    for u, n_cs, amp, delay in ues:
        one = srs.srs_add(np.zeros_like(grid), N_RB, u, m_srs, n_cs, k_tc,
                          off, amp)
        assert np.array_equal(one, srs_ref.srs_add(
            np.zeros_like(grid), N_RB, u, m_srs, n_cs, k_tc, off, amp))
        k = np.arange(N_RB * 12)
        grid += (one * np.exp(-2j * np.pi * k * delay / 2048)).astype(
            np.complex64)
    sig = np.sqrt(10 ** (-snr_db / 10) / 2)
    return (grid + sig * (rng.standard_normal(grid.shape)
                          + 1j * rng.standard_normal(grid.shape))
            ).astype(np.complex64)


@pytest.mark.parametrize("k_tc,off", [(0, 0), (1, 1)])
def test_detect_and_estimate(k_tc, off):
    """Three UEs on shifts 0, 3 and 6 of one comb (24 PRB): per-shift
    powers and peak delays as the reference's, the strong shifts found;
    each UE's LS channel estimate as the reference's.  Shift n_cs lands in
    delay window (8 - n_cs) mod 8 (the IFFT of e^{+j alpha n}), in both
    packages."""
    rng = np.random.default_rng(k_tc)
    m_srs, u = 24, 17
    ues = [(u, 0, 1.0, 0), (u, 3, 0.7, 2), (u, 6, 1.2, 5)]
    grid = sounded_grid(rng, ues, m_srs, k_tc, off)
    p, peak = srs.srs_detect(torch.from_numpy(grid), N_RB, u, m_srs, k_tc,
                             off)
    p_ref, peak_ref = srs_ref.srs_detect(jnp.asarray(grid), N_RB, u, m_srs,
                                         k_tc, off)
    p_ref, peak_ref = np.asarray(p_ref), np.asarray(peak_ref)
    assert np.max(np.abs(p.numpy() - p_ref)) <= TOL * np.max(p_ref)
    assert np.array_equal(peak.numpy(), peak_ref)
    assert set(np.argsort(p.numpy())[-3:]) == {(8 - n) % 8 for _, n, _, _
                                               in ues}
    for _, n_cs, _, _ in ues:
        h = srs.srs_estimate_channel(torch.from_numpy(grid), N_RB, u, m_srs,
                                     n_cs, k_tc, off)
        h_ref = np.asarray(srs_ref.srs_estimate_channel(
            jnp.asarray(grid), N_RB, u, m_srs, n_cs, k_tc, off))
        assert h.dtype == torch.complex64 and h.shape == (m_srs * 6,)
        assert np.max(np.abs(h.numpy() - h_ref)) <= \
            TOL * np.max(np.abs(h_ref))


def test_noise_only_powers_flat():
    """Noise alone: each shift holds about 1/8 of the power, as the
    reference's."""
    rng = np.random.default_rng(9)
    grid = (rng.standard_normal((14, N_RB * 12))
            + 1j * rng.standard_normal((14, N_RB * 12))).astype(np.complex64)
    p, _ = srs.srs_detect(torch.from_numpy(grid), N_RB, 5, 16)
    p_ref, _ = srs_ref.srs_detect(jnp.asarray(grid), N_RB, 5, 16)
    assert np.max(np.abs(p.numpy() - np.asarray(p_ref))) <= TOL
    assert abs(float(p.sum()) - 1.0) < 1e-5 and float(p.max()) < 0.5
