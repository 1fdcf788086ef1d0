"""The port's PRACH (``lteax_torch.phy.channels.prach``) against the
reference's (``lteax.phy.channels.prach``), on the CPU.

The plans and the UE's transmit side are numpy copies: the root table,
``cyclic_shifts`` and ``preamble_set`` must be equal for every
zeroCorrelationZoneConfig, with and without the high-speed flag, and each
burst of ``generate_prach_cv`` within 1e-5 of its peak.  The detector runs
in torch (complex64 FFTs) where the reference runs numpy: the same
(index, delay) list, metrics within 1e-4 relative.  A row whose metric lies
within 1e-4 of the threshold may be on one list only (the two arithmetics
round differently there); every other row must be on both.
"""

import numpy as np
import pytest
import torch

from lteax.phy.channels import prach as prach_ref
from lteax.phy.tables import prach_roots as roots_ref

from lteax_torch.phy.channels import prach
from lteax_torch.phy.tables import prach_roots

REL = 1e-4
ROOTS = (129, 710, 1, 838, 22, 419, 420, 300)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def same_detections(got, want, threshold=8.0):
    """Equal (index, delay) rows and metrics within ``REL``; a row on one
    list only must lie within ``REL`` of the threshold."""
    g = {i: (d, m) for i, d, m in got}
    w = {i: (d, m) for i, d, m in want}
    for i in set(g) ^ set(w):
        m = (g.get(i) or w.get(i))[1]
        assert abs(m / threshold - 1) < REL, (i, g.get(i), w.get(i))
    for i in set(g) & set(w):
        assert g[i][0] == w[i][0], (i, g[i], w[i])
        assert abs(g[i][1] - w[i][1]) <= REL * abs(w[i][1]), (i, g[i], w[i])
    return len(set(g) & set(w))


def burst(rng, parts, fmt=0, fs=30.72e6, snr_db=10.0):
    """Sum of ``(u, cv, delay)`` bursts, delayed, plus AWGN at ``snr_db``
    per sample; CP skipped -> complex64."""
    n_cp = int(prach.PRACH_FORMATS[fmt][0] * fs / 30.72e6)
    out = None
    for u, cv, delay in parts:
        b = prach_ref.generate_prach_cv(u, cv, fmt, fs)
        b = np.concatenate([np.zeros(delay, np.complex64), b])[:len(b)]
        out = b if out is None else out + b
    sig = np.sqrt(10 ** (-snr_db / 10) / 2)
    out = out + sig * (rng.standard_normal(len(out))
                       + 1j * rng.standard_normal(len(out)))
    return out[n_cp:].astype(np.complex64)


def test_root_table_equal():
    assert prach_roots.LOGICAL_ROOT_ORDER == roots_ref.LOGICAL_ROOT_ORDER
    assert len(prach_roots.LOGICAL_ROOT_ORDER) == 838


@pytest.mark.parametrize("high_speed", [False, True])
def test_shift_sets_equal(high_speed):
    """Every zeroCorrelationZoneConfig, several roots; the preamble sets
    (which walk the logical roots) from several starting indices."""
    table = prach.NCS_RESTRICTED if high_speed else prach.NCS_UNRESTRICTED
    assert table == (prach_ref.NCS_RESTRICTED if high_speed
                     else prach_ref.NCS_UNRESTRICTED)
    for zczc, n_cs in enumerate(table):
        for u in ROOTS:
            assert prach.cyclic_shifts(u, n_cs, high_speed) == \
                prach_ref.cyclic_shifts(u, n_cs, high_speed)
            assert prach.d_u(u) == prach_ref.d_u(u)
        for root_idx in (0, 22, 400, 837):
            try:
                want = prach_ref.preamble_set(root_idx, zczc, high_speed)
            except ValueError:
                with pytest.raises(ValueError):
                    prach.preamble_set(root_idx, zczc, high_speed)
                continue
            assert prach.preamble_set(root_idx, zczc, high_speed) == want


@pytest.mark.parametrize("fs", [30.72e6, 1.92e6])
@pytest.mark.parametrize("fmt", [0, 1, 2, 3])
def test_generate_equal(fmt, fs):
    """Formats 0-3 at 30.72 and 1.92 Msps, within 1e-5 of the peak."""
    for u, cv in ((129, 0), (710, 119), (22, 357)):
        got = prach.generate_prach_cv(u, cv, fmt, fs)
        want = prach_ref.generate_prach_cv(u, cv, fmt, fs)
        assert got.dtype == np.complex64 and got.shape == want.shape
        peak = np.max(np.abs(want))
        assert np.max(np.abs(got - want)) <= 1e-5 * peak
    assert np.array_equal(prach.generate_prach(129, 3, 119),
                          prach_ref.generate_prach(129, 3, 119))


@pytest.mark.parametrize("snr_db", [10.0, 0.0])
def test_detect_unrestricted_with_delays(snr_db):
    """Each of the root's 7 shifts (N_cs 119) alone, with a random delay
    inside its zone: the reference's list, and the sent preamble found."""
    rng = np.random.default_rng(11)
    u, n_cs = 129, 119
    for v in range(839 // n_cs):
        delay = int(rng.integers(0, n_cs * 24576 // 839))
        rx = burst(rng, [(u, v * n_cs, delay)], snr_db=snr_db)
        got = prach.detect_prach(rx, u, n_cs, device="cpu")
        want = prach_ref.detect_prach(rx, u, n_cs)
        same_detections(got, want)
        best = max(got, key=lambda t: t[2])
        assert best[0] == v
        assert abs(best[1] - delay) <= 24576 / 839, (best, delay)


def test_detect_two_preambles_of_one_root():
    """Two UEs on one root, other shifts and delays: both found, both
    lists equal; a torch tensor input is detected on its device."""
    rng = np.random.default_rng(5)
    u, n_cs = 710, 59
    rx = burst(rng, [(u, 2 * n_cs, 300), (u, 9 * n_cs, 1100)], snr_db=5.0)
    got = prach.detect_prach(torch.from_numpy(rx), u, n_cs)
    want = prach_ref.detect_prach(rx, u, n_cs)
    assert same_detections(got, want) >= 2
    found = {i for i, _, m in got if m > 50}
    assert {2, 9} <= found


def test_detect_restricted_set():
    """A high-speed cell: the restricted shift set of a root, a preamble
    at one of its shifts, the detector over the explicit set."""
    rng = np.random.default_rng(3)
    n_cs = prach.NCS_RESTRICTED[5]
    u = next(u for u in ROOTS if len(prach.cyclic_shifts(u, n_cs, True)) > 4)
    shifts = prach.cyclic_shifts(u, n_cs, True)
    for i in (0, len(shifts) // 2, len(shifts) - 1):
        rx = burst(rng, [(u, shifts[i], 200)], snr_db=3.0)
        got = prach.detect_prach_cv(rx, u, shifts, n_cs, device="cpu")
        want = prach_ref.detect_prach_cv(rx, u, shifts, n_cs)
        same_detections(got, want)
        assert max(got, key=lambda t: t[2])[0] == i


def test_detect_at_1p92_msps():
    """The 1536-point window of a 1.4 MHz cell."""
    rng = np.random.default_rng(8)
    fs = 1.92e6
    rx = burst(rng, [(22, 4 * 38, 20)], fs=fs, snr_db=6.0)
    got = prach.detect_prach(rx, 22, 38, fs=fs, device="cpu")
    same_detections(got, prach_ref.detect_prach(rx, 22, 38, fs=fs))
    assert max(got, key=lambda t: t[2])[0] == 4


def test_noise_alone_detects_nothing():
    """Noise alone at threshold 16: |corr|^2 / mean is exponential, so the
    default 8 lets e^-8 of the ~839 zone bins through (0.28 false alarms a
    window, in both packages); 16 lets 9e-5 a window through."""
    rng = np.random.default_rng(0)
    for u, n_cs in ((129, 119), (838, 13), (22, 0)):
        for _ in range(4):
            rx = ((rng.standard_normal(24576)
                   + 1j * rng.standard_normal(24576)) / np.sqrt(2)
                  ).astype(np.complex64)
            assert prach.detect_prach(rx, u, n_cs, threshold=16.0,
                                      device="cpu") == []
            assert prach_ref.detect_prach(rx, u, n_cs, threshold=16.0) == []


def test_detect_needs_a_card_unless_asked_for_the_cpu():
    """An array goes to the current CUDA device: without one the detector
    raises unless the caller passes ``device="cpu"``."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    rx = prach.generate_prach(129, 0, 119)[3168:]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        prach.detect_prach(rx, 129, 119)
    assert prach.detect_prach(rx, 129, 119, device="cpu")[0][:2] == (0, 0)
