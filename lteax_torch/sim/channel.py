"""AWGN and 3GPP multipath fading channel simulators (36.101 Annex B.2).

(reference capability: none — the reference has no channel simulator; its
octave/ scripts are tested noiseless.  SURVEY.md §4 requires AWGN SNR sweeps
and EPA/EVA fading for the chan-est milestones, so this module exists for
the new framework's test strategy.)

The port's own copy of ``lteax/sim/channel.py``: the port
imports nothing of the JAX package, and ``tests/test_torch_plans.py``
holds the two equal.
"""

from __future__ import annotations

import numpy as np

# (delays_ns, powers_db) per 36.101 Table B.2.1-2/3/4
PROFILES = {
    "epa": ((0, 30, 70, 90, 110, 190, 410),
            (0.0, -1.0, -2.0, -3.0, -8.0, -17.2, -20.8)),
    "eva": ((0, 30, 150, 310, 370, 710, 1090, 1730, 2510),
            (0.0, -1.5, -1.4, -3.6, -0.6, -9.1, -7.0, -12.0, -16.9)),
    "etu": ((0, 50, 120, 200, 230, 500, 1600, 2300, 5000),
            (-1.0, -1.0, -1.0, 0.0, 0.0, 0.0, -3.0, -5.0, -7.0)),
}


def awgn(rng: np.random.Generator, x: np.ndarray, snr_db: float) -> np.ndarray:
    """Complex AWGN at the given SNR relative to the mean power of x."""
    p = np.mean(np.abs(x) ** 2)
    nv = p / 10 ** (snr_db / 10)
    n = (rng.standard_normal(x.shape) + 1j * rng.standard_normal(x.shape))
    return (x + np.sqrt(nv / 2) * n).astype(np.complex64)


def tap_impulse_response(rng: np.random.Generator, profile: str, fs: float,
                         normalize: bool = True) -> np.ndarray:
    """One Rayleigh-faded snapshot of the profile as a discrete FIR.

    Fractional tap delays are rounded to the nearest sample (adequate down to
    1.92 Msps where EPA collapses to ~2 taps)."""
    delays_ns, powers_db = PROFILES[profile]
    n_taps = int(np.ceil(delays_ns[-1] * 1e-9 * fs)) + 1
    h = np.zeros(n_taps, dtype=np.complex64)
    amp = 10 ** (np.asarray(powers_db) / 20)
    for d_ns, a in zip(delays_ns, amp):
        idx = int(round(d_ns * 1e-9 * fs))
        g = (rng.standard_normal() + 1j * rng.standard_normal()) / np.sqrt(2)
        h[idx] += a * g
    if normalize:
        h = h / np.linalg.norm(h)
    return h


def apply_multipath(x: np.ndarray, h: np.ndarray) -> np.ndarray:
    """Convolve (same length as x, causal)."""
    return np.convolve(x, h)[: len(x)].astype(np.complex64)


def fade_and_awgn(rng: np.random.Generator, x: np.ndarray, profile: str,
                  fs: float, snr_db: float) -> tuple[np.ndarray, np.ndarray]:
    """-> (received samples, channel impulse response used)."""
    h = tap_impulse_response(rng, profile, fs)
    y = apply_multipath(x, h)
    return awgn(rng, y, snr_db), h
