"""PRACH: random access preambles, generation and detection (36.211 §5.7);
counterpart of ``lteax.phy.channels.prach``.

Preamble formats 0-3 (FDD): length-839 Zadoff-Chu at 1.25 kHz subcarrier
spacing.  The plans (``physical_root``, ``d_u``, ``cyclic_shifts``,
``preamble_set``, ``zc_root_seq``, ``preamble_freq_cv``) and the UE's
transmit side (``generate_prach[_cv]``) are numpy copies of the
reference's.  The eNB's detector runs in torch on the samples' device (the
card unless the caller asks for the CPU): the ``n_fft``-point FFT of the
window, the 839 PRACH bins times the conjugate root spectrum, the 839-point
IFFT, then one gather of every shift's delay window with a row-wise max
and first argmax in place of the reference's loop over shifts, and one
host read.  ``tests/test_torch_prach.py`` holds both sides to the
reference.
"""

from __future__ import annotations

import math
from functools import lru_cache

import numpy as np
import torch

from lteax_torch.host import read
from lteax_torch.phy.tables.prach_roots import LOGICAL_ROOT_ORDER
from lteax_torch.pipeline import _resolve_device

N_ZC = 839
DELTA_F_RA = 1250.0   # Hz

# format: (T_cp in Ts units of 1/30.72e6, T_seq)
PRACH_FORMATS = {
    0: (3168, 24576),
    1: (21024, 24576),
    2: (6240, 2 * 24576),
    3: (21024, 2 * 24576),
}

# Table 5.7.2-2: zeroCorrelationZoneConfig -> N_cs
NCS_UNRESTRICTED = (0, 13, 15, 18, 22, 26, 32, 38, 46, 59, 76, 93, 119, 167,
                    279, 419)
NCS_RESTRICTED = (15, 18, 22, 26, 32, 38, 46, 55, 68, 82, 100, 128, 158,
                  202, 237)


def physical_root(logical_idx: int) -> int:
    """36.211 Table 5.7.2-4 lookup (formats 0-3)."""
    return LOGICAL_ROOT_ORDER[logical_idx]


def d_u(u: int) -> int:
    """Doppler-induced cyclic-shift distance: folded modular inverse of u."""
    p = pow(u, -1, N_ZC)
    return p if p < N_ZC - p else N_ZC - p


def cyclic_shifts(u: int, n_cs: int, restricted: bool) -> list[int]:
    """All usable cyclic-shift offsets C_v for root ``u`` (36.211 §5.7.2).

    Unrestricted: C_v = v*N_cs, v = 0..floor(N_zc/N_cs)-1 (all of N_zc when
    N_cs = 0).  Restricted (high-speed): the masked shift set around d_u —
    returns [] when the root supports no restricted shifts at this N_cs."""
    if not restricted:
        if n_cs == 0:
            return [0]
        return [v * n_cs for v in range(N_ZC // n_cs)]
    d = d_u(u)
    if n_cs <= d < N_ZC / 3:
        n_shift = d // n_cs
        d_start = 2 * d + n_shift * n_cs
        n_group = N_ZC // d_start
        n_bar = max((N_ZC - 2 * d - n_group * d_start) // n_cs, 0)
    elif N_ZC / 3 <= d <= (N_ZC - n_cs) / 2:
        n_shift = (N_ZC - 2 * d) // n_cs
        d_start = N_ZC - 2 * d + n_shift * n_cs
        n_group = d // d_start
        n_bar = min(max((4 * d - N_ZC - n_group * d_start) // n_cs, 0),
                    n_shift)
    else:
        return []
    out = []
    for v in range(n_shift * n_group + n_bar):
        out.append(d_start * (v // n_shift) + (v % n_shift) * n_cs)
    return out


def preamble_set(root_seq_index: int, zczc: int, high_speed: bool = False,
                 n_preambles: int = 64) -> list[tuple[int, int]]:
    """The cell's preamble set: ``n_preambles`` (u, C_v) pairs.

    36.211 §5.7.2: enumerate all cyclic shifts of the logical root
    ``root_seq_index``, then of consecutive logical roots (mod 838), until
    64 preambles exist.  ``zczc`` = zeroCorrelationZoneConfig (SIB2),
    ``high_speed`` = prach_high_speed_flag selecting the restricted table."""
    n_cs = (NCS_RESTRICTED if high_speed else NCS_UNRESTRICTED)[zczc]
    out: list[tuple[int, int]] = []
    logical = root_seq_index
    while len(out) < n_preambles:
        u = physical_root(logical % len(LOGICAL_ROOT_ORDER))
        for cv in cyclic_shifts(u, n_cs, high_speed):
            out.append((u, cv))
            if len(out) == n_preambles:
                break
        logical += 1
        if logical - root_seq_index > len(LOGICAL_ROOT_ORDER):
            raise ValueError("config yields no usable preambles")
    return out


@lru_cache(maxsize=None)
def zc_root_seq(u: int) -> np.ndarray:
    n = np.arange(N_ZC)
    return np.exp(-1j * np.pi * u * n * (n + 1) / N_ZC).astype(np.complex64)


def preamble_freq_cv(u: int, cv: int) -> np.ndarray:
    """Frequency-domain (839,) preamble for an explicit cyclic shift C_v."""
    x = np.roll(zc_root_seq(u), -cv)
    return np.fft.fft(x).astype(np.complex64) / np.sqrt(N_ZC)


def preamble_freq(u: int, v: int, n_cs: int) -> np.ndarray:
    """Frequency-domain (839,) preamble for unrestricted shift index v."""
    return preamble_freq_cv(u, v * n_cs)


def generate_prach(u: int, v: int, n_cs: int, fmt: int = 0,
                   fs: float = 30.72e6) -> np.ndarray:
    """Baseband PRACH burst (CP + sequence) of unrestricted shift index v:
    the pure preamble waveform around DC (the caller applies the in-grid
    frequency placement)."""
    return generate_prach_cv(u, v * n_cs, fmt, fs)


def generate_prach_cv(u: int, cv: int, fmt: int = 0,
                      fs: float = 30.72e6) -> np.ndarray:
    """Baseband PRACH burst for an explicit cyclic shift C_v (covers the
    restricted-set shifts from ``cyclic_shifts``/``preamble_set``)."""
    t_cp, t_seq = PRACH_FORMATS[fmt]
    scale = fs / 30.72e6
    n_cp, n_seq = int(t_cp * scale), int(t_seq * scale)
    n_fft = int(24576 * scale)
    xf = preamble_freq_cv(u, cv)
    grid = np.zeros(n_fft, dtype=np.complex64)
    # 839 bins at 1.25 kHz; center the sequence around DC
    k = np.arange(N_ZC) - N_ZC // 2
    grid[k % n_fft] = xf
    one_seq = np.fft.ifft(grid) * np.sqrt(n_fft)
    reps = n_seq // n_fft
    seq = np.tile(one_seq, max(reps, 1))[:n_seq]
    return np.concatenate([seq[-n_cp:], seq]).astype(np.complex64)


# -- detection (torch, on the samples' device) --------------------------------

@lru_cache(maxsize=64)
def _detect_plan(u: int, n_fft: int, device: torch.device):
    """The window's 839 PRACH bins (839,) int64 and the conjugate root
    spectrum conj(FFT(x_u)) / sqrt(839) (839,) complex64, on ``device``."""
    k = (np.arange(N_ZC) - N_ZC // 2) % n_fft
    ref = np.conj(np.fft.fft(zc_root_seq(u)) / np.sqrt(N_ZC))
    return (torch.as_tensor(k.astype(np.int64), device=device),
            torch.as_tensor(ref.astype(np.complex64), device=device))


@lru_cache(maxsize=64)
def _zone_idx(shifts: tuple[int, ...], zone: int,
              device: torch.device) -> torch.Tensor:
    """(n_shifts, zone) int64: the correlator indices (N_ZC - C_v + tau)
    mod N_ZC, tau = 0..zone-1, of each shift's delay window."""
    z = (N_ZC - np.asarray(shifts, np.int64)) % N_ZC
    return torch.as_tensor((z[:, None] + np.arange(zone)[None, :]) % N_ZC,
                           device=device)


def detect_prach(rx, u: int, n_cs: int, fmt: int = 0,
                 fs: float = 30.72e6, threshold: float = 8.0, device=None):
    """Detect preambles in a received burst window.

    rx: samples covering (at least) the sequence part, CP already skipped.
    Returns list of (v, delay_samples, metric) for peaks above
    ``threshold`` x mean power, one strongest per cyclic-shift zone.
    """
    n_shifts = N_ZC // n_cs if n_cs > 0 else 1
    shifts = [v * n_cs for v in range(n_shifts)]
    return detect_prach_cv(rx, u, shifts, n_cs, fmt, fs, threshold, device)


def detect_prach_cv(rx, u: int, shifts: list[int], zone: int, fmt: int = 0,
                    fs: float = 30.72e6, threshold: float = 8.0,
                    device=None):
    """Detector over an explicit shift set (e.g. a restricted set from
    ``cyclic_shifts``).  Returns (shift_index, delay_samples, metric) per
    detected preamble; ``zone`` is the delay search width (ZC samples,
    normally N_cs).

    ``rx`` is a torch tensor (detected on its device) or an array, which
    goes to ``device`` (default: the current CUDA device; without one this
    raises unless ``device="cpu"``).  A preamble at shift C_v with delay
    tau (ZC units, 0 <= tau < zone) peaks at correlator index
    (N_ZC - C_v + tau) mod N_ZC.  ``fmt`` is unused, as in the
    reference: the window is the first ``n_fft`` samples."""
    if not torch.is_tensor(rx):
        rx = torch.as_tensor(np.asarray(rx), device=_resolve_device(device))
    dev = rx.device
    n_fft = int(24576 * (fs / 30.72e6))
    bins, ref = _detect_plan(u, n_fft, dev)
    win = torch.fft.fft(rx[:n_fft].to(torch.complex64), n_fft) \
        / math.sqrt(n_fft)
    corr = torch.fft.ifft(win[bins] * ref) * math.sqrt(N_ZC)
    power = corr.real ** 2 + corr.imag ** 2
    zpow = power[_zone_idx(tuple(shifts), max(zone, 1), dev)]
    peak, tau = torch.max(zpow, dim=1)
    metric = peak / torch.mean(power)
    ms, taus = read(torch.stack([metric.to(torch.float64),
                                 tau.to(torch.float64)]))
    samples_per_zc = n_fft / N_ZC     # delay granularity in output samples
    return [(i, int(round(int(t) * samples_per_zc)), m)
            for i, (m, t) in enumerate(zip(ms, taus)) if m > threshold]
