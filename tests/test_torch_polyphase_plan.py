"""The resampler kernel's launch plan and tile walk, on the CPU.

``csrc/polyphase.cu`` runs what ``polyphase.launch_plan`` tells it: items
(frame slot, phase) a thread with their taps in registers, tiles of F
frames staged by 16-byte copies from an even sample, two buffers, a block
walking tiles with a stride of the grid.  These tests hold the plan to the
kernel's limits for every ratio the scanner can meet, and emulate the
kernel's walk in numpy (f32 multiplies and adds in the kernel's order) bit
for bit against ``resample_poly_plain``.  No JAX, no card."""

import re
from fractions import Fraction
from pathlib import Path

import numpy as np
import pytest
import torch

from lteax_torch.kernels import _build, polyphase as pp

LTE_RATES = (1.92e6, 3.84e6, 7.68e6, 15.36e6, 23.04e6, 30.72e6)
SDR_RATES = (2e6, 4e6, 5e6, 8e6, 10e6, 12.5e6, 20e6, 25e6, 40e6, 50e6, 56e6)
TEST_RATIOS = {(192, 125), (125, 192), (2, 3), (25, 24), (1, 10), (2, 1),
               (4, 5), (5, 4), (3, 2), (768, 625), (1536, 625), (12, 125)}
SCANNER_RATIOS = sorted({
    (f.numerator, f.denominator) for f in
    (Fraction(int(round(fs)), int(round(r))).limit_denominator(1024)
     for fs in LTE_RATES for r in SDR_RATES)} | TEST_RATIOS)
N_SM = 132


def emulate(x: np.ndarray, p: int, q: int, plan: pp.LaunchPlan):
    """The kernel's walk in numpy: (y (C, n_frames*P) complex64, writes per
    output).  Staging buffers start as NaN, so that a read of a sample the
    walk did not stage shows in the result."""
    c, l = x.shape
    nf, kin = pp.n_frames_out(l, p, q), pp.k_in(p, q)
    flat = x.reshape(-1)
    bank = pp.design_polyphase(p, q, pp.TAPS)
    y = np.full(c * nf * p, np.nan, np.complex64)
    writes = np.zeros(c * nf * p, np.int64)
    n_tiles = c * plan.tiles

    def tile(u):
        cc = u // plan.tiles
        j0 = (u - cc * plan.tiles) * plan.frames
        return cc, j0, min(plan.frames, nf - j0), cc * l + j0 * q

    def stage(t, buf):
        cc, _, nft, g0 = t
        ga = g0 & ~1
        pairs = (g0 - ga + (nft - 1) * q + kin + 1) >> 1
        assert ga % 2 == 0 and 2 * pairs <= plan.buf
        idx = ga + np.arange(2 * pairs)
        inside = idx < cc * l + l                 # else zero-filled
        assert idx[inside].min() >= 0 and idx[inside].max() < c * l
        buf[:] = np.nan
        buf[:2 * pairs] = np.where(inside, flat[np.minimum(idx, c * l - 1)],
                                   0)

    m_tid = (np.arange(plan.per_thread)[:, None] * plan.threads
             + np.arange(plan.threads)[None, :]).ravel()
    for g in range(plan.groups):
        k = g * plan.per_thread * plan.threads + m_tid
        live = k < plan.slots * p
        s = np.where(live, k // p, plan.frames)
        r = np.where(live, k - s * p, 0)
        taps = bank[(r * q) % p]                           # registers
        in_off = s * q + (r * q) // p + pp.TAPS - 1
        for b in range(plan.blocks):
            us = list(range(b, n_tiles, plan.blocks))
            bufs = [np.empty(plan.buf, np.complex64) for _ in range(2)]
            if us:
                stage(tile(us[0]), bufs[0])
            for i, u in enumerate(us):
                if i + 1 < len(us):
                    stage(tile(us[i + 1]), bufs[(i + 1) & 1])
                cc, j0, nft, g0 = tile(u)
                xs = bufs[i & 1][g0 & 1:]
                f0 = np.arange(0, nft, plan.slots)[:, None]
                on = (f0 + s[None, :]) < nft
                base = np.where(on, f0 * q + in_off[None, :], 0)
                ar = ai = None
                for t in range(pp.TAPS):
                    v = xs[base - t * on]
                    tr, ti = taps[:, t] * v.real, taps[:, t] * v.imag
                    ar = tr if ar is None else ar + tr
                    ai = ti if ai is None else ai + ti
                out = ((cc * nf + j0 + f0) * p + k[None, :])[on]
                np.add.at(writes, out, 1)
                y[out] = (ar + 1j * ai).astype(np.complex64)[on]
    return y.reshape(c, nf * p), writes


def _noise(c, l, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((c, l))
            + 1j * rng.standard_normal((c, l))).astype(np.complex64)


@pytest.mark.parametrize("p,q", SCANNER_RATIOS)
def test_plan_within_the_kernels_limits(p, q):
    for c, l in ((1, 400_000), (16, 400_000), (3, 20_011),
                 (1, pp.k_in(p, q) + q)):
        pl = pp.launch_plan(c, l, p, q, N_SM)
        assert pl.smem == 16 * pl.buf <= pp.SMEM_BLOCK
        assert pl.buf % 2 == 0 and pl.buf >= (pl.frames - 1) * q \
            + pp.k_in(p, q) + 1
        assert pl.threads in pp.THREADS and pl.per_thread in pp.PER_THREAD
        assert pl.frames % pl.slots == 0
        assert pl.slots * p <= pl.threads * pl.per_thread * pl.groups
        assert pl.groups == 1 or (pl.slots == 1 and p > pl.threads
                                  * pl.per_thread)
        assert pl.tiles * pl.frames >= pp.n_frames_out(l, p, q) > \
            (pl.tiles - 1) * pl.frames
        assert 1 <= pl.blocks <= c * pl.tiles


@pytest.mark.parametrize("p,q", SCANNER_RATIOS)
def test_walk_covers_every_output_once(p, q):
    """Two odd-length channels: odd channel starts, ragged last tiles; the
    card's grid and a 2-SM grid (several tiles a block, both buffers)."""
    x = _noise(2, 20_011, p + q)
    ref = pp.resample_poly_plain(torch.from_numpy(x), p, q).numpy()
    for n_sm in (N_SM, 2):
        pl = pp.launch_plan(2, 20_011, p, q, n_sm)
        y, writes = emulate(x, p, q, pl)
        assert (writes == 1).all()
        assert np.array_equal(y.view(np.uint32), ref.view(np.uint32))


@pytest.mark.parametrize("p,q", [(192, 125), (768, 625), (1536, 625),
                                 (3072, 625), (12, 125), (2, 1), (1, 10)])
@pytest.mark.parametrize("c,l", [(1, 30_011), (3, 9_999), (2, 1)])
def test_emulated_kernel_equals_plain(p, q, c, l):
    """Bit for bit on ragged lengths; (2, 1) stands for the length that
    leaves exactly one output frame.  3072/625 splits its phases over two
    groups of blocks."""
    if l == 1:
        l = pp.k_in(p, q) + 2 * q - 1
        assert pp.n_frames_out(l, p, q) == 1
    x = _noise(c, l, l)
    assert (pp.launch_plan(c, l, p, q, N_SM).groups > 1) == (p == 3072)
    ref = pp.resample_poly_plain(torch.from_numpy(x), p, q).numpy()
    for n_sm in (N_SM, 1):
        y, writes = emulate(x, p, q, pp.launch_plan(c, l, p, q, n_sm))
        assert (writes == 1).all()
        assert np.array_equal(y.view(np.uint32), ref.view(np.uint32))


def test_emulation_sees_a_wrong_walk():
    """The emulation is no tautology: a plan whose tiles are one frame too
    short leaves outputs unwritten, one whose buffer is a pair too small
    fails its staging."""
    x = _noise(1, 5_011, 1)
    pl = pp.launch_plan(1, 5_011, 192, 125, N_SM)
    with pytest.raises((AssertionError, IndexError)):
        emulate(x, 192, 125, pl._replace(buf=pl.buf - 2))
    y, writes = emulate(x, 192, 125, pl._replace(tiles=pl.tiles - 1))
    assert (writes == 0).any()


def test_scanner_launch_fills_the_card():
    """One channel of 20 ms at 20 Msps, 192/125: at least two blocks an SM;
    sixteen channels: every block walks several tiles."""
    one = pp.launch_plan(1, 400_000, 192, 125, N_SM)
    assert one.blocks * one.groups >= 2 * N_SM
    assert one.threads >= 128
    many = pp.launch_plan(16, 400_000, 192, 125, N_SM)
    assert 16 * many.tiles >= 2 * many.blocks
    assert many.frames * 125 + pp.k_in(192, 125) >= pp.SPAN_TARGET


def test_plan_refuses_what_the_kernel_cannot_stage():
    with pytest.raises(ValueError):
        pp.launch_plan(1, 100_000, 2, 40_001, N_SM)
    with pytest.raises(ValueError):
        pp.launch_plan(1, 10, 192, 125, N_SM)


def test_c_entry_takes_the_plans_arguments():
    """``lteax_resample``'s C parameters match the ctypes signature: three
    pointers, the thirteen ints the wrapper passes, the stream."""
    src = (Path(pp.__file__).parent / "csrc" / "polyphase.cu").read_text()
    params = re.search(r'extern "C" int lteax_resample\(([^)]*)\)',
                       src).group(1).split(",")
    kinds = ["p" if "*" in a or "cudaStream_t" in a else "i" for a in params]
    sig = _build.SIGNATURES["lteax_resample"]
    assert len(kinds) == len(sig)
    assert kinds == ["p" if t is _build._P else "i" for t in sig]
    assert kinds == ["p"] * 3 + ["i"] * 13 + ["p"]


def test_device_bank_is_kept():
    a = pp._device_bank(192, 125, "cpu")
    assert pp._device_bank(192, 125, "cpu") is a
    assert torch.equal(a, torch.from_numpy(pp.design_polyphase(192, 125)))
