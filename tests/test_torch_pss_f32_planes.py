"""The f32 PSS routine's arithmetic on the CPU, without the card: the
three-plane bfloat16 split of x and of the replicas' Toeplitz operand, and
the pass table ``PSS_F32_PASSES`` parsed out of ``csrc/pss.cu`` and
emulated in float64 on the Toeplitz GEMM against a float64 correlation.

The limit, 1e-8 of sum_k |terms| of each output's real and imaginary part:
the six passes with i + j <= 2 leave out products of order 2^-26 of a term
(about 6e-10 of the terms' sum, random signs), while leaving out any one of
the six costs 1e-7 or more, and so does the two-plane form (the three
passes with i + j <= 1).  At a 2048-tap peak that is ~1e-7 of the peak,
which the card's tolerance ``F32_TOL`` alone would not catch, so the pass
set is held here.  No reference call: the float64 correlation is the
reference."""

import re
from itertools import combinations
from pathlib import Path

import numpy as np
import pytest
import torch

from lteax_torch.kernels import pss
from lteax_torch.phy.config import PhyConfig
from lteax_torch.phy.sync import pss_time_filters

SRC = Path(pss.__file__).resolve().parent / "csrc" / "pss.cu"
LIMIT = 1e-8


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pass_table() -> list[tuple[int, int]]:
    text = re.search(r"#define PSS_F32_PASSES (\{.*\})", SRC.read_text())
    return [(int(i), int(j)) for i, j in
            re.findall(r"\{(\d+), (\d+)\}", text.group(1))]


PASSES = _pass_table()


def test_pass_table_is_the_split():
    """Six passes, each plane product with i + j <= 2 once, grouped by A
    plane from x0 on (the kernel stages one A plane at a time)."""
    assert sorted(PASSES) == [(i, j) for i in range(3) for j in range(3)
                              if i + j <= 2]
    assert [i for i, _ in PASSES] == sorted(i for i, _ in PASSES)
    assert len(PASSES) == pss.F32_PASSES == 6 and pss.PLANES == 3


def _decades(lo: int, hi: int, n: int = 40_000, seed: int = 0):
    rng = np.random.default_rng(seed)
    mant = rng.uniform(1.0, 2.0, n)
    exp = rng.integers(lo, hi, n)
    sign = rng.choice([-1.0, 1.0], n)
    return torch.from_numpy((sign * mant * 2.0 ** exp).astype(np.float32))


def _sum64(planes) -> np.ndarray:
    return sum(p.to(torch.float64) for p in planes).numpy()


def test_x_split_reassembles_exactly_over_decades():
    """x0 + x1 + x2 == x for float32 values from 2^-110 to 2^127 (bfloat16
    has float32's exponent range, and each plane keeps 8 significant bits
    of what the planes before left).  Below 2^-110 the third plane's bits
    fall under bfloat16's smallest subnormal (2^-133) and are lost: such a
    sample moves a correlation by less than 2^-133 a tap, far below the
    float32 rounding of any IQ capture's peak, whose samples are O(1)
    (noise at unit variance, sc8 counts, or scaled floats)."""
    x = _decades(-110, 127)
    planes = pss.split_bf16(x)
    assert all(p.dtype == torch.bfloat16 for p in planes)
    np.testing.assert_array_equal(_sum64(planes), x.double().numpy())
    # planes shrink by at least 2^8 each: the split is the leading bits
    a = [p.double().abs().numpy() for p in planes]
    assert np.all(a[1] <= a[0] * 2.0 ** -8) and np.all(a[2] <= a[1] * 2.0 ** -8)
    tiny = _decades(-126, -115, seed=1)
    assert not np.array_equal(_sum64(pss.split_bf16(tiny)), tiny.double().numpy())
    special = torch.tensor([0.0, -0.0, 1.0, -3.0, 2.0 ** -110], dtype=torch.float32)
    np.testing.assert_array_equal(_sum64(pss.split_bf16(special)),
                                  special.double().numpy())


def _unimage(img: torch.Tensor) -> np.ndarray:
    """The kernel's image (..., nch, 3, K/8, N, 8) -> (..., nch, 3, K, N)."""
    a = img.to(torch.float64).transpose(-1, -2)
    return a.reshape(*a.shape[:-3], -1, a.shape[-1]).numpy()


@pytest.mark.parametrize("n_rb", [6, 25])
def test_b_planes_reassemble_and_plane0_is_the_bf16_image(n_rb):
    filt = pss_time_filters(PhyConfig(n_rb_dl=n_rb))
    planes = pss._toeplitz_planes(filt)
    nch = filt.shape[1] // pss.FRAME + 1
    assert planes.dtype == torch.bfloat16
    assert planes.shape == (3, nch, 3, 16, 2 * pss.FRAME, 8)
    np.testing.assert_array_equal(_unimage(planes).sum(axis=0),
                                  pss.toeplitz_operand_np(filt))
    # the bf16 routine's operand is plane 0: its results do not change
    assert torch.equal(planes[0], pss._toeplitz_image(filt))
    assert torch.equal(pss._operand("f32", filt.tobytes(), filt.shape[1],
                                    "cpu"), planes)


def _emulate(n_rb: int, passes, frames: int = 16, seed: int = 0):
    """The Toeplitz GEMM over ``passes`` in float64, against a float64
    correlation: max over outputs, roots and (re, im) of |error| / sum_k
    |terms|."""
    filt = pss_time_filters(PhyConfig(n_rb_dl=n_rb))
    nf, f = filt.shape[1], pss.FRAME
    nch = nf // f + 1
    rows = frames + nch - 1
    rng = np.random.default_rng(seed + n_rb)
    x = (rng.standard_normal(rows * f)
         + 1j * rng.standard_normal(rows * f)).astype(np.complex64)
    x[100:100 + nf] += 3 * filt[1]
    xr = torch.view_as_real(torch.from_numpy(x)).reshape(rows, 2 * f)
    a = [p.double().numpy() for p in pss.split_bf16(xr)]      # (rows, K)
    b = _unimage(pss._toeplitz_planes(filt))                 # (P, nch, 3, K, N)
    got = np.zeros((3, frames, 2 * f))
    for i, j in passes:
        for c in range(nch):
            got += np.einsum("tk,rkn->rtn", a[i][c:c + frames], b[j][c])
    xa = xr.double().numpy()
    ba = pss.toeplitz_operand_np(filt).astype(np.float64)
    size = sum(np.einsum("tk,rkn->rtn", np.abs(xa[c:c + frames]),
                         np.abs(ba[c])) for c in range(nch))
    # float64 correlation of the same samples, outputs n < frames * 64
    h = np.conj(filt.astype(np.complex128))
    xp = x.astype(np.complex128)
    n_out = frames * f
    win = np.lib.stride_tricks.sliding_window_view(xp, nf)[:n_out]
    corr = win @ h.T                                          # (n_out, 3)
    want = np.stack([corr.real, corr.imag], -1).transpose(1, 0, 2)
    want = want.reshape(3, frames, 2 * f)
    return float((np.abs(got - want) / size).max())


@pytest.mark.parametrize("n_rb", [6, 25])
def test_pass_table_is_within_f32_of_a_float64_correlation(n_rb):
    assert _emulate(n_rb, PASSES) <= LIMIT


MUTATIONS = {f"drop_{i}{j}": [p for p in PASSES if p != (i, j)]
             for i, j in PASSES}
MUTATIONS["two_planes"] = [(i, j) for i in range(2) for j in range(2)
                           if i + j <= 1]


@pytest.mark.parametrize("name", sorted(MUTATIONS))
def test_fewer_passes_fail_the_limit(name):
    """Each five-pass table, and the two-plane form, are no f32 routine."""
    assert _emulate(25, MUTATIONS[name]) > LIMIT
