"""The port's PUCCH (``lteax_torch.phy.channels.pucch``) against the
reference's (``lteax.phy.channels.pucch``), on the CPU.

The UE's side (tables, encoders, the grid mapping) is a numpy copy and
must be equal.  The receivers run in torch (complex64 sums, a float32
(2^A, 20) matmul for RM(20, A)) where the reference runs numpy: on seeded
noisy grids the decoded bits are equal and every metric is within 1e-5
relative of the reference's.
"""

import numpy as np
import pytest
import torch

from lteax.phy.channels import pucch as pucch_ref

from lteax_torch.phy.channels import pucch

REL = 1e-5
N_RB = 25
CID, SF, RNTI = 77, 3, 0x41


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def close(a, b):
    assert abs(a - b) <= REL * max(abs(b), 1e-6), (a, b)


def noisy(rng, x, sigma):
    h = 0.8 * np.exp(0.7j)
    return (h * x + sigma * (rng.standard_normal(x.shape)
                             + 1j * rng.standard_normal(x.shape))
            ).astype(np.complex64)


def test_tables_unchanged():
    assert pucch.PHI_M12 == pucch_ref.PHI_M12
    assert np.array_equal(pucch.RM_20_BASIS, pucch_ref.RM_20_BASIS)
    assert np.array_equal(pucch.W3, pucch_ref.W3)
    assert np.array_equal(pucch.W4, pucch_ref.W4)
    for cid in (0, 77, 503):
        for alpha in (0, 5, 11):
            assert np.array_equal(pucch._r_alpha(cid, 4, alpha),
                                  pucch_ref._r_alpha(cid, 4, alpha))


@pytest.mark.parametrize("bits", [(), (0,), (1,), (0, 1), (1, 0), (1, 1)])
def test_format1_three_covers_share_one_prb(bits):
    """Formats 1 (SR), 1a and 1b: three UEs on orthogonal covers 0, 1, 2
    of one resource, superposed on a 25-PRB grid, extracted and decoded
    per cover."""
    rng = np.random.default_rng(len(bits) * 7 + sum(bits))
    m = 3
    grid = np.zeros((14, N_RB * 12), np.complex64)
    sent = {}
    for oc in range(3):
        b = bits if oc == 0 else tuple(int(x) for x in
                                       rng.integers(0, 2, len(bits)))
        syms = pucch.pucch_format1_encode(b, CID, SF, 2, oc)
        assert np.array_equal(syms, pucch_ref.pucch_format1_encode(
            b, CID, SF, 2, oc))
        grid = pucch.pucch_map_format1(grid, syms, m, N_RB)
        sent[oc] = b
    grid = noisy(rng, grid, 0.3)
    for oc, b in sent.items():
        res = pucch.pucch_extract(torch.from_numpy(grid), m, N_RB)
        got = pucch.pucch_format1_decode(res, CID, SF, 2, oc, len(b))
        want = pucch_ref.pucch_format1_decode(
            pucch_ref.pucch_extract(grid, m, N_RB), CID, SF, 2, oc, len(b))
        assert got[0] == want[0] == b
        close(got[1], want[1])


@pytest.mark.parametrize("a", range(1, 14))
def test_rm20_every_length(a):
    """Encoder equal; the ML decoder on noisy LLRs: bits and metric."""
    rng = np.random.default_rng(a)
    for _ in range(3):
        bits = rng.integers(0, 2, a)
        cw = pucch.rm20_encode(bits)
        assert np.array_equal(cw, pucch_ref.rm20_encode(bits))
        llr = ((1 - 2 * cw) + 0.8 * rng.standard_normal(20)).astype(
            np.float32)
        got_b, got_m = pucch.rm20_decode(torch.from_numpy(llr), a)
        want_b, want_m = pucch_ref.rm20_decode(llr, a)
        assert np.array_equal(got_b, want_b) and got_b.dtype == np.int32
        close(got_m, want_m)


@pytest.mark.parametrize("a", [4, 10, 13])
def test_format2(a):
    rng = np.random.default_rng(100 + a)
    for alpha in (0, 7):
        bits = rng.integers(0, 2, a)
        syms = pucch.pucch_format2_encode(bits, CID, SF, RNTI, alpha)
        assert np.array_equal(syms, pucch_ref.pucch_format2_encode(
            bits, CID, SF, RNTI, alpha))
        rx = noisy(rng, syms, 0.4)
        got = pucch.pucch_format2_decode(torch.from_numpy(rx), CID, SF,
                                         RNTI, a, alpha)
        want = pucch_ref.pucch_format2_decode(rx, CID, SF, RNTI, a, alpha)
        assert np.array_equal(got[0], want[0])
        assert np.array_equal(got[0], bits)
        close(got[1], want[1])


@pytest.mark.parametrize("ack", [(0,), (1,), (0, 0), (0, 1), (1, 0), (1, 1)])
def test_format2ab(ack):
    """2a (one ACK bit) and 2b (two): CQI bits, ACK bits, both metrics."""
    rng = np.random.default_rng(sum(ack) + 10 * len(ack))
    a = 11
    cqi = rng.integers(0, 2, a)
    syms = pucch.pucch_format2ab_encode(cqi, ack, CID, SF, RNTI, 1)
    assert np.array_equal(syms, pucch_ref.pucch_format2ab_encode(
        cqi, ack, CID, SF, RNTI, 1))
    rx = noisy(rng, syms, 0.3)
    got = pucch.pucch_format2ab_decode(torch.from_numpy(rx), CID, SF, RNTI,
                                       a, len(ack), 1)
    want = pucch_ref.pucch_format2ab_decode(rx, CID, SF, RNTI, a, len(ack),
                                            1)
    assert np.array_equal(got[0], want[0]) and np.array_equal(got[0], cqi)
    assert got[1] == want[1] == ack
    close(got[2], want[2])
    close(got[3], want[3])


def test_grid_mapping_extract_and_presence():
    """Resources at both band edges of a 25-PRB grid (slot hopping): the
    mapping, the gather back and the energy detector."""
    rng = np.random.default_rng(1)
    grid = np.zeros((14, N_RB * 12), np.complex64)
    used = (0, 1, 6, 9)
    for m in used:
        syms = (rng.standard_normal((2, 7, 12))
                + 1j * rng.standard_normal((2, 7, 12))).astype(np.complex64)
        got = pucch.pucch_map_format1(grid, syms, m, N_RB)
        assert np.array_equal(got, pucch_ref.pucch_map_format1(grid, syms, m,
                                                               N_RB))
        grid = got
    for m in range(12):
        assert pucch.pucch_prb(m, 1, N_RB) == pucch_ref.pucch_prb(m, 1, N_RB)
        res = pucch.pucch_extract(torch.from_numpy(grid), m, N_RB)
        assert res.dtype == torch.complex64 and res.shape == (2, 7, 12)
        assert np.array_equal(res.numpy(),
                              pucch_ref.pucch_extract(grid, m, N_RB))
        assert pucch.pucch_present(torch.from_numpy(grid), m, N_RB) == \
            pucch_ref.pucch_present(grid, m, N_RB) == (m in used)
