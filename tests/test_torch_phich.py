"""The port's PHICH (``lteax_torch.phy.channels.phich``) against the
reference's (``lteax.phy.channels.phich``), on the CPU: the superposed
group symbols bit for bit; the per-call despread metric of every one of
the 8 sequences within 1e-5 (of metrics of magnitude ~10) on noisy REs; the
batched decode of every (group, sequence) of a subframe, from a grid's REs
at ``grid.phich_flat_idx`` in one read, equal to the reference's per-call
decode, with every HI bit right."""

import numpy as np
import pytest
import torch

from lteax.phy.channels import phich as phich_ref
from lteax.phy.config import PhyConfig as RefPhyConfig
from lteax.phy.grid import phich_flat_idx as phich_flat_idx_ref

from lteax_torch import host
from lteax_torch.phy.channels import phich
from lteax_torch.phy.config import PhyConfig
from lteax_torch.phy.grid import n_phich_groups


def _acks(rng, n: int = 8) -> dict[int, int]:
    seqs = rng.choice(8, n, replace=False)
    return {int(s): int(b) for s, b in zip(seqs, rng.integers(0, 2, n))}


@pytest.mark.parametrize("cid,sf", [(0, 0), (77, 3), (214, 4), (503, 9)])
def test_group_encode_bit_equal(cid, sf):
    rng = np.random.default_rng(cid + sf)
    for n in (1, 3, 8):
        acks = _acks(rng, n)
        got = phich.phich_group_encode(acks, cid, sf)
        ref = phich_ref.phich_group_encode(acks, cid, sf)
        assert got.dtype == ref.dtype == np.complex64
        np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("cid,sf", [(5, 1), (214, 4), (400, 8)])
def test_group_decode_metrics_match(cid, sf):
    """All 8 sequences superposed, AWGN of variance 0.5 per RE."""
    rng = np.random.default_rng(cid)
    acks = _acks(rng)
    y = phich_ref.phich_group_encode(acks, cid, sf)
    y = (y + (rng.standard_normal(12) + 1j * rng.standard_normal(12)) * 0.5
         ).astype(np.complex64)
    batched = phich.phich_decode(torch.from_numpy(y), cid, sf).numpy()
    for s in range(8):
        got = phich.phich_group_decode(y, cid, sf, s)
        ref = phich_ref.phich_group_decode(y, cid, sf, s)
        assert isinstance(got, float)
        assert abs(got - ref) <= 1e-5 * max(1.0, abs(ref)), (s, got, ref)
        assert abs(batched[s] - ref) <= 1e-5 * max(1.0, abs(ref))


@pytest.mark.parametrize("n_rb,ng,cid,sf", [(6, 1.0, 150, 2), (25, 0.5, 77, 7),
                                            (50, 2.0, 301, 5)])
def test_subframe_decode_equals_per_call_decode(n_rb, ng, cid, sf):
    """Every group of a subframe carrying all 8 sequences, on a grid with
    noise elsewhere: one read gives (n_groups, 8) metrics equal to the
    reference's per-call decode of each (group, sequence), each HI bit
    right."""
    cfg, cfg_r = PhyConfig(n_rb_dl=n_rb), RefPhyConfig(n_rb_dl=n_rb)
    n_g = n_phich_groups(cfg, ng)
    idx = phich.phich_subframe_idx(cfg, cid, ng)
    assert idx.shape == (n_g, 12)
    for g in range(n_g):
        np.testing.assert_array_equal(idx[g],
                                      phich_flat_idx_ref(cfg_r, cid, ng, g))
    rng = np.random.default_rng(n_rb)
    n = cfg.n_sym_subframe * cfg.n_sc
    grid = ((rng.standard_normal(n) + 1j * rng.standard_normal(n)) * 0.1
            ).astype(np.complex64)
    sent = rng.integers(0, 2, (n_g, 8))
    for g in range(n_g):
        grid[idx[g]] += phich.phich_group_encode(
            {s: int(sent[g, s]) for s in range(8)}, cid, sf)
    reads = host.READS
    got = phich.phich_decode_subframe(torch.from_numpy(grid), cfg, cid, ng, sf)
    assert host.READS == reads + 1
    assert got.shape == (n_g, 8) and got.dtype == np.float32
    per_call = np.asarray([[phich_ref.phich_group_decode(grid[idx[g]], cid, sf, s)
                            for s in range(8)] for g in range(n_g)])
    np.testing.assert_allclose(got, per_call, rtol=0,
                               atol=1e-5 * np.abs(per_call).max())
    np.testing.assert_array_equal((got < 0).astype(int), sent)
