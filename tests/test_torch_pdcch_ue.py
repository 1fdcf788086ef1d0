"""The port's PDCCH blind decodes of the UE-specific DCI formats against the
reference's, on the CPU: the cases of ``tests/test_pdcch_ue_ss.py``
(DCIs at Y_k-hashed UE-space candidates of every aggregation level that
fits, found by the batched blind decode with ``subframe`` and missed
without it) for formats 0, 1, 1B, 1D, 2, 2A, 3 and 3A at 25 PRB, cfi 3.

Both packages encode the same DCIs (the symbols equal), both de-interleave
the same LLRs with ``pdcch_llrs_to_logical`` (within 1e-6) and both blind
decode: the found lists (message, CCE start, L) are equal, each placed DCI
is found at its (start, L) with its fields, and without the UE space none
of them is."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lteax.phy.channels import dci as dci_ref
from lteax.phy.channels import pdcch as pdcch_ref
from lteax.phy.config import PhyConfig as RefPhyConfig
from lteax.phy.mod import demodulate_maxlog as demod_ref

from lteax_torch import host
from lteax_torch.phy.channels import dci, pdcch
from lteax_torch.phy.config import PhyConfig
from lteax_torch.phy.mod import demodulate_maxlog
from lteax_torch.sim import ctrl_gen

N_RB, NID, CFI, NG = 25, 214, 3, 1.0
CFG, CFG_R = PhyConfig(n_rb_dl=N_RB), RefPhyConfig(n_rb_dl=N_RB)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _placements(rnti: int, sf: int):
    """One UE-space (not common) candidate per aggregation level, CCEs
    disjoint, as many levels as fit (largest first)."""
    ncce = pdcch.n_cce(CFG, NID, CFI, NG)
    common = set(pdcch.common_search_candidates(ncce))
    used: set[int] = set()
    out = []
    for l_want in (8, 4, 2, 1):
        for start, l_agg in pdcch.ue_search_candidates(ncce, rnti, sf):
            cces = set(range(start, start + l_agg))
            if l_agg == l_want and (start, l_agg) not in common and \
                    not cces & used:
                used |= cces
                out.append((start, l_agg))
                break
    return out


def _as_plain(x):
    return dataclasses.asdict(x) if dataclasses.is_dataclass(x) else x


# format -> (RNTI, subframe) whose UE space holds disjoint candidates at L
# 4, 2 and 1 (at 25 PRB, 20 CCEs, every L = 8 candidate is a common one);
# 3/3A on TPC-RNTIs
CASES = {"0": (0x100, 2), "1": (0x61, 4), "1b": (0x2B7, 8),
         "1d": (0x1234, 1), "2": (0x3D, 8), "2a": (0x4F1, 4),
         "3": (0xFFF0, 5), "3a": (0xFFF1, 7)}


@pytest.mark.parametrize("fmt", list(CASES))
def test_blind_decode_finds_ue_space_dcis_as_the_reference(fmt):
    rnti, sf = CASES[fmt]
    places = _placements(rnti, sf)
    assert [l for _, l in places] == [4, 2, 1], places
    rng = np.random.default_rng([ord(c) for c in fmt])
    msgs = [ctrl_gen.random_message(fmt, N_RB, rng) for _ in places]
    dcis = [(bits, rnti, start, l_agg)
            for (bits, _), (start, l_agg) in zip(msgs, places)]
    sym = pdcch.pdcch_encode(dcis, CFG, NID, CFI, NG, sf)[0]
    sym_r = np.asarray(pdcch_ref.pdcch_encode(dcis, CFG_R, NID, CFI, NG,
                                              sf))[0]
    np.testing.assert_allclose(sym, sym_r, rtol=0, atol=1e-6)
    llr = demodulate_maxlog(torch.from_numpy(sym), "qpsk") * 4.0
    logical = pdcch.pdcch_llrs_to_logical(llr, CFG, NID, CFI, NG, sf)
    logical_r = pdcch_ref.pdcch_llrs_to_logical(
        demod_ref(jnp.asarray(sym), "qpsk") * 4.0, CFG_R, NID, CFI, NG, sf)
    np.testing.assert_allclose(logical.numpy(), np.asarray(logical_r),
                               rtol=0, atol=1e-6)
    ncce = pdcch.n_cce(CFG, NID, CFI, NG)
    assert ncce == pdcch_ref.n_cce(CFG_R, NID, CFI, NG)
    decode = getattr(pdcch, f"pdcch_blind_decode_{fmt}")
    decode_r = getattr(pdcch_ref, f"pdcch_blind_decode_{fmt}")
    for subframe in (sf, None):
        reads = host.READS
        found = decode(logical, N_RB, rnti, ncce, subframe=subframe)
        assert host.READS == reads + 1           # one read per blind decode
        found_r = decode_r(logical_r, N_RB, rnti, ncce, subframe=subframe)
        assert [(_as_plain(d), s, l) for d, s, l in found] == \
            [(_as_plain(d), s, l) for d, s, l in found_r]
        hits = {(s, l): _as_plain(d) for d, s, l in found}
        for (_, want), place in zip(msgs, places):
            if subframe is None:
                assert place not in hits, (fmt, place)
            else:
                assert hits[place] == _as_plain(want), (fmt, place)


def test_ue_search_space_as_the_reference():
    """Y_k, the UE candidates and the merged set, for a grid of RNTIs,
    subframes and CCE counts."""
    for rnti in (0x3D, 0x100, 0x2B7, 0xFFF3):
        for sf in range(10):
            assert pdcch.ue_search_y(rnti, sf) == \
                pdcch_ref.ue_search_y(rnti, sf)
            for ncce in (2, 5, 20, 41, 84):
                assert pdcch.search_candidates(ncce, rnti, sf) == \
                    pdcch_ref.search_candidates(ncce, rnti, sf)


def test_format_0_and_1a_share_a_size_and_a_blind_decode_tells_them_apart():
    """A format-0 and a 1A message on one RNTI, each at its own UE
    candidate: the 0 decode finds the 0 and never the 1A, the 1A decode the
    reverse (the format flag).  A candidate of a larger L that starts at
    the same CCE may decode the same message again (the circular buffer),
    in both packages alike."""
    rnti, sf = 0x61, 4
    places = _placements(rnti, sf)[:2]
    b0, _ = ctrl_gen.random_message("0", N_RB, np.random.default_rng(1))
    b1a = dci.dci_1a_pack(dci.Dci1A(rb_start=0, l_crb=5, mcs=9, rv=1), N_RB)
    dcis = [(b0, rnti, *places[0]), (b1a, rnti, *places[1])]
    sym = pdcch.pdcch_encode(dcis, CFG, NID, CFI, NG, sf)[0]
    llr = demodulate_maxlog(torch.from_numpy(sym), "qpsk") * 4.0
    logical = pdcch.pdcch_llrs_to_logical(llr, CFG, NID, CFI, NG, sf)
    ncce = pdcch.n_cce(CFG, NID, CFI, NG)
    f0 = pdcch.pdcch_blind_decode_0(logical, N_RB, rnti, ncce, sf)
    f1a = pdcch.pdcch_blind_decode_1a(logical, N_RB, rnti, ncce, sf)
    for found, mine, other, cls in ((f0, places[0], places[1], dci.Dci0),
                                    (f1a, places[1], places[0], dci.Dci1A)):
        hits = [(s, l) for _, s, l in found]
        assert mine in hits and other not in hits, hits
        assert all(isinstance(d, cls) for d, _, _ in found)
    assert dci_ref.dci_1a_size(N_RB) == dci.dci_1a_size(N_RB)


def test_control_subframe_decodes_as_the_reference():
    """A whole control region from ``sim/ctrl_gen.py`` at 25 PRB: a C-RNTI
    DCI of each UE format at UE-space candidates (L 4, 2, 2, 1, 1, 1),
    DCI 3 and 3A on TPC-RNTIs in the common space, every PHICH group
    carrying 8 HI bits.  From the grid's REs (unit channel, as the
    reference's ``enb_sim`` reads them): each DCI found at its (start, L)
    with its message, every HI bit right, the PCFICH's CFI 3."""
    from lteax_torch.phy.channels import pcfich, phich
    from lteax_torch.phy.grid import pcfich_flat_idx, pdcch_flat_idx
    sf = 6
    rng = np.random.default_rng(8)
    ue = list(zip(ctrl_gen.UE_FORMATS, (1, 1, 2, 1, 4, 2)))
    dcis = ctrl_gen.ue_dci_plan(CFG, NID, CFI, NG, sf, ue,
                                [("3", 0xFFF0, 0, 4), ("3a", 0xFFF1, 4, 4)],
                                rng)
    hi = rng.integers(0, 2, (phich.phich_subframe_idx(CFG, NID, NG).shape[0],
                             8))
    flat = torch.from_numpy(ctrl_gen.ctrl_subframe(CFG, NID, CFI, NG, sf,
                                                   dcis, hi).reshape(-1))
    cfi, _ = pcfich.pcfich_decode(demodulate_maxlog(
        flat[pcfich_flat_idx(CFG, NID)], "qpsk"), NID, sf)
    assert int(cfi) == CFI
    llr = demodulate_maxlog(flat[pdcch_flat_idx(CFG, NID, CFI, NG)
                                 .reshape(-1)], "qpsk") * 4.0
    logical = pdcch.pdcch_llrs_to_logical(llr, CFG, NID, CFI, NG, sf)
    ncce = pdcch.n_cce(CFG, NID, CFI, NG)
    for d in dcis:
        kw = {} if d.fmt in ("3", "3a") else {"subframe": sf}
        found = getattr(pdcch, f"pdcch_blind_decode_{d.fmt}")(
            logical, N_RB, d.rnti, ncce, **kw)
        hits = {(s, l): _as_plain(m) for m, s, l in found}
        assert hits.get((d.start, d.l_agg)) == _as_plain(d.msg), d
    got = phich.phich_decode_subframe(flat, CFG, NID, NG, sf)
    np.testing.assert_array_equal((got < 0).astype(int), hi)
