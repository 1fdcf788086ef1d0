"""Jax-free control-region test signal: one port-0 downlink subframe
carrying the CRS, the PCFICH, every PHICH group and a set of DCIs on the
PDCCH, for the UE-specific control decode (``pdcch.pdcch_blind_decode_*``,
``phich.phich_decode_subframe``).

:func:`ue_dci_plan` draws one C-RNTI DCI per requested (format, L) at a
UE-space candidate of that RNTI's search space (36.213 §9.1.1) that is no
common candidate and overlaps no CCE already taken, and group TPC DCIs
(formats 3 / 3A) on TPC-RNTIs at common candidates; :func:`ctrl_subframe`
maps them, the PCFICH and the HI bits of every (group, sequence) into the
grid (symbols from ``pdcch_encode``, ``pcfich_encode`` and
``phich_group_encode``).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from lteax_torch.phy.channels import dci, pcfich, pdcch, phich
from lteax_torch.phy.config import PhyConfig
from lteax_torch.phy.grid import (crs_flat_idx, n_phich_groups,
                                  pcfich_flat_idx, pdcch_flat_idx)
from lteax_torch.sim.dl_gen import crs_grid_values

UE_FORMATS = ("0", "1", "1b", "1d", "2", "2a")
TPC_FORMATS = ("3", "3a")


@dataclasses.dataclass(frozen=True)
class PlacedDci:
    """One DCI of the plan: its format, RNTI, CCE start, L, payload bits
    and the message a blind decode must return (a dataclass, or the TPC
    commands of formats 3 / 3A)."""
    fmt: str
    rnti: int
    start: int
    l_agg: int
    bits: np.ndarray
    msg: object


def random_message(fmt: str, n_rb: int, rng: np.random.Generator):
    """(payload bits, message) of a random DCI of ``fmt`` (2 antenna ports
    for 1B / 1D)."""
    r = lambda n: int(rng.integers(n))
    l_crb = 1 + r(n_rb)
    riv = dict(rb_start=r(n_rb - l_crb + 1), l_crb=l_crb)
    harq = dict(mcs=r(29), rv=r(4), harq=r(8), ndi=r(2), tpc=r(4))
    bitmap = 1 + r(2 ** dci.n_rbg(n_rb) - 1)
    if fmt == "0":
        m = dci.Dci0(**riv, mcs=r(29), ndi=r(2), tpc=r(4), dmrs_cs=r(8),
                     hopping=bool(r(2)), cqi_request=bool(r(2)))
        return dci.dci_0_pack(m, n_rb, dci.dci_1a_size(n_rb)), m
    if fmt == "1":
        m = dci.Dci1(rbg_bitmap=bitmap, **harq)
        return dci.dci_1_pack(m, n_rb), m
    if fmt in ("1b", "1d"):
        last = ({"pmi_confirm": r(2)} if fmt == "1b"
                else {"dl_power_offset": r(2)})
        m = (dci.Dci1B if fmt == "1b" else dci.Dci1D)(
            **riv, **harq, tpmi=r(4), distributed=bool(r(2)), **last)
        return getattr(dci, f"dci_{fmt}_pack")(m, n_rb), m
    if fmt in ("2", "2a"):
        two = dict(rbg_bitmap=bitmap, mcs0=r(29), mcs1=r(29), rv0=r(4),
                   rv1=r(4), ndi0=r(2), ndi1=r(2), harq=r(8), tpc=r(4),
                   swap=r(2))
        if fmt == "2":
            m = dci.Dci2(**two, precoding=r(3))
            return dci.dci_2_pack(m, n_rb), m
        m = dci.Dci2A(**two)
        return dci.dci_2a_pack(m, n_rb), m
    if fmt == "3":
        cmds = tuple(r(4) for _ in range(dci.dci_3_n_commands(n_rb)))
        return dci.dci_3_pack(cmds, n_rb), cmds
    if fmt == "3a":
        cmds = tuple(r(2) for _ in range(dci.dci_3a_n_commands(n_rb)))
        return dci.dci_3a_pack(cmds, n_rb), cmds
    raise ValueError(f"DCI format {fmt!r}")


def ue_dci_plan(cfg: PhyConfig, n_cell_id: int, cfi: int, ng: float,
                subframe: int, ue: list[tuple[str, int]],
                tpc: list[tuple[str, int, int, int]],
                rng: np.random.Generator) -> list[PlacedDci]:
    """The subframe's DCIs: first the group TPC ones, ``tpc`` = [(format,
    TPC-RNTI, CCE start, L)] at common candidates; then one per ``ue`` =
    [(format, L)], largest L first, each on the first C-RNTI drawn from
    ``rng`` whose UE space has a candidate of that L that is no common
    candidate and whose CCEs are free."""
    ncce = pdcch.n_cce(cfg, n_cell_id, cfi, ng)
    common = set(pdcch.common_search_candidates(ncce))
    taken: set[int] = set()
    out = []

    def place(fmt, rnti, start, l_agg):
        bits, msg = random_message(fmt, cfg.n_rb_dl, rng)
        taken.update(range(start, start + l_agg))
        out.append(PlacedDci(fmt, rnti, start, l_agg, bits, msg))

    for fmt, rnti, start, l_agg in tpc:
        if (start, l_agg) not in common or \
                taken & set(range(start, start + l_agg)):
            raise ValueError(f"({start}, {l_agg}) is no free common "
                             f"candidate")
        place(fmt, rnti, start, l_agg)
    for fmt, l_want in sorted(ue, key=lambda x: -x[1]):
        for _ in range(10000):
            rnti = int(rng.integers(0x003D, 0xFFF3))
            cand = next(((s, l) for s, l in pdcch.ue_search_candidates(
                ncce, rnti, subframe) if l == l_want
                and (s, l) not in common
                and not taken & set(range(s, s + l))), None)
            if cand is not None:
                place(fmt, rnti, *cand)
                break
        else:
            raise ValueError(f"no free UE candidate of L={l_want} in "
                             f"{ncce} CCEs")
    return out


def ctrl_subframe(cfg: PhyConfig, n_cell_id: int, cfi: int, ng: float,
                  subframe: int, dcis: list[PlacedDci],
                  hi: np.ndarray) -> np.ndarray:
    """(n_sym, n_sc) complex64 grid of one port: the CRS, the PCFICH
    (``cfi``), the PDCCH carrying ``dcis`` and every PHICH group g with
    the HI bits ``hi[g, s]`` (1 = ACK) on its 8 sequences s."""
    if hi.shape != (n_phich_groups(cfg, ng), 8):
        raise ValueError(f"hi {hi.shape}: one row of 8 bits per group")
    flat = np.zeros(cfg.n_sym_subframe * cfg.n_sc, np.complex64)
    flat[crs_flat_idx(cfg, n_cell_id, 0)] = crs_grid_values(cfg, n_cell_id,
                                                            subframe)
    flat[pcfich_flat_idx(cfg, n_cell_id)] = pcfich.pcfich_encode(
        cfi, n_cell_id, subframe)
    idx = phich.phich_subframe_idx(cfg, n_cell_id, ng)
    for g in range(len(idx)):
        flat[idx[g]] = phich.phich_group_encode(
            {s: int(hi[g, s]) for s in range(8)}, n_cell_id, subframe)
    ctrl = cfi + 1 if cfg.n_rb_dl <= 10 else cfi
    flat[pdcch_flat_idx(cfg, n_cell_id, ctrl, ng).reshape(-1)] = \
        pdcch.pdcch_encode([(d.bits, d.rnti, d.start, d.l_agg) for d in dcis],
                           cfg, n_cell_id, ctrl, ng, subframe)[0]
    return flat.reshape(cfg.n_sym_subframe, cfg.n_sc)
