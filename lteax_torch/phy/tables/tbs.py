"""Transport block size and MCS tables (36.213 §7.1.7).

(reference capability: ``liblte/src/liblte_phy.cc ::
liblte_phy_get_tbs_mcs_and_n_prb_for_dl`` / ``liblte_phy_get_tbs_and_n_prb_for_dl``.)

PROVENANCE: no 3GPP spec text was at hand when the table was made
(SURVEY.md).  Table 7.1.7.2.1-1 is served complete (27 x 110)
from ``tbs_full.py``, generated by ``scripts/tbs_reconcile.py`` from two
independent from-memory transcriptions (column-wise anchors + row-wise rows)
cross-validated against the uniform-segmentation ladder, two-axis
monotonicity, and per-row spectral-efficiency smoothness.  Per-cell
provenance is in ``tbs_full.PROV``: "A" anchor (both transcriptions agree),
"R" row-recall (pinned between agreeing anchors), "F" fit (SE interpolation,
flagged NOT spec-exact).  All values segment uniformly (tests assert it),
which the static-shape device path relies on.

The port's own copy of ``lteax/phy/tables/tbs.py``: the port
imports nothing of the JAX package, and ``tests/test_torch_plans.py``
holds the two equal.
"""

from __future__ import annotations

# 36.213 Table 7.1.7.1-1: MCS -> (modulation order Q_m, I_TBS)
def mcs_to_qm_itbs(mcs: int) -> tuple[int, int]:
    if 0 <= mcs <= 9:
        return 2, mcs
    if 10 <= mcs <= 16:
        return 4, mcs - 1
    if 17 <= mcs <= 28:
        return 6, mcs - 2
    raise ValueError(f"reserved/unsupported MCS {mcs}")


MOD_BY_QM = {2: "qpsk", 4: "16qam", 6: "64qam"}

from lteax_torch.phy.tables.tbs_full import TBS_TABLE, PROV  # noqa: E402

# Back-compat view: the columns that were transcribed first (standard
# bandwidths + DCI-1A columns), now served from the full table.
TBS_COLUMNS: dict[int, tuple[int, ...]] = {
    n: tuple(TBS_TABLE[i][n - 1] for i in range(27))
    for n in (1, 2, 3, 4, 5, 6, 15, 25, 50, 75, 100)
}


from functools import lru_cache


@lru_cache(maxsize=None)
def _allowed_uniform_tbs() -> tuple[int, ...]:
    """All TBS values whose 36.212 §5.1.2 segmentation is uniform (a single
    code-block size K, zero filler): TBS = C*(K-24) - 24 for valid K.
    Every entry of Table 7.1.7.2.1-1 lies in this set — it is both a
    transcription checksum and the quantization grid for the table
    reconciler (scripts/tbs_reconcile.py)."""
    from lteax_torch.phy.tables.turbo_qpp import VALID_K
    from lteax_torch.phy.fec.segmentation import segment_info

    out = set()
    for k in VALID_K:
        out.add(int(k) - 24)                       # C == 1
    for c in range(2, 66):                          # covers up to ~400k bits
        for k in VALID_K:
            out.add(c * (int(k) - 24) - 24)
    good = [t for t in sorted(out) if t > 0
            and segment_info(t + 24).c_minus == 0
            and segment_info(t + 24).f == 0]
    return tuple(good)


def get_tbs(i_tbs: int, n_prb: int, interp: bool = False) -> int:
    """36.213 Table 7.1.7.2.1-1 lookup — full 27 x 110 grid.

    ``interp`` is accepted for back-compat and ignored: the table is now
    complete (see module docstring for provenance; per-cell confidence via
    ``get_tbs_provenance``)."""
    if not 0 <= i_tbs <= 26:
        raise ValueError(f"I_TBS {i_tbs} out of range")
    if not 1 <= n_prb <= 110:
        raise ValueError(f"N_PRB {n_prb} out of range")
    return TBS_TABLE[i_tbs][n_prb - 1]


def get_tbs_provenance(i_tbs: int, n_prb: int) -> str:
    """Transcription confidence of a table cell: "A" (anchor — two
    independent transcriptions agree), "R" (row-recall pinned between
    anchors), "F" (fit — SE interpolation, NOT guaranteed spec-exact)."""
    return PROV[i_tbs][n_prb - 1]


def get_tbs_for_mcs(mcs: int, n_prb: int, interp: bool = False
                    ) -> tuple[int, str]:
    """-> (tbs, modulation scheme name)."""
    qm, itbs = mcs_to_qm_itbs(mcs)
    return get_tbs(itbs, n_prb, interp), MOD_BY_QM[qm]


# 36.213 §7.1.7.2: DCI format 1A with SI/P/RA-RNTI uses N_PRB_1A ∈ {2, 3}
# selected by the TPC LSB, as the TBS column regardless of actual PRBs.
def tbs_1a(i_tbs: int, n_prb_1a: int) -> int:
    assert n_prb_1a in (2, 3)
    return get_tbs(i_tbs, n_prb_1a)


def pick_mcs_for_size(n_bits: int, n_prb: int, max_mcs: int = 28,
                      interp: bool = False) -> tuple[int, int]:
    """Smallest MCS whose TBS at ``n_prb`` fits ``n_bits`` payload.

    (reference capability: ``liblte_phy_get_tbs_mcs_and_n_prb_for_dl`` —
    the scheduler's lookup.)  Returns (mcs, tbs)."""
    for mcs in range(max_mcs + 1):
        try:
            tbs, _ = get_tbs_for_mcs(mcs, n_prb, interp)
        except ValueError:
            continue
        if tbs >= n_bits:
            return mcs, tbs
    raise ValueError(f"{n_bits} bits exceed TBS at {n_prb} PRB")
