"""LTE band <-> EARFCN <-> frequency mapping (36.101 §5.7.3), FDD + TDD.

(reference capability: ``liblte/src/liblte_interface.cc ::
liblte_interface_dl_earfcn_to_frequency`` and the first/last-EARFCN tables.)

F_DL(MHz) = F_DL_low + 0.1 * (N_DL - N_Offs_DL);  UL analogous.

The port's own copy of ``lteax/stack/bands.py``: the port
imports nothing of the JAX package, and ``tests/test_torch_plans.py``
holds the two equal.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class Band:
    band: int
    f_dl_low: float        # MHz
    n_offs_dl: int
    n_dl_max: int          # inclusive
    f_ul_low: float
    n_offs_ul: int
    n_ul_max: int
    tdd: bool = False      # TDD bands: UL == DL (same EARFCN range)


# All Rel-11 FDD bands (36.101 Table 5.7.3-1; the reference's
# liblte_interface carries the same generation of the table)
BANDS: tuple[Band, ...] = (
    Band(1, 2110.0, 0, 599, 1920.0, 18000, 18599),
    Band(2, 1930.0, 600, 1199, 1850.0, 18600, 19199),
    Band(3, 1805.0, 1200, 1949, 1710.0, 19200, 19949),
    Band(4, 2110.0, 1950, 2399, 1710.0, 19950, 20399),
    Band(5, 869.0, 2400, 2649, 824.0, 20400, 20649),
    Band(6, 875.0, 2650, 2749, 830.0, 20650, 20749),
    Band(7, 2620.0, 2750, 3449, 2500.0, 20750, 21449),
    Band(8, 925.0, 3450, 3799, 880.0, 21450, 21799),
    Band(9, 1844.9, 3800, 4149, 1749.9, 21800, 22149),
    Band(10, 2110.0, 4150, 4749, 1710.0, 22150, 22749),
    Band(11, 1475.9, 4750, 4949, 1427.9, 22750, 22949),
    Band(12, 729.0, 5010, 5179, 699.0, 23010, 23179),
    Band(13, 746.0, 5180, 5279, 777.0, 23180, 23279),
    Band(14, 758.0, 5280, 5379, 788.0, 23280, 23379),
    Band(17, 734.0, 5730, 5849, 704.0, 23730, 23849),
    Band(18, 860.0, 5850, 5999, 815.0, 23850, 23999),
    Band(19, 875.0, 6000, 6149, 830.0, 24000, 24149),
    Band(20, 791.0, 6150, 6449, 832.0, 24150, 24449),
    Band(21, 1495.9, 6450, 6599, 1447.9, 24450, 24599),
    Band(22, 3510.0, 6600, 7399, 3410.0, 24600, 25399),
    Band(23, 2180.0, 7500, 7699, 2000.0, 25500, 25699),
    Band(24, 1525.0, 7700, 8039, 1626.5, 25700, 26039),
    Band(25, 1930.0, 8040, 8689, 1850.0, 26040, 26689),
    Band(26, 859.0, 8690, 9039, 814.0, 26690, 27039),
    Band(27, 852.0, 9040, 9209, 807.0, 27040, 27209),
    Band(28, 758.0, 9210, 9659, 703.0, 27210, 27659),
    Band(30, 2350.0, 9770, 9869, 2305.0, 27660, 27759),
    Band(31, 462.5, 9870, 9919, 452.5, 27760, 27809),
    # TDD bands 33-44 (36.101 Table 5.7.3-1; the reference's
    # liblte_interface band map includes the TDD rows too).  UL = DL.
    Band(33, 1900.0, 36000, 36199, 1900.0, 36000, 36199, tdd=True),
    Band(34, 2010.0, 36200, 36349, 2010.0, 36200, 36349, tdd=True),
    Band(35, 1850.0, 36350, 36949, 1850.0, 36350, 36949, tdd=True),
    Band(36, 1930.0, 36950, 37549, 1930.0, 36950, 37549, tdd=True),
    Band(37, 1910.0, 37550, 37749, 1910.0, 37550, 37749, tdd=True),
    Band(38, 2570.0, 37750, 38249, 2570.0, 37750, 38249, tdd=True),
    Band(39, 1880.0, 38250, 38649, 1880.0, 38250, 38649, tdd=True),
    Band(40, 2300.0, 38650, 39649, 2300.0, 38650, 39649, tdd=True),
    Band(41, 2496.0, 39650, 41589, 2496.0, 39650, 41589, tdd=True),
    Band(42, 3400.0, 41590, 43589, 3400.0, 41590, 43589, tdd=True),
    Band(43, 3600.0, 43590, 45589, 3600.0, 43590, 45589, tdd=True),
    Band(44, 703.0, 45590, 46589, 703.0, 45590, 46589, tdd=True),
)


def is_tdd_band(band: int) -> bool:
    return _BY_BAND[band].tdd

_BY_BAND = {b.band: b for b in BANDS}


def dl_earfcn_to_freq_mhz(earfcn: int) -> float:
    for b in BANDS:
        if b.n_offs_dl <= earfcn <= b.n_dl_max:
            return b.f_dl_low + 0.1 * (earfcn - b.n_offs_dl)
    raise ValueError(f"DL EARFCN {earfcn} not in any supported band")


def dl_freq_to_earfcn(band: int, freq_mhz: float) -> int:
    b = _BY_BAND[band]
    n = b.n_offs_dl + round((freq_mhz - b.f_dl_low) / 0.1)
    if not b.n_offs_dl <= n <= b.n_dl_max:
        raise ValueError(f"{freq_mhz} MHz outside band {band}")
    return n


def band_of_dl_earfcn(earfcn: int) -> int:
    for b in BANDS:
        if b.n_offs_dl <= earfcn <= b.n_dl_max:
            return b.band
    raise ValueError(f"DL EARFCN {earfcn} unknown")


def band_dl_earfcns(band: int, step: int = 100) -> list[int]:
    """Scan list across a band (the reference's scanner retune list; here a
    channel-shard axis)."""
    b = _BY_BAND[band]
    return list(range(b.n_offs_dl, b.n_dl_max + 1, step))


def ul_earfcn_for_dl(dl_earfcn: int) -> int:
    b = _BY_BAND[band_of_dl_earfcn(dl_earfcn)]
    return b.n_offs_ul + (dl_earfcn - b.n_offs_dl)
