"""RRC MasterInformationBlock codec (exact 36.331 §6.2.2 24-bit encoding).

(reference capability: ``liblte/src/liblte_rrc.cc ::
liblte_rrc_pack_bcch_bch_msg`` / ``liblte_rrc_unpack_bcch_bch_msg``.)

The port's own copy of the MIB part of ``lteax/stack/rrc.py`` (the port
imports nothing of the JAX package); ``tests/test_torch_plans.py`` holds the
two equal.  The SIB1 / SystemInformation / Paging codecs are not ported yet.
"""

from __future__ import annotations

import dataclasses

import numpy as np

BW_ENUM = (6, 15, 25, 50, 75, 100)
PHICH_RES_ENUM = (1 / 6, 1 / 2, 1, 2)
PHICH_RES_NAMES = ("1/6", "1/2", "1", "2")


@dataclasses.dataclass
class Mib:
    n_rb_dl: int
    phich_duration_extended: bool
    phich_resource: float      # 1/6, 1/2, 1, 2
    sfn: int                   # full SFN; only sfn>>2 is carried


def pack_mib(m: Mib) -> np.ndarray:
    bits: list[int] = []
    bw = BW_ENUM.index(m.n_rb_dl)
    for i in (2, 1, 0):
        bits.append((bw >> i) & 1)
    bits.append(1 if m.phich_duration_extended else 0)
    res = PHICH_RES_ENUM.index(m.phich_resource)
    for i in (1, 0):
        bits.append((res >> i) & 1)
    sfn8 = (m.sfn >> 2) & 0xFF
    for i in range(7, -1, -1):
        bits.append((sfn8 >> i) & 1)
    bits.extend([0] * 10)
    return np.asarray(bits, dtype=np.int32)


def unpack_mib(bits: np.ndarray, sfn_mod4: int = 0) -> Mib:
    b = [int(x) for x in bits]
    bw = (b[0] << 2) | (b[1] << 1) | b[2]
    dur = bool(b[3])
    res = (b[4] << 1) | b[5]
    sfn8 = 0
    for i in range(8):
        sfn8 = (sfn8 << 1) | b[6 + i]
    return Mib(n_rb_dl=BW_ENUM[bw], phich_duration_extended=dur,
               phich_resource=PHICH_RES_ENUM[res],
               sfn=(sfn8 << 2) | (sfn_mod4 & 3))
