"""PCFICH: control format indicator channel (36.212 §5.3.4, 36.211 §6.7),
counterpart of ``lteax.phy.channels.pcfich``.

The encoder is numpy (the cell generator); :func:`pcfich_decode` runs in
torch on the LLRs' device and leaves the CFI there for the caller to read.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from lteax_torch.phy import seq
from lteax_torch.phy.mod import modulate


@lru_cache(maxsize=None)
def cfi_codewords() -> np.ndarray:
    """(3, 32) int — 36.212 Table 5.3.4-1: CFI n -> repeated pattern."""
    base = {1: [0, 1, 1], 2: [1, 0, 1], 3: [1, 1, 0]}
    out = np.zeros((3, 32), dtype=np.int32)
    for cfi in (1, 2, 3):
        out[cfi - 1] = np.tile(base[cfi], 11)[:32]
    return out


def _c_init(n_cell_id: int, subframe: int) -> int:
    ns = 2 * subframe
    return (ns // 2 + 1) * (2 * n_cell_id + 1) * 512 + n_cell_id


def pcfich_encode(cfi: int, n_cell_id: int, subframe: int) -> np.ndarray:
    """-> (16,) QPSK symbols."""
    bits = cfi_codewords()[cfi - 1]
    c = seq.gold_sequence_np(_c_init(n_cell_id, subframe), 32)
    return modulate((bits + c) % 2, "qpsk")


def pcfich_decode(llrs: torch.Tensor, n_cell_id: int, subframe: int):
    """llrs (32,) from the 16 PCFICH REs -> (cfi, scores (3,)), both on the
    LLRs' device: the descrambled LLRs correlated with the three
    codewords, the best one's CFI (the first on a tie)."""
    dev = llrs.device
    sgn = torch.as_tensor(seq.scrambling_symbols_np(
        _c_init(n_cell_id, subframe), 32), device=dev)
    cw_sgn = torch.as_tensor((1.0 - 2.0 * cfi_codewords()).astype(np.float32),
                             device=dev)
    scores = cw_sgn @ (llrs.to(torch.float32) * sgn)
    return torch.argmax(scores) + 1, scores
