"""PHICH: HARQ indicator channel (36.212 §5.3.5, 36.211 §6.9), normal
duration / normal CP; counterpart of ``lteax.phy.channels.phich``.

Each PHICH group carries up to 8 ACK/NACK bits code-multiplexed with
length-4 orthogonal sequences (4 real + 4 imaginary), spread over 12 REs
(3 REGs in symbol 0).  Encoding superposes all PHICHs of a group; decoding
despreads with the conjugate sequence.

The encoder is numpy, with the reference's signature.  :func:`phich_decode`
despreads every (group, sequence) of a subframe in one complex matmul on
the REs' device; the reference's per-call :func:`phich_group_decode` is a
wrapper over it with its signature and sign convention, and
:func:`phich_decode_subframe` gathers a grid's PHICH REs
(``grid.phich_flat_idx``) and brings the metrics home in one read
(``lteax_torch.host.read``).
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from lteax_torch.host import read
from lteax_torch.phy import seq
from lteax_torch.phy.config import PhyConfig
from lteax_torch.phy.grid import n_phich_groups, phich_flat_idx

N_SF = 4
_W_REAL = np.array([
    [1, 1, 1, 1],
    [1, -1, 1, -1],
    [1, 1, -1, -1],
    [1, -1, -1, 1],
], dtype=np.complex64)
W_SEQS = np.concatenate([_W_REAL, 1j * _W_REAL])      # (8, 4)


def _c_init(n_cell_id: int, subframe: int) -> int:
    ns = 2 * subframe
    return (ns // 2 + 1) * (2 * n_cell_id + 1) * 512 + n_cell_id


@lru_cache(maxsize=None)
def _scrambler(n_cell_id: int, subframe: int) -> np.ndarray:
    """(12,) complex64 +-1 cell-specific scrambling of one PHICH group."""
    c = seq.gold_sequence_np(_c_init(n_cell_id, subframe), 12)
    return (1.0 - 2.0 * c).astype(np.complex64)


def phich_group_encode(acks: dict[int, int], n_cell_id: int,
                       subframe: int) -> np.ndarray:
    """acks: {n_seq (0..7): harq bit (1 = ACK)} -> (12,) superposed symbols."""
    scr = _scrambler(n_cell_id, subframe)
    out = np.zeros(12, dtype=np.complex64)
    for n_seq, bit in acks.items():
        # HI bit b (1 = ACK), BPSK per 36.211 §7.1.1: (1-2b)(1+j)/sqrt(2)
        z = np.complex64((1 - 2 * bit) * (1 + 1j) / np.sqrt(2))
        out += np.tile(W_SEQS[n_seq], 3) * scr * z
    return out


@lru_cache(maxsize=None)
def despread_matrix(n_cell_id: int, subframe: int) -> np.ndarray:
    """(12, 8) complex64: column s is conj(w_s * scr) * (1 - j) / sqrt(2),
    so the real parts of ``re_vals @ M`` are the 8 sequences' metrics."""
    w = np.tile(W_SEQS, (1, 3)) * _scrambler(n_cell_id, subframe)[None, :]
    return (np.conj(w).T * np.complex64((1 - 1j) / np.sqrt(2))
            ).astype(np.complex64)


def phich_decode(re_vals: torch.Tensor, n_cell_id: int,
                 subframe: int) -> torch.Tensor:
    """re_vals (..., 12) complex, one PHICH group each -> (..., 8) float32
    soft metrics of the 8 sequences on the REs' device (positive = bit 0 =
    NACK, negative = bit 1 = ACK; LLR convention)."""
    m = torch.as_tensor(despread_matrix(n_cell_id, subframe),
                        device=re_vals.device)
    return (re_vals.to(torch.complex64) @ m).real


def phich_group_decode(re_vals: np.ndarray, n_cell_id: int, subframe: int,
                       n_seq: int) -> float:
    """Despread one PHICH (the reference's per-call API over
    :func:`phich_decode`): -> soft metric for the HI bit (negative = ACK)."""
    y = torch.as_tensor(np.asarray(re_vals, dtype=np.complex64))
    return float(phich_decode(y, n_cell_id, subframe)[n_seq])


@lru_cache(maxsize=None)
def phich_subframe_idx(cfg: PhyConfig, n_cell_id: int, ng: float) -> np.ndarray:
    """(n_groups, 12) flat RE indices of every PHICH group of a subframe."""
    return np.stack([phich_flat_idx(cfg, n_cell_id, ng, g)
                     for g in range(n_phich_groups(cfg, ng))])


def phich_decode_subframe(grid_flat: torch.Tensor, cfg: PhyConfig,
                          n_cell_id: int, ng: float,
                          subframe: int) -> np.ndarray:
    """Every (group, sequence) of one subframe: grid_flat (n_sym*n_sc,)
    complex (equalised REs) -> (n_groups, 8) float32 numpy metrics, in one
    read; HI bit 1 (ACK) where the metric is negative."""
    idx = torch.as_tensor(phich_subframe_idx(cfg, n_cell_id, ng)
                          .astype(np.int64), device=grid_flat.device)
    return np.asarray(read(phich_decode(grid_flat[idx], n_cell_id,
                                        subframe)), dtype=np.float32)
