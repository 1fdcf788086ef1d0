"""Counted device -> host reads.

The scanner path branches on host values: each point where it needs them
brings one small tensor home through :func:`read`, and ``READS`` counts
those reads where they happen (set it to 0 before the run to count).
"""

from __future__ import annotations

import torch

READS = 0
"""Device -> host reads made through :func:`read` since the last reset."""


def read(t: torch.Tensor) -> list:
    """One counted device -> host read of ``t`` as a (nested) list."""
    global READS
    READS += 1
    return t.tolist()
