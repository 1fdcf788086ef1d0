"""The front's span a batch: CUDA events recorded by the benchmark around
each call into ``dec.front``, mean over the window's batches (none on the
CPU)."""

import numpy as np


def read(run):
    ms = run.record.front_ms
    return float(np.mean(ms)) if ms else None
