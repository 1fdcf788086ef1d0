"""The turbo tail's span a batch: CUDA events recorded by the benchmark
around each call into ``dec.turbo`` (its host syncs included), mean over
the window's batches (none on the CPU)."""

import numpy as np


def read(run):
    ms = run.record.turbo_ms
    return float(np.mean(ms)) if ms else None
