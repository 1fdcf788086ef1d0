"""The decoder layer's host syncs a batch (the turbo schedule's reads of a
device flag, ``TurboStats.syncs``), mean over the window's batches."""

import numpy as np


def read(run):
    return float(np.mean(run.record.syncs))
