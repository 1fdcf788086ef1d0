"""The turbo tail's full iterations a batch (``TurboStats.n_iter``, the
compacted retry's included), mean over the window's batches."""

import numpy as np


def read(run):
    return float(np.mean(run.record.iters))
