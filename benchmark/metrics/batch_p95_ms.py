"""The 95th percentile of every batch's latency in the window: from the
call to the decoder until its bits and CRC flags are in host memory, host
clock."""

import numpy as np


def read(run):
    return float(np.percentile(run.record.latencies, 95)) * 1e3
