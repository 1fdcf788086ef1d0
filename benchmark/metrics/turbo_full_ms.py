"""The device time a batch of the turbo tail's full-batch work: the
batch's layout (``turbo.layout``: its systematic, parity and interleaved
streams, the zero state) and its full-batch iterations, each with its CRC
parity check and its host read of the failing count (``turbo.iter``); the
CUDA events of those stages summed a batch, mean over the traced batches of
``benchmark/spans.py`` (none on the CPU)."""

from benchmark import spans


def read(run):
    return spans.stage_ms(run, "turbo.layout", "turbo.iter")
