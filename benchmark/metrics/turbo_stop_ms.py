"""The device time a batch of the turbo tail's stopping loop: the compacted
retry (``turbo.compact``: the gather of the failing blocks and their
early-stop loop) and the full-batch early-stop loop (``turbo.earlystop``),
the CUDA events of those stages summed a batch, mean over the traced
batches of ``benchmark/spans.py`` (none on the CPU)."""

from benchmark import spans


def read(run):
    return spans.stage_ms(run, "turbo.compact", "turbo.earlystop")
