"""The turbo tail's full-batch iterations a batch (``TurboStats.full``: of
``turbo_iters``, those over every codeblock of the batch), mean over the
batches of ``benchmark/spans.py``'s first pass."""

from benchmark import spans


def read(run):
    return spans.counter_mean(run, "full")
