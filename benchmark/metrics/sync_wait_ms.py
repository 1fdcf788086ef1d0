"""The host's wait a batch at the decoder's syncs (``TurboStats.wait_s``:
the host clock around each read of a device flag or count), in ms, mean
over the batches of ``benchmark/spans.py``'s first pass."""

from benchmark import spans


def read(run):
    wait_s = spans.counter_mean(run, "wait_s")
    return None if wait_s is None else wait_s * 1e3
