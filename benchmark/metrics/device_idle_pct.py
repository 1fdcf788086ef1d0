"""The device's idle share of the traced batches: 100 (1 - busy / window),
busy the union of every kernel, copy and set in the profiler's trace."""


def read(run):
    tr = run.trace
    if not tr or not tr["busy_s"]:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
