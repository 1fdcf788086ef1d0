"""Kernel launches a batch: every kernel in the profiler's trace of the
device's activity over the traced batches, over the number of batches
(none on the CPU)."""


def read(run):
    kernels = (run.trace or {}).get("kernels")
    if not kernels:
        return None
    return len(kernels) / run.traffic["trace_batches"]
