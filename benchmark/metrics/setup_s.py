"""Set-up: from the run's first line to the window's start (imports,
inputs from the seed, the decoder's plans, one decode of every batch, the
first of which builds or loads the kernels), host clock."""


def read(run):
    return run.setup_s
