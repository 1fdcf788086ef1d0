"""The device time a batch of the front's demap: the staging of its inputs and
the demap kernel (K3): the CUDA events of the program's ``front.demap``
stage, mean over the traced batches of ``benchmark/spans.py`` (none on the
CPU)."""

from benchmark import spans


def read(run):
    return spans.stage_ms(run, "front.demap")
