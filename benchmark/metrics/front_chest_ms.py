"""The device time a batch of the front's channel and noise estimates and its
equaliser: the CUDA events of the program's ``front.chest`` stage, mean over
the traced batches of ``benchmark/spans.py`` (none on the CPU)."""

from benchmark import spans


def read(run):
    return spans.stage_ms(run, "front.chest")
