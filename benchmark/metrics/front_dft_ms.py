"""The device time a batch of the front's OFDM demod (the DL's IQ conversion
and DFT; the UL's IDFT de-precoding): the CUDA events of the program's
``front.dft`` stage, mean over the traced batches of ``benchmark/spans.py``
(none on the CPU)."""

from benchmark import spans


def read(run):
    return spans.stage_ms(run, "front.dft")
