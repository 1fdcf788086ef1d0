"""The device time a batch of the turbo tail's CRCs: CRC24B,
desegmentation and CRC24A, the CUDA events of the program's ``turbo.crc``
stage, mean over the traced batches of ``benchmark/spans.py`` (none on the
CPU)."""

from benchmark import spans


def read(run):
    return spans.stage_ms(run, "turbo.crc")
