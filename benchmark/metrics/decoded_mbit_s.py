"""Decoded throughput: the TBS bits of every transport block of the
window's batches that passed its CRCs and equals what was sent, over the
window's wall time (its start to the last batch's end), host clock."""


def read(run):
    rec = run.record
    return rec.good * run.cfg["tbs"] / rec.wall_s / 1e6
