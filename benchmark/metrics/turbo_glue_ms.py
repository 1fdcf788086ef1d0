"""The turbo tail's glue: the device time a batch of every kernel, copy
and set launched inside the program's ``lteax.turbo`` range other than the
turbo kernel (``turbo_half*``), each attributed by its correlation to the
runtime call on the loop's thread (``benchmark/spans.py``'s ``reduce``);
none on the CPU."""

from benchmark import spans


def read(run):
    tr = spans.measure(run).get("trace")
    if not tr or not any(name.startswith("lteax.turbo")
                         for name in tr["by_span"]):
        return None
    return tr["turbo_glue_s"] / tr["batches"] * 1e3
