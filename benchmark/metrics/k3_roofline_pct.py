"""K3, the demap kernel (``csrc/demap.cu``): the sum of its launches'
bounds (``benchmark/counts.py``, one launch a batch of B subframes, its
input and output dtypes from the kernel's template arguments) over the sum
of their device times in the traced batches, in percent.  Every launch is
counted at B subframes whatever the system's ``codewords``: the MIMO front
(``pipeline.MimoFront``) launches K3 once per codeword over the B
subframes, which is one such launch each."""

from benchmark.counts import bound_s, demap_work


def _bytes(name: str) -> tuple[int, int]:
    args = name.split("<", 1)[1].rstrip(">").split(",")
    size = lambda a: 2 if "bfloat16" in a else 4
    return size(args[1]), size(args[2])


def read(run):
    launches = [k for k in (run.trace or {}).get("kernels", [])
                if "demap_kernel" in k[0]]
    if not launches:
        return None
    n, npad = run.system.demap_columns(run.cfg)
    bound = sum(bound_s(demap_work(run.traffic["batch"], n, npad,
                                    run.cfg["qm"], *_bytes(name)))
                for name, _, _ in launches)
    return 100.0 * bound / sum(s for _, _, s in launches)
