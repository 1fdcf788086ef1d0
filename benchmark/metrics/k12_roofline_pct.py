"""K1/K2, the turbo half-iteration kernel (``csrc/turbo.cu``): the sum of
its launches' bounds (``benchmark/counts.py``) over the sum of their device
times in the traced batches, in percent.  A launch's codeblocks follow
from its grid against the largest grid of the same kernel, which is a
full-batch launch (B x codewords x C codeblocks: every transport block of
the batch's subframe rows): every decode starts with one."""

from benchmark.counts import bound_s, turbo_half_work
from benchmark.spec import codewords


def read(run):
    launches = [k for k in (run.trace or {}).get("kernels", [])
                if "turbo_half" in k[0]]
    if not launches:
        return None
    geom = run.system.geometry(run.cfg)
    full = run.traffic["batch"] * codewords(run.system) * geom.c
    widest = {}
    for name, grid, _ in launches:
        widest[name] = max(widest.get(name, 0), grid[0])
    t = run.cfg["tuning"]
    bound = sum(bound_s(turbo_half_work(
        round(full * grid[0] / widest[name]), geom.k + 3, t["win"],
        t["acq"], "bf16" if "bf16" in name else "f32"))
        for name, grid, _ in launches)
    return 100.0 * bound / sum(s for _, _, s in launches)
