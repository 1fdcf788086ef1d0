"""Which keys of the reference's ``DecoderTuning`` change what a decode
computes, found by running the reference both ways in interpret mode on
the CPU at small shapes.  ``lteax_torch.phy.tuning.DecoderTuning.from_dict``
resolves the keys that change no value to the reference's defaults and
carries the values that change the decode into the port's fields; this
script is the evidence for each.

Prints one JSON line a comparison: the key, the values compared, what was
compared (a kernel's outputs, a de-match, a front's LLRs, or a decoder's
bits, CRC flags and iteration count), whether everything was equal, and
how many values differ and by how much at most.

- ``tb``, ``gb``: the natural-tile kernel (``half_iteration_pallas``) at
  each tile and lane fold, f32 and bf16, l, a_next and b_next.
- ``blane_unroll``: the layout kernel (``half_iteration_blane``) at each
  unroll against unroll 4, bf16 (interpret mode clamps an unroll above 4
  to 4; at 1 and 2 its bf16 renormalisation cadence follows the unroll).
- ``fused``: the unfused natural kernel against the fused one with frozen
  padding (``fused=False`` resolves to the freeze), f32 and bf16.
- ``nofreeze`` and ``combine_bf16``: the layout kernel's l with the knob
  against without it (and ``nofreeze`` against the pin and the freeze), at
  K = 1024, C = 8, win 128, acq 16, in f32, bf16 and bf16_f32store.
- ``struct_dematch``: ``soft_dematch`` structured against the gather at
  the SIC front's geometries (the one batch path that reads it while
  ``pallas_demap`` is on).
- ``blane_flat`` (DL), ``blane_flat_mimo`` (TM3), ``ul_planar_boundary``
  (UL), ``mimo_planar_boundary`` (TM3), ``print_iters`` (DL),
  ``layout_glue`` (DL) and ``pallas_demap`` (DL): the decoder at 6 PRB,
  B = 4, near its threshold, on the layout path (retry sizes 1), both
  values, on the same IQ; ``pallas_demap`` also the front's de-matched
  LLRs (the natural stage boundary), f32.

Run from the repository root (a few minutes)::

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/torch_tuning_keys.py
"""

import json
import os

import conftest  # noqa: F401  (JAX on the CPU)
import jax
import jax.numpy as jnp
import numpy as np

from lteax.kernels.turbo_mlm import (_pin_boundaries, half_iteration_blane,
                                     half_iteration_pallas)
from lteax.phy.channels import pdsch as pdsch_ref
from lteax.phy.channels import pusch as pusch_ref
from lteax.phy.config import PhyConfig as RefPhyConfig
from lteax.phy.tuning import DecoderTuning as RefTuning
from lteax.shard.pipeline import (make_batch_decoder_pallas,
                                  make_mimo_batch_decoder,
                                  make_pusch_batch_decoder)

from lteax_torch.phy.channels import pusch
from lteax_torch.sim import ul_gen
from lteax_torch.sim.dl_gen import DlCell, dl_subframes
from lteax_torch.sim.mimo_gen import MimoCell, mimo_subframes

WIN, ACQ, B = 128, 16, 4
# the layout path with its compacted retry at every batch size
SMALL_RETRY = dict(retry_m=1, retry_m_dl=1, retry_m_mimo=1, print_iters=True,
                   ofdm_dft="fft", ul_dft="fft")


def report(key, values, what, x, y=None):
    """One comparison's line: ``x`` and ``y`` are sequences of arrays to
    compare, or ``x`` a bool when ``y`` is None."""
    out = {"key": key, "values": values, "compared": what}
    if y is None:
        out["equal"] = bool(x)
    else:
        d = [np.abs(np.asarray(a, np.float32) - np.asarray(b, np.float32))
             for a, b in zip(x, y)]
        out.update(equal=all(not (e > 0).any() for e in d),
                   n_values=int(sum(e.size for e in d)),
                   n_differ=int(sum((e > 0).sum() for e in d)),
                   max_abs_diff=float(max(e.max() for e in d)))
    print(json.dumps(out), flush=True)


def _half_inputs(k: int, c: int):
    n = k + 3
    n_w = -(-n // WIN)
    rng = np.random.default_rng(k + c)
    u = (rng.standard_normal((c, n)) * 6.0).astype(np.float32)
    v = (rng.standard_normal((c, n)) * 6.0).astype(np.float32)
    a0 = (-np.abs(rng.standard_normal((c, n_w, 8))) * 3).astype(np.float32)
    b0 = (-np.abs(rng.standard_normal((c, n_w, 8))) * 3).astype(np.float32)
    a0, b0 = _pin_boundaries(jnp.asarray(a0), jnp.asarray(b0))
    return jnp.asarray(u), jnp.asarray(v), a0, b0


def kernels() -> None:
    k, c = 1024, 8
    u, v, a0, b0 = _half_inputs(k, c)
    n = k + 3
    nat = lambda **kw: half_iteration_pallas(u, v, a0, b0, WIN, ACQ, n,
                                             interpret=True, **kw)
    for mdtype in ("f32", "bf16"):
        base = nat(tb=8, gb=1, fused=True, pinpad=True, mdtype=mdtype)
        for tb in (1, 16):
            report("tb", [8, tb], f"half_iteration_pallas {mdtype}",
                   base, nat(tb=tb, gb=1, fused=True, pinpad=True,
                             mdtype=mdtype))
        for gb in (2, 4):
            report("gb", [1, gb], f"half_iteration_pallas {mdtype}",
                   base, nat(tb=8, gb=gb, fused=True, pinpad=True,
                             mdtype=mdtype))
        report("fused", [True, False],
               f"half_iteration_pallas {mdtype}, fused freeze vs unfused",
               nat(tb=8, gb=1, fused=True, pinpad=False, mdtype=mdtype),
               nat(tb=8, gb=1, fused=False, pinpad=False, mdtype=mdtype))
    n_w = -(-n // WIN)
    lay = lambda x: jnp.pad(x, ((0, 0), (0, n_w * WIN - n))).reshape(
        c, n_w, WIN).transpose(2, 1, 0)
    bl = lambda unroll=4, mdtype="bf16", **kw: half_iteration_blane(
        lay(u), lay(v), a0.transpose(1, 2, 0), b0.transpose(1, 2, 0), WIN,
        ACQ, n, tl=c, mdtype=mdtype, unroll=unroll, interpret=True,
        **{"pinpad": True, **kw})
    base = bl()
    for unroll in (1, 2, 8, 16):
        report("blane_unroll", [4, unroll], "half_iteration_blane bf16",
               base, bl(unroll))
    for mdtype in ("f32", "bf16", "bf16_f32store"):
        free = bl(mdtype=mdtype, nofreeze=True)[:1]
        for pad, pinpad in (("pinpad", True), ("freeze", False)):
            report("nofreeze", [False, True], f"half_iteration_blane "
                   f"{mdtype} l, against the {pad}",
                   bl(mdtype=mdtype, pinpad=pinpad)[:1], free)
        if mdtype != "f32":
            for pinpad in (True, False):
                report("combine_bf16", [False, True],
                       f"half_iteration_blane {mdtype} l, pinpad {pinpad}",
                       bl(mdtype=mdtype, pinpad=pinpad)[:1],
                       bl(mdtype=mdtype, pinpad=pinpad,
                          combine_bf16=True)[:1])


def dematch() -> None:
    rng = np.random.default_rng(5)
    for cell in (MimoCell(n_rb_dl=6, cfi=2, mcs=15, tm=4),
                 MimoCell(n_rb_dl=25, cfi=2, mcs=28)):
        g = cell.geom
        geom = pdsch_ref.pdsch_geometry(g.tbs, g.n_re, g.qm, g.rv)
        x = jnp.asarray(rng.standard_normal((3, geom.g)).astype(np.float32))
        report("struct_dematch", [False, True],
               f"soft_dematch, {cell.n_rb_dl} PRB MCS {cell.mcs}",
               np.array_equal(
                   np.asarray(pdsch_ref.soft_dematch(x, geom, False)),
                   np.asarray(pdsch_ref.soft_dematch(x, geom, True))))


def _decode(make, x):
    out = make()(x)
    return [np.asarray(o) for o in out]


def fronts() -> None:
    """The DL front's de-matched LLRs (the natural stage boundary) with the
    demap kernel and with the XLA demap, f32."""
    from lteax.shard.pipeline import _pdsch_stages
    os.environ["LTEAX_OFDM_DFT"] = "fft"
    dl = DlCell(n_rb_dl=6, mcs=28)
    g = dl.geom
    geom = pdsch_ref.pdsch_geometry(g.tbs, g.n_re, g.qm, g.rv)
    iq, _ = dl_subframes(dl, B, snr_db=19.5, seed=4)
    f = lambda demap: jax.jit(_pdsch_stages(
        RefPhyConfig(n_rb_dl=dl.n_rb_dl), dl.n_cell_id, dl.cfi, dl.prbs,
        dl.subframe, dl.rnti, geom, dl.scheme, 6,
        RefTuning(mdtype="f32", demap_in="f32", ofdm_dft="fft",
                  pallas_demap=demap), True, planar_boundary=False)[0])(
        jnp.asarray(iq))
    report("pallas_demap", [True, False], "DL front LLRs f32", [f(True)],
           [f(False)])


def decoders() -> None:
    os.environ["LTEAX_OFDM_DFT"] = "fft"
    os.environ["LTEAX_UL_DFT"] = "fft"
    dl = DlCell(n_rb_dl=6, mcs=28)
    g = dl.geom
    geom = pdsch_ref.pdsch_geometry(g.tbs, g.n_re, g.qm, g.rv)
    iq, _ = dl_subframes(dl, B, snr_db=19.5, seed=4)
    x = jnp.asarray(iq)
    for mdtype in ("bf16", "f32"):
        mk = lambda **kw: (lambda: make_batch_decoder_pallas(
            RefPhyConfig(n_rb_dl=dl.n_rb_dl), dl.n_cell_id, dl.cfi, dl.prbs,
            dl.subframe, dl.rnti, geom, dl.scheme, n_iter=6,
            tuning=RefTuning(**{**SMALL_RETRY, "mdtype": mdtype,
                                "demap_in": mdtype, **kw}),
            interpret=True))
        base = _decode(mk(), x)
        out = {"n_iter": int(base[2]), "ok": int(base[1].sum())}
        for key, val in (("blane_flat", False), ("layout_glue", False),
                         ("pallas_demap", False)):
            if mdtype == "f32" and key != "layout_glue":
                continue
            got = _decode(mk(**{key: val}), x)
            report(key, [not val, val], f"DL decode {mdtype} {out}, "
                   f"other n_iter {int(got[2])} ok {int(got[1].sum())}",
                   base, got)
        if mdtype == "bf16":
            got = _decode(mk(print_iters=False), x)
            report("print_iters", [True, False], "DL decode bf16 bits, ok",
                   base[:2], got)

    alloc = pusch.PuschAlloc(n_prb=6, rb_start=0, mcs_tbs=1192, qm=4)
    ul = ul_gen.UlCell(alloc=alloc, n_cell_id=301, subframe=2, rnti=0x5DEF)
    alloc_r = pusch_ref.PuschAlloc(n_prb=6, rb_start=0, mcs_tbs=1192, qm=4)
    iq, _ = ul_gen.ul_subframes(ul, B, snr_db=10.0, seed=4)
    mk = lambda **kw: (lambda: make_pusch_batch_decoder(
        alloc_r, ul.rnti, ul.subframe, ul.n_cell_id, n_iter=6,
        tuning=RefTuning(**{**SMALL_RETRY, **kw}), interpret=True))
    x = jnp.asarray(iq)
    base = _decode(mk(), x)
    got = _decode(mk(ul_planar_boundary=False), x)
    report("ul_planar_boundary", [True, False],
           f"UL decode bf16 n_iter {int(base[2])} ok {int(base[1].sum())}",
           base, got)

    tm3 = MimoCell(n_rb_dl=6, cfi=2, mcs=28)
    g = tm3.geom
    geom = pdsch_ref.pdsch_geometry(g.tbs, g.n_re, g.qm, g.rv)
    iq, _ = mimo_subframes(tm3, B, snr_db=23.0, seed=4)
    mk = lambda **kw: (lambda: make_mimo_batch_decoder(
        RefPhyConfig(n_rb_dl=tm3.n_rb_dl, n_ant=2), tm3.n_cell_id, tm3.cfi,
        tm3.prbs, tm3.subframe, tm3.rnti, geom, tm3.scheme, n_iter=6,
        tuning=RefTuning(**{**SMALL_RETRY, **kw}), tm=tm3.tm,
        cb_index=tm3.cb_index, interpret=True))
    x = jnp.asarray(iq)
    base = _decode(mk(), x)
    for key in ("blane_flat_mimo", "mimo_planar_boundary"):
        got = _decode(mk(**{key: False}), x)
        report(key, [True, False], f"TM3 MMSE decode bf16 n_iter "
               f"{int(base[2])} ok {int(base[1].sum())}", base, got)


if __name__ == "__main__":
    kernels()
    dematch()
    fronts()
    decoders()
