"""Max-log-MAP turbo half-iteration kernel and the batched turbo decoder.

Port of ``lteax/kernels/turbo_mlm.py``: the TPU kernels
``half_iteration_blane`` and ``half_iteration_pallas`` (one function on two
tiles) become ONE CUDA kernel on the natural (C, K+3) layout,
``csrc/turbo.cu`` (a block owns consecutive windows of one codeblock, 8
lanes carry each window's chain, the alpha/beta stores stay in shared
memory; see the note in the source), in the reference's forms: an f32 or
bf16 trellis (``mdtype`` "f32", or "bf16" and "bf16_f32store", whose
stores hold the same bf16 values; the bf16 kernel carries two codeblocks
a lane in bf16x2 registers), pinned, frozen or free padding (``pinpad``,
``nofreeze``) and, in bf16, the combine's sums and maxes in f32 or in
bf16 (``combine_bf16``), and the layout kernel's bf16 renormalisation at the
reference's ``blane_unroll`` (:func:`renorm_steps`).  The reference's
unfused natural kernel (``_make_kernel``, ``fused=False``, and acq > win/2:
whole-window alpha and beta stores, then one combine pass) runs as
instances of the same two kernels on the same lanes and walk (``kUnf``:
its ungrouped combine, its renormalisation over the whole window, acq up
to win, any even win), in f32, bf16 and bf16_f32store, whose combines
differ.
:func:`half_iteration_plain` is the same arithmetic in plain torch,
vectorised the way the Pallas body is: a Python loop over trellis steps on
(C, n_w) tensors.  :func:`half_iteration_raw`
runs it for CPU tensors and launches the kernel for CUDA tensors.

:func:`turbo_decode_batch` is the natural-path half of
``turbo_decode_batch_pallas``: DEC1/DEC2 halves with the QPP gathers,
pinned window boundaries, next-iteration init (NII), the half-iteration CRC
early stop and the multi-level compacted retry.  On the reference's layout
path in bf16 the glue after each half (the extrinsic, the QPP gather into
the next half's input, the NII hand-over and the CRC parity) is one kernel,
``csrc/turbo_glue.cu`` (:func:`turbo_glue`; its plain version
:func:`turbo_glue_plain`).  The reference's
``lax.while_loop``/``lax.cond`` become host branches on one device flag
each; :class:`TurboStats` counts those host syncs and the host seconds
they block.  The batch's layout (its systematic, parity and interleaved
streams and the zero state), the full-batch iterations, the compacted retry
and the full-batch early-stop loop are the stages ``turbo.layout``,
``turbo.iter``, ``turbo.compact`` and ``turbo.earlystop``
(:class:`lteax_torch.utils.trace.stage`).
"""

from __future__ import annotations

import dataclasses
import time
from functools import lru_cache

import numpy as np
import torch

from lteax_torch.phy.tables.turbo_qpp import qpp_deinterleaver, qpp_interleaver
from lteax_torch.phy.fec.crc import crc_matrix, crc_parity_ok, pack_rows
from lteax_torch.phy.fec.turbo import _unrolled_wiring
from lteax_torch.phy.tuning import MDTYPES, blane_renorm_unroll
from lteax_torch.utils.trace import stage

NEG = -1e9
PIN = 512.0
"""Pinned-padding magnitude: dead positions get u += PIN in the beta sweep,
so the state-0 self-loop dominates every dead step (the termination pin)."""

WINDOWS_PER_BLOCK = 4
"""Consecutive windows of a codeblock that one block of the kernel owns in
the decoders (8 lanes each, so one warp a block): 21.4 KB of shared memory
a block at win 128, ten blocks (40 chains) an SM.  The bf16 kernel's
window carries two codeblocks: 21.0 KB, ten blocks (80 chains); 4 is its
fastest count too (``bench/turbo_variants.py --mdtype bf16``)."""

LAUNCHES = 0
"""Launches of the f32 pinned-padding form since the last reset
(plain-version calls do not count)."""

_FUSED_FORMS = (
    "bf16", "bf16_freeze", "bf16_nofreeze", "bf16_combine",
    "bf16_combine_freeze", "bf16_combine_nofreeze")
FORM_LAUNCHES = {f: 0 for f in (
    "f32_freeze", "f32_nofreeze", *_FUSED_FORMS,
    *(f"{f}_u{u}" for u in (1, 2) for f in _FUSED_FORMS),
    "f32_unfused", "bf16_unfused", "bf16_f32store_unfused")}
"""Launches of every other form, as :data:`LAUNCHES`: by trellis (``bf16``:
the kernel of both bf16 mdtypes), ``_combine`` with the bf16 combine,
``_freeze`` / ``_nofreeze`` for frozen / free padding, ``_u<U>`` with the
layout kernel's renormalisation at unroll U (1 and 2 here; another U
gets its key at its first launch), and the unfused kernel by mdtype
(:func:`_form`)."""

_TRELLIS = {"f32": "f32", "bf16": "bf16", "bf16_f32store": "bf16"}
"""The kernel's trellis of each ``mdtype``."""

GLUE_LAUNCHES = 0
"""Launches of the glue kernel (:func:`turbo_glue`) since the last reset."""

GLUE_TABLES = {1: ("pi", "m_nat"), 2: ("inv", "m_perm")}
"""The permutation and the CRC matrix (:func:`_tables`' keys) of the glue
after DEC1 (1) and after DEC2 (2)."""


def _gammas(uu, vv):
    gpp = 0.5 * (uu + vv)
    gpm = 0.5 * (uu - vv)
    return (gpp, gpm, -gpm, -gpp)


def _live_masks(win: int, acq: int, n_w: int, n: int, device):
    """(n_w, win) / (n_w, acq) bool: trellis position inside [0, n)."""
    w = np.arange(n_w)[:, None]
    pos_main = win * w + np.arange(win)[None, :]
    pos_aacq = win * w - acq + np.arange(acq)[None, :]
    pos_bacq = win * (w + 1) + np.arange(acq)[None, :]
    t = lambda x: torch.as_tensor(x, device=device)
    return (t(pos_main < n), t((pos_aacq >= 0) & (pos_aacq < n)),
            t(pos_bacq < n))


def _metric_dtypes(mdtype: str):
    """(metric dtype, extrinsic-carry dtype) of an ``mdtype``
    (``turbo_mlm.py:549``, ``:1246`` in the reference; the store dtype
    changes no value and is the kernel's alone)."""
    if mdtype not in MDTYPES:
        raise ValueError(f"mdtype {mdtype!r}: one of {MDTYPES}")
    if mdtype == "f32":
        return torch.float32, torch.float32
    return torch.bfloat16, (torch.bfloat16 if mdtype == "bf16"
                            else torch.float32)


def renorm_period(win: int) -> int:
    """Trellis steps between two bf16 renormalisations (a -= a[0],
    b -= b[0]) of the fused kernels' main sweeps: 4, or 2 when win/2 is not
    a multiple of 4, counted over the half window (the fused kernel's loop
    body, ``turbo_mlm.py:304``; the layout kernel's ``_renorm_at`` at its
    default unrolls).  The layout kernel at ``blane_unroll`` 1 or 2 moves
    them (:func:`renorm_steps`); the unfused kernel counts over the whole
    window (:func:`unfused_period`); the acquisition never renormalises."""
    return 4 if (win // 2) % 4 == 0 else 2


def unfused_period(win: int) -> int:
    """The unfused kernel's bf16 renormalisation period: every 4 steps
    counted over the whole window, or 2 when win is not a multiple of 4
    (``turbo_mlm.py:147``, ``:160-168``).  At win 36 it is 4 where the
    fused kernels' is 2."""
    return 4 if win % 4 == 0 else 2


def renorm_unroll(mdtype: str, win: int, unroll: int | None) -> int | None:
    """The layout kernel's renormalisation unroll where it moves the bf16
    renormalisation off :func:`renorm_period`'s steps, else None: the
    reference's ``blane_unroll`` resolved as ``_make_kernel_blane`` does
    (:func:`lteax_torch.phy.tuning.blane_renorm_unroll`); 1 and 2 at win
    128, 1 and 3 at win 36.  An f32 trellis never renormalises."""
    if unroll is None or _metric_dtypes(mdtype)[0] == torch.float32:
        return None
    u = blane_renorm_unroll(win, unroll)
    return None if renorm_steps(win, u) == renorm_steps(win) else u


def renorm_steps(win: int, unroll: int | None = None) -> frozenset:
    """The steps t of a window after which the fused kernels renormalise a
    bf16 trellis: :func:`renorm_period`'s, or at a resolved layout-kernel
    unroll U those of ``_renorm_at`` (``turbo_mlm.py:473-476``): t mod U
    is U - 1 or 3 mod 4 (every step at U = 1, every other at U = 2)."""
    if unroll is None:
        p = renorm_period(win)
        return frozenset(t for t in range(win) if (t + 1) % p == 0)
    return frozenset(t for t in range(win)
                     if (t % unroll) % 4 == 3 or t % unroll == unroll - 1)


def resolve_form(mdtype: str, pinpad: bool, nofreeze: bool = False,
                 combine_bf16: bool = False,
                 fused: bool = True) -> tuple[bool, bool, bool]:
    """(pinpad, nofreeze, combine_bf16) as the reference's kernel takes
    them: ``nofreeze`` turns the pin off (``turbo_mlm.py:583``), and the
    bf16 combine needs bf16 stores (``combine_bf16 and is_bf16``; under
    "bf16_f32store" one operand of each sum is an f32 store, which makes
    the sum f32).  The unfused kernel (``fused`` False) freezes: it has
    neither the pin nor ``nofreeze`` (``turbo_mlm.py:1219-1220``), nor
    the bf16 combine."""
    _metric_dtypes(mdtype)
    if not fused:
        return False, False, False
    nofreeze = bool(nofreeze)
    return (bool(pinpad) and not nofreeze, nofreeze,
            bool(combine_bf16) and mdtype == "bf16")


def half_iteration_plain(u, v, a_init, b_init, win: int, acq: int,
                         mdtype: str = "f32", pinpad: bool = True,
                         nofreeze: bool = False, combine_bf16: bool = False,
                         *, fused: bool = True, unroll: int | None = None):
    """Plain torch version of the kernel.

    u, v (C, n); a_init, b_init (C, n_w, 8) f32 (pinned by the caller).
    Returns (l (C, n), a_nii, b_nii (C, n_w, 8) f32) — the raw NII exports:
    a_nii[w] = alpha at (w+1)*win - acq, b_nii[w] = beta at w*win + acq.

    ``mdtype`` "f32": every operation in f32 and l in f32.  "bf16" and
    "bf16_f32store" (one arithmetic; the stores hold bf16 values either
    way): u, v and the inits rounded to bf16, every ACS add in bf16, the
    main sweeps renormalised every :func:`renorm_period` steps, the combine
    summed in f32 from the bf16 metrics, l rounded to bf16.  ``pinpad``
    False keeps the old beta at dead positions of the main sweep (a select
    in f32, ``m*new + (1-m)*old`` in bf16), as the acquisition always does;
    ``nofreeze`` steps it there as anywhere (u = v = 0: no pin, no freeze).
    ``combine_bf16`` (mdtype "bf16" only, :func:`resolve_form`): the
    combine's sums and group maxima in bf16, then widened to f32 for the
    gamma merge.  ``unroll``: the layout kernel's ``blane_unroll``, whose
    bf16 renormalisation steps :func:`renorm_steps` gives (None:
    :func:`renorm_period`'s).  ``fused`` False is the unfused kernel
    (:func:`_half_iteration_unfused_plain`; win/2 < acq <= win allowed).
    """
    if not fused:
        return _half_iteration_unfused_plain(u, v, a_init, b_init, win, acq,
                                             mdtype)
    pinpad, nofreeze, comb16 = resolve_form(mdtype, pinpad, nofreeze,
                                            combine_bf16)
    fwd, bwd, out0, out1 = _unrolled_wiring()
    dt, _ = _metric_dtypes(mdtype)
    bf16 = dt == torch.bfloat16
    f32 = torch.float32
    c, n = u.shape
    n_w = -(-n // win)
    half = win // 2
    steps = renorm_steps(win, renorm_unroll(mdtype, win, unroll))
    pad = lambda x: torch.nn.functional.pad(x.to(dt), (0, n_w * win - n))
    um = pad(u).reshape(c, n_w, win)
    vm = pad(v).reshape(c, n_w, win)

    def acq_slices(x):
        # alpha: previous window's tail; beta: next window's head
        z = torch.zeros_like(x[:, :1, :acq])
        return (torch.cat([z, x[:, :-1, win - acq:]], dim=1),
                torch.cat([x[:, 1:, :acq], z], dim=1))

    ua, ub = acq_slices(um)
    va, vb = acq_slices(vm)
    lv_main, lv_a, lv_b = _live_masks(win, acq, n_w, n, u.device)
    lm = ((~lv_main).to(f32) * PIN).to(dt)           # (n_w, win) pin addend

    def acs_fwd(a, uu, vv):
        g = _gammas(uu, vv)
        return [torch.maximum(a[p0] + g[g0], a[p1] + g[g1])
                for (p0, p1, g0, g1) in fwd]

    def acs_bwd(b, uu, vv):
        g = _gammas(uu, vv)
        return [torch.maximum(b[n0] + g[g0], b[n1] + g[g1])
                for (n0, n1, g0, g1) in bwd]

    def freeze(new, old, keep):
        if bf16:
            m = keep.to(dt)
            return [m * x + (1.0 - m) * y for x, y in zip(new, old)]
        return [torch.where(keep, x, y) for x, y in zip(new, old)]

    def beta_step(b, j):
        if pinpad:
            return acs_bwd(b, um[..., j] + lm[:, j], vm[..., j])
        if nofreeze:
            return acs_bwd(b, um[..., j], vm[..., j])
        return freeze(acs_bwd(b, um[..., j], vm[..., j]), b, lv_main[:, j])

    def renorm(a, b, t):
        if bf16 and t in steps:
            a = [x - a[0] for x in a]
            b = [x - b[0] for x in b]
        return a, b

    def combine(a_s, b_s, uu, vv):
        g = _gammas(uu.to(f32), vv.to(f32))
        if not comb16:
            a_s = [x.to(f32) for x in a_s]
            b_s = [x.to(f32) for x in b_s]
        m = [None] * 4
        for s in range(8):
            for ns, gc in (out0[s], out1[s]):
                t = a_s[s] + b_s[ns]
                m[gc] = t if m[gc] is None else torch.maximum(m[gc], t)
        m = [x.to(f32) for x in m]
        l0 = torch.maximum(m[0] + g[0], m[1] + g[1])
        l1 = torch.maximum(m[2] + g[2], m[3] + g[3])
        return (l0 - l1).to(dt)

    a = [a_init[..., s].to(dt) for s in range(8)]
    b = [b_init[..., s].to(dt) for s in range(8)]
    for t in range(acq):
        a = freeze(acs_fwd(a, ua[..., t], va[..., t]), a, lv_a[:, t])
        j = acq - 1 - t
        b = freeze(acs_bwd(b, ub[..., j], vb[..., j]), b, lv_b[:, j])

    astore, bstore = [None] * half, [None] * half
    for t in range(half):
        astore[t] = a
        a = acs_fwd(a, um[..., t], vm[..., t])
        j = win - 1 - t
        bstore[j - half] = b
        b = beta_step(b, j)
        a, b = renorm(a, b, t)

    l = torch.empty((c, n_w, win), dtype=dt, device=u.device)
    a_nii = b_nii = None
    for t in range(half, win):
        j = win - 1 - t
        if t == win - acq:
            a_nii = torch.stack(a, -1).to(f32)
            b_nii = torch.stack(b, -1).to(f32)
        l[..., t] = combine(a, bstore[t - half], um[..., t], vm[..., t])
        l[..., j] = combine(astore[j], b, um[..., j], vm[..., j])
        a = acs_fwd(a, um[..., t], vm[..., t])
        b = beta_step(b, j)
        a, b = renorm(a, b, t)
    return l.reshape(c, n_w * win)[:, :n], a_nii, b_nii


def _half_iteration_unfused_plain(u, v, a_init, b_init, win: int, acq: int,
                                  mdtype: str = "f32"):
    """Plain torch version of the unfused kernel (the reference's
    ``_make_kernel`` with ``fused=False``), as :func:`half_iteration_plain`
    returns.  The acquisition freezes as the fused kernels' does (any
    0 < acq <= win: it reads the neighbours' windows); then both sweeps
    run over the whole window, alpha unmasked and beta frozen at dead
    positions, and keep every pre-step metric: alpha at t, beta at the
    position after j.  Under a bf16 trellis both renormalise after every
    :func:`unfused_period` steps.  The NII exports are read from the
    stores, alpha at win - acq and beta's store acq - 1.  Then one combine
    over all 8 states of each bit, ``(astore + gamma) + bstore``, with no
    grouping by gamma code, and L = l0 - l1 in the combine's dtype: f32;
    bf16 under "bf16" (bf16 stores: each sum rounds); f32 under
    "bf16_f32store" (its f32 stores promote the sums), L rounded to bf16
    once."""
    fwd, bwd, out0, out1 = _unrolled_wiring()
    dt, _ = _metric_dtypes(mdtype)
    sdt = torch.float32 if mdtype == "bf16_f32store" else dt
    bf16 = dt == torch.bfloat16
    f32 = torch.float32
    c, n = u.shape
    n_w = -(-n // win)
    period = unfused_period(win)
    pad = lambda x: torch.nn.functional.pad(x.to(dt), (0, n_w * win - n))
    um = pad(u).reshape(c, n_w, win)
    vm = pad(v).reshape(c, n_w, win)
    z = torch.zeros_like(um[:, :1, :acq])
    ua = torch.cat([z, um[:, :-1, win - acq:]], dim=1)
    va = torch.cat([z, vm[:, :-1, win - acq:]], dim=1)
    ub = torch.cat([um[:, 1:, :acq], z], dim=1)
    vb = torch.cat([vm[:, 1:, :acq], z], dim=1)
    lv_main, lv_a, lv_b = _live_masks(win, acq, n_w, n, u.device)

    def acs(m, wiring, uu, vv):
        g = _gammas(uu, vv)
        return [torch.maximum(m[i0] + g[g0], m[i1] + g[g1])
                for (i0, i1, g0, g1) in wiring]

    def freeze(new, old, keep):
        if bf16:
            k = keep.to(dt)
            return [k * x + (1.0 - k) * y for x, y in zip(new, old)]
        return [torch.where(keep, x, y) for x, y in zip(new, old)]

    a = [a_init[..., s].to(dt) for s in range(8)]
    b = [b_init[..., s].to(dt) for s in range(8)]
    for t in range(acq):
        a = freeze(acs(a, fwd, ua[..., t], va[..., t]), a, lv_a[:, t])
        j = acq - 1 - t
        b = freeze(acs(b, bwd, ub[..., j], vb[..., j]), b, lv_b[:, j])

    astore, bstore = [None] * win, [None] * win
    for t in range(win):
        astore[t] = torch.stack(a, -1).to(sdt)
        a = acs(a, fwd, um[..., t], vm[..., t])
        j = win - 1 - t
        bstore[j] = torch.stack(b, -1).to(sdt)
        b = freeze(acs(b, bwd, um[..., j], vm[..., j]), b, lv_main[:, j])
        if bf16 and (t + 1) % period == 0:
            a = [x - a[0] for x in a]
            b = [x - b[0] for x in b]
    a_nii = astore[win - acq].to(f32)
    b_nii = bstore[acq - 1].to(f32)

    ast = torch.stack(astore, -2)               # (C, n_w, win, 8)
    bst = torch.stack(bstore, -2)
    g = _gammas(um, vm)
    l0 = l1 = None
    for s in range(8):
        (ns0, g0), (ns1, g1) = out0[s], out1[s]
        t0 = ast[..., s] + g[g0] + bst[..., ns0]
        t1 = ast[..., s] + g[g1] + bst[..., ns1]
        l0 = t0 if l0 is None else torch.maximum(l0, t0)
        l1 = t1 if l1 is None else torch.maximum(l1, t1)
    l = (l0 - l1).to(dt)
    return l.reshape(c, n_w * win)[:, :n], a_nii, b_nii


PADS = {"pin": 0, "freeze": 1, "nofreeze": 2}
"""The beta main sweep's dead positions, as the kernel's ``pad`` flag."""


def _pad(pinpad: bool, nofreeze: bool) -> str:
    return "nofreeze" if nofreeze else "pin" if pinpad else "freeze"


def _form(mdtype: str, pinpad: bool, nofreeze: bool = False,
          combine_bf16: bool = False, *, fused: bool = True,
          unroll: int | None = None) -> str:
    """The kernel form's name (of resolved flags, :func:`resolve_form` and
    :func:`renorm_unroll`): its trellis, "_combine" with the bf16 combine,
    "_freeze" / "_nofreeze" without pinned padding, "_u<U>" with the
    renormalisation at layout unroll U; the unfused kernel's
    "<mdtype>_unfused"."""
    if not fused:
        return mdtype + "_unfused"
    pad = _pad(pinpad, nofreeze)
    return (_TRELLIS[mdtype] + ("_combine" if combine_bf16 else "")
            + ("" if pad == "pin" else "_" + pad)
            + ("" if unroll is None else f"_u{unroll}"))


def _check_acq(win: int, acq: int, fused: bool) -> None:
    top = win // 2 if fused else win
    if win % 2 or not 0 < acq <= top:
        raise ValueError("need an even win and 0 < acq <= "
                         + ("win/2" if fused else "win")
                         + " (the unfused kernel takes acq up to win)")


def half_iteration_raw(u, v, a_init, b_init, win: int, acq: int,
                       mdtype: str = "f32", pinpad: bool = True,
                       nofreeze: bool = False, combine_bf16: bool = False,
                       *, fused: bool = True, unroll: int | None = None):
    """(l, a_nii, b_nii) of one half-iteration; CPU tensors take the plain
    version, CUDA tensors launch the kernel.  l is in the metric dtype.
    ``fused`` False runs the unfused kernel; ``unroll`` is the layout
    kernel's ``blane_unroll`` (None: the default renormalisation)."""
    c, n = u.shape
    n_w = -(-n // win)
    if a_init.shape != (c, n_w, 8) or b_init.shape != (c, n_w, 8):
        raise ValueError(f"boundary inits must be {(c, n_w, 8)}")
    _check_acq(win, acq, fused)
    form = resolve_form(mdtype, pinpad, nofreeze, combine_bf16, fused)
    if not u.is_cuda:
        return half_iteration_plain(u, v, a_init, b_init, win, acq, mdtype,
                                    *form, fused=fused, unroll=unroll)
    # at most WINDOWS_PER_BLOCK windows a block, in whole warps
    wpb = -(-min(WINDOWS_PER_BLOCK, n_w) // 4) * 4
    return half_iteration_kernel(u, v, a_init, b_init, win, acq, wpb, mdtype,
                                 *form, fused=fused, unroll=unroll)


def half_iteration_kernel(u, v, a_init, b_init, win: int, acq: int,
                          wpb: int, mdtype: str = "f32",
                          pinpad: bool = True, nofreeze: bool = False,
                          combine_bf16: bool = False, *, fused: bool = True,
                          unroll: int | None = None):
    """Launch the kernel on CUDA tensors with ``wpb`` windows per block: a
    multiple of 4 (8 lanes a window, whole warps a block; windows beyond
    the row run on zeros and write nothing).  It needs no scratch: the
    three outputs are all it allocates.  u, v are staged in the metric
    dtype (a bf16 form reads bf16 u, v and writes bf16 l); the inits and
    the NII exports stay f32.  ``fused`` False launches the kernels'
    unfused instances (any even win, acq up to win); ``unroll`` as
    :func:`half_iteration_raw`."""
    global LAUNCHES
    _check_acq(win, acq, fused)
    pinpad, nofreeze, combine_bf16 = resolve_form(mdtype, pinpad, nofreeze,
                                                  combine_bf16, fused)
    ru = renorm_unroll(mdtype, win, unroll) if fused else None
    if wpb <= 0 or wpb % 4:
        raise ValueError("the kernel needs wpb to be a multiple of 4")
    if fused and win % 4:
        raise ValueError("the fused kernels need win to be a multiple of 4")
    out = _launch("lteax_turbo_half", u, v, a_init, b_init, win, acq, wpb,
                  mdtype, int(_TRELLIS[mdtype] == "bf16"),
                  PADS[_pad(pinpad, nofreeze)], int(combine_bf16),
                  int(fused), ru or 0,
                  int(not fused and mdtype == "bf16_f32store"))
    form = _form(mdtype, pinpad, nofreeze, combine_bf16, fused=fused,
                 unroll=ru)
    if form == "f32":
        LAUNCHES += 1
    else:
        FORM_LAUNCHES[form] = FORM_LAUNCHES.get(form, 0) + 1
    return out


BF16_VARIANTS = {
    1: "(b) two codeblocks a lane, native bf16x2 arithmetic",
    2: "(b) + the renormalisation's broadcast beside the exchange",
    3: "(b) + the slab staged by cp.async"}
"""The bf16 kernel's variants (``csrc/turbo.cu``), lever by lever; the
decoders launch 3."""


def half_iteration_bf16_variant(u, v, a_init, b_init, win: int, acq: int,
                                variant: int, pinpad: bool = True,
                                wpb: int = WINDOWS_PER_BLOCK):
    """The bf16 kernel as :data:`BF16_VARIANTS` ``variant``, for timing
    them against one another: as :func:`half_iteration_kernel` with
    ``mdtype="bf16"``, and not counted (no decoder launches it)."""
    if variant not in BF16_VARIANTS:
        raise ValueError(f"variant {variant}: one of {sorted(BF16_VARIANTS)}")
    if win % 4 or wpb <= 0 or wpb % 4:
        raise ValueError("the kernel needs win and wpb to be multiples of 4")
    return _launch("lteax_turbo_half_bf16_variant", u, v, a_init, b_init,
                   win, acq, wpb, "bf16", int(not pinpad), variant)


def _launch(entry: str, u, v, a_init, b_init, win: int, acq: int, wpb: int,
            mdtype: str, *flags: int):
    """Check, allocate the outputs and call the C entry ``entry`` with its
    trailing int ``flags``."""
    from lteax_torch.kernels._build import check_cuda, library, stream_handle
    dt, _ = _metric_dtypes(mdtype)

    def staged(x):
        # a bf16 form rounds f32 u, v to bf16, as the reference's
        # um.astype(dt) does; anything else must come in the metric dtype
        if x.dtype == torch.float32 and dt == torch.bfloat16:
            check_cuda("half_iteration", x)
            return x.to(dt)
        return x

    u, v = staged(u), staged(v)
    check_cuda("half_iteration", u, v, dtype=dt)
    check_cuda("half_iteration", a_init, b_init)
    c, n = u.shape
    n_w = a_init.shape[1]
    dev = u.device
    l = torch.empty((c, n), dtype=dt, device=dev)
    a_nii = torch.empty((c, n_w, 8), dtype=torch.float32, device=dev)
    b_nii = torch.empty_like(a_nii)
    library().call(entry, u.data_ptr(), v.data_ptr(), a_init.data_ptr(),
                   b_init.data_ptr(), l.data_ptr(), a_nii.data_ptr(),
                   b_nii.data_ptr(), c, n, n_w, win, acq, wpb, *flags,
                   stream_handle(u))
    return l, a_nii, b_nii


def _nii_post(a_nii, b_nii):
    """Shift the NII exports into init position and max-normalise."""
    a_next = torch.roll(a_nii, 1, dims=1)
    b_next = torch.roll(b_nii, -1, dims=1)
    a_next = a_next - torch.amax(a_next, dim=-1, keepdim=True)
    b_next = b_next - torch.amax(b_next, dim=-1, keepdim=True)
    return a_next, b_next


def half_iteration(u, v, a_init, b_init, win: int, acq: int,
                   mdtype: str = "f32", pinpad: bool = True,
                   nofreeze: bool = False, combine_bf16: bool = False,
                   *, fused: bool = True, unroll: int | None = None,
                   raw: bool = False):
    """u, v (C, n); a_init/b_init (C, n_w, 8) -> (L (C, n), a_next, b_next)
    with the reference's NII convention (``half_iteration_pallas``);
    ``raw``: the NII exports as the kernel wrote them
    (:func:`half_iteration_raw`), which the glue hands over
    (:func:`turbo_glue`).  Every half-iteration of a decode goes through
    this function, so a test can watch what each receives."""
    l, a_nii, b_nii = half_iteration_raw(u, v, a_init, b_init, win, acq,
                                         mdtype, pinpad, nofreeze,
                                         combine_bf16, fused=fused,
                                         unroll=unroll)
    return (l, a_nii, b_nii) if raw else (l, *_nii_post(a_nii, b_nii))


def _pin_boundaries(a_init, b_init):
    """Pin window 0's alpha to the start state and the last window's beta
    to the termination state (state 0)."""
    pin = torch.full((8,), NEG, dtype=torch.float32, device=a_init.device)
    pin[0] = 0.0
    a = a_init.clone()
    b = b_init.clone()
    a[:, 0, :] = pin
    b[:, -1, :] = pin
    return a, b


def turbo_glue_plain(l, u, s, st, a_nii, b_nii, tab: dict, after: int,
                     ext_scale: float, *, crc: bool = False,
                     bits: bool = False):
    """Plain torch version of the glue kernel: what the presum form (the
    reference's layout path in bf16) does between two half-iterations.

    The half after which it runs (``after`` 1: DEC1, 2: DEC2) read u and
    wrote l (C, K+3) and the raw NII exports a_nii, b_nii (C, n_w, 8).  The
    extrinsic is ext_scale * (l - u) over the first K positions, taken
    through the permutation that ``tab`` (:func:`_tables`) holds for that
    half (:data:`GLUE_TABLES`: pi after DEC1, its inverse after DEC2) and
    added to the other half's static LLRs s (C, K); its 3 tail values st
    (C, 3) follow.  Returns (u_next (C, K+3), a_next, b_next (C, n_w, 8)
    pinned, ok, bits): ok (``crc``) each row's CRC parity of l < 0 against
    the half's matrix, bits (``bits``, with ``crc`` only) the hard
    decisions l < 0 through the permutation, int8 (natural order after
    DEC2); None where not asked for.  l is read in u's dtype, the
    extrinsic carry's."""
    p_key, m_key = GLUE_TABLES[after]
    perm = tab[p_key]
    k = perm.shape[0]
    lk = l[:, :k].to(u.dtype)
    u_next = torch.cat([s + (ext_scale * (lk - u[:, :k]))[:, perm], st],
                       dim=1)
    a_next, b_next = _pin_boundaries(*_nii_post(a_nii, b_nii))
    ok = crc_parity_ok(lk < 0, tab[m_key]) if crc else None
    hard = (lk < 0).to(torch.int8)[:, perm] if bits else None
    return u_next, a_next, b_next, ok, hard


def turbo_glue(l, u, s, st, a_nii, b_nii, tab: dict, after: int,
               ext_scale: float, *, crc: bool = False, bits: bool = False):
    """:func:`turbo_glue_plain` in bf16 (l, u, s and st bf16, rows of unit
    stride): CPU tensors take the plain version, CUDA tensors launch the
    kernel (``csrc/turbo_glue.cu``, one block a row), which reads the
    permutation in int16 and the CRC matrix as rows packed into 32 bits
    (:func:`_tables`)."""
    global GLUE_LAUNCHES
    if not l.is_cuda:
        return turbo_glue_plain(l, u, s, st, a_nii, b_nii, tab, after,
                                ext_scale, crc=crc, bits=bits)
    from lteax_torch.kernels._build import check_cuda, library, stream_handle
    p_key, m_key = GLUE_TABLES[after]
    perm = tab[p_key + "16"]
    c, k = u.shape[0], perm.shape[0]
    n_w = a_nii.shape[1]
    for x in (l, u, s, st):
        if not (x.is_cuda and x.dtype == torch.bfloat16 and x.dim() == 2
                and x.shape[0] == c and x.stride(1) == 1):
            raise ValueError("turbo_glue: needs bf16 CUDA rows of unit "
                             f"stride, got {x.dtype} {tuple(x.shape)}")
    if min(l.shape[1], u.shape[1]) < k or s.shape[1] != k or st.shape[1] != 3:
        raise ValueError(f"turbo_glue: K = {k} needs l, u (C, >= K), s "
                         "(C, K) and st (C, 3)")
    check_cuda("turbo_glue", a_nii, b_nii)
    if a_nii.shape != (c, n_w, 8) or b_nii.shape != a_nii.shape:
        raise ValueError(f"turbo_glue: the NII exports must be {(c, n_w, 8)}")
    dev = u.device
    u_next = torch.empty((c, k + 3), dtype=torch.bfloat16, device=dev)
    a_next = torch.empty_like(a_nii)
    b_next = torch.empty_like(b_nii)
    ok = torch.empty(c, dtype=torch.bool, device=dev) if crc else None
    hard = (torch.empty((c, k), dtype=torch.int8, device=dev) if bits
            else None)
    ptr = lambda x: None if x is None else x.data_ptr()
    library().call("lteax_turbo_glue", l.data_ptr(), l.stride(0),
                   u.data_ptr(), u.stride(0), s.data_ptr(), s.stride(0),
                   st.data_ptr(), st.stride(0), perm.data_ptr(),
                   ptr(tab[m_key + "32"] if crc else None), ext_scale, c, k,
                   n_w,
                   a_nii.data_ptr(), b_nii.data_ptr(), u_next.data_ptr(),
                   a_next.data_ptr(), b_next.data_ptr(), ptr(ok), ptr(hard),
                   stream_handle(u))
    GLUE_LAUNCHES += 1
    return u_next, a_next, b_next, ok, hard


@dataclasses.dataclass
class TurboStats:
    """What one decode did: iterations (the reference's ``n_iter``), host
    syncs on a device value, each compacted retry as (full-batch
    iterations done, blocks failing), the full-batch iterations (``full``:
    ``n_iter`` is ``full`` plus the early-stop loop's iterations), the
    host seconds the syncs blocked (``wait_s``) and the half-iterations
    whose glue ran in the glue kernel (``glue_fused``)."""
    n_iter: int = 0
    syncs: int = 0
    retries: list = dataclasses.field(default_factory=list)
    full: int = 0
    wait_s: float = 0.0
    glue_fused: int = 0

    def _read(self, to, x: torch.Tensor):
        t0 = time.perf_counter()
        value = to(x)
        self.wait_s += time.perf_counter() - t0
        self.syncs += 1
        return value

    def flag(self, x: torch.Tensor) -> bool:
        return self._read(bool, x)

    def count(self, x: torch.Tensor) -> int:
        return self._read(int, x)


@lru_cache(maxsize=16)
def _tables(k: int, early_crc: str | None, device: torch.device):
    """QPP permutations and the early-stop CRC matrices (natural order for
    DEC1, interleaved rows for DEC2) on ``device``; for the glue kernel
    (:func:`turbo_glue`) the permutations also in int16 (``pi16``,
    ``inv16``) and the matrices' rows packed into int32 (``m_nat32``,
    ``m_perm32``, :func:`~lteax_torch.phy.fec.crc.pack_rows`)."""
    pi = np.asarray(qpp_interleaver(k)).astype(np.int64)
    inv = np.asarray(qpp_deinterleaver(k)).astype(np.int64)
    t = lambda x, dt=None: torch.as_tensor(x, dtype=dt, device=device)
    out = {"pi": t(pi), "inv": t(inv), "pi16": t(pi, torch.int16),
           "inv16": t(inv, torch.int16)}
    if early_crc is not None:
        m = crc_matrix(k, early_crc)
        out["m_nat"] = t(m, torch.float32)
        out["m_perm"] = t(m[pi], torch.float32)
        out["m_nat32"] = t(pack_rows(m), torch.int32)
        out["m_perm32"] = t(pack_rows(m[pi]), torch.int32)
    return out


def kernel_fused(fused: bool, win: int, acq: int) -> bool:
    """Whether the reference's decode runs its fused kernels: ``fused``,
    and an acquisition that fits the half window (``turbo_mlm.py:1218``;
    else the unfused kernel)."""
    return bool(fused) and acq <= win // 2


def layout_path(c: int, early_crc: str | None, retry_m: int, *,
                layout_glue: bool = True, fused: bool = True) -> bool:
    """Whether the reference decodes a batch of ``c`` codeblocks on its
    layout path (``turbo_mlm.py:1300``): ``layout_glue``, the fused
    kernels (:func:`kernel_fused`), and no early stop or a compacted retry
    smaller than the batch."""
    return (bool(layout_glue) and bool(fused)
            and (early_crc is None or 0 < retry_m < c))


def turbo_decode_batch(llr_d: torch.Tensor, k: int, n_iter: int = 6,
                       win: int = 128, acq: int = 16,
                       ext_scale: float = 0.75,
                       early_crc: str | None = None, retry_m: int = 0,
                       retry_levels: int = 2, mdtype: str = "f32",
                       pinpad: bool = True, nofreeze: bool = False,
                       combine_bf16: bool = False, fused: bool = True,
                       layout_glue: bool = True,
                       blane_unroll: int | None = None):
    """Batched turbo decode.  llr_d (C, 3, K+4) -> (bits (C, K) int8,
    :class:`TurboStats`).

    Same schedule as ``turbo_decode_batch_pallas`` on its natural path:
    ``early_crc`` ("24A"/"24B"/None) stops once every block's CRC checks,
    tested after each half; with 0 < retry_m < C, after one full-batch
    iteration only the <= retry_m failing blocks keep iterating in a
    gathered subbatch, else another full-batch iteration runs, up to
    ``retry_levels`` of them, then the full-batch early-stop loop.

    ``mdtype`` picks the trellis (:func:`half_iteration_plain`) and the
    extrinsic carry: bf16 for "bf16", f32 otherwise; the CRC reads the
    signs of the kernel's l.  A bf16 form keeps the reference's rounding
    order, which differs between its two paths: where the reference runs
    its layout path (no early stop, or 0 < retry_m < C, the compacted
    retry included) u is pre-summed, u = ls + le, and the extrinsic is
    ext_scale * (l - u); on its natural path the extrinsic subtracts twice,
    ext_scale * (l - ls - le), and LLRs keep their dtype.  The f32 form
    runs the natural order on every path, as it always has (in f32 the two
    orders differ in the last ulp only).

    ``nofreeze`` drops the freeze and the pin of every half-iteration's
    main beta sweep (:func:`half_iteration_plain`).  ``combine_bf16`` takes
    the bf16 combine (:func:`resolve_form`) where the reference does: in
    the full-batch iterations of its layout path, not in its compacted
    retry (``run_earlystop_l`` passes no ``combine_bf16``), its full-batch
    early-stop loop or its natural path.  ``blane_unroll`` (the layout
    kernel's unroll, None: the default) moves the bf16 renormalisation
    (:func:`renorm_steps`) in the same half-iterations: the compacted
    retry and the early-stop loop call the reference's layout kernel at
    its default unroll.

    ``fused`` False, or acq > win/2, runs the unfused kernel
    (:func:`_half_iteration_unfused_plain`) with frozen padding whatever
    ``pinpad`` and ``nofreeze`` say, on the natural path; ``layout_glue``
    False takes the natural path too (``turbo_mlm.py:1218-1220``,
    ``:1300``)."""
    stats = TurboStats()
    dev = llr_d.device
    c = llr_d.shape[0]
    n = k + 3
    n_w = -(-n // win)
    tab = _tables(k, early_crc, dev)
    pi, inv = tab["pi"], tab["inv"]
    _, dt_e = _metric_dtypes(mdtype)
    fused = kernel_fused(fused, win, acq)
    layout = layout_path(c, early_crc, retry_m, layout_glue=layout_glue,
                         fused=fused)
    presum = mdtype != "f32" and layout
    # the presum form's glue between halves: the glue kernel for a bf16
    # carry (plain torch on the CPU); "bf16_f32store" carries f32 and keeps
    # the plain version everywhere
    glue = turbo_glue if dt_e == torch.bfloat16 else turbo_glue_plain
    fuse = presum and dt_e == torch.bfloat16 and llr_d.is_cuda

    def data_from(x):
        d0, d1, d2 = x[:, 0], x[:, 1], x[:, 2]
        ls = d0[:, :k]
        sys_t1 = torch.stack([d0[:, k], d2[:, k], d1[:, k + 1]], dim=1)
        par_t1 = torch.stack([d1[:, k], d0[:, k + 1], d2[:, k + 1]], dim=1)
        sys_t2 = torch.stack([d0[:, k + 2], d2[:, k + 2], d1[:, k + 3]], dim=1)
        par_t2 = torch.stack([d1[:, k + 2], d0[:, k + 3], d2[:, k + 3]], dim=1)
        v1 = torch.cat([d1[:, :k], par_t1], dim=1)
        v2 = torch.cat([d2[:, :k], par_t2], dim=1)
        return (ls, ls[:, pi], v1, v2, sys_t1, sys_t2)

    def make_halves(data, full: bool = False):
        """DEC1 and DEC2 over a (sub)batch on the carried state (carry, a1,
        b1, a2, b2): ``dec1(state, crc)`` -> (state, mid, l1, ok) and
        ``dec2(state, mid, crc, bits)`` -> (state, l2, ok, bits), where
        ``mid`` is what DEC1 hands DEC2, l1 and l2 (C', K) the APP LLRs (l2
        in DEC2's interleaved order), ok each block's CRC parity
        (``crc``) and bits the hard decisions in natural order (``bits``),
        else None.  ``full``: the layout path's full-batch iterations, with
        the bf16 combine and the unroll."""
        ls_, lsi_, v1_, v2_, st1_, st2_ = data
        comb = combine_bf16 and full
        unroll = blane_unroll if full else None

        def half(u, v, a, b, raw=False):
            return half_iteration(u, v, a, b, win, acq, mdtype, pinpad,
                                  nofreeze, comb, fused=fused, unroll=unroll,
                                  raw=raw)

        if presum:
            # the reference's layout path: the carry is DEC1's input u1 =
            # static + extrinsic, tails included; the boundaries are
            # carried pinned; after each half the glue gives the other
            # half's input, ext_scale * (l - u) through the QPP permutation
            # plus its static LLRs, the NII hand-over and the CRC parity
            def dec1(state, crc=False):
                u1, a1, b1, a2, b2 = state
                l1, an, bn = half(u1, v1_, a1, b1, raw=True)
                u2, a1, b1, ok, _ = glue(l1, u1, lsi_, st2_, an, bn, tab, 1,
                                         ext_scale, crc=crc)
                stats.glue_fused += fuse
                return (u1, a1, b1, a2, b2), u2, l1[:, :k], ok

            def dec2(state, u2, crc=False, bits=False):
                _, a1, b1, a2, b2 = state
                l2, an, bn = half(u2, v2_, a2, b2, raw=True)
                u1, a2, b2, ok, hard = glue(l2, u2, ls_, st1_, an, bn, tab,
                                            2, ext_scale, crc=crc, bits=bits)
                stats.glue_fused += fuse
                return (u1, a1, b1, a2, b2), l2[:, :k], ok, hard

            return dec1, dec2

        def dec1(state, crc=False):
            le21, a1, b1, a2, b2 = state
            u1 = torch.cat([(ls_ + le21).to(dt_e), st1_.to(dt_e)], dim=1)
            l1, a1, b1 = half(u1, v1_, *_pin_boundaries(a1, b1))
            l1 = l1[:, :k].to(dt_e)
            ok = crc_parity_ok(l1 < 0, tab["m_nat"]) if crc else None
            return (le21, a1, b1, a2, b2), l1, l1, ok

        def dec2(state, l1, crc=False, bits=False):
            le21, a1, b1, a2, b2 = state
            la2 = (ext_scale * (l1 - ls_ - le21)).to(dt_e)[:, pi]
            u2 = torch.cat([(lsi_ + la2).to(dt_e), st2_.to(dt_e)], dim=1)
            l2, a2, b2 = half(u2, v2_, *_pin_boundaries(a2, b2))
            l2 = l2[:, :k].to(dt_e)
            le21 = (ext_scale * (l2 - lsi_ - la2)).to(dt_e)[:, inv]
            ok = crc_parity_ok(l2 < 0, tab["m_perm"]) if crc else None
            hard = (l2 < 0).to(torch.int8)[:, inv] if bits else None
            return (le21, a1, b1, a2, b2), l2, ok, hard

        return dec1, dec2

    with stage("turbo.layout"):
        if mdtype == "f32" or presum:
            llr_d = llr_d.to(dt_e)
        data_full = data_from(llr_d)
        zero = torch.zeros((c, n_w, 8), dtype=torch.float32, device=dev)
        le21 = torch.zeros((c, k), dtype=dt_e, device=dev)
        if presum:
            ls, _, _, _, st1, _ = data_full
            init = (torch.cat([ls + le21, st1], dim=1),
                    *_pin_boundaries(zero, zero) * 2)
        else:
            init = (le21, zero, zero, zero, zero)

    def one_iteration(state, crc=False):
        """A full-batch iteration -> (state, l2, ok, bits), with DEC2's CRC
        parity and hard decisions where ``crc``."""
        dec1, dec2 = make_halves(data_full, layout)
        state, mid, _, _ = dec1(state)
        return dec2(state, mid, crc=crc, bits=crc)

    if early_crc is None:
        state = init
        for _ in range(n_iter):
            with stage("turbo.iter"):
                state, l2, _, _ = one_iteration(state)
        stats.n_iter = stats.full = n_iter
        return (l2[:, inv] < 0).to(torch.int8), stats

    def run_earlystop(data, state, iters_left: int, ignore=None):
        """Early-stopping decode of a (sub)batch from a carried state.
        ``ignore`` marks blocks whose CRC must not delay the stop.
        Returns (bits (c', K) int8 natural order, full iterations used)."""
        dec1, dec2 = make_halves(data)

        def allok(par):
            return torch.all(par if ignore is None else par | ignore)

        llast = torch.zeros((data[0].shape[0], k), dtype=dt_e, device=dev)
        it, from1 = 0, False
        while it < iters_left:
            state, mid, l1, ok = dec1(state, crc=True)
            it += 1
            if stats.flag(allok(ok)):
                llast, from1 = l1, True          # skip DEC2
                break
            state, llast, ok, _ = dec2(state, mid, crc=True)
            if stats.flag(allok(ok)):
                break
        bits = (llast < 0).to(torch.int8)
        # llast is natural-order after a DEC1 stop, interleaved otherwise
        return (bits if from1 else bits[:, inv]), it

    if not 0 < retry_m < c:
        with stage("turbo.earlystop"):
            bits, stats.n_iter = run_earlystop(data_full, init, n_iter)
        return bits, stats

    def compact_at(kk, state_k, bits_k, okb_k, n_fail):
        """Gather the (<= retry_m) failing blocks and finish them alone."""
        idx = torch.argsort(okb_k.to(torch.int8), stable=True)[:retry_m]
        sub_data = tuple(x[idx] for x in data_full)
        sub_state = tuple(x[idx] for x in state_k)
        ign = okb_k[idx]
        if n_fail:
            stats.retries.append((kk, n_fail))
        sub_bits, sub_it = run_earlystop(sub_data, sub_state,
                                         0 if n_fail == 0 else n_iter - kk,
                                         ignore=ign)
        bits = bits_k.clone()
        bits[idx] = torch.where(~ign[:, None], sub_bits, bits_k[idx])
        return bits, sub_it

    # kk full-batch iterations done: compact the failing blocks, run one
    # more full-batch iteration (up to retry_levels), or finish the batch
    # in the full-batch early-stop loop.  (A loop, not the reference's
    # recursion: a self-referencing closure would hold this decode's
    # tensors until Python's cycle collector runs.)
    kk = 0
    state = init
    while True:
        with stage("turbo.iter"):
            state, _, okb, bits = one_iteration(state, crc=True)
            kk += 1
            n_fail = stats.count(torch.sum(~okb))
        if n_fail <= retry_m:
            with stage("turbo.compact"):
                bits, extra = compact_at(kk, state, bits, okb, n_fail)
            break
        if kk >= min(retry_levels, n_iter - 1):
            with stage("turbo.earlystop"):
                bits, extra = run_earlystop(data_full, state, n_iter - kk)
            break
    stats.full = kk
    stats.n_iter = kk + extra
    return bits, stats
