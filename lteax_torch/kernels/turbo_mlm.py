"""Max-log-MAP turbo half-iteration kernel and the batched turbo decoder.

Port of ``lteax/kernels/turbo_mlm.py``: the TPU kernels
``half_iteration_blane`` and ``half_iteration_pallas`` (one function on two
tiles) become ONE CUDA kernel on the natural (C, K+3) layout,
``csrc/turbo.cu`` (a block owns consecutive windows of one codeblock, 8
lanes carry each window's chain, the alpha/beta stores stay in shared
memory; see the note in the source), in the reference's forms: an f32 or
bf16 trellis (``mdtype`` "f32", or "bf16" and "bf16_f32store", whose
stores hold the same bf16 values; the bf16 kernel carries two codeblocks
a lane in bf16x2 registers) and pinned or frozen padding (``pinpad``).
:func:`half_iteration_plain` is the same arithmetic in plain torch,
vectorised the way the Pallas body is: a Python loop over trellis steps on
(C, n_w) tensors.  :func:`half_iteration_raw`
runs it for CPU tensors and launches the kernel for CUDA tensors.

:func:`turbo_decode_batch` is the natural-path half of
``turbo_decode_batch_pallas``: DEC1/DEC2 halves with the QPP gathers,
pinned window boundaries, next-iteration init (NII), the half-iteration CRC
early stop and the multi-level compacted retry.  The reference's
``lax.while_loop``/``lax.cond`` become host branches on one device flag
each; :class:`TurboStats` counts those host syncs.
"""

from __future__ import annotations

import dataclasses
from functools import lru_cache

import numpy as np
import torch

from lteax_torch.phy.tables.turbo_qpp import qpp_deinterleaver, qpp_interleaver
from lteax_torch.phy.fec.crc import crc_matrix, crc_parity_ok
from lteax_torch.phy.fec.turbo import _unrolled_wiring
from lteax_torch.phy.tuning import MDTYPES

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

FORM_LAUNCHES = {"bf16": 0, "bf16_freeze": 0, "f32_freeze": 0}
"""Launches of every other form, by trellis (``bf16``: the kernel of both
bf16 mdtypes) and ``_freeze`` without pinned padding, as :data:`LAUNCHES`."""

_TRELLIS = {"f32": "f32", "bf16": "bf16", "bf16_f32store": "bf16"}
"""The kernel's trellis of each ``mdtype``."""


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
    b -= b[0]) of the main sweeps: 4, or 2 when win/2 is not a multiple of
    4.  Both reference kernels renormalise at this cadence whatever their
    unroll (``_renorm_at``; the fused kernel's loop body); the
    acquisition never does."""
    return 4 if (win // 2) % 4 == 0 else 2


def half_iteration_plain(u, v, a_init, b_init, win: int, acq: int,
                         mdtype: str = "f32", pinpad: bool = True):
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
    in f32, ``m*new + (1-m)*old`` in bf16), as the acquisition always does.
    """
    fwd, bwd, out0, out1 = _unrolled_wiring()
    dt, _ = _metric_dtypes(mdtype)
    bf16 = dt == torch.bfloat16
    f32 = torch.float32
    c, n = u.shape
    n_w = -(-n // win)
    half = win // 2
    period = renorm_period(win)
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
        return freeze(acs_bwd(b, um[..., j], vm[..., j]), b, lv_main[:, j])

    def renorm(a, b, t):
        if bf16 and (t + 1) % period == 0:
            a = [x - a[0] for x in a]
            b = [x - b[0] for x in b]
        return a, b

    def combine(a_s, b_s, uu, vv):
        g = _gammas(uu.to(f32), vv.to(f32))
        a_s = [x.to(f32) for x in a_s]
        b_s = [x.to(f32) for x in b_s]
        m = [None] * 4
        for s in range(8):
            for ns, gc in (out0[s], out1[s]):
                t = a_s[s] + b_s[ns]
                m[gc] = t if m[gc] is None else torch.maximum(m[gc], t)
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


def _form(mdtype: str, pinpad: bool) -> str:
    """The kernel form's name: its trellis, "_freeze" without pinned
    padding."""
    return _TRELLIS[mdtype] + ("" if pinpad else "_freeze")


def half_iteration_raw(u, v, a_init, b_init, win: int, acq: int,
                       mdtype: str = "f32", pinpad: bool = True):
    """(l, a_nii, b_nii) of one half-iteration; CPU tensors take the plain
    version, CUDA tensors launch the kernel.  l is in the metric dtype."""
    c, n = u.shape
    n_w = -(-n // win)
    if a_init.shape != (c, n_w, 8) or b_init.shape != (c, n_w, 8):
        raise ValueError(f"boundary inits must be {(c, n_w, 8)}")
    if win % 2 or not 0 < acq <= win // 2:
        raise ValueError("need an even win and 0 < acq <= win/2")
    _metric_dtypes(mdtype)
    if not u.is_cuda:
        return half_iteration_plain(u, v, a_init, b_init, win, acq, mdtype,
                                    pinpad)
    # at most WINDOWS_PER_BLOCK windows a block, in whole warps
    wpb = -(-min(WINDOWS_PER_BLOCK, n_w) // 4) * 4
    return half_iteration_kernel(u, v, a_init, b_init, win, acq, wpb, mdtype,
                                 pinpad)


def half_iteration_kernel(u, v, a_init, b_init, win: int, acq: int,
                          wpb: int, mdtype: str = "f32",
                          pinpad: bool = True):
    """Launch the kernel on CUDA tensors with ``wpb`` windows per block: a
    multiple of 4 (8 lanes a window, whole warps a block; windows beyond
    the row run on zeros and write nothing).  It needs no scratch: the
    three outputs are all it allocates.  u, v are staged in the metric
    dtype (a bf16 form reads bf16 u, v and writes bf16 l); the inits and
    the NII exports stay f32."""
    global LAUNCHES
    out = _launch("lteax_turbo_half", u, v, a_init, b_init, win, acq, wpb,
                  mdtype, int(_TRELLIS[mdtype] == "bf16"), int(not pinpad))
    if mdtype == "f32" and pinpad:
        LAUNCHES += 1
    else:
        FORM_LAUNCHES[_form(mdtype, pinpad)] += 1
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
    if win % 4 or wpb <= 0 or wpb % 4:
        raise ValueError("the kernel needs win and wpb to be multiples of 4")
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
                   mdtype: str = "f32", pinpad: bool = True):
    """u, v (C, n); a_init/b_init (C, n_w, 8) -> (L (C, n), a_next, b_next)
    with the reference's NII convention (``half_iteration_pallas``)."""
    l, a_nii, b_nii = half_iteration_raw(u, v, a_init, b_init, win, acq,
                                         mdtype, pinpad)
    return (l, *_nii_post(a_nii, b_nii))


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


@dataclasses.dataclass
class TurboStats:
    """What one decode did: full iterations (the reference's ``n_iter``),
    host syncs on a device flag, and each compacted retry as
    (full-batch iterations done, blocks failing)."""
    n_iter: int = 0
    syncs: int = 0
    retries: list = dataclasses.field(default_factory=list)

    def flag(self, x: torch.Tensor) -> bool:
        self.syncs += 1
        return bool(x)

    def count(self, x: torch.Tensor) -> int:
        self.syncs += 1
        return int(x)


@lru_cache(maxsize=16)
def _tables(k: int, early_crc: str | None, device: torch.device):
    """QPP permutations and the early-stop CRC matrices (natural order for
    DEC1, interleaved rows for DEC2) on ``device``."""
    pi = np.asarray(qpp_interleaver(k)).astype(np.int64)
    inv = np.asarray(qpp_deinterleaver(k)).astype(np.int64)
    t = lambda x, dt=None: torch.as_tensor(x, dtype=dt, device=device)
    out = {"pi": t(pi), "inv": t(inv)}
    if early_crc is not None:
        m = crc_matrix(k, early_crc)
        out["m_nat"] = t(m, torch.float32)
        out["m_perm"] = t(m[pi], torch.float32)
    return out


def turbo_decode_batch(llr_d: torch.Tensor, k: int, n_iter: int = 6,
                       win: int = 128, acq: int = 16,
                       ext_scale: float = 0.75,
                       early_crc: str | None = None, retry_m: int = 0,
                       retry_levels: int = 2, mdtype: str = "f32",
                       pinpad: bool = True):
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
    orders differ in the last ulp only)."""
    stats = TurboStats()
    dev = llr_d.device
    c = llr_d.shape[0]
    n = k + 3
    n_w = -(-n // win)
    tab = _tables(k, early_crc, dev)
    pi, inv = tab["pi"], tab["inv"]
    _, dt_e = _metric_dtypes(mdtype)
    presum = mdtype != "f32" and (early_crc is None or 0 < retry_m < c)
    if mdtype == "f32" or presum:
        llr_d = llr_d.to(dt_e)

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

    def half(u, v, a, b):
        return half_iteration(u, v, *_pin_boundaries(a, b), win, acq,
                              mdtype, pinpad)

    def make_halves(data):
        ls_, lsi_, v1_, v2_, st1_, st2_ = data
        if presum:
            # the reference's layout path: u = static + extrinsic, and the
            # extrinsic comes back as ext_scale * (l - u)
            def dec1(le21, a1, b1):
                u1 = torch.cat([ls_ + le21, st1_], dim=1)
                l1, a1n, b1n = half(u1, v1_, a1, b1)
                return (l1[:, :k].to(dt_e), u1[:, :k]), a1n, b1n

            def ext12(l1, le21):
                l1, u1 = l1
                return ext_scale * (l1 - u1)

            def dec2(le12, a2, b2):
                u2 = torch.cat([lsi_ + le12[:, pi], st2_], dim=1)
                l2, a2n, b2n = half(u2, v2_, a2, b2)
                l2 = l2[:, :k].to(dt_e)
                return l2, (ext_scale * (l2 - u2[:, :k]))[:, inv], a2n, b2n

            return dec1, dec2, ext12

        def dec1(le21, a1, b1):
            u1 = torch.cat([(ls_ + le21).to(dt_e), st1_.to(dt_e)], dim=1)
            l1, a1n, b1n = half(u1, v1_, a1, b1)
            return l1[:, :k].to(dt_e), a1n, b1n

        def ext12(l1, le21):
            return (ext_scale * (l1 - ls_ - le21)).to(dt_e)

        def dec2(le12, a2, b2):
            la2 = le12[:, pi]
            u2 = torch.cat([(lsi_ + la2).to(dt_e), st2_.to(dt_e)], dim=1)
            l2, a2n, b2n = half(u2, v2_, a2, b2)
            l2 = l2[:, :k].to(dt_e)
            le21n = (ext_scale * (l2 - lsi_ - la2)).to(dt_e)[:, inv]
            return l2, le21n, a2n, b2n

        return dec1, dec2, ext12

    def l_of(l1):
        """DEC1's APP LLR (the presum form carries its u beside it)."""
        return l1[0] if presum else l1

    data_full = data_from(llr_d)
    zero = torch.zeros((c, n_w, 8), dtype=torch.float32, device=dev)
    init = (torch.zeros((c, k), dtype=dt_e, device=dev),
            zero, zero, zero, zero)

    def one_iteration(le21, a1, b1, a2, b2):
        dec1, dec2, ext12 = make_halves(data_full)
        l1, a1n, b1n = dec1(le21, a1, b1)
        # l2 stays in DEC2's interleaved domain (CRC rows are permuted)
        l2, le21n, a2n, b2n = dec2(ext12(l1, le21), a2, b2)
        return le21n, a1n, b1n, a2n, b2n, l2

    if early_crc is None:
        state = init
        for _ in range(n_iter):
            *state, l2 = one_iteration(*state)
        stats.n_iter = n_iter
        return (l2[:, inv] < 0).to(torch.int8), stats

    m_nat, m_perm = tab["m_nat"], tab["m_perm"]

    def run_earlystop(data, state, iters_left: int, ignore=None):
        """Early-stopping decode of a (sub)batch from a carried state.
        ``ignore`` marks blocks whose CRC must not delay the stop.
        Returns (bits (c', K) int8 natural order, full iterations used)."""
        dec1, dec2, ext12 = make_halves(data)

        def allok(par):
            return torch.all(par if ignore is None else par | ignore)

        le21, a1, b1, a2, b2 = state
        llast = torch.zeros((data[0].shape[0], k), dtype=dt_e, device=dev)
        it, from1 = 0, False
        while it < iters_left:
            l1, a1, b1 = dec1(le21, a1, b1)
            it += 1
            if stats.flag(allok(crc_parity_ok(l_of(l1) < 0, m_nat))):
                llast, from1 = l_of(l1), True    # skip DEC2
                break
            llast, le21, a2, b2 = dec2(ext12(l1, le21), a2, b2)
            if stats.flag(allok(crc_parity_ok(llast < 0, m_perm))):
                break
        bits = (llast < 0).to(torch.int8)
        # llast is natural-order after a DEC1 stop, interleaved otherwise
        return (bits if from1 else bits[:, inv]), it

    if not 0 < retry_m < c:
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
        *state, l2 = one_iteration(*state)
        kk += 1
        okb = crc_parity_ok(l2 < 0, m_perm)
        bits = (l2 < 0).to(torch.int8)[:, inv]
        n_fail = stats.count(torch.sum(~okb))
        if n_fail <= retry_m:
            bits, extra = compact_at(kk, tuple(state), bits, okb, n_fail)
            break
        if kk >= min(retry_levels, n_iter - 1):
            bits, extra = run_earlystop(data_full, tuple(state), n_iter - kk)
            break
    stats.n_iter = kk + extra
    return bits, stats
