"""The bf16 turbo kernel's design where no card is at hand.

``csrc/turbo.cu::turbo_half_bf16_kernel`` carries two codeblocks a lane in
bf16x2 registers, renormalises from lane 0's own ``lo`` beside the step's
exchange, and stages u, v by cp.async as raw bf16 planes that start one
slot late where a row is not 4-byte aligned.  Here its lane algorithm is
emulated with torch's bf16 operations, with the wiring parsed out of the
source, and held bit for bit to ``half_iteration_plain(mdtype="bf16")``;
the staging's word plan is walked in numpy; and the premise of the native
arithmetic is checked: one bf16 add, sub, max or halving equals the f32
operation rounded to bf16, over the metrics' range."""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from lteax_torch.kernels import turbo_mlm as tm
from lteax_torch.phy.fec import turbo

BF, F32 = torch.bfloat16, torch.float32


def _turbo_cu() -> str:
    return (Path(__file__).resolve().parents[1] / "lteax_torch" / "kernels"
            / "csrc" / "turbo.cu").read_text()


def _bf16_source() -> str:
    src = _turbo_cu()
    return src[src.index("// ---- the bf16 trellis"):]


def _wiring(src: str) -> dict:
    """The bf16 kernel's hand-derived lane wiring, parsed out of it."""
    one = lambda pat: re.search(pat, src).groups()
    w = {"keeps1_from": int(one(r"const bool keeps1 = q >= (\d);")[0])}
    a, b, c, d = map(int, one(
        r"const int mcode = keeps1 \? 3 - \(q == 3 \? (\d) : (\d)\) : "
        r"\(q == 0 \? (\d) : (\d)\);"))
    w["mcode"] = (c, d, 3 - b, 3 - a)
    # a lane sends Q across the first stage where keeps1 differs from
    # bit0_is_p, else P
    assert "keeps1 != (bool)p.bit0_is_p" in src
    assert "const float send0 = p.sends_q ? qm0 : pm0, keep0 = p.sends_q " \
        "? pm0 : qm0;" in src
    folds = []
    for pat in (r"send{h}, (\d)\)", r"in_b{h}, (\d)\)", r"in_c{h}, (\d)\)"):
        dist = {int(one(r"__shfl_xor_sync\(all, " + pat.format(h=h))[0])
                for h in (0, 1)}
        assert len(dist) == 1             # both codeblocks fold alike
        folds.append(dist.pop())
    w["fold"] = tuple(folds)
    # lane 0's state 0 after the step (lane 0 of each 4: width 4): its own
    # lo, or its held r0 when the step is frozen
    w["s0_live"], w["s0_frozen"] = one(
        r"s0 = __shfl_sync\(all, t >= skip \? (\w+) : (\w+), 0, 4\);")
    return w


def _emulate(u, v, a_init, b_init, win, acq, pinpad, w):
    """The bf16 kernel's lane algorithm in torch bf16, a window at a time:
    codeblocks paired (2i, 2i+1) in the two halves of a register (an odd
    C's last high half on zeros), 4 lanes a direction each holding one
    butterfly's pair, one exchange a step, the renormalisation's state 0
    taken before the exchange, the combine in f32 folded across the lanes.
    The kernel's pipelining changes no value and is left out."""
    fwd, bwd, _, _ = turbo._unrolled_wiring()
    c, n = u.shape
    n_w, half = -(-n // win), win // 2
    period = tm.renorm_period(win)
    c2 = c + c % 2

    def pairs(x):                          # (C, ...) -> (C2/2, 2, ...)
        x = torch.cat([x, torch.zeros_like(x[:1])]) if c % 2 else x
        return x.reshape(c2 // 2, 2, *x.shape[1:])

    pad = lambda x: torch.nn.functional.pad(x, (acq, n_w * win + acq - n))
    up, vp = pairs(pad(u)), pairs(pad(v))  # position p at p + acq
    ai, bi = pairs(a_init), pairs(b_init)
    q = torch.arange(4)
    swap2 = ((q & 1) << 1) | (q >> 1)

    def phase(d, ph):
        k = swap2 if ph else q
        code = torch.tensor([fwd[i][2] if d == 0 else
                             bwd[2 * i][2] if bwd[2 * i][0] == i
                             else bwd[2 * i][3] for i in k.tolist()])
        return {"pair": k, "vneg": (code == 1) | (code == 2),
                "neg": code >= 2, "swap": 1 if ph == d else 2,
                "bit0_is_p": torch.tensor([fwd[i][2] < 2 for i in k.tolist()])}

    def gamma(p, pos, pin=False):          # bf16: (u + v) rounded, halved
        uu, vv = up[..., pos + acq, None], vp[..., pos + acq, None]
        g = (uu + torch.where(p["vneg"], -vv, vv)) * 0.5
        if pin:
            g = torch.full_like(g, 256.0)
        return torch.where(p["neg"], -g, g)

    def butterfly(r, g):
        return (torch.maximum(r[0] + g, r[1] - g),
                torch.maximum(r[0] - g, r[1] + g))

    def exchange(lohi, p):
        lo, hi = lohi
        bit = (q & p["swap"]) != 0
        got = torch.where(bit, lo, hi)[..., q ^ p["swap"]]
        return torch.where(bit, got, lo), torch.where(bit, hi, got)

    state = lambda d, k, r: k + 4 * r if d else 2 * k + r
    mcode = torch.tensor(w["mcode"])
    keeps1 = q >= w["keeps1_from"]
    cneg, cvneg = mcode >= 2, (mcode == 1) | (mcode == 2)
    l = torch.zeros((c2 // 2, 2, n_w * win), dtype=BF)
    nii = torch.zeros((2, c2 // 2, 2, n_w, 8), dtype=F32)
    for wi in range(n_w):
        base = wi * win
        t_pin = win - (n - base)
        skips = (0, 0 if pinpad else max(t_pin, 0))
        phs = [[phase(d, ph) for ph in (0, 1)] for d in (0, 1)]
        regs = []
        for d in (0, 1):
            first = (acq if wi == 0 else 0) if d == 0 else \
                min(max(base + win + acq - n, 0), acq)
            ph = (acq - first + skips[d]) & 1
            k = phs[d][ph]["pair"]
            init = (bi if d else ai)[:, :, wi]
            r = (init[..., state(d, k, 0)].to(BF),
                 init[..., state(d, k, 1)].to(BF))
            for t in range(first, acq):        # live positions only
                p = phs[d][ph]
                pos = base + win + acq - 1 - t if d else base - acq + t
                r = exchange(butterfly(r, gamma(p, pos)), p)
                ph ^= 1
            regs.append(r)
        store = torch.zeros((2, half, c2 // 2, 2, 4, 2), dtype=BF)
        for t in range(win):
            new = []
            for d in (0, 1):
                p, r = phs[d][t & 1], regs[d]
                pos = base + (win - 1 - t if d else t)
                if t < half:
                    store[d, t][..., p["pair"], 0] = r[0]
                    store[d, t][..., p["pair"], 1] = r[1]
                else:
                    if t == win - acq:
                        held = max(t, skips[d])
                        k = phs[d][held & 1]["pair"]
                        for i in (0, 1):
                            nii[d][:, :, wi, state(d, k, i)] = r[i].to(F32)
                    o = store[1 - d, win - 1 - t][..., p["pair"], :].to(F32)
                    x, y = r[0].to(F32), r[1].to(F32)
                    pm = torch.maximum(x + o[..., 0], y + o[..., 1])
                    qm = torch.maximum(x + o[..., 1], y + o[..., 0])
                    sends_q = keeps1 != p["bit0_is_p"]
                    send = torch.where(sends_q, qm, pm)
                    keep = torch.where(sends_q, pm, qm)
                    got = send[..., q ^ w["fold"][0]]
                    uu = up[..., pos + acq, None].to(F32)
                    vv = vp[..., pos + acq, None].to(F32)
                    ga = 0.5 * (uu + torch.where(cvneg, -vv, vv))
                    in_b = torch.maximum(keep, got) \
                        + torch.where(cneg, -ga, ga)
                    in_c = torch.maximum(in_b, in_b[..., q ^ w["fold"][1]])
                    l_c = in_c - in_c[..., q ^ w["fold"][2]]
                    l[..., pos] = l_c[..., 0].to(BF)
                lohi = butterfly(r, gamma(p, pos, pin=pinpad and d == 1
                                          and t < t_pin))
                live = t >= skips[d]
                s0 = {"lo": lohi[0], "hi": lohi[1], "r0": r[0]}[
                    w["s0_live"] if live else w["s0_frozen"]]
                if live:
                    r = exchange(lohi, p)
                if (t + 1) % period == 0:
                    s0 = s0[..., :1]               # lane 0's, to every lane
                    r = (r[0] - s0, r[1] - s0)
                new.append(r)
            regs = new
    unpair = lambda x: x.reshape(c2, *x.shape[2:])[:c]
    return unpair(l)[:, :n], unpair(nii[0]), unpair(nii[1])


def _inputs(c, n, win, seed):
    n_w = -(-n // win)
    rng = np.random.default_rng(seed)
    f32 = lambda x: torch.from_numpy(x.astype(np.float32))
    u = f32(rng.standard_normal((c, n)) * 8).to(BF)
    v = f32(rng.standard_normal((c, n)) * 8).to(BF)
    init = lambda: f32(-np.abs(rng.standard_normal((c, n_w, 8))) * 4)
    a0, b0 = tm._pin_boundaries(init(), init())
    return u, v, a0, b0


@pytest.mark.parametrize("c,k,win,acq", [
    (3, 40, 32, 8),          # odd C; the last window has 11 live positions
    (4, 200, 36, 16),        # win/2 = 18: renormalised every 2 steps
    (1, 197, 32, 16),        # the SI shape's kind: C = 1
    (5, 125, 128, 16)])      # one window, 128 positions, 128 live
@pytest.mark.parametrize("pinpad", [True, False], ids=["pinned", "frozen"])
def test_bf16_lane_algorithm(c, k, win, acq, pinpad):
    """Bit for bit against ``half_iteration_plain(mdtype="bf16")``, pinned
    and frozen, with the wiring parsed out of the bf16 kernel."""
    torch.set_num_threads(1)
    src = _bf16_source()
    w = _wiring(src)
    assert w == {"keeps1_from": 2, "mcode": (0, 1, 2, 3), "fold": (3, 1, 3),
                 "s0_live": "lo", "s0_frozen": "r0"}
    n = k + 3
    args = _inputs(c, n, win, n + win)
    ref = tm.half_iteration_plain(*args, win, acq, "bf16", pinpad)
    got = _emulate(*args, win, acq, pinpad, w)
    for g, r in zip(got, ref):
        assert g.dtype == r.dtype and torch.equal(g, r)
    # a state 0 from hi does not pass (in a frozen step lo and the held r0
    # are equal on these inputs: the last window's beta is pinned and its
    # dead gammas are 0)
    worse = _emulate(*args, win, acq, pinpad, {**w, "s0_live": "hi"})
    assert not all(torch.equal(g, r) for g, r in zip(worse, ref))


def _plan_words(n, win, acq, wpb, w0, addr_parity):
    """The kAsync staging of one plane, walked as the kernel walks it:
    (slots of the raw plane, the copies it starts).  The row's element 0
    sits at a bf16 address of parity ``addr_parity``."""
    slab = wpb * win + 2 * acq
    plane = slab + 2
    p0 = w0 * win
    shift = (addr_parity + acq) & 1
    raw = np.full(plane, -1, np.int64)          # -1: never written
    copies = []
    for wi in range(plane // 2):
        pa = p0 - acq - shift + 2 * wi
        la, lb = 0 <= pa < n, 0 <= pa + 1 < n
        if la:
            nbytes = 4 if lb else 2
            copies.append((addr_parity + pa, nbytes))
            raw[2 * wi] = pa
            raw[2 * wi + 1] = pa + 1 if lb else n   # n: a zero filled in
        else:
            raw[2 * wi] = n
            raw[2 * wi + 1] = pa + 1 if lb else n
    return raw, shift, copies


@pytest.mark.parametrize("n,win,acq,wpb,w0", [
    (5827, 128, 16, 4, 0), (5827, 128, 16, 4, 44), (5827, 128, 16, 8, 40),
    (43, 128, 16, 4, 0), (227, 32, 16, 4, 4), (1027, 36, 16, 12, 24),
    (6147, 128, 16, 4, 48)])
@pytest.mark.parametrize("addr_parity", [0, 1])
def test_bf16_staging_plan(n, win, acq, wpb, w0, addr_parity):
    """Every 4-byte copy is aligned in device memory, a 2-byte one only at
    the row's last position, none reads outside [0, n), and the re-packed
    slab holds position p0 + rel at ``slab_index(rel)``, zero outside
    [0, n)."""
    src = _bf16_source()
    assert "const int pa = p0 - acq - shift + 2 * wi;" in src
    assert "(((reinterpret_cast<uintptr_t>(src) >> 1) + acq) & 1)" in src
    assert "raw[i + shift[0]]" in src
    raw, shift, copies = _plan_words(n, win, acq, wpb, w0, addr_parity)
    for e, nbytes in copies:
        assert e % 2 == 0                  # a bf16 address: 4-byte aligned
        pos = e - addr_parity
        assert 0 <= pos and pos + nbytes // 2 <= n
        assert nbytes == 4 or pos == n - 1
    p0 = w0 * win
    slab = wpb * win + 2 * acq
    for i in range(slab):                  # the re-pack reads slot i + shift
        pos = p0 + i - acq
        assert raw[i + shift] == (pos if 0 <= pos < n else n)


def _metric_values() -> torch.Tensor:
    """bf16 values over the metrics' range: zeros, subnormals, the pins,
    the boundary init, and a spread of normals."""
    tiny = [2.0 ** -133, 2.0 ** -127, 2.0 ** -126, 3 * 2.0 ** -130]
    pins = [256.0, 512.0, 1e9, 0.5, 1.0, 1.5, 255.0, 257.0, 511.0, 513.0]
    rng = np.random.default_rng(7)
    spread = np.concatenate([rng.standard_normal(150) * 8,
                             rng.standard_normal(60) * 600,
                             np.exp(rng.uniform(-30, 30, 60))])
    x = np.concatenate([[0.0], tiny, pins, spread])
    x = np.concatenate([x, -x])
    return torch.unique(torch.tensor(x, dtype=F32).to(BF))


def test_bf16_ops_are_f32_ops_rounded():
    """The premise of the native arithmetic: for bf16 a and b, the bf16 add,
    sub, max and halving (what the kernel's add.rn / sub.rn / fma.rn / max /
    mul.rn.bf16x2 compute, and what torch's bf16 and the plain version
    compute) equal the f32 operation rounded to bf16 once, over every pair
    of the metrics' values; and the kernel's packed constants are 1, 0.5
    and HALF_PIN."""
    x = _metric_values()
    a, b = x[:, None].expand(len(x), len(x)), x[None, :].expand(len(x), len(x))
    fa, fb = a.to(F32), b.to(F32)
    same = lambda g, r: torch.equal(g.to(F32), r) and \
        torch.equal(torch.isnan(g), torch.isnan(r))
    assert same(a + b, (fa + fb).to(BF).to(F32))
    assert same(a - b, (fa - fb).to(BF).to(F32))
    assert same(torch.maximum(a, b), torch.maximum(fa, fb).to(BF).to(F32))
    assert same(a * 0.5, (fa * 0.5).to(BF).to(F32))
    # the kernel's gamma: u + v * (-1) rounded once is u - v rounded, and a
    # halving by -0.5 is the negated halving
    assert same((fa + fb * -1.0).to(BF), (a - b).to(F32))
    assert same(a * -0.5, (-(a * 0.5)).to(F32))
    text = _turbo_cu()
    bits = lambda val: int(
        torch.tensor([val], dtype=BF).view(torch.int16)[0]) & 0xFFFF
    for name, val in (("kOne2", 1.0), ("kHalf2", 0.5), ("kHalfPin2", 256.0)):
        word = int(re.search(rf"{name} = (0x[0-9a-f]+)u;", text).group(1), 16)
        assert word == bits(val) * 0x10001, name
