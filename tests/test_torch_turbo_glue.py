"""The turbo decoder's glue between half-iterations (``turbo_glue``): its
plain version against the torch code the decoder ran inline before it, the
packed CRC rows against ``crc_parity_ok``, and, on the card, the kernel
against the plain version and a decode with the kernel against one with
the plain glue.

The card tests are marked ``cuda`` and skip without a CUDA device; on the
card: ``python -m pytest --noconftest -m cuda tests/test_torch_turbo_glue.py``
(this file imports no jax)."""

import numpy as np
import pytest
import torch

import lteax_torch.kernels.turbo_mlm as tm
from lteax_torch.phy.fec.crc import (attach_crc_np, crc_matrix, crc_parity_ok,
                                     pack_rows)
from lteax_torch.phy.fec.turbo import turbo_encode

BF = torch.bfloat16


def glue_inputs(c: int, k: int, crc: str, seed: int, dev, win: int = 128):
    """(l, u, ls, lsi, st, a_nii, b_nii, tab) of one half at K = k: l's
    signs spell a codeword with a valid ``crc`` in every other row, in
    natural order (as DEC1's) and, as ``l_perm``, in DEC2's interleaved
    order; ls is a strided view into (C, 3, K+4) LLRs, as the decoder's."""
    rng = np.random.default_rng(seed)
    n, n_w = k + 3, -(-(k + 3) // win)
    tab = tm._tables(k, crc, dev)
    pi = tab["pi"].cpu().numpy()
    cw = attach_crc_np(rng.integers(0, 2, (c, k - 24)), crc)
    cw[1::2, rng.integers(0, k)] ^= 1                   # odd rows fail
    t = lambda x, dt=torch.float32: torch.as_tensor(
        np.asarray(x, np.float32), device=dev).to(dt)
    mag = np.abs(rng.standard_normal((c, n))) * 8 + 0.01
    sign = lambda bits: np.concatenate(
        [1 - 2 * bits, rng.choice([-1, 1], (c, 3))], axis=1)
    llr = t(rng.standard_normal((c, 3, k + 4)) * 4, BF)
    return {"l": t(mag * sign(cw), BF), "l_perm": t(mag * sign(cw[:, pi]), BF),
            "u": t(rng.standard_normal((c, n)) * 6, BF),
            "ls": llr[:, 0, :k], "lsi": llr[:, 0, :k][:, tab["pi"]],
            "st": t(rng.standard_normal((c, 3)) * 4, BF),
            "a_nii": t(rng.standard_normal((c, n_w, 8)) * 5),
            "b_nii": t(rng.standard_normal((c, n_w, 8)) * 5), "tab": tab}


def glue_args(x: dict, after: int):
    """The arguments of ``turbo_glue`` after DEC1 (1) or DEC2 (2)."""
    if after == 1:
        return (x["l"], x["u"], x["lsi"], x["st"], x["a_nii"], x["b_nii"],
                x["tab"], 1, 0.75)
    return (x["l_perm"], x["u"], x["ls"], x["st"], x["a_nii"], x["b_nii"],
            x["tab"], 2, 0.75)


# -- on the CPU ----------------------------------------------------------

@pytest.mark.parametrize("k", [40, 1056, 5824])
def test_glue_plain_is_the_inline_glue(k):
    """``turbo_glue_plain`` is the presum form's glue as the decoder ran
    it inline: DEC1's extrinsic gathered by pi into DEC2's input, DEC2's
    by pi's inverse into the next DEC1's, each with its tails by cat, the
    NII exports rolled, normalised and pinned, the CRC by the f32 product
    and DEC2's bits through the inverse."""
    x = glue_inputs(5, k, "24B", k, "cpu")
    tab = x["tab"]
    pi, inv = tab["pi"], tab["inv"]
    nii = tm._pin_boundaries(*tm._nii_post(x["a_nii"], x["b_nii"]))

    l1, u1 = x["l"][:, :k], x["u"][:, :k]
    le12 = 0.75 * (l1 - u1)
    want1 = (torch.cat([x["lsi"] + le12[:, pi], x["st"]], dim=1), *nii,
             crc_parity_ok(l1 < 0, tab["m_nat"]), None)
    l2, u2 = x["l_perm"][:, :k], x["u"][:, :k]
    le21 = (0.75 * (l2 - u2))[:, inv]
    want2 = (torch.cat([x["ls"] + le21, x["st"]], dim=1), *nii,
             crc_parity_ok(l2 < 0, tab["m_perm"]),
             (l2 < 0).to(torch.int8)[:, inv])
    for after, want in ((1, want1), (2, want2)):
        got = tm.turbo_glue_plain(*glue_args(x, after), crc=True,
                                  bits=after == 2)
        for g, w in zip(got, want):
            assert (g is None and w is None) or (
                g.dtype == w.dtype and torch.equal(g, w))
    for ok in (want1[3], want2[3]):                     # valid, broken rows
        assert ok[0::2].all() and not ok[1::2].any()
    assert torch.equal(want2[4], (x["l"][:, :k] < 0).to(torch.int8))


@pytest.mark.parametrize("kind", ["24A", "24B"])
@pytest.mark.parametrize("k", [40, 5824])
def test_packed_crc_rows_give_the_parity(kind, k):
    """The XOR of ``pack_rows``' rows where a bit is 1 is the parity
    ``bits @ m mod 2`` packed the same way, so a zero XOR is
    ``crc_parity_ok``: on random bits and on valid codewords, in natural
    and in QPP-interleaved row order (DEC1's and DEC2's matrices)."""
    rng = np.random.default_rng(k)
    m = crc_matrix(k, kind)
    pi = tm._tables(k, None, "cpu")["pi"].numpy()
    bits = np.concatenate([rng.integers(0, 2, (64, k)),
                           attach_crc_np(rng.integers(0, 2, (16, k - 24)),
                                         kind)])
    for rows, b in ((m, bits), (m[pi], bits[:, pi])):
        packed = pack_rows(rows)
        syn = np.bitwise_xor.reduce(np.where(b == 1, packed, 0), axis=1)
        par = (b.astype(np.int64) @ rows) % 2
        assert np.array_equal(syn, pack_rows(par))
        ok = crc_parity_ok(torch.as_tensor(b),
                           torch.as_tensor(rows, dtype=torch.float32))
        assert np.array_equal(syn == 0, ok.numpy())
        assert ok[64:].all() and not ok[:64].any()


def test_pack_rows_refuses_32_bits():
    with pytest.raises(ValueError):
        pack_rows(np.zeros((4, 32), np.uint8))


def coded_llrs(c: int, k: int, esn0_db: float, seed: int) -> np.ndarray:
    """(C, 3, K+4) channel LLRs of random CRC24B codeblocks over BPSK at
    ``esn0_db``, with their bits: (llrs f32, bits (C, K))."""
    rng = np.random.default_rng(seed)
    bits = attach_crc_np(rng.integers(0, 2, (c, k - 24)), "24B")
    d = turbo_encode(bits, k)
    var = 10 ** (-esn0_db / 10)
    y = 1 - 2 * d + rng.standard_normal(d.shape) * np.sqrt(var)
    return (2 * y / var).astype(np.float32), bits


@pytest.mark.parametrize("mdtype,early_crc,retry_m", [
    ("bf16", "24B", 2),             # the presum form: compacted retry
    ("bf16", None, 0),              # the presum form: no early stop
    ("bf16_f32store", "24B", 2),    # an f32 carry: the plain glue
    ("bf16", "24B", 0),             # the natural path
    ("f32", "24B", 2)])
def test_cpu_decode_runs_no_glue_kernel(mdtype, early_crc, retry_m):
    """A CPU decode takes the plain glue: ``glue_fused`` reads 0 and the
    kernel's counter does not move, on and off the presum form; the decode
    still gives the bits sent."""
    llr, bits = coded_llrs(6, 40, 6.0, 3)
    before = tm.GLUE_LAUNCHES
    got, stats = tm.turbo_decode_batch(torch.from_numpy(llr), 40, win=32,
                                       acq=8, mdtype=mdtype,
                                       early_crc=early_crc, retry_m=retry_m)
    assert stats.glue_fused == 0 and tm.GLUE_LAUNCHES == before
    assert np.array_equal(got.numpy(), bits)


# -- on the card ---------------------------------------------------------

@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("crc,bits", [(False, False), (True, False),
                                      (True, True)])
@pytest.mark.parametrize("after", [1, 2])
@pytest.mark.parametrize("c,k", [
    (6656, 5824), (13312, 5824),    # the benchmark's cells
    (37, 5824),                     # an odd C
    (37, 40), (37, 6144),           # the smallest and the largest K
    (1, 1056)])                     # one row
def test_glue_kernel_matches_plain(dev, c, k, after, crc, bits):
    """Bit for bit, every output, after DEC1 and after DEC2, with and
    without the CRC parity and the hard decisions."""
    x = glue_inputs(c, k, "24A", k + after, dev)
    before = tm.GLUE_LAUNCHES
    got = tm.turbo_glue(*glue_args(x, after), crc=crc, bits=bits)
    assert tm.GLUE_LAUNCHES == before + 1
    want = tm.turbo_glue_plain(*glue_args(x, after), crc=crc, bits=bits)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert (g is None and w is None) or (
            g.dtype == w.dtype and torch.equal(g, w))
    if crc and c > 1:
        assert got[3][0::2].all() and not got[3][1::2].any()


@pytest.mark.cuda
def test_glue_kernel_refuses_what_it_does_not_take(dev):
    x = glue_inputs(4, 40, "24A", 0, dev)
    args = list(glue_args(x, 1))
    for i, bad in ((0, x["l"].float()), (2, x["lsi"].T.contiguous().T),
                   (3, x["st"][:, :2]), (4, x["a_nii"].double())):
        with pytest.raises(ValueError):
            tm.turbo_glue(*args[:i], bad, *args[i + 1:])
    with pytest.raises(RuntimeError):       # the bits come with the CRC
        tm.turbo_glue(*args, bits=True)


def _decode(llr, k: int, plain: bool, monkeypatch, **kw):
    """``turbo_decode_batch`` with the glue kernel, or with the plain glue
    in its place (``plain``) -> (bits, stats, glue kernel launches)."""
    before = tm.GLUE_LAUNCHES
    with monkeypatch.context() as mp:
        if plain:
            mp.setattr(tm, "turbo_glue", tm.turbo_glue_plain)
        bits, stats = tm.turbo_decode_batch(llr, k, **kw)
    torch.cuda.synchronize()
    return bits.cpu(), stats, tm.GLUE_LAUNCHES - before


@pytest.mark.cuda
@pytest.mark.parametrize("case,esn0_db,c,early_crc,retry_m,presum", [
    # near threshold: more than retry_m blocks fail after 2 full-batch
    # iterations, so the full-batch early-stop loop runs
    ("edge", 0.0, 1024, "24B", 64, True),
    # clean: a few blocks fail after one, and the compacted retry runs
    ("clean", 2.5, 1024, "24B", 64, True),
    # C = 1 with the early stop: off the layout path, the natural glue
    ("one_block", 1.0, 1, "24B", 64, False),
    # C = 1 without it: the layout path, the kernel for every half
    ("one_block_no_stop", 1.0, 1, None, 0, True)])
def test_decode_with_glue_kernel_matches_plain_glue(
        dev, monkeypatch, case, esn0_db, c, early_crc, retry_m, presum):
    """The same bits, iterations, full-batch iterations, host syncs and
    retries with the glue kernel as with the plain glue, at the decoders'
    shape (K = 5824, bf16, win 128, acq 16).  ``glue_fused`` counts the
    kernel's launches: every half of a decode on the presum form (2 an
    iteration, one less where the early stop ends after DEC1), none off
    it."""
    k = 5824
    llr, sent = coded_llrs(c, k, esn0_db, 7)
    llr = torch.from_numpy(llr).to(dev)
    kw = dict(n_iter=6, win=128, acq=16, ext_scale=0.75, early_crc=early_crc,
              retry_m=retry_m, retry_levels=2, mdtype="bf16")
    got, s, launched = _decode(llr, k, False, monkeypatch, **kw)
    want, w, plain_launched = _decode(llr, k, True, monkeypatch, **kw)
    assert torch.equal(got, want)
    assert (s.n_iter, s.full, s.syncs, s.retries) == (
        w.n_iter, w.full, w.syncs, w.retries)
    assert s.glue_fused == launched and plain_launched == 0
    if presum:
        assert 2 * s.n_iter - 1 <= s.glue_fused <= 2 * s.n_iter
    else:
        assert s.glue_fused == 0
    if case == "edge":
        assert s.full == 2 and s.n_iter > 2 and not s.retries
    if case == "clean":
        assert s.full == 1 and 0 < s.retries[0][1] <= retry_m
    assert (got.numpy() == sent).all(axis=1).mean() > 0.9
