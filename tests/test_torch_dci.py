"""The port's DCI codec (``lteax_torch.phy.channels.dci``) against the
reference's (``lteax.phy.channels.dci``), in both directions: for every
format at 6, 15, 25, 50 and 100 PRB (1B and 1D with 2 and 4 antenna ports)
the sizes are equal; fields packed by the port unpack in the reference to
the same message and the reverse; the packed bits are equal; random bit
strings of the format's size unpack to the same message (or to None in
both).  Then the RBG helpers of resource allocation type 0.  Pure numpy."""

import dataclasses

import numpy as np
import pytest

from lteax.phy.channels import dci as dci_ref

from lteax_torch.phy.channels import dci

N_RBS = (6, 15, 25, 50, 100)


def _riv_fields(rng, n_rb):
    l_crb = int(rng.integers(1, n_rb + 1))
    return dict(rb_start=int(rng.integers(0, n_rb - l_crb + 1)), l_crb=l_crb)


def _harq_fields(rng):
    return dict(mcs=int(rng.integers(32)), rv=int(rng.integers(4)),
                harq=int(rng.integers(8)), ndi=int(rng.integers(2)),
                tpc=int(rng.integers(4)))


def _bitmap(rng, n_rb):
    return int(rng.integers(1, 2 ** dci.n_rbg(n_rb)))


def _f0(rng, n_rb, _):
    return dict(**_riv_fields(rng, n_rb), mcs=int(rng.integers(32)),
                ndi=int(rng.integers(2)), tpc=int(rng.integers(4)),
                dmrs_cs=int(rng.integers(8)), hopping=bool(rng.integers(2)),
                cqi_request=bool(rng.integers(2)))


def _f1(rng, n_rb, _):
    return dict(rbg_bitmap=_bitmap(rng, n_rb), **_harq_fields(rng))


def _f1a(rng, n_rb, _):
    return dict(**_riv_fields(rng, n_rb), **_harq_fields(rng),
                distributed=bool(rng.integers(2)))


def _f1bd(last):
    def fields(rng, n_rb, n_ant):
        return dict(**_f1a(rng, n_rb, n_ant),
                    tpmi=int(rng.integers(2 ** (2 if n_ant == 2 else 4))),
                    **{last: int(rng.integers(2))})
    return fields


def _f2a(rng, n_rb, _):
    return dict(rbg_bitmap=_bitmap(rng, n_rb), mcs0=int(rng.integers(32)),
                mcs1=int(rng.integers(32)), rv0=int(rng.integers(4)),
                rv1=int(rng.integers(4)), ndi0=int(rng.integers(2)),
                ndi1=int(rng.integers(2)), harq=int(rng.integers(8)),
                tpc=int(rng.integers(4)), swap=int(rng.integers(2)))


def _f2(rng, n_rb, n_ant):
    return dict(**_f2a(rng, n_rb, n_ant), precoding=int(rng.integers(3)))


def _f1c(rng, n_rb, _):
    ndl = n_rb // dci._n_rb_step(n_rb)
    l1c = int(rng.integers(1, ndl + 1))
    return dict(rb_start=int(rng.integers(0, ndl - l1c + 1)), l_crb=l1c,
                i_tbs=int(rng.integers(32)),
                gap=int(rng.integers(2)) if n_rb >= 50 else 0)


# format -> (message class, random fields(rng, n_rb, n_ant))
FORMATS = {
    "0": ("Dci0", _f0), "1": ("Dci1", _f1), "1a": ("Dci1A", _f1a),
    "1b": ("Dci1B", _f1bd("pmi_confirm")),
    "1d": ("Dci1D", _f1bd("dl_power_offset")), "1c": ("Dci1C", _f1c),
    "2": ("Dci2", _f2), "2a": ("Dci2A", _f2a),
}


def _codec(mod, fmt, n_rb, n_ant):
    """(size, pack(msg) -> bits, unpack(bits) -> msg) of one format."""
    if fmt == "0":
        size = mod.dci_1a_size(n_rb)
        return (size, lambda m: mod.dci_0_pack(m, n_rb, size),
                lambda b: mod.dci_0_unpack(b, n_rb))
    size = getattr(mod, f"dci_{fmt}_size")
    pack = getattr(mod, f"dci_{fmt}_pack")
    unpack = getattr(mod, f"dci_{fmt}_unpack")
    if fmt in ("1b", "1d"):
        return (size(n_rb, n_ant), lambda m: pack(m, n_rb, n_ant),
                lambda b: unpack(b, n_rb, n_ant))
    return size(n_rb), lambda m: pack(m, n_rb), lambda b: unpack(b, n_rb)


def _same_msg(a, r):
    assert (a is None) == (r is None), (a, r)
    if a is not None:
        assert type(a).__name__ == type(r).__name__
        assert dataclasses.asdict(a) == dataclasses.asdict(r)


CASES = [(f, n_rb, n_ant) for f in FORMATS for n_rb in N_RBS
         for n_ant in ((2, 4) if f in ("1b", "1d") else (2,))]


@pytest.mark.parametrize("fmt,n_rb,n_ant", CASES,
                         ids=[f"{f}-{n}prb-{a}ant" for f, n, a in CASES])
def test_format_packs_and_unpacks_as_the_reference(fmt, n_rb, n_ant):
    cls, fields = FORMATS[fmt]
    size, pack, unpack = _codec(dci, fmt, n_rb, n_ant)
    size_r, pack_r, unpack_r = _codec(dci_ref, fmt, n_rb, n_ant)
    assert size == size_r
    assert size not in dci.AMBIGUOUS_SIZES or fmt == "1c"
    rng = np.random.default_rng([ord(c) for c in fmt] + [n_rb, n_ant])
    for _ in range(10):
        f = fields(rng, n_rb, n_ant)
        bits = pack(getattr(dci, cls)(**f))
        bits_r = pack_r(getattr(dci_ref, cls)(**f))
        assert bits.dtype == bits_r.dtype and len(bits) == size
        np.testing.assert_array_equal(bits, bits_r)
        got, got_r = unpack(bits_r), unpack_r(bits)       # crossed
        _same_msg(got, got_r)
        assert dataclasses.asdict(got) == f
    for _ in range(20):
        noise = rng.integers(0, 2, size).astype(np.int32)
        _same_msg(unpack(noise), unpack_r(noise))
    assert unpack(np.zeros(size + 1, np.int32)) is None or fmt == "0"


@pytest.mark.parametrize("n_rb", N_RBS)
def test_formats_3_and_3a_as_the_reference(n_rb):
    """Group TPC commands at the 0/1A size: N = L_1A // 2 two-bit commands
    (3) or L_1A one-bit commands (3A); short lists pad with 0."""
    assert dci.dci_3_n_commands(n_rb) == dci_ref.dci_3_n_commands(n_rb)
    assert dci.dci_3a_n_commands(n_rb) == dci_ref.dci_3a_n_commands(n_rb)
    rng = np.random.default_rng(n_rb)
    for n3, n3a in ((dci.dci_3_n_commands(n_rb), dci.dci_3a_n_commands(n_rb)),
                    (3, 5)):
        c3 = tuple(int(x) for x in rng.integers(0, 4, n3))
        c3a = tuple(int(x) for x in rng.integers(0, 2, n3a))
        for pk, up, cmds in (("dci_3_pack", "dci_3_unpack", c3),
                             ("dci_3a_pack", "dci_3a_unpack", c3a)):
            bits = getattr(dci, pk)(cmds, n_rb)
            np.testing.assert_array_equal(bits,
                                          getattr(dci_ref, pk)(cmds, n_rb))
            assert len(bits) == dci.dci_1a_size(n_rb)
            got = getattr(dci, up)(bits, n_rb)
            assert got == getattr(dci_ref, up)(bits, n_rb)
            assert got[:len(cmds)] == cmds and not any(got[len(cmds):])
    for pk, bad in (("dci_3_pack", (4,)), ("dci_3a_pack", (2,))):
        for mod in (dci, dci_ref):
            with pytest.raises(ValueError):
                getattr(mod, pk)(bad, n_rb)


@pytest.mark.parametrize("n_rb", [6, 10, 11, 15, 25, 26, 27, 50, 63, 64,
                                  75, 100])
def test_rbg_helpers_as_the_reference(n_rb):
    """P and N_RBG (36.213 Table 7.1.6.1-1), bitmap <-> PRBs with the short
    last RBG, the smallest covering bitmap and its range check."""
    assert dci.rbg_size(n_rb) == dci_ref.rbg_size(n_rb)
    assert dci.n_rbg(n_rb) == dci_ref.n_rbg(n_rb)
    rng = np.random.default_rng(n_rb)
    for bitmap in (1, 2 ** dci.n_rbg(n_rb) - 1,
                   *rng.integers(0, 2 ** dci.n_rbg(n_rb), 6)):
        prbs = dci.rbg_bitmap_to_prbs(int(bitmap), n_rb)
        assert prbs == dci_ref.rbg_bitmap_to_prbs(int(bitmap), n_rb)
        assert all(0 <= p < n_rb for p in prbs)
        assert dci.prbs_to_rbg_bitmap(prbs, n_rb) == int(bitmap)
    sub = sorted(rng.choice(n_rb, min(n_rb, 5), replace=False).tolist())
    assert dci.prbs_to_rbg_bitmap(sub, n_rb) == \
        dci_ref.prbs_to_rbg_bitmap(sub, n_rb)
    assert dci.Dci1(rbg_bitmap=3, mcs=0, rv=0).prbs(n_rb) == \
        dci_ref.Dci1(rbg_bitmap=3, mcs=0, rv=0).prbs(n_rb)
    for mod in (dci, dci_ref):
        with pytest.raises(ValueError):
            mod.prbs_to_rbg_bitmap([n_rb], n_rb)
        with pytest.raises(ValueError):
            mod.dci_1_pack(mod.Dci1(rbg_bitmap=2 ** mod.n_rbg(n_rb), mcs=0,
                                    rv=0), n_rb)
