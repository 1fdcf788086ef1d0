"""The port's copies of the eNB's stack modules against the reference's, on
the CPU: ``lteax_torch.stack.{mac_sched, pdcp, cnfg_db, gw, timers}``.

Each case is one of the reference's own tests (``tests/test_mac_sched.py``,
``test_pdcp_entity.py``, ``test_gw.py``, ``test_stack_engine.py``) run as
one script on both packages: the same inputs (seeded where random) must
give the same grants, bytes, values, errors and return values, and the
reference test's own assertions hold on the port's record.
"""

import struct

import numpy as np
import pytest
import torch

from lteax.stack import cnfg_db as cnfg_ref
from lteax.stack import gw as gw_ref
from lteax.stack import mac_pdu as mac_pdu_ref
from lteax.stack import mac_sched as sched_ref
from lteax.stack import pdcp as pdcp_ref
from lteax.stack import security as sec_ref
from lteax.stack import timers as timers_ref

from lteax_torch.stack import (cnfg_db, gw, mac_pdu, mac_sched, pdcp,
                               security, timers)

@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch thread, as in every file that runs the reference."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


REF = dict(sched=sched_ref, mac_pdu=mac_pdu_ref, pdcp=pdcp_ref,
           sec=sec_ref, cnfg=cnfg_ref, gw=gw_ref, timers=timers_ref)
PORT = dict(sched=mac_sched, mac_pdu=mac_pdu, pdcp=pdcp, sec=security,
            cnfg=cnfg_db, gw=gw, timers=timers)


def _grant(g) -> tuple:
    return (g.rnti, g.rb_start, g.n_prb, g.mcs, g.tbs, g.payload, g.kind)


# -- mac_sched (tests/test_mac_sched.py) --------------------------------------

def sched_si(m):
    s = m["sched"].DlScheduler(n_rb_dl=25)
    sib1, si = b"\x01" * 20, b"\x02" * 30
    return [[_grant(g) for g in s.schedule(0, 5, sib1=sib1, si=si)],
            [_grant(g) for g in s.schedule(1, 5, sib1=sib1, si=si)],
            [_grant(g) for g in s.schedule(0, 3)]]


def sched_rar(m):
    s = m["sched"].DlScheduler(n_rb_dl=25)
    tc = s.on_prach(rapid=17)
    grants = s.schedule(2, 1)
    _, rars = m["mac_pdu"].unpack_rar_pdu(grants[0].payload)
    return [tc, [_grant(g) for g in grants], rars[0].rapid, rars[0].tc_rnti]


def sched_round_robin(m):
    s = m["sched"].DlScheduler(n_rb_dl=25)
    rng = np.random.default_rng(5)
    for rnti in (0x10, 0x11, 0x12):
        s.add_ue(rnti, cqi_mcs=int(rng.integers(4, 16)))
        for i in range(10):
            s.enqueue(rnti, bytes([rnti & 0xFF]) * int(rng.integers(8, 60)))
    s.update_cqi(0x11, 12)
    out = []
    for tti in range(60):
        out.append([_grant(g) for g in s.schedule(tti // 10, tti % 10)])
        if all(not u.buffered for u in s.ues.values()):
            break
    return out


def sched_no_overlap(m):
    s = m["sched"].DlScheduler(n_rb_dl=15, si_prbs=6)
    s.add_ue(0x20)
    s.enqueue(0x20, b"x" * 100)
    s.on_prach(3)
    return [_grant(g) for g in s.schedule(0, 5, sib1=b"s" * 10,
                                          si=b"t" * 10)]


def sched_tables(m):
    return [m["sched"].CQI_TO_MCS, m["sched"].SI_RNTI,
            m["sched"].RA_RNTI_BASE]


# -- pdcp (tests/test_pdcp_entity.py) -----------------------------------------

def _keys(m, k_enb=bytes(range(32))):
    return m["sec"].generate_as_keys(k_enb)


def pdcp_srb_wrap(m):
    k_enc, k_int, _ = _keys(m)
    enb, ue = m["pdcp"].srb_pair(1, k_enc, k_int)
    out = []
    for i in range(70):                      # > 2 wraps of the 5-bit SN
        pdu = enb.encode(f"rrc-{i}".encode())
        out.append((pdu, ue.decode(pdu)))
    return [out, enb.tx_count, ue.rx_next]


def pdcp_integrity(m):
    k_enc, k_int, _ = _keys(m)
    enb, ue = m["pdcp"].srb_pair(1, k_enc, k_int)
    pdu = bytearray(enb.encode(b"hello"))
    pdu[2] ^= 0x40                           # flip a ciphertext bit
    good = enb.encode(b"again")
    return [bytes(pdu), ue.decode(bytes(pdu)), good, ue.decode(good)]


def pdcp_wrong_key(m):
    k_enc, k_int, _ = _keys(m)
    enb, _ = m["pdcp"].srb_pair(1, k_enc, k_int)
    other = _keys(m, bytes(32))
    _, ue = m["pdcp"].srb_pair(1, other[0], other[1])
    pdu = enb.encode(b"secret")
    return [pdu, ue.decode(pdu)]


def pdcp_drb_hfn(m):
    _, _, k_up = _keys(m)
    enb = m["pdcp"].PdcpEntity(srb=False, rb_id=5, direction_tx=1,
                               k_enc=k_up)
    ue = m["pdcp"].PdcpEntity(srb=False, rb_id=5, direction_tx=0,
                              k_enc=k_up)
    enb.tx_count = 4090
    ue.rx_next = 4090
    out = []
    for i in range(12):                      # crosses COUNT 4096
        pdu = enb.encode(f"ip-packet-{i}".encode())
        out.append((pdu, ue.decode(pdu)))
    return [out, ue.rx_next]


def pdcp_drb_7bit(m):
    _, _, k_up = _keys(m)
    args = dict(srb=False, rb_id=6, k_enc=k_up, sn_bits=7)
    enb = m["pdcp"].PdcpEntity(direction_tx=1, **args)
    ue = m["pdcp"].PdcpEntity(direction_tx=0, **args)
    out = []
    for i in range(300):                     # > 2 wraps of the 7-bit SN
        pdu = enb.encode(bytes([i & 0xFF]) * 5)
        out.append((pdu, ue.decode(pdu)))
    return out


def pdcp_pre_security(m):
    enb = m["pdcp"].PdcpEntity(srb=True, rb_id=1, direction_tx=1)
    ue = m["pdcp"].PdcpEntity(srb=True, rb_id=1, direction_tx=0)
    raw0 = enb.encode(b"rrc-setup-era")
    out = [raw0, ue.decode(raw0)]
    ke, ki, _ = _keys(m)
    enb.set_keys(ke, ki)
    ue.set_keys(ke, ki)
    raw = enb.encode(b"protected-era")
    bad = raw[:1] + bytes([raw[1] ^ 0xFF]) + raw[2:]
    return out + [raw, ue.decode(raw), ue.decode(bad)]


def pdcp_eea1_eia1(m):
    """The negotiated SNOW 3G algorithms (EEA1 / EIA1) on seeded SDUs."""
    rng = np.random.default_rng(11)
    k_enc, k_int = rng.bytes(16), rng.bytes(16)
    args = dict(srb=True, rb_id=2, k_enc=k_enc, k_int=k_int, enc_alg=1,
                int_alg=1)
    enb = m["pdcp"].PdcpEntity(direction_tx=1, **args)
    ue = m["pdcp"].PdcpEntity(direction_tx=0, **args)
    out = []
    for n in rng.integers(1, 200, 8):
        pdu = enb.encode(rng.bytes(int(n)))
        out.append((pdu, ue.decode(pdu)))
    return out


# -- cnfg_db (tests/test_stack_engine.py::test_cnfg_db) -----------------------

def _db(m, path):
    return (m["cnfg"].CnfgDb(path)
            .define("dl_earfcn", 300, lo=0, hi=65535)
            .define("bandwidth", 6, choices=(6, 15, 25, 50, 75, 100))
            .define("enable_pcap", False)
            .define("mcc", "001"))


def cnfg(m, path):
    db = _db(m, path)
    seen = []
    db._on_change["mcc"] = seen.append
    db.set("dl_earfcn", "1950")
    errs = []
    for name, value in (("bandwidth", 7), ("dl_earfcn", 70000),
                        ("dl_earfcn", -1)):
        try:
            db.set(name, value)
        except ValueError as e:
            errs.append(str(e))
    db.set("enable_pcap", "on")
    db.set("mcc", 262)
    db2 = _db(m, path)
    view = db2.as_ctrl_params()
    view["bandwidth"] = "25"
    return [db.items(), errs, seen, db2.items(), dict(view),
            "bandwidth" in view, "nope" in view, view["dl_earfcn"],
            open(path).read()]


# -- gw (tests/test_gw.py) ----------------------------------------------------

def _icmp_echo(src, dst, ident=0x1234, seq=1, payload=b"lteax-ping"):
    icmp = bytearray(struct.pack(">BBHHH", 8, 0, 0, ident, seq) + payload)
    cs = 0
    buf = icmp + (b"\x00" if len(icmp) % 2 else b"")
    for i in range(0, len(buf), 2):
        cs += (buf[i] << 8) | buf[i + 1]
    cs = (cs & 0xFFFF) + (cs >> 16)
    icmp[2:4] = struct.pack(">H", ~cs & 0xFFFF)
    ip = bytearray(struct.pack(">BBHHHBBH4s4s", 0x45, 0, 20 + len(icmp), 1,
                               0, 64, 1, 0, bytes(src), bytes(dst)))
    cs = 0
    for i in range(0, 20, 2):
        cs += (ip[i] << 8) | ip[i + 1]
    cs = (cs & 0xFFFF) + (cs >> 16)
    ip[10:12] = struct.pack(">H", ~cs & 0xFFFF)
    return bytes(ip) + bytes(icmp)


def gw_ipv4(m):
    rng = np.random.default_rng(3)
    out = []
    for _ in range(20):
        src = tuple(int(b) for b in rng.integers(0, 256, 4))
        dst = tuple(int(b) for b in rng.integers(0, 256, 4))
        pkt = _icmp_echo(src, dst, int(rng.integers(1 << 16)),
                         int(rng.integers(1 << 16)),
                         rng.bytes(int(rng.integers(0, 64))))
        rep = m["gw"].ipv4_icmp_echo_reply(pkt)
        out.append((m["gw"].ipv4_dst(pkt), rep, m["gw"].ipv4_dst(rep),
                    m["gw"].ipv4_icmp_echo_reply(rep)))
    return out + [m["gw"].ipv4_dst(b"\x60" + bytes(39)),
                  m["gw"].ipv4_icmp_echo_reply(b"junk")]


def gw_loop(m):
    g = m["gw"].GwLoop()
    got = []
    g.add_route((10, 0, 0, 2), got.append)
    p2 = _icmp_echo((10, 0, 0, 1), (10, 0, 0, 2))
    p9 = _icmp_echo((10, 0, 0, 1), (10, 0, 0, 9))
    g.inject_dl(p2)
    g.inject_dl(p9)                          # unrouted: dropped
    g.inject_dl(b"\x60" + bytes(39))         # IPv6: not ours
    g.send_ul(b"up")
    g.del_route((10, 0, 0, 2))
    g.inject_dl(p2)
    g.close()
    return [got, g.ul_packets]


# -- timers (tests/test_stack_engine.py::test_timer_manager) ------------------

def timer_manager(m):
    tm = m["timers"].TimerManager()
    fired = []
    t1 = tm.start(5, lambda: fired.append("a"))
    t2 = tm.start(3, lambda: fired.append("b"))
    t3 = tm.start(4, lambda: fired.append("c"))
    out = [tm.stop(t3), tm.stop(t3), tm.tick(2), list(fired), tm.tick(1),
           list(fired), tm.running(t1), tm.running(t2)]
    t1b = tm.restart(t1, 10)
    out += [t1b, tm.restart(999, 3), tm.tick(5), tm.tick(5), list(fired),
            tm.running(t1b), tm.now]
    rng = np.random.default_rng(8)
    ids = [tm.start(int(n), lambda i=i: fired.append(i))
           for i, n in enumerate(rng.integers(0, 20, 30))]
    for tid in ids[::4]:
        tm.stop(tid)
    out += [[tm.tick(int(n)) for n in rng.integers(0, 4, 12)], fired]
    return out


CASES = {f.__name__: f for f in (
    sched_si, sched_rar, sched_round_robin, sched_no_overlap, sched_tables,
    pdcp_srb_wrap, pdcp_integrity, pdcp_wrong_key, pdcp_drb_hfn,
    pdcp_drb_7bit, pdcp_pre_security, pdcp_eea1_eia1, gw_ipv4, gw_loop,
    timer_manager)}


@pytest.mark.parametrize("case", sorted(CASES))
def test_stack_case_equals_the_reference(case):
    assert CASES[case](PORT) == CASES[case](REF)


def test_cnfg_db_equals_the_reference(tmp_path):
    got = cnfg(PORT, str(tmp_path / "port.json"))
    want = cnfg(REF, str(tmp_path / "ref.json"))
    assert got == want
    # the reference test's own assertions, on the port's record
    items, errs, seen, items2 = got[:4]
    assert items["dl_earfcn"] == 1950 and len(errs) == 3 and seen == ["262"]
    assert items2["enable_pcap"] is True and items2["bandwidth"] == 25


def test_reference_assertions_hold_on_the_port():
    """The reference tests' own checks, on the port's copies."""
    g_even, g_odd, g_none = sched_si(PORT)
    assert g_even[0][0] == mac_sched.SI_RNTI and g_even[0][6] == "sib1"
    assert g_odd[0][6] == "si" and g_none == []
    tc, grants, rapid, tc_rx = sched_rar(PORT)
    assert len(grants) == 1 and grants[0][6] == "rar"
    assert rapid == 17 and tc_rx == tc
    served = {}
    for tti in sched_round_robin(PORT):
        for g in tti:
            served[g[0]] = served.get(g[0], 0) + 1
    assert sorted(served) == [0x10, 0x11, 0x12]
    spans = sorted((g[1], g[1] + g[2]) for g in sched_no_overlap(PORT))
    assert all(a1 <= b0 for (_, a1), (b0, _) in zip(spans, spans[1:]))
    out, tx, rx = pdcp_srb_wrap(PORT)
    assert [sdu for _, sdu in out] == [f"rrc-{i}".encode()
                                       for i in range(70)]
    assert tx == 70 and rx == 70
    assert pdcp_integrity(PORT)[1::2] == [None, b"again"]
    assert pdcp_wrong_key(PORT)[1] is None
    raw0, sdu0, raw, sdu, bad = pdcp_pre_security(PORT)
    assert raw0[-4:] == bytes(4) and raw[-4:] != bytes(4)
    assert (sdu0, sdu, bad) == (b"rrc-setup-era", b"protected-era", None)
    got, ul = gw_loop(PORT)
    assert len(got) == 1 and ul == [b"up"]
    fired = timer_manager(PORT)[12]
    assert fired == ["b", "a"]
