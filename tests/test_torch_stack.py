"""The port's stack copies against the reference's, on the CPU.

``lteax_torch.stack.{mac_pdu, rlc_pdu, pdcp_pdu, snow3g, nas, rlc_am,
rlc_um, users, rrc_dedicated, rrc_meas, rrc_proc}`` and
``lteax_torch.io.pcap`` are copies that change only their import paths;
``lteax_torch.stack.security`` replaces the ``cryptography`` package with
its own AES-128.  Each is held to the reference by behaviour: the same
messages pack to the same bytes, the 3GPP / RFC vectors of the reference's
own tests hold, seeded random keys and messages give the reference's bytes
through every security function, and the RRC attach and handover of
``rrc_attach_sim`` (with no PHY in between) exchange the same bytes.
"""

import dataclasses
import os

import numpy as np
import pytest

from lteax.apps import rrc_attach_sim as sim_ref
from lteax.io import pcap as pcap_ref
from lteax.stack import mac_pdu as mac_ref
from lteax.stack import nas as nas_ref
from lteax.stack import pdcp_pdu as pdcp_ref
from lteax.stack import rlc_am as am_ref
from lteax.stack import rlc_pdu as rlc_ref
from lteax.stack import rlc_um as um_ref
from lteax.stack import rrc_dedicated as rd_ref
from lteax.stack import rrc_proc as proc_ref
from lteax.stack import security as sec_ref
from lteax.stack import snow3g as snow_ref
from lteax.stack import users as users_ref

from lteax_torch.apps import rrc_attach_sim as sim
from lteax_torch.io import pcap
from lteax_torch.stack import (mac_pdu, nas, pdcp_pdu, rlc_am, rlc_pdu,
                               rlc_um, rrc_dedicated, rrc_proc, security,
                               snow3g, users)

IMSI = (0, 0, 1, 0, 1, 1, 2, 3, 4, 5, 6, 7, 8, 9, 0)
K = bytes.fromhex("465b5ce8b199b49faa5f0a2ee238a6bc")
OPC = bytes.fromhex("cd63cb71954a9f4e48a5994e37a02baf")


def twin(mod, mod_ref, name, **kw):
    """The same dataclass built in the port's module and the reference's."""
    return getattr(mod, name)(**kw), getattr(mod_ref, name)(**kw)


def rbytes(rng, n):
    return rng.integers(0, 256, n).astype(np.uint8).tobytes()


def test_pdus_pack_to_the_reference_bytes():
    """Seeded random MAC, RAR, RLC UM/AM/STATUS and PDCP SRB/DRB PDUs."""
    rng = np.random.default_rng(0)
    for _ in range(20):
        subs = [(int(lcid), rbytes(rng, 1 if lcid == mac_pdu.LCID_TA_CMD
                                   else int(rng.integers(1, 300))))
                for lcid in rng.choice([0, 1, 3, mac_pdu.LCID_TA_CMD],
                                       int(rng.integers(1, 4)))]
        pad = None if rng.random() < 0.5 else \
            sum(len(p) for _, p in subs) + 20
        got = mac_pdu.pack_mac_pdu([mac_pdu.MacSubPdu(l, p)
                                    for l, p in subs], pad)
        want = mac_ref.pack_mac_pdu([mac_ref.MacSubPdu(l, p)
                                     for l, p in subs], pad)
        assert got == want
        assert [(s.lcid, s.payload) for s in mac_pdu.unpack_mac_pdu(got)] \
            == [(s.lcid, s.payload) for s in mac_ref.unpack_mac_pdu(want)]
        rar = dict(rapid=int(rng.integers(64)),
                   timing_advance=int(rng.integers(2048)),
                   ul_grant=int(rng.integers(1 << 20)),
                   tc_rnti=int(rng.integers(1 << 16)))
        a, b = twin(mac_pdu, mac_ref, "Rar", **rar)
        got = mac_pdu.pack_rar_pdu([a], backoff=3)
        assert got == mac_ref.pack_rar_pdu([b], backoff=3)
        assert dataclasses.asdict(mac_pdu.unpack_rar_pdu(got)[1][0]) == rar
        data = rbytes(rng, int(rng.integers(1, 100)))
        for name, fields, pack in (
                ("UmdPdu", dict(sn=int(rng.integers(1024)), data=data,
                                fi=int(rng.integers(4))), "pack_umd"),
                ("AmdPdu", dict(sn=int(rng.integers(1024)), data=data,
                                poll=bool(rng.integers(2)),
                                fi=int(rng.integers(4))), "pack_amd"),
                ("StatusPdu", dict(ack_sn=int(rng.integers(1024)),
                                   nack_sns=tuple(int(x) for x in
                                                  rng.integers(0, 1024, 3))),
                 "pack_status")):
            a, b = twin(rlc_pdu, rlc_ref, name, **fields)
            assert getattr(rlc_pdu, pack)(a) == getattr(rlc_ref, pack)(b)
        for name, fields, pack in (
                ("PdcpSrbPdu", dict(sn=int(rng.integers(32)), data=data,
                                    mac_i=rbytes(rng, 4)), "pack_srb"),
                ("PdcpDrbPdu", dict(sn=int(rng.integers(4096)), data=data),
                 "pack_drb")):
            a, b = twin(pdcp_pdu, pdcp_ref, name, **fields)
            assert getattr(pdcp_pdu, pack)(a) == getattr(pdcp_ref, pack)(b)


# -- security: the vectors of the reference's tests, then random inputs --------

def test_milenage_35207_test_set_1():
    rand = bytes.fromhex("23553cbe9637a89d218ae64dae47bf35")
    op = bytes.fromhex("cdc202d5123e20f62b6d676ac72cb318")
    sqn, amf = bytes.fromhex("ff9bb4d0b607"), bytes.fromhex("b9b9")
    assert security.milenage_op_c(K, op) == OPC
    assert security.milenage_f1(K, rand, sqn, amf, op_c=OPC)[0] == \
        bytes.fromhex("4a9ffac354dfafb3")
    res, ck, ik, ak = security.milenage_f2345(K, rand, op_c=OPC)
    assert res == bytes.fromhex("a54211d5e3ba50bf")
    assert ck == bytes.fromhex("b40ba9a3c58b2a05bbf0d987b21bf8cb")
    assert ik == bytes.fromhex("f769bcd751044604127672711c6d3441")
    assert ak == bytes.fromhex("aa689c648370")


def test_eia2_cmac_and_aes_vectors():
    """33.401 C.2 EIA2 set 1 (58 bits), RFC 4493 CMAC, FIPS-197 C.1."""
    key = bytes.fromhex("2bd6459f82c5b300952c49104881ff48")
    assert security.eia2(key, 0x38A6F056, 0x18, 0,
                         bytes.fromhex("3332346263393840"),
                         data_bits=58) == bytes.fromhex("118c6eb8")
    key = bytes.fromhex("2b7e151628aed2a6abf7158809cf4f3c")
    assert security.aes_cmac(key, b"") == \
        bytes.fromhex("bb1d6929e95937287fa37d129b756746")
    assert security.aes_cmac(
        key, bytes.fromhex("6bc1bee22e409f96e93d7e117393172a")) == \
        bytes.fromhex("070a16b46b4d4144f79bdd9dd04a287c")
    assert security._aes_ecb_encrypt(
        bytes(range(16)), bytes.fromhex("00112233445566778899aabbccddeeff")
    ) == bytes.fromhex("69c4e0d86a7b0430d8cdb78070b4c55a")
    data = bytes(range(64))
    c = security.eea2(bytes(range(16)), 7, 3, 1, data)
    assert c != data and security.eea2(bytes(range(16)), 7, 3, 1, c) == data


def test_security_equals_the_reference_on_random_inputs():
    """The KDFs, Milenage f1-f5, AES-ECB, EEA2 at lengths that are not
    multiples of 16 and EIA2 / CMAC at bit lengths that are not multiples
    of 8, byte for byte against the ``cryptography``-backed reference."""
    rng = np.random.default_rng(7)
    for i in range(12):
        k, opc, rand = rbytes(rng, 16), rbytes(rng, 16), rbytes(rng, 16)
        sqn, amf = rbytes(rng, 6), rbytes(rng, 2)
        assert security.milenage_op_c(k, opc) == sec_ref.milenage_op_c(k, opc)
        assert security.milenage_f1(k, rand, sqn, amf, op_c=opc) == \
            sec_ref.milenage_f1(k, rand, sqn, amf, op_c=opc)
        assert security.milenage_f2345(k, rand, op=opc) == \
            sec_ref.milenage_f2345(k, rand, op=opc)
        blk = rbytes(rng, 16 * (1 + i % 3))
        assert security._aes_ecb_encrypt(k, blk) == \
            sec_ref._aes_ecb_encrypt(k, blk)
        args = (rbytes(rng, 16), rbytes(rng, 16), sqn, rbytes(rng, 3))
        k_asme = security.generate_k_asme(*args)
        assert k_asme == sec_ref.generate_k_asme(*args)
        k_enb = security.generate_k_enb(k_asme, i)
        assert k_enb == sec_ref.generate_k_enb(k_asme, i)
        assert security.generate_nas_keys(k_asme, 2, 2) == \
            sec_ref.generate_nas_keys(k_asme, 2, 2)
        assert security.generate_as_keys(k_enb) == \
            sec_ref.generate_as_keys(k_enb)
        assert security.generate_k_enb_star(k_enb, 350, 6300) == \
            sec_ref.generate_k_enb_star(k_enb, 350, 6300)
        count, bearer = int(rng.integers(1 << 32)), int(rng.integers(32))
        data = rbytes(rng, int(rng.integers(0, 70)))
        assert security.eea2(k, count, bearer, i % 2, data) == \
            sec_ref.eea2(k, count, bearer, i % 2, data)
        bits = max(0, 8 * len(data) - int(rng.integers(0, 8)))
        assert security.eia2(k, count, bearer, i % 2, data, bits) == \
            sec_ref.eia2(k, count, bearer, i % 2, data, bits)
        assert security.aes_cmac(k, data, bits) == \
            sec_ref.aes_cmac(k, data, bits)
        for alg in (0, 1, 2):
            assert security.eea(alg, k, count, bearer, 1, data) == \
                sec_ref.eea(alg, k, count, bearer, 1, data)
        for alg in (1, 2):
            assert security.eia(alg, k, count, bearer, 0, data, bits) == \
                sec_ref.eia(alg, k, count, bearer, 0, data, bits)


def test_snow3g_equals_the_reference():
    """EEA1 on the 33.401 C.1 set 1 vector and random inputs, EIA1 on
    random inputs at odd bit lengths."""
    key = bytes.fromhex("d3c5d592327fb11c4035c6680af8c6d1")
    pt = bytes.fromhex("981ba6824c1bfb1ab485472029b71d80"
                       "8ce33e2cc3c0b5fc1f3de8a6dc66b1f0")
    assert snow3g.eea1(key, 0x398A59B4, 0x15, 1, pt, data_bits=253) == \
        bytes.fromhex("5d5bfe75eb04f68ce0a12377ea00b37d"
                      "47c6a0ba06309155086a859c4341b378")
    assert snow3g.SR == snow_ref.SR and snow3g.SQ == snow_ref.SQ
    rng = np.random.default_rng(3)
    for _ in range(6):
        k, data = rbytes(rng, 16), rbytes(rng, int(rng.integers(1, 60)))
        count, bearer = int(rng.integers(1 << 32)), int(rng.integers(32))
        bits = 8 * len(data) - int(rng.integers(0, 8))
        assert snow3g.eea1(k, count, bearer, 1, data, bits) == \
            snow_ref.eea1(k, count, bearer, 1, data, bits)
        assert snow3g.eia1(k, count, bearer, 0, data, bits) == \
            snow_ref.eia1(k, count, bearer, 0, data, bits)


# -- NAS, pcap -----------------------------------------------------------------

def nas_messages(m):
    """Every NAS message ``attach_sim`` and ``rrc_proc`` send, packed by
    the module ``m`` (the port's or the reference's nas)."""
    esm = m.pack_pdn_connectivity_request(m.PdnConnectivityRequest())
    bearer = m.pack_activate_default_bearer_request(
        m.ActivateDefaultBearerRequest(ebi=5, pti=1, apn="internet",
                                       ip=(10, 0, 0, 2)))
    return [
        esm, bearer,
        m.pack_attach_request(m.AttachRequest(imsi=IMSI, esm_container=esm)),
        m.pack_auth_request(m.AuthRequest(ksi=0, rand=bytes(range(16)),
                                          autn=bytes(range(16, 32)))),
        m.pack_auth_response(m.AuthResponse(res=bytes(range(8)))),
        m.pack_security_mode_command(m.SecurityModeCommand(2, 2, 0)),
        m.pack_security_mode_complete(),
        m.pack_attach_accept(m.AttachAccept(
            attach_result=1, t3412_s=3600, tac=0x1234, mcc=(0, 0, 1),
            mnc=(0, 1), esm_container=bearer)),
        m.pack_attach_complete(m.AttachComplete(
            esm_container=m.pack_activate_default_bearer_accept(
                m.ActivateDefaultBearerAccept(ebi=5)))),
        m.pack_emm_information(m.EmmInformation(network_name="lteax")),
        m.pack_detach_request(m.DetachRequest(switch_off=True, ksi=1)),
        m.pack_detach_accept(),
    ]


def test_nas_messages_and_protection():
    """Each message packs to the reference's bytes and unpacks alike;
    protect / unprotect agree both ways, with and without ciphering."""
    got, want = nas_messages(nas), nas_messages(nas_ref)
    assert got == want
    for name, i in (("attach_request", 2), ("auth_request", 3),
                    ("attach_accept", 7), ("emm_information", 9)):
        unpack = "unpack_" + name
        assert dataclasses.asdict(getattr(nas, unpack)(got[i])) == \
            dataclasses.asdict(getattr(nas_ref, unpack)(want[i]))
    rng = np.random.default_rng(5)
    k_int, k_enc = rbytes(rng, 16), rbytes(rng, 16)
    for i, plain in enumerate(got):
        for hdr in (nas.SEC_HDR_INTEGRITY,
                    nas.SEC_HDR_INTEGRITY_CIPHERED,
                    nas.SEC_HDR_INTEGRITY_CIPHERED_NEW_CTX):
            wire = nas.protect(plain, k_int, i, i % 2 == 0, k_enc, hdr)
            assert wire == nas_ref.protect(plain, k_int, i, i % 2 == 0,
                                           k_enc, hdr)
            assert nas.unprotect(wire, k_int, i, i % 2 == 0, k_enc) == \
                nas_ref.unprotect(wire, k_int, i, i % 2 == 0, k_enc) == \
                (plain, True)


def test_pcap_writer_equal_bytes(tmp_path):
    """The same records with fixed timestamps: the same file."""
    files = []
    for mod, name in ((pcap, "port"), (pcap_ref, "ref")):
        path = tmp_path / f"{name}.pcap"
        with mod.MacPcapWriter(str(path)) as w:
            w.write(b"\x3d\x21\x04abcd", mod.DIR_DL, mod.RNTI_SI, 0xFFFF,
                    subframe=5, ts=1000.5)
            w.write(bytes(10), mod.DIR_UL, mod.RNTI_C, 0x003D, ts=1000.625)
            w.write(b"rar", mod.DIR_DL, mod.RNTI_RA, 2, subframe=1,
                    ts=12.000001)
        files.append(path.read_bytes())
    assert files[0] == files[1] and len(files[0]) > 24


# -- RLC entities, users, and the RRC procedure with no PHY between ------------

def rlc_traffic(am, um, pdu_mod):
    """SDUs through an AM link that drops every fifth PDU (STATUS, poll
    retransmissions) and a UM link that reorders and loses: every PDU sent
    and every SDU delivered, in order."""
    log = []
    tx, rx = am.AmTransmitter(poll_every=3), am.AmReceiver()
    for i in range(14):
        tx.submit(bytes([i]) * (5 + i % 7))
    n = 0
    for _ in range(30):
        while (pdu := tx.pull()) is not None:
            log.append(pdu)
            n += 1
            if n % 5:
                rx.handle_pdu(pdu)
        log.extend(rx.take_delivered())
        st = rx.make_status()
        if st is not None:
            log.append(st)
            tx.handle_status(pdu_mod.unpack_status(st))
        if tx.all_acked:
            break
        tx.poll_retransmit()
    utx, urx = um.UmTransmitter(sn_bits=5), um.UmReceiver(sn_bits=5)
    pdus = [utx.send(bytes([i]) * 3) for i in range(40)]
    log.extend(pdus)
    for j in (1, 0, 2, 4, 3, *range(6, 40)):
        urx.handle_pdu(pdus[j])
        urx.tick(4)
    log.extend(urx.take_delivered())
    return log


def test_rlc_entities_equal():
    got = rlc_traffic(rlc_am, rlc_um, rlc_pdu)
    assert got == rlc_traffic(am_ref, um_ref, rlc_ref)
    assert len(got) > 60


def rrc_exchange(proc, usr, rd, link, mac, monkeypatch):
    """``rrc_attach_sim``'s procedure (attach, DRB packet keys, A3
    measurement config, report, handover command and the target cell's
    ReconfigurationComplete) with the bytes handed over directly: every
    MAC PDU on the air in order, then the final states."""
    draws = iter(range(1, 1000))
    monkeypatch.setattr(os, "urandom",
                        lambda n: next(draws).to_bytes(n, "big"))
    hss = usr.Hss()
    hss.add_user("".join(map(str, IMSI)), K.hex(), OPC.hex())
    enb = proc.EnbRrc(hss, usr.UserManager(), seed=42)
    ue = proc.UeRrc(IMSI, K, OPC)
    dl, ul = link(downlink=True), link(downlink=False)
    air = []

    def on_air(chan, raw, srb):
        lcid = mac.LCID_CCCH if chan == "ccch" else 0x01
        pdu = mac.pack_mac_pdu([mac.MacSubPdu(
            lcid, raw if chan == "ccch" else srb.frame(raw))])
        air.append(pdu)
        sub = mac.unpack_mac_pdu(pdu)[0]
        return sub.lcid, (sub.payload if sub.lcid == mac.LCID_CCCH
                          else srb.deframe(sub.payload))

    def up(chan, raw, rnti=0x3D, srb=ul):
        lcid, body = on_air(chan, raw, srb)
        return (enb.on_ul_ccch(rnti, body) if lcid == mac.LCID_CCCH
                else enb.on_ul_dcch(rnti, body))

    def down(chan, raw):
        lcid, body = on_air(chan, raw, dl)
        return (ue.on_dl_ccch(body) if lcid == mac.LCID_CCCH
                else ue.on_dl_dcch(body))

    queue = up("ccch", ue.connect())
    while queue:
        replies = down(*queue.pop(0))
        if ue.k_enb and ul.k_int is None:
            ul.k_int = dl.k_int = sim.security.generate_as_keys(ue.k_enb)[1]
        for c, raw in replies:
            queue.extend(up(c, raw))
    enb.neighbors[350] = 6300
    (c, raw), = enb.configure_measurements(0x3D)
    for c2, raw2 in down(c, raw):
        assert up(c2, raw2) == []
    (c, rep), = ue.measurement_report(
        1, serv_rsrp=50, serv_rsrq=20,
        neigh=(rd.MeasResultEutra(350, rsrp=62),))
    cmds = up(c, rep)
    (c, comp), = down(*cmds[0])
    ul_t = link(downlink=False)
    ul_t.k_int = sim.security.generate_as_keys(ue.k_enb)[1]
    assert up(c, comp, ue.c_rnti, ul_t) == []
    p = enb.proc(ue.c_rnti)
    return (air, ue.state, p.state, ue.k_enb, p.k_enb, ue.ip, enb.events,
            ue.events, sorted(u.imsi for u in enb.users._by_rnti.values()))


def test_rrc_attach_and_handover_exchange_equal(monkeypatch):
    got = rrc_exchange(rrc_proc, users, rrc_dedicated, sim._SrbLink, mac_pdu,
                       monkeypatch)
    want = rrc_exchange(proc_ref, users_ref, rd_ref, sim_ref._SrbLink,
                        mac_ref, monkeypatch)
    assert got[0] == want[0] and len(got[0]) >= 15
    assert got[1:] == want[1:]
    assert got[1:3] == ("connected", "attach-done")
    assert "handover-complete" in got[6]
