"""The port's eNodeB service (``lteax_torch.apps.enb_service``) on the CPU
(``device="cpu"``), against the reference's ``tests/test_enb_service.py``
and ``tests/test_gw.py``.

- Attach, ping and detach over the ctrl socket give the reference test's
  strings.
- The IQ the service writes (``iq_out``) equals the reference service's for
  the same configuration within 1e-5 (absolute; unit-power resource
  elements, orthonormal OFDM) over its first 10 subframes, and the port's
  ``file_scan.scan`` decodes 45 subframes of it to the cell ID, the MIB
  and SIB1's TAC.
- The freerun thread runs the TTI loop on the service's explicit device.
- A kernel ICMP echo goes through a TUN device, the DRB over the port's
  TTI loop, the UE's echo, SR / DCI 0 / PUSCH and back into the kernel
  (skipped without ``/dev/net/tun`` and raw-socket privileges).
"""

import socket
import struct
import time

import numpy as np
import pytest
import torch

from lteax.apps.enb_service import EnbService as RefEnbService

from lteax_torch.apps.enb_service import EnbService
from lteax_torch.apps.file_scan import scan
from lteax_torch.phy.config import PhyConfig
from lteax_torch.stack.gw import GwTun

IMSI = "001011234567890"
K_HEX = "465b5ce8b199b49faa5f0a2ee238a6bc"
OPC_HEX = "cd63cb71954a9f4e48a5994e37a02baf"
IQ_TOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def _setup():
    """One torch thread; the reference's fft OFDM (the port's form)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    mp = pytest.MonkeyPatch()
    mp.setenv("LTEAX_OFDM_DFT", "fft")
    yield
    mp.undo()
    torch.set_num_threads(n)


def _cmd(port, line):
    with socket.create_connection(("127.0.0.1", port), timeout=120) as s:
        s.sendall(line.encode() + b"\n")
        return s.makefile().readline().strip()


def test_enb_service_attach_ping_detach():
    svc = EnbService(port=0, device="cpu")
    try:
        p = svc.port
        assert _cmd(p, f"add_user {IMSI} {K_HEX} {OPC_HEX}").startswith("ok")
        assert _cmd(p, "write n_id_cell 77").startswith("ok")
        assert _cmd(p, "read bandwidth") == "ok bandwidth = 6"
        assert _cmd(p, "start").startswith("ok started")
        assert svc.enb.device == torch.device("cpu")
        assert "attaching" in _cmd(p, f"add_ue {IMSI}")
        assert _cmd(p, "step 40") == "ok tti=40"
        st = _cmd(p, "status")
        assert "state=connected" in st and "ip=10.0.0.2" in st
        assert _cmd(p, f"ping {IMSI}") == "ok queued"
        _cmd(p, "step 10")
        assert "rx=1" in _cmd(p, "status")
        su = next(iter(svc.ues.values()))
        assert su.ue.data_sdus == [b"ping-" + IMSI.encode()]
        assert su.ue.device == svc.device
        assert "detaching" in _cmd(p, f"detach_ue {IMSI}")
        _cmd(p, "step 20")
        assert "state=idle" in _cmd(p, "status")
        assert _cmd(p, "ping 999").startswith("ok error")
        assert _cmd(p, "add_ue 999999999999999").startswith("ok error")
    finally:
        svc.close()


def _iq(cls, path, n_tti, **kw) -> np.ndarray:
    svc = cls(port=0, **kw)
    try:
        assert _cmd(svc.port, "write n_id_cell 133").startswith("ok")
        assert _cmd(svc.port, f"write iq_out {path}").startswith("ok")
        assert _cmd(svc.port, "start").startswith("ok started")
        _cmd(svc.port, f"step {n_tti}")
    finally:
        svc.close()
    return np.fromfile(path, np.float32).view(np.complex64)


@pytest.fixture(scope="module")
def iq_out(tmp_path_factory):
    d = tmp_path_factory.mktemp("enb_iq")
    return (_iq(EnbService, d / "port.iq", 45, device="cpu"),
            _iq(RefEnbService, d / "ref.iq", 10))


def test_iq_out_equals_the_reference(iq_out):
    got, want = iq_out
    nsf = PhyConfig(n_rb_dl=6).n_samps_subframe
    assert len(got) == 45 * nsf and len(want) == 10 * nsf
    assert np.max(np.abs(got[:len(want)] - want)) <= IQ_TOL


def test_iq_out_decoded_by_the_port_scanner(iq_out):
    res = scan(iq_out[0], PhyConfig(n_rb_dl=6), device="cpu")
    assert res.n_cell_id == 133
    assert res.mib is not None and res.mib.n_rb_dl == 6
    assert res.sib1 is not None and res.sib1.tac == 0x1234


def test_freerun_thread_uses_the_service_device():
    """``start freerun`` advances the TTI loop in its own thread, whose
    receivers take the service's device (not the thread's current one)."""
    svc = EnbService(port=0, device="cpu")
    try:
        svc.hss.add_user(IMSI, K_HEX, OPC_HEX)
        assert _cmd(svc.port, "start freerun") == "ok started (freerun)"
        assert "attaching" in _cmd(svc.port, f"add_ue {IMSI}")
        t_end = time.monotonic() + 60
        while svc._tti < 12 and time.monotonic() < t_end:
            time.sleep(0.05)
        assert _cmd(svc.port, "stop") == "ok stopped"
        assert svc._tti >= 12
        su = next(iter(svc.ues.values()))
        assert su.ue.device == svc.enb.device == torch.device("cpu")
        assert su.ue.rrc_ue.state != "idle"
    finally:
        svc.close()


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


def _tun_available():
    if not GwTun.available():
        return False
    try:
        s = socket.socket(socket.AF_INET, socket.SOCK_RAW,
                          socket.IPPROTO_ICMP)
        s.close()
        return True
    except PermissionError:
        return False


@pytest.mark.skipif(not _tun_available(),
                    reason="needs /dev/net/tun + raw-socket privileges")
def test_kernel_ping_through_phy(tmp_path):
    """Kernel ICMP -> TUN -> DRB DL over the port's TTI loop -> UE echo ->
    SR/grant -> PUSCH UL -> TUN -> kernel.  Its own interface and subnet
    (10.0.77.0/24), so that it may run beside the reference's test: the UE
    answers for 10.0.77.2 (routed to it by hand; the MME hands out
    10.0.0.x)."""
    svc = EnbService(port=0, cnfg_path=str(tmp_path / "cnfg"),
                     hss_path=str(tmp_path / "hss"), device="cpu")
    ue_ip = (10, 0, 77, 2)
    try:
        svc.cnfg.set("gw_enable", True)
        svc.cnfg.set("gw_ifname", "lteaxtorch0")
        svc.cnfg.set("gw_ip", "10.0.77.1")
        imsi = "001010000000001"
        svc.hss.add_user(imsi, "000102030405060708090a0b0c0d0e0f",
                         "101112131415161718191a1b1c1d1e1f")
        assert "started" in svc._cmd_start([])
        assert svc.gw is not None, "TUN gateway failed to come up"
        assert "attaching" in svc._cmd_add_ue([imsi])
        svc._cmd_step(["12"])                 # completes attach + route
        rnti, su = next(iter(svc.ues.items()))
        assert su.ue.rrc_ue.ip is not None
        svc.gw.add_route(ue_ip, lambda pkt: svc._gw_dl(rnti, pkt))
        sock = socket.socket(socket.AF_INET, socket.SOCK_RAW,
                             socket.IPPROTO_ICMP)
        sock.bind(("10.0.77.1", 0))
        sock.settimeout(0.2)
        sock.sendto(_icmp_echo((10, 0, 77, 1), ue_ip)[20:],
                    (".".join(map(str, ue_ip)), 0))
        reply = None
        for _ in range(40):                   # SR handshake needs TTIs
            svc._cmd_step(["4"])
            try:
                data, addr = sock.recvfrom(2048)
            except socket.timeout:
                continue
            ihl = (data[0] & 0xF) * 4
            if data[ihl] == 0 and addr[0] == ".".join(map(str, ue_ip)):
                reply = data
                break
        sock.close()
        assert reply is not None, "no ICMP echo reply through the PHY"
        assert reply[ihl + 4:ihl + 8] == struct.pack(">HH", 0x1234, 1)
    finally:
        svc.close()
