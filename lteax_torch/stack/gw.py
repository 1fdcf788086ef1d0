"""IP gateway: TUN device bridging the kernel IP stack to UE bearers.
The port's own copy of ``lteax.stack.gw``.

(reference capability: ``LTE_fdd_enodeb/src/LTE_fdd_enb_gw.cc`` — a Linux
TUN device whose read thread pushes DL IP packets into PDCP and which
writes UL-delivered packets back to the kernel — SURVEY.md §2.3 GW row.)

Two interchangeable backends:

- :class:`GwTun` — the real thing: opens ``/dev/net/tun``, configures the
  interface (``ip addr``/``ip link``), reads DL packets in a thread and
  routes them by destination IP to a per-UE callback; ``send_ul`` injects
  UE uplink packets into the kernel.  Needs ``/dev/net/tun`` and the
  privileges to configure it.
- :class:`GwLoop` — in-process pair with the same surface for unprivileged
  tests: ``inject_dl`` plays the kernel's role, UL packets land in
  ``ul_packets``.

Routing: the owner registers ``add_route(ip, cb)`` per attached UE (the IP
the MME assigned in the ActivateDefaultEpsBearer); unrouted packets are
dropped (counted).
"""

from __future__ import annotations

import fcntl
import os
import select
import struct
import subprocess
import threading

from lteax_torch.utils.metrics import EVENTS, METRICS

_TUNSETIFF = 0x400454CA
_IFF_TUN = 0x0001
_IFF_NO_PI = 0x1000


def ipv4_dst(packet: bytes) -> tuple[int, int, int, int] | None:
    """Destination IP of an IPv4 packet, or None for non-IPv4."""
    if len(packet) < 20 or packet[0] >> 4 != 4:
        return None
    return tuple(packet[16:20])


def ipv4_icmp_echo_reply(packet: bytes) -> bytes | None:
    """If ``packet`` is an IPv4 ICMP echo request, build the echo reply
    (the simulated UE's ping responder); else None."""
    if len(packet) < 28 or packet[0] >> 4 != 4 or packet[9] != 1:
        return None
    ihl = (packet[0] & 0xF) * 4
    icmp = packet[ihl:]
    if not icmp or icmp[0] != 8:         # echo request
        return None
    ip = bytearray(packet[:ihl])
    ip[12:16], ip[16:20] = packet[16:20], packet[12:16]   # swap src/dst
    ip[8] = 64                            # fresh TTL
    ip[10:12] = b"\x00\x00"
    cs = 0
    for i in range(0, ihl, 2):
        cs += (ip[i] << 8) | ip[i + 1]
    cs = (cs & 0xFFFF) + (cs >> 16)
    cs = (cs & 0xFFFF) + (cs >> 16)
    ip[10:12] = struct.pack(">H", ~cs & 0xFFFF)
    reply = bytearray(icmp)
    reply[0] = 0                          # echo reply
    reply[2:4] = b"\x00\x00"
    cs = 0
    if len(reply) % 2:
        reply.append(0)
    for i in range(0, len(reply), 2):
        cs += (reply[i] << 8) | reply[i + 1]
    cs = (cs & 0xFFFF) + (cs >> 16)
    cs = (cs & 0xFFFF) + (cs >> 16)
    reply[2:4] = struct.pack(">H", ~cs & 0xFFFF)
    if len(icmp) % 2:
        reply = reply[:-1]
    return bytes(ip) + bytes(reply)


class _GwBase:
    def __init__(self):
        self._routes: dict[tuple, object] = {}
        self._lock = threading.Lock()

    def add_route(self, ip: tuple, cb) -> None:
        """cb(packet: bytes) receives DL packets addressed to ``ip``."""
        with self._lock:
            self._routes[tuple(ip)] = cb
        EVENTS.emit("gw.route_add", level="debug",
                    ip=".".join(map(str, ip)))

    def del_route(self, ip: tuple) -> None:
        with self._lock:
            self._routes.pop(tuple(ip), None)

    def _route_dl(self, packet: bytes) -> None:
        dst = ipv4_dst(packet)
        if dst is None:
            return                        # IPv6/other: not ours
        with self._lock:
            cb = self._routes.get(dst)
        if cb is None:
            METRICS.inc("gw.dl_unrouted")
            return
        METRICS.inc("gw.dl_packets")
        cb(packet)


class GwTun(_GwBase):
    """Real TUN gateway (requires /dev/net/tun + `ip` config privileges)."""

    def __init__(self, ifname: str = "lteax_gw", ip: str = "10.0.0.1",
                 prefix: int = 24):
        super().__init__()
        self.ifname = ifname
        self.fd = os.open("/dev/net/tun", os.O_RDWR)
        ifr = struct.pack("16sH22s", ifname.encode(),
                          _IFF_TUN | _IFF_NO_PI, b"")
        fcntl.ioctl(self.fd, _TUNSETIFF, ifr)
        subprocess.run(["ip", "addr", "replace", f"{ip}/{prefix}",
                        "dev", ifname], check=True)
        subprocess.run(["ip", "link", "set", ifname, "up"], check=True)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._read_loop, daemon=True)
        self._thread.start()
        EVENTS.emit("gw.up", ifname=ifname, ip=ip)

    @staticmethod
    def available() -> bool:
        return os.path.exists("/dev/net/tun") and os.access("/dev/net/tun",
                                                            os.W_OK)

    def _read_loop(self) -> None:
        while not self._stop.is_set():
            rd, _, _ = select.select([self.fd], [], [], 0.2)
            if not rd:
                continue
            try:
                pkt = os.read(self.fd, 4096)
            except OSError:
                return
            self._route_dl(pkt)

    def send_ul(self, packet: bytes) -> None:
        """UE -> network: inject the packet into the kernel."""
        METRICS.inc("gw.ul_packets")
        os.write(self.fd, packet)

    def close(self) -> None:
        self._stop.set()
        self._thread.join(timeout=2)
        os.close(self.fd)


class GwLoop(_GwBase):
    """In-process backend with the same surface (tests, no privileges)."""

    def __init__(self):
        super().__init__()
        self.ul_packets: list[bytes] = []

    def inject_dl(self, packet: bytes) -> None:
        self._route_dl(packet)

    def send_ul(self, packet: bytes) -> None:
        METRICS.inc("gw.ul_packets")
        self.ul_packets.append(packet)

    def close(self) -> None:
        pass
