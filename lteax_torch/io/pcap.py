"""MAC-LTE pcap writer (Wireshark ``mac-lte-framed`` format).

(reference capability: the ``enable_pcap`` MAC-layer dump of
``LTE_fdd_enb_mac.cc`` — SURVEY.md §5 calls it "the one genuinely good
observability feature"; capability parity here.)

Packets are written with LINKTYPE_USER1 (148) carrying the Wireshark
packet-mac-lte "framed" header: radioType, direction, rntiType, then
optional tags terminated by the PAYLOAD tag.  Open in Wireshark with
DLT_USER1 mapped to ``mac-lte-framed``.

The port's own copy of ``lteax/io/pcap.py`` (it imports nothing of the
JAX package); ``tests/test_torch_stack.py`` holds the two equal.
"""

from __future__ import annotations

import struct
import time

LINKTYPE_USER1 = 148

FDD_RADIO = 1
DIR_UL = 0
DIR_DL = 1
RNTI_NO = 0
RNTI_P = 1
RNTI_RA = 2
RNTI_C = 3
RNTI_SI = 4
RNTI_SPS = 5
RNTI_M = 6

TAG_RNTI = 0x02
TAG_UEID = 0x03
TAG_SUBFRAME = 0x04
TAG_PAYLOAD = 0x01


class MacPcapWriter:
    def __init__(self, path: str):
        self._f = open(path, "wb")
        # pcap global header (LE, v2.4)
        self._f.write(struct.pack("<IHHiIII", 0xA1B2C3D4, 2, 4, 0, 0, 65535,
                                  LINKTYPE_USER1))

    def write(self, mac_pdu: bytes, direction: int = DIR_DL,
              rnti_type: int = RNTI_C, rnti: int | None = None,
              subframe: int | None = None, ts: float | None = None) -> None:
        body = bytes([FDD_RADIO, direction, rnti_type])
        if rnti is not None:
            body += bytes([TAG_RNTI]) + struct.pack(">H", rnti)
        if subframe is not None:
            body += bytes([TAG_SUBFRAME]) + struct.pack(">H", subframe)
        body += bytes([TAG_PAYLOAD]) + mac_pdu
        t = time.time() if ts is None else ts
        sec, usec = int(t), int((t % 1) * 1e6)
        self._f.write(struct.pack("<IIII", sec, usec, len(body), len(body)))
        self._f.write(body)

    def close(self) -> None:
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
