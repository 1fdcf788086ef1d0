"""PDCP PDU pack/unpack (36.323 §6.2).

(reference capability: ``liblte/src/liblte_pdcp.cc ::
liblte_pdcp_pack_data_pdu`` etc.)

The port's own copy of ``lteax/stack/pdcp_pdu.py`` (it imports nothing of the
JAX package); ``tests/test_torch_stack.py`` holds the two equal.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class PdcpSrbPdu:
    sn: int                # 5 bits
    data: bytes
    mac_i: bytes = b"\x00\x00\x00\x00"


def pack_srb(p: PdcpSrbPdu) -> bytes:
    return bytes([p.sn & 0x1F]) + p.data + p.mac_i


def unpack_srb(data: bytes) -> PdcpSrbPdu:
    return PdcpSrbPdu(sn=data[0] & 0x1F, data=data[1:-4], mac_i=data[-4:])


@dataclasses.dataclass
class PdcpDrbPdu:
    sn: int
    data: bytes
    sn_bits: int = 12      # 7 or 12


def pack_drb(p: PdcpDrbPdu) -> bytes:
    if p.sn_bits == 7:
        return bytes([(1 << 7) | (p.sn & 0x7F)]) + p.data
    return bytes([(1 << 7) | ((p.sn >> 8) & 0xF), p.sn & 0xFF]) + p.data


def unpack_drb(data: bytes, sn_bits: int = 12) -> PdcpDrbPdu:
    if sn_bits == 7:
        return PdcpDrbPdu(sn=data[0] & 0x7F, data=data[1:], sn_bits=7)
    return PdcpDrbPdu(sn=((data[0] & 0xF) << 8) | data[1], data=data[2:],
                      sn_bits=12)
