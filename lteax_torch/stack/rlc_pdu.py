"""RLC PDU pack/unpack: TM/UM/AM data PDUs + AM STATUS (36.322 §6.2).

(reference capability: ``liblte/src/liblte_rlc.cc ::
liblte_rlc_pack_amd_pdu`` / ``liblte_rlc_unpack_umd_pdu`` / status PDUs.)

Single-segment data PDUs (no LI lists) — the segmentation state machines of
the eNB live above this codec.

The port's own copy of ``lteax/stack/rlc_pdu.py`` (it imports nothing of the
JAX package); ``tests/test_torch_stack.py`` holds the two equal.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class UmdPdu:
    sn: int
    data: bytes
    sn_bits: int = 10      # 5 or 10
    fi: int = 0            # framing info (2 bits)


def pack_umd(p: UmdPdu) -> bytes:
    if p.sn_bits == 5:
        return bytes([(p.fi << 6) | (0 << 5) | (p.sn & 0x1F)]) + p.data
    return bytes([(p.fi << 3) | (0 << 2) | ((p.sn >> 8) & 0x3),
                  p.sn & 0xFF]) + p.data


def unpack_umd(data: bytes, sn_bits: int = 10) -> UmdPdu:
    if sn_bits == 5:
        return UmdPdu(sn=data[0] & 0x1F, data=data[1:], sn_bits=5,
                      fi=(data[0] >> 6) & 0x3)
    return UmdPdu(sn=((data[0] & 0x3) << 8) | data[1], data=data[2:],
                  sn_bits=10, fi=(data[0] >> 3) & 0x3)


@dataclasses.dataclass
class AmdPdu:
    sn: int                # 10 bits
    data: bytes
    poll: bool = False
    fi: int = 0
    resegment: bool = False


def pack_amd(p: AmdPdu) -> bytes:
    b0 = (1 << 7) | ((1 if p.resegment else 0) << 6) \
        | ((1 if p.poll else 0) << 5) | (p.fi << 3) | (0 << 2) \
        | ((p.sn >> 8) & 0x3)
    return bytes([b0, p.sn & 0xFF]) + p.data


def unpack_amd(data: bytes) -> AmdPdu | None:
    if not (data[0] >> 7):
        return None        # control PDU
    return AmdPdu(sn=((data[0] & 0x3) << 8) | data[1], data=data[2:],
                  poll=bool((data[0] >> 5) & 1), fi=(data[0] >> 3) & 0x3,
                  resegment=bool((data[0] >> 6) & 1))


@dataclasses.dataclass
class StatusPdu:
    ack_sn: int
    nack_sns: tuple[int, ...] = ()


def pack_status(p: StatusPdu) -> bytes:
    """AM STATUS PDU (CPT=0), bit-packed: D/C=0,CPT(3),ACK_SN(10),E1,
    then per NACK: NACK_SN(10),E1,E2=0."""
    bits: list[int] = []

    def put(v, w):
        for i in range(w - 1, -1, -1):
            bits.append((v >> i) & 1)

    put(0, 1)              # D/C = control
    put(0, 3)              # CPT = STATUS
    put(p.ack_sn, 10)
    put(1 if p.nack_sns else 0, 1)
    for i, sn in enumerate(p.nack_sns):
        put(sn, 10)
        put(1 if i < len(p.nack_sns) - 1 else 0, 1)
        put(0, 1)          # E2: no segment offset
    while len(bits) % 8:
        bits.append(0)
    return bytes(int("".join(map(str, bits[i:i + 8])), 2)
                 for i in range(0, len(bits), 8))


def unpack_status(data: bytes) -> StatusPdu | None:
    bits = []
    for byte in data:
        for i in range(7, -1, -1):
            bits.append((byte >> i) & 1)
    pos = 0

    def get(w):
        nonlocal pos
        v = 0
        for _ in range(w):
            v = (v << 1) | bits[pos]
            pos += 1
        return v

    if get(1) != 0 or get(3) != 0:
        return None
    ack = get(10)
    e1 = get(1)
    nacks = []
    while e1:
        nacks.append(get(10))
        e1 = get(1)
        get(1)             # E2 (segments unsupported)
    return StatusPdu(ack_sn=ack, nack_sns=tuple(nacks))
