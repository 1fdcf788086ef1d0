"""MAC PDU pack/unpack (36.321 §6).

(reference capability: ``liblte/src/liblte_mac.cc ::
liblte_mac_pack_mac_pdu`` / ``liblte_mac_unpack_mac_pdu`` /
``liblte_mac_pack_random_access_response_pdu``.)

The port's own copy of ``lteax/stack/mac_pdu.py`` (it imports nothing of the
JAX package); ``tests/test_torch_stack.py`` holds the two equal.
"""

from __future__ import annotations

import dataclasses

# LCIDs (DL-SCH)
LCID_CCCH = 0x00
LCID_CONT_RES = 0x1C
LCID_TA_CMD = 0x1D
LCID_PADDING = 0x1F


@dataclasses.dataclass
class MacSubPdu:
    lcid: int
    payload: bytes = b""          # SDU or CE body


def _pack_headers_bodies(items: list[MacSubPdu], final_padding: bool) -> bytes:
    """Subheader chain then bodies.  With ``final_padding`` a padding
    subheader terminates the chain (its body = rest of the PDU)."""
    ce_sizes = {LCID_CONT_RES: 6, LCID_TA_CMD: 1}
    headers = b""
    bodies = b""
    for i, sp in enumerate(items):
        last = (i == len(items) - 1) and not final_padding
        e = 0 if last else 1
        if sp.lcid in ce_sizes or sp.lcid == LCID_PADDING:
            headers += bytes([(e << 5) | sp.lcid])
            if sp.lcid in ce_sizes:
                assert len(sp.payload) == ce_sizes[sp.lcid], sp
                bodies += sp.payload
        else:
            l = len(sp.payload)
            if last:
                headers += bytes([(0 << 5) | sp.lcid])
            elif l < 128:
                headers += bytes([(1 << 5) | sp.lcid, l & 0x7F])
            else:
                headers += bytes([(1 << 5) | sp.lcid,
                                  0x80 | ((l >> 8) & 0x7F), l & 0xFF])
            bodies += sp.payload
    if final_padding:
        headers += bytes([(0 << 5) | LCID_PADDING])
    return headers + bodies


def pack_mac_pdu(subpdus: list[MacSubPdu], pad_to: int | None = None) -> bytes:
    """Build a MAC PDU (36.321 §6.1.2): subheaders then SDUs/CEs.

    Padding: 1-2 spare bytes become leading padding subheaders; more becomes
    a final padding subheader whose body extends to the end of the PDU."""
    items = list(subpdus)
    pdu = _pack_headers_bodies(items, final_padding=False)
    if pad_to is None or len(pdu) >= pad_to:
        return pdu
    pad = pad_to - len(pdu)
    if pad <= 2:
        lead = [MacSubPdu(LCID_PADDING)] * pad
        return _pack_headers_bodies(lead + items, final_padding=False)
    body = _pack_headers_bodies(items, final_padding=True)
    return body + bytes(pad_to - len(body))


def unpack_mac_pdu(data: bytes) -> list[MacSubPdu]:
    """Parse subheaders then split bodies."""
    ce_sizes = {LCID_CONT_RES: 6, LCID_TA_CMD: 1}
    hdrs = []
    pos = 0
    while True:
        b0 = data[pos]
        e = (b0 >> 5) & 1
        lcid = b0 & 0x1F
        pos += 1
        if lcid in ce_sizes or lcid == LCID_PADDING:
            hdrs.append((lcid, ce_sizes.get(lcid, 0)))
        elif e == 0:
            hdrs.append((lcid, -1))       # last SDU: takes the remainder
        else:
            f = (data[pos] >> 7) & 1
            if f:
                l = ((data[pos] & 0x7F) << 8) | data[pos + 1]
                pos += 2
            else:
                l = data[pos] & 0x7F
                pos += 1
            hdrs.append((lcid, l))
        if e == 0:
            break
    out = []
    for lcid, l in hdrs:
        if lcid == LCID_PADDING:
            out.append(MacSubPdu(lcid, b""))
            continue
        if l < 0:
            l = len(data) - pos
        out.append(MacSubPdu(lcid, data[pos:pos + l]))
        pos += l
    return out


@dataclasses.dataclass
class Rar:
    rapid: int
    timing_advance: int       # 11 bits
    ul_grant: int             # 20 bits
    tc_rnti: int              # 16 bits


def pack_rar_pdu(rars: list[Rar], backoff: int | None = None) -> bytes:
    """Random Access Response PDU (36.321 §6.1.5/6.2.3)."""
    out = b""
    if backoff is not None:
        e = 1 if rars else 0
        out += bytes([(e << 7) | (0 << 6) | (backoff & 0x0F)])
    for i, r in enumerate(rars):
        e = 0 if i == len(rars) - 1 else 1
        out += bytes([(e << 7) | (1 << 6) | (r.rapid & 0x3F)])
    for r in rars:
        ta, g = r.timing_advance & 0x7FF, r.ul_grant & 0xFFFFF
        out += bytes([
            (ta >> 4) & 0x7F,
            ((ta & 0xF) << 4) | ((g >> 16) & 0xF),
            (g >> 8) & 0xFF,
            g & 0xFF,
            (r.tc_rnti >> 8) & 0xFF,
            r.tc_rnti & 0xFF,
        ])
    return out


def unpack_rar_pdu(data: bytes) -> tuple[int | None, list[Rar]]:
    backoff = None
    rapids = []
    pos = 0
    while True:
        b0 = data[pos]
        e, t = (b0 >> 7) & 1, (b0 >> 6) & 1
        pos += 1
        if t == 0:
            backoff = b0 & 0x0F
        else:
            rapids.append(b0 & 0x3F)
        if e == 0:
            break
    rars = []
    for rapid in rapids:
        b = data[pos:pos + 6]
        ta = (b[0] << 4) | (b[1] >> 4)
        g = ((b[1] & 0xF) << 16) | (b[2] << 8) | b[3]
        rnti = (b[4] << 8) | b[5]
        rars.append(Rar(rapid, ta & 0x7FF, g, rnti))
        pos += 6
    return backoff, rars
