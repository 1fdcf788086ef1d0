"""PDCP entity: COUNT state, EIA1/2 integrity, EEA1/2 ciphering (36.323 §5).
The port's own copy
of ``lteax.stack.pdcp``, over the port's ``pdcp_pdu`` and the plain-Python
AES / SNOW 3G of its ``security``.

(reference capability: ``LTE_fdd_enb_pdcp.{h,cc}`` — SRB integrity+ciphering
and DRB ciphering over the `pdcp_pdu` codecs, with HFN/SN COUNT maintenance.)

One entity per bearer per side.  SRBs use 5-bit SN with MAC-I (integrity
over the PDU header || SDU, 36.323 §5.7), then ciphering of SDU || MAC-I;
DRBs use 7/12-bit SN with ciphering only.  Receive-side HFN inference picks
the COUNT candidate nearest the next expected COUNT (handles SN wrap and
modest reordering).  BEARER for 33.401 is the 5-bit rb identity - 1.
"""

from __future__ import annotations

from lteax_torch.stack import pdcp_pdu
from lteax_torch.stack.security import eea, eia


class PdcpEntity:
    def __init__(self, *, srb: bool, rb_id: int, direction_tx: int,
                 k_enc: bytes | None = None, k_int: bytes | None = None,
                 sn_bits: int | None = None, enc_alg: int = 2,
                 int_alg: int = 2):
        self.srb = srb
        # negotiated EPS algorithm ids (SecurityModeCommand): EEA1/EEA2,
        # EIA1/EIA2 via security.eea/eia dispatch
        self.enc_alg = enc_alg
        self.int_alg = int_alg
        self.sn_bits = 5 if srb else (sn_bits or 12)
        self.mod = 1 << self.sn_bits
        self.bearer5 = (rb_id - 1) & 0x1F
        self.dir_tx = direction_tx & 1
        self.k_enc = k_enc
        self.k_int = k_int
        # SRB with k_int=None runs in pre-security mode (MAC-I all-zero,
        # not verified) until set_keys() — SRB1 before the AS
        # SecurityModeCommand, 36.331 §5.3.1.1
        self.tx_count = 0
        self.rx_next = 0          # next expected receive COUNT

    def set_keys(self, k_enc: bytes | None, k_int: bytes | None) -> None:
        """Activate AS security on this entity (takes effect from the next
        PDU in each direction)."""
        self.k_enc = k_enc
        self.k_int = k_int

    # -- helpers -----------------------------------------------------------
    def _header(self, sn: int) -> bytes:
        if self.srb:
            return bytes([sn & 0x1F])
        if self.sn_bits == 7:
            return bytes([(1 << 7) | (sn & 0x7F)])
        return bytes([(1 << 7) | ((sn >> 8) & 0xF), sn & 0xFF])

    def _infer_count(self, sn: int) -> int:
        """COUNT candidate with this SN closest to the expected COUNT."""
        exp = self.rx_next
        hfn = exp >> self.sn_bits
        cands = [(h << self.sn_bits) | sn for h in (hfn - 1, hfn, hfn + 1)
                 if h >= 0]
        return min(cands, key=lambda c: abs(c - exp))

    # -- data path ---------------------------------------------------------
    def encode(self, sdu: bytes) -> bytes:
        count = self.tx_count
        sn = count % self.mod
        self.tx_count += 1
        if self.srb:
            mac = b"\x00\x00\x00\x00" if self.k_int is None else \
                eia(self.int_alg, self.k_int, count, self.bearer5,
                    self.dir_tx, self._header(sn) + sdu)
            body = sdu + mac
            if self.k_enc is not None:
                body = eea(self.enc_alg, self.k_enc, count, self.bearer5,
                           self.dir_tx, body)
            return bytes([sn & 0x1F]) + body
        body = sdu
        if self.k_enc is not None:
            body = eea(self.enc_alg, self.k_enc, count, self.bearer5,
                       self.dir_tx, body)
        return pdcp_pdu.pack_drb(pdcp_pdu.PdcpDrbPdu(sn=sn, data=body,
                                                     sn_bits=self.sn_bits))

    def decode(self, raw: bytes) -> bytes | None:
        """-> SDU, or None on integrity failure (SRB)."""
        dir_rx = 1 - self.dir_tx
        if self.srb:
            sn = raw[0] & 0x1F
            count = self._infer_count(sn)
            body = raw[1:]
            if self.k_enc is not None:
                body = eea(self.enc_alg, self.k_enc, count, self.bearer5,
                           dir_rx, body)
            sdu, mac = body[:-4], body[-4:]
            if self.k_int is not None:
                want = eia(self.int_alg, self.k_int, count, self.bearer5,
                           dir_rx, self._header(sn) + sdu)
                if mac != want:
                    return None
        else:
            pdu = pdcp_pdu.unpack_drb(raw, sn_bits=self.sn_bits)
            count = self._infer_count(pdu.sn)
            sdu = pdu.data
            if self.k_enc is not None:
                sdu = eea(self.enc_alg, self.k_enc, count, self.bearer5,
                          dir_rx, sdu)
        self.rx_next = max(self.rx_next, count + 1)
        return sdu


def srb_pair(rb_id: int, k_enc: bytes, k_int: bytes):
    """(eNB-side, UE-side) SRB entities: eNB transmits downlink (dir 1)."""
    enb = PdcpEntity(srb=True, rb_id=rb_id, direction_tx=1,
                     k_enc=k_enc, k_int=k_int)
    ue = PdcpEntity(srb=True, rb_id=rb_id, direction_tx=0,
                    k_enc=k_enc, k_int=k_int)
    return enb, ue
