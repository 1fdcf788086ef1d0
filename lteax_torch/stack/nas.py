"""NAS EMM/ESM message codec subset (24.301 §8/§9) + security-protected
NAS wrapping.

(reference capability: ``liblte/src/liblte_mme.cc ::
liblte_mme_pack_attach_request_msg`` / ``_unpack_*``, authentication
request/response, security mode command/complete, activate default EPS
bearer, EMM information, and the security-protected NAS header handling.)

Covers the attach/AKA/security-mode flow the reference's builtin MME runs.
IE encodings follow 24.301 layouts for the fields carried; optional IEs not
needed by that flow are omitted (tracked for the citation pass).

The port's own copy of ``lteax/stack/nas.py`` (it imports nothing of the
JAX package); ``tests/test_torch_stack.py`` holds the two equal.
"""

from __future__ import annotations

import dataclasses
import functools
import struct

from lteax_torch.stack import security as sec

PD_EMM = 0x07
PD_ESM = 0x02

# message types (24.301 table 9.8.1)
MT_ATTACH_REQUEST = 0x41
MT_ATTACH_ACCEPT = 0x42
MT_ATTACH_COMPLETE = 0x43
MT_ATTACH_REJECT = 0x44
MT_AUTH_REQUEST = 0x52
MT_AUTH_RESPONSE = 0x53
MT_AUTH_REJECT = 0x54
MT_IDENTITY_REQUEST = 0x55
MT_IDENTITY_RESPONSE = 0x56
MT_SECURITY_MODE_COMMAND = 0x5D
MT_SECURITY_MODE_COMPLETE = 0x5E
MT_EMM_INFORMATION = 0x61
MT_ACT_DEF_BEARER_REQUEST = 0xC1
MT_ACT_DEF_BEARER_ACCEPT = 0xC2
MT_PDN_CONNECTIVITY_REQUEST = 0xD0

SEC_HDR_PLAIN = 0x0
SEC_HDR_INTEGRITY = 0x1
SEC_HDR_INTEGRITY_CIPHERED = 0x2
SEC_HDR_INTEGRITY_NEW_CTX = 0x3
SEC_HDR_INTEGRITY_CIPHERED_NEW_CTX = 0x4


def _bcd(digits) -> bytes:
    ds = list(digits)
    if len(ds) % 2:
        ds = ds + [0xF]
    return bytes((ds[i + 1] << 4) | ds[i] for i in range(0, len(ds), 2))


def _unbcd(data: bytes) -> list[int]:
    out = []
    for b in data:
        out.append(b & 0xF)
        out.append(b >> 4)
    return [d for d in out if d != 0xF]


def _safe(fn):
    """Map truncated/malformed input to ``None`` instead of raising.

    Unpack functions parse untrusted over-the-air bytes; any indexing,
    struct, or IE-decode error on a short or corrupt body means "not this
    message" — the same contract as returning ``None`` on a header
    mismatch.  (A bool-returning unpack decays to ``None`` which is falsy,
    preserving its contract.)
    """
    @functools.wraps(fn)
    def wrapper(data: bytes, *args, **kwargs):
        try:
            return fn(data, *args, **kwargs)
        except (IndexError, struct.error, ValueError, UnicodeDecodeError):
            return None
    return wrapper


# ---------------------------------------------------------------------------
# EMM messages
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class AttachRequest:
    imsi: tuple[int, ...]            # digits
    attach_type: int = 1             # EPS attach
    ksi: int = 7                     # no key available
    ue_caps: bytes = b"\xf0\xf0"     # EEA0/EIA0..2-ish bitmap
    esm_container: bytes = b""


def pack_attach_request(m: AttachRequest) -> bytes:
    out = bytes([PD_EMM, MT_ATTACH_REQUEST,
                 (m.ksi << 4) | m.attach_type])
    ident = _bcd(m.imsi)
    # EPS mobile identity: len, odd/even|type(=1 IMSI) in first nibble
    odd = len(m.imsi) % 2
    first = (m.imsi[0] << 4) | (odd << 3) | 0x1
    body = bytes([first]) + _bcd(m.imsi[1:])
    out += bytes([len(body)]) + body
    out += bytes([len(m.ue_caps)]) + m.ue_caps
    out += struct.pack(">H", len(m.esm_container)) + m.esm_container
    return out


@_safe
def unpack_attach_request(data: bytes) -> AttachRequest | None:
    if data[0] != PD_EMM or data[1] != MT_ATTACH_REQUEST:
        return None
    ksi = data[2] >> 4
    at = data[2] & 0xF
    pos = 3
    ilen = data[pos]
    pos += 1
    first = data[pos]
    digits = [first >> 4] + _unbcd(data[pos + 1: pos + ilen])
    pos += ilen
    clen = data[pos]
    pos += 1
    caps = data[pos:pos + clen]
    pos += clen
    elen = struct.unpack(">H", data[pos:pos + 2])[0]
    pos += 2
    esm = data[pos:pos + elen]
    return AttachRequest(imsi=tuple(digits), attach_type=at, ksi=ksi,
                         ue_caps=caps, esm_container=esm)


@dataclasses.dataclass
class AuthRequest:
    ksi: int
    rand: bytes          # 16
    autn: bytes          # 16


def pack_auth_request(m: AuthRequest) -> bytes:
    return bytes([PD_EMM, MT_AUTH_REQUEST, m.ksi & 0xF]) + m.rand \
        + bytes([len(m.autn)]) + m.autn


@_safe
def unpack_auth_request(data: bytes) -> AuthRequest | None:
    if data[0] != PD_EMM or data[1] != MT_AUTH_REQUEST:
        return None
    ksi = data[2] & 0xF
    rand = data[3:19]
    alen = data[19]
    return AuthRequest(ksi=ksi, rand=rand, autn=data[20:20 + alen])


@dataclasses.dataclass
class AuthResponse:
    res: bytes


def pack_auth_response(m: AuthResponse) -> bytes:
    return bytes([PD_EMM, MT_AUTH_RESPONSE, len(m.res)]) + m.res


@_safe
def unpack_auth_response(data: bytes) -> AuthResponse | None:
    if data[0] != PD_EMM or data[1] != MT_AUTH_RESPONSE:
        return None
    return AuthResponse(res=data[3:3 + data[2]])


@dataclasses.dataclass
class SecurityModeCommand:
    ciphering_alg: int   # 0=EEA0, 1=EEA1, 2=EEA2
    integrity_alg: int   # 1=EIA1, 2=EIA2
    ksi: int
    replayed_ue_caps: bytes = b"\xf0\xf0"


def pack_security_mode_command(m: SecurityModeCommand) -> bytes:
    return bytes([PD_EMM, MT_SECURITY_MODE_COMMAND,
                  (m.ciphering_alg << 4) | m.integrity_alg, m.ksi & 0xF,
                  len(m.replayed_ue_caps)]) + m.replayed_ue_caps


@_safe
def unpack_security_mode_command(data: bytes) -> SecurityModeCommand | None:
    if data[0] != PD_EMM or data[1] != MT_SECURITY_MODE_COMMAND:
        return None
    return SecurityModeCommand(
        ciphering_alg=data[2] >> 4, integrity_alg=data[2] & 0xF,
        ksi=data[3] & 0xF, replayed_ue_caps=data[5:5 + data[4]])


def pack_security_mode_complete() -> bytes:
    return bytes([PD_EMM, MT_SECURITY_MODE_COMPLETE])


@_safe
def unpack_security_mode_complete(data: bytes) -> bool:
    return len(data) >= 2 and data[0] == PD_EMM and \
        data[1] == MT_SECURITY_MODE_COMPLETE


@dataclasses.dataclass
class AttachComplete:
    esm_container: bytes = b""


def pack_attach_complete(m: AttachComplete) -> bytes:
    return bytes([PD_EMM, MT_ATTACH_COMPLETE]) + \
        struct.pack(">H", len(m.esm_container)) + m.esm_container


@_safe
def unpack_attach_complete(data: bytes) -> AttachComplete | None:
    if data[0] != PD_EMM or data[1] != MT_ATTACH_COMPLETE:
        return None
    elen = struct.unpack(">H", data[2:4])[0]
    return AttachComplete(esm_container=data[4:4 + elen])


@dataclasses.dataclass
class AttachAccept:
    attach_result: int
    t3412_s: int
    tac: int
    mcc: tuple[int, int, int]
    mnc: tuple[int, ...]
    esm_container: bytes = b""


def pack_attach_accept(m: AttachAccept) -> bytes:
    plmn = _bcd([*m.mcc, *m.mnc])
    out = bytes([PD_EMM, MT_ATTACH_ACCEPT, m.attach_result & 0xF,
                 min(m.t3412_s // 60, 31) | 0x20])   # GPRS timer, minutes
    out += bytes([6]) + plmn.ljust(3, b"\xff") + struct.pack(">H", m.tac) \
        + bytes([0])
    out += struct.pack(">H", len(m.esm_container)) + m.esm_container
    return out


@_safe
def unpack_attach_accept(data: bytes) -> AttachAccept | None:
    if data[0] != PD_EMM or data[1] != MT_ATTACH_ACCEPT:
        return None
    result = data[2] & 0xF
    t3412 = (data[3] & 0x1F) * 60
    pos = 4
    tlen = data[pos]
    pos += 1
    plmn = _unbcd(data[pos:pos + 3])
    tac = struct.unpack(">H", data[pos + 3:pos + 5])[0]
    pos += tlen
    elen = struct.unpack(">H", data[pos:pos + 2])[0]
    pos += 2
    return AttachAccept(attach_result=result, t3412_s=t3412, tac=tac,
                        mcc=tuple(plmn[:3]), mnc=tuple(plmn[3:]),
                        esm_container=data[pos:pos + elen])


MT_DETACH_REQUEST = 0x45
MT_DETACH_ACCEPT = 0x46
MT_TAU_REQUEST = 0x48
MT_TAU_ACCEPT = 0x49
MT_SERVICE_REQUEST_HDR = 0xC  # security header type for SERVICE REQUEST


@dataclasses.dataclass
class DetachRequest:
    detach_type: int = 1       # EPS detach
    switch_off: bool = False
    ksi: int = 0


def pack_detach_request(m: DetachRequest) -> bytes:
    dt = (m.detach_type & 0x7) | (0x8 if m.switch_off else 0)
    return bytes([PD_EMM, MT_DETACH_REQUEST, (m.ksi << 4) | dt])


@_safe
def unpack_detach_request(data: bytes) -> DetachRequest | None:
    if data[0] != PD_EMM or data[1] != MT_DETACH_REQUEST:
        return None
    return DetachRequest(detach_type=data[2] & 0x7,
                         switch_off=bool(data[2] & 0x8), ksi=data[2] >> 4)


def pack_detach_accept() -> bytes:
    return bytes([PD_EMM, MT_DETACH_ACCEPT])


@dataclasses.dataclass
class TauRequest:
    update_type: int = 0       # TA updating
    ksi: int = 0
    old_guti: int = 0          # 32-bit M-TMSI subset


def pack_tau_request(m: TauRequest) -> bytes:
    return bytes([PD_EMM, MT_TAU_REQUEST,
                  (m.ksi << 4) | (m.update_type & 0xF)]) \
        + struct.pack(">I", m.old_guti)


@_safe
def unpack_tau_request(data: bytes) -> TauRequest | None:
    if data[0] != PD_EMM or data[1] != MT_TAU_REQUEST:
        return None
    return TauRequest(update_type=data[2] & 0xF, ksi=data[2] >> 4,
                      old_guti=struct.unpack(">I", data[3:7])[0])


@dataclasses.dataclass
class TauAccept:
    update_result: int = 0
    t3412_s: int = 3600
    tac: int = 0
    mcc: tuple[int, int, int] = (0, 0, 1)
    mnc: tuple[int, ...] = (0, 1)


def pack_tau_accept(m: TauAccept) -> bytes:
    plmn = _bcd([*m.mcc, *m.mnc])
    return bytes([PD_EMM, MT_TAU_ACCEPT, m.update_result & 0xF,
                  min(m.t3412_s // 60, 31) | 0x20, 6]) \
        + plmn.ljust(3, b"\xff") + struct.pack(">H", m.tac) + bytes([0])


@_safe
def unpack_tau_accept(data: bytes) -> TauAccept | None:
    if data[0] != PD_EMM or data[1] != MT_TAU_ACCEPT:
        return None
    plmn = _unbcd(data[5:8])
    tac = struct.unpack(">H", data[8:10])[0]
    return TauAccept(update_result=data[2] & 0xF,
                     t3412_s=(data[3] & 0x1F) * 60, tac=tac,
                     mcc=tuple(plmn[:3]), mnc=tuple(plmn[3:]))


@dataclasses.dataclass
class ServiceRequest:
    """SERVICE REQUEST (24.301 §8.2.25): 2-byte compact format with its own
    security header type, short MAC."""
    ksi: int = 0
    seq: int = 0
    short_mac: int = 0


def pack_service_request(m: ServiceRequest) -> bytes:
    return bytes([(MT_SERVICE_REQUEST_HDR << 4) | PD_EMM,
                  (m.ksi << 5) | (m.seq & 0x1F)]) \
        + struct.pack(">H", m.short_mac)


@_safe
def unpack_service_request(data: bytes) -> ServiceRequest | None:
    if (data[0] >> 4) != MT_SERVICE_REQUEST_HDR or (data[0] & 0xF) != PD_EMM:
        return None
    return ServiceRequest(ksi=data[1] >> 5, seq=data[1] & 0x1F,
                          short_mac=struct.unpack(">H", data[2:4])[0])


@dataclasses.dataclass
class EmmInformation:
    network_name: str = ""


def pack_emm_information(m: EmmInformation) -> bytes:
    name = m.network_name.encode()
    return bytes([PD_EMM, MT_EMM_INFORMATION, 0x43, len(name) + 1, 0x80]) \
        + name


@_safe
def unpack_emm_information(data: bytes) -> EmmInformation | None:
    if data[0] != PD_EMM or data[1] != MT_EMM_INFORMATION:
        return None
    if len(data) > 4 and data[2] == 0x43:
        ln = data[3]
        return EmmInformation(network_name=data[5:4 + ln].decode(
            errors="replace"))
    return EmmInformation()


# ---------------------------------------------------------------------------
# ESM messages (minimal)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class PdnConnectivityRequest:
    ebi: int = 0
    pti: int = 1
    pdn_type: int = 1    # IPv4


def pack_pdn_connectivity_request(m: PdnConnectivityRequest) -> bytes:
    return bytes([(m.ebi << 4) | PD_ESM, m.pti, MT_PDN_CONNECTIVITY_REQUEST,
                  (m.pdn_type << 4) | 0x1])


@dataclasses.dataclass
class ActivateDefaultBearerRequest:
    ebi: int
    pti: int
    apn: str
    ip: tuple[int, int, int, int]


def pack_activate_default_bearer_request(m: ActivateDefaultBearerRequest) -> bytes:
    apn_b = m.apn.encode()
    return bytes([(m.ebi << 4) | PD_ESM, m.pti, MT_ACT_DEF_BEARER_REQUEST,
                  len(apn_b)]) + apn_b + bytes([5, 1, *m.ip])


@_safe
def unpack_activate_default_bearer_request(data: bytes):
    if (data[0] & 0xF) != PD_ESM or data[2] != MT_ACT_DEF_BEARER_REQUEST:
        return None
    ebi, pti = data[0] >> 4, data[1]
    alen = data[3]
    apn = data[4:4 + alen].decode()
    pos = 4 + alen
    ip = tuple(data[pos + 2:pos + 6])
    return ActivateDefaultBearerRequest(ebi=ebi, pti=pti, apn=apn, ip=ip)


@dataclasses.dataclass
class ActivateDefaultBearerAccept:
    ebi: int
    pti: int = 0


def pack_activate_default_bearer_accept(m: ActivateDefaultBearerAccept
                                        ) -> bytes:
    return bytes([(m.ebi << 4) | PD_ESM, m.pti, MT_ACT_DEF_BEARER_ACCEPT])


@_safe
def unpack_activate_default_bearer_accept(data: bytes
                                          ) -> ActivateDefaultBearerAccept | None:
    if (data[0] & 0xF) != PD_ESM or data[2] != MT_ACT_DEF_BEARER_ACCEPT:
        return None
    return ActivateDefaultBearerAccept(ebi=data[0] >> 4, pti=data[1])


# ---------------------------------------------------------------------------
# EMM procedure-outcome / identity messages
# (reference capability: ``liblte/src/liblte_mme.cc`` identity request/
#  response, authentication failure/reject, attach/service/TAU reject,
#  GUTI reallocation, EMM status pack/unpack pairs.)
# ---------------------------------------------------------------------------

MT_TAU_COMPLETE = 0x4A
MT_TAU_REJECT = 0x4B
MT_SERVICE_REJECT = 0x4E
MT_GUTI_REALLOC_COMMAND = 0x50
MT_GUTI_REALLOC_COMPLETE = 0x51
MT_AUTH_FAILURE = 0x5C
MT_EMM_STATUS = 0x60

# identity types (24.301 §9.9.3.17 / 24.008 §10.5.1.4)
ID_TYPE_IMSI = 1
ID_TYPE_IMEI = 2
ID_TYPE_IMEISV = 3
ID_TYPE_TMSI = 4

# common EMM causes (24.301 §9.9.3.9)
EMM_CAUSE_IMSI_UNKNOWN_IN_HSS = 0x02
EMM_CAUSE_ILLEGAL_UE = 0x03
EMM_CAUSE_MAC_FAILURE = 0x14
EMM_CAUSE_SYNCH_FAILURE = 0x15
EMM_CAUSE_EPS_NOT_ALLOWED = 0x07
EMM_CAUSE_PLMN_NOT_ALLOWED = 0x0B
EMM_CAUSE_TA_NOT_ALLOWED = 0x0C
EMM_CAUSE_NETWORK_FAILURE = 0x11
EMM_CAUSE_CONGESTION = 0x16
EMM_CAUSE_UE_ID_NOT_DERIVABLE = 0x09
EMM_CAUSE_PROTOCOL_ERROR = 0x6F


@dataclasses.dataclass
class IdentityRequest:
    id_type: int = ID_TYPE_IMSI


def pack_identity_request(m: IdentityRequest) -> bytes:
    return bytes([PD_EMM, MT_IDENTITY_REQUEST, m.id_type & 0xF])


@_safe
def unpack_identity_request(data: bytes) -> IdentityRequest | None:
    if data[0] != PD_EMM or data[1] != MT_IDENTITY_REQUEST:
        return None
    return IdentityRequest(id_type=data[2] & 0xF)


@dataclasses.dataclass
class IdentityResponse:
    id_type: int = ID_TYPE_IMSI
    digits: tuple[int, ...] = ()     # IMSI/IMEI(SV) digits


def pack_identity_response(m: IdentityResponse) -> bytes:
    # Mobile Identity IE (LV): odd/even flag in bit 4, type in bits 1-3
    ds = list(m.digits)
    odd = len(ds) % 2 == 1
    first = ((ds[0] if ds else 0) << 4) | (0x8 if odd else 0) | (m.id_type & 7)
    body = bytes([first]) + _bcd(ds[1:])
    return bytes([PD_EMM, MT_IDENTITY_RESPONSE, len(body)]) + body


@_safe
def unpack_identity_response(data: bytes) -> IdentityResponse | None:
    if data[0] != PD_EMM or data[1] != MT_IDENTITY_RESPONSE:
        return None
    ilen = data[2]
    body = data[3:3 + ilen]
    id_type = body[0] & 7
    digits = [body[0] >> 4] + _unbcd(body[1:])
    return IdentityResponse(id_type=id_type, digits=tuple(digits))


@dataclasses.dataclass
class AuthFailure:
    cause: int = EMM_CAUSE_MAC_FAILURE
    auts: bytes = b""                # present iff cause == synch failure


def pack_auth_failure(m: AuthFailure) -> bytes:
    out = bytes([PD_EMM, MT_AUTH_FAILURE, m.cause & 0xFF])
    if m.auts:
        out += bytes([0x30, len(m.auts)]) + m.auts   # Authentication failure
    return out                                       # parameter TLV (IEI 0x30)


@_safe
def unpack_auth_failure(data: bytes) -> AuthFailure | None:
    if data[0] != PD_EMM or data[1] != MT_AUTH_FAILURE:
        return None
    auts = b""
    if len(data) > 3 and data[3] == 0x30:
        auts = data[5:5 + data[4]]
    return AuthFailure(cause=data[2], auts=auts)


def pack_auth_reject() -> bytes:
    return bytes([PD_EMM, MT_AUTH_REJECT])


@_safe
def unpack_auth_reject(data: bytes) -> bool:
    return len(data) >= 2 and data[0] == PD_EMM and data[1] == MT_AUTH_REJECT


def _pack_cause_msg(mt: int, cause: int) -> bytes:
    return bytes([PD_EMM, mt, cause & 0xFF])


def _unpack_cause_msg(data: bytes, mt: int) -> int | None:
    if data[0] != PD_EMM or data[1] != mt:
        return None
    return data[2]


def pack_attach_reject(cause: int, esm_container: bytes = b"") -> bytes:
    out = _pack_cause_msg(MT_ATTACH_REJECT, cause)
    if esm_container:
        out += bytes([0x78]) + struct.pack(">H", len(esm_container)) \
            + esm_container                          # ESM container TLV-E
    return out


@_safe
def unpack_attach_reject(data: bytes) -> tuple[int, bytes] | None:
    if data[0] != PD_EMM or data[1] != MT_ATTACH_REJECT:
        return None
    esm = b""
    if len(data) > 3 and data[3] == 0x78:
        elen = struct.unpack(">H", data[4:6])[0]
        esm = data[6:6 + elen]
    return data[2], esm


def pack_service_reject(cause: int) -> bytes:
    return _pack_cause_msg(MT_SERVICE_REJECT, cause)


@_safe
def unpack_service_reject(data: bytes) -> int | None:
    return _unpack_cause_msg(data, MT_SERVICE_REJECT)


def pack_tau_reject(cause: int) -> bytes:
    return _pack_cause_msg(MT_TAU_REJECT, cause)


@_safe
def unpack_tau_reject(data: bytes) -> int | None:
    return _unpack_cause_msg(data, MT_TAU_REJECT)


def pack_tau_complete() -> bytes:
    return bytes([PD_EMM, MT_TAU_COMPLETE])


@_safe
def unpack_tau_complete(data: bytes) -> bool:
    return len(data) >= 2 and data[0] == PD_EMM and data[1] == MT_TAU_COMPLETE


MT_DL_NAS_TRANSPORT = 0x62
MT_UL_NAS_TRANSPORT = 0x63


def pack_dl_nas_transport(container: bytes) -> bytes:
    """DOWNLINK NAS TRANSPORT (24.301 §8.2.12): carries an SMS-CP message
    transparently inside the NAS message container LV IE.

    (reference capability: ``liblte_mme_pack_downlink_nas_transport_msg``.)"""
    assert len(container) <= 252
    return bytes([PD_EMM, MT_DL_NAS_TRANSPORT, len(container)]) + container


@_safe
def unpack_dl_nas_transport(data: bytes) -> bytes | None:
    if data[0] != PD_EMM or data[1] != MT_DL_NAS_TRANSPORT:
        return None
    n = data[2]
    if len(data) < 3 + n:
        return None
    return bytes(data[3:3 + n])


def pack_ul_nas_transport(container: bytes) -> bytes:
    """UPLINK NAS TRANSPORT (24.301 §8.2.30)."""
    assert len(container) <= 252
    return bytes([PD_EMM, MT_UL_NAS_TRANSPORT, len(container)]) + container


@_safe
def unpack_ul_nas_transport(data: bytes) -> bytes | None:
    if data[0] != PD_EMM or data[1] != MT_UL_NAS_TRANSPORT:
        return None
    n = data[2]
    if len(data) < 3 + n:
        return None
    return bytes(data[3:3 + n])


def pack_emm_status(cause: int) -> bytes:
    return _pack_cause_msg(MT_EMM_STATUS, cause)


@_safe
def unpack_emm_status(data: bytes) -> int | None:
    return _unpack_cause_msg(data, MT_EMM_STATUS)


@dataclasses.dataclass
class Guti:
    """GUTI fields for the EPS mobile identity IE (24.301 §9.9.3.12)."""
    mcc: tuple[int, int, int] = (0, 0, 1)
    mnc: tuple[int, ...] = (0, 1)
    mme_group_id: int = 0
    mme_code: int = 0
    m_tmsi: int = 0


def _pack_guti_ie(g: Guti) -> bytes:
    # odd/even=0, type=6 (GUTI); MCC/MNC BCD with MNC in digit-3 slot
    mcc, mnc = g.mcc, g.mnc
    d = [mcc[0] | (mcc[1] << 4), mcc[2] | ((mnc[2] << 4) if len(mnc) == 3
                                           else 0xF0), mnc[0] | (mnc[1] << 4)]
    body = bytes([0xF6]) + bytes(d) \
        + struct.pack(">H", g.mme_group_id) + bytes([g.mme_code]) \
        + struct.pack(">I", g.m_tmsi)
    return bytes([len(body)]) + body


def _unpack_guti_ie(data: bytes) -> tuple[Guti, int]:
    glen = data[0]
    body = data[1:1 + glen]
    if (body[0] & 0xF) != 6:
        raise ValueError("not a GUTI mobile identity")
    mcc = (body[1] & 0xF, body[1] >> 4, body[2] & 0xF)
    mnc3 = body[2] >> 4
    mnc = (body[3] & 0xF, body[3] >> 4) + ((mnc3,) if mnc3 != 0xF else ())
    g = Guti(mcc=mcc, mnc=mnc,
             mme_group_id=struct.unpack(">H", body[4:6])[0],
             mme_code=body[6],
             m_tmsi=struct.unpack(">I", body[7:11])[0])
    return g, 1 + glen


def pack_guti_realloc_command(g: Guti) -> bytes:
    return bytes([PD_EMM, MT_GUTI_REALLOC_COMMAND]) + _pack_guti_ie(g)


@_safe
def unpack_guti_realloc_command(data: bytes) -> Guti | None:
    if data[0] != PD_EMM or data[1] != MT_GUTI_REALLOC_COMMAND:
        return None
    return _unpack_guti_ie(data[2:])[0]


def pack_guti_realloc_complete() -> bytes:
    return bytes([PD_EMM, MT_GUTI_REALLOC_COMPLETE])


@_safe
def unpack_guti_realloc_complete(data: bytes) -> bool:
    return len(data) >= 2 and data[0] == PD_EMM \
        and data[1] == MT_GUTI_REALLOC_COMPLETE


# ---------------------------------------------------------------------------
# ESM procedure-outcome / information messages
# (reference capability: ``liblte_mme.cc`` ESM information request/response,
#  PDN connectivity reject, deactivate EPS bearer context, PDN disconnect.)
# ---------------------------------------------------------------------------

MT_PDN_CONNECTIVITY_REJECT = 0xD1
MT_PDN_DISCONNECT_REQUEST = 0xD2
MT_DEACT_BEARER_REQUEST = 0xCD
MT_DEACT_BEARER_ACCEPT = 0xCE
MT_ESM_INFORMATION_REQUEST = 0xD9
MT_ESM_INFORMATION_RESPONSE = 0xDA
MT_ESM_STATUS = 0xE8

ESM_CAUSE_INSUFFICIENT_RESOURCES = 0x1A
ESM_CAUSE_UNKNOWN_APN = 0x1B
ESM_CAUSE_PDN_TYPE_NOT_SUPPORTED = 0x32
ESM_CAUSE_REGULAR_DEACTIVATION = 0x24
ESM_CAUSE_PROTOCOL_ERROR = 0x6F


def _esm_hdr(ebi: int, pti: int, mt: int) -> bytes:
    return bytes([(ebi << 4) | PD_ESM, pti, mt])


def _esm_match(data: bytes, mt: int) -> bool:
    return len(data) >= 3 and (data[0] & 0xF) == PD_ESM and data[2] == mt


def pack_pdn_connectivity_reject(pti: int, cause: int) -> bytes:
    return _esm_hdr(0, pti, MT_PDN_CONNECTIVITY_REJECT) + bytes([cause])


@_safe
def unpack_pdn_connectivity_reject(data: bytes) -> tuple[int, int] | None:
    if not _esm_match(data, MT_PDN_CONNECTIVITY_REJECT):
        return None
    return data[1], data[3]                          # (pti, cause)


def pack_esm_information_request(pti: int) -> bytes:
    return _esm_hdr(0, pti, MT_ESM_INFORMATION_REQUEST)


@_safe
def unpack_esm_information_request(data: bytes) -> int | None:
    return data[1] if _esm_match(data, MT_ESM_INFORMATION_REQUEST) else None


def pack_esm_information_response(pti: int, apn: str = "") -> bytes:
    out = _esm_hdr(0, pti, MT_ESM_INFORMATION_RESPONSE)
    if apn:
        # APN IE (24.008 §10.5.6.1): dotted labels as length-prefixed parts
        parts = b"".join(bytes([len(p)]) + p.encode()
                         for p in apn.split("."))
        out += bytes([0x28, len(parts)]) + parts
    return out


@_safe
def unpack_esm_information_response(data: bytes) -> tuple[int, str] | None:
    if not _esm_match(data, MT_ESM_INFORMATION_RESPONSE):
        return None
    apn = ""
    if len(data) > 3 and data[3] == 0x28:
        body, pos, labels = data[5:5 + data[4]], 0, []
        while pos < len(body):
            n = body[pos]
            labels.append(body[pos + 1:pos + 1 + n].decode())
            pos += 1 + n
        apn = ".".join(labels)
    return data[1], apn


def pack_deactivate_bearer_request(ebi: int, pti: int, cause: int
                                   = ESM_CAUSE_REGULAR_DEACTIVATION) -> bytes:
    return _esm_hdr(ebi, pti, MT_DEACT_BEARER_REQUEST) + bytes([cause])


@_safe
def unpack_deactivate_bearer_request(data: bytes
                                     ) -> tuple[int, int, int] | None:
    if not _esm_match(data, MT_DEACT_BEARER_REQUEST):
        return None
    return data[0] >> 4, data[1], data[3]            # (ebi, pti, cause)


def pack_deactivate_bearer_accept(ebi: int, pti: int = 0) -> bytes:
    return _esm_hdr(ebi, pti, MT_DEACT_BEARER_ACCEPT)


@_safe
def unpack_deactivate_bearer_accept(data: bytes) -> int | None:
    return data[0] >> 4 if _esm_match(data, MT_DEACT_BEARER_ACCEPT) else None


def pack_pdn_disconnect_request(pti: int, linked_ebi: int) -> bytes:
    return _esm_hdr(0, pti, MT_PDN_DISCONNECT_REQUEST) \
        + bytes([linked_ebi & 0xF])


@_safe
def unpack_pdn_disconnect_request(data: bytes) -> tuple[int, int] | None:
    if not _esm_match(data, MT_PDN_DISCONNECT_REQUEST):
        return None
    return data[1], data[3] & 0xF                    # (pti, linked ebi)


def pack_esm_status(ebi: int, pti: int, cause: int) -> bytes:
    return _esm_hdr(ebi, pti, MT_ESM_STATUS) + bytes([cause])


@_safe
def unpack_esm_status(data: bytes) -> tuple[int, int, int] | None:
    if not _esm_match(data, MT_ESM_STATUS):
        return None
    return data[0] >> 4, data[1], data[3]


# ---------------------------------------------------------------------------
# Security-protected NAS (24.301 §9.1/9.5)
# ---------------------------------------------------------------------------

def protect(plain: bytes, k_nas_int: bytes, count: int, downlink: bool,
            k_nas_enc: bytes | None = None,
            sec_hdr: int = SEC_HDR_INTEGRITY) -> bytes:
    """Wrap a plain NAS message with SEQ + MAC (EIA2), optional EEA2."""
    direction = 1 if downlink else 0
    seq = count & 0xFF
    body = plain
    if sec_hdr in (SEC_HDR_INTEGRITY_CIPHERED,
                   SEC_HDR_INTEGRITY_CIPHERED_NEW_CTX):
        assert k_nas_enc is not None
        body = sec.eea2(k_nas_enc, count, 0, direction, plain)
    mac = sec.eia2(k_nas_int, count, 0, direction, bytes([seq]) + body)
    return bytes([(sec_hdr << 4) | PD_EMM]) + mac + bytes([seq]) + body


@_safe
def unprotect(data: bytes, k_nas_int: bytes, count_hint: int,
              downlink: bool, k_nas_enc: bytes | None = None
              ) -> tuple[bytes, bool] | None:
    """-> (plain message, mac_ok).  ``count_hint`` supplies the upper bits
    of the NAS COUNT (low byte comes from the SEQ field)."""
    sec_hdr = data[0] >> 4
    if (data[0] & 0xF) != PD_EMM or sec_hdr == SEC_HDR_PLAIN:
        return None
    mac, seq, body = data[1:5], data[5], data[6:]
    count = (count_hint & ~0xFF) | seq
    direction = 1 if downlink else 0
    calc = sec.eia2(k_nas_int, count, 0, direction, bytes([seq]) + body)
    ok = calc == mac
    if sec_hdr in (SEC_HDR_INTEGRITY_CIPHERED,
                   SEC_HDR_INTEGRITY_CIPHERED_NEW_CTX) and k_nas_enc:
        body = sec.eea2(k_nas_enc, count, 0, direction, body)
    return body, ok
