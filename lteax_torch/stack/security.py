"""LTE security primitives: key derivation, Milenage AKA, EEA2/EIA2.

(reference capability: ``liblte/src/liblte_security.cc ::
liblte_security_generate_k_asme``, ``liblte_security_milenage_f1`` /
``_f2345``, ``liblte_security_128_eea2``, ``liblte_security_128_eia2``,
``liblte_security_kdf`` — SURVEY.md §2.1.)

Host-side control-plane code (33.401 / 35.206 / 33.401 Annex B).  The
port's own copy of ``lteax/stack/security.py``, with AES-128 (FIPS-197) in
plain Python in place of the ``cryptography`` package, which the port does
not need: the block cipher (:func:`_aes_ecb_encrypt`), CTR for EEA2 and the
CMAC on top.  ``tests/test_torch_stack.py`` holds every function equal to
its original, byte for byte.
"""

from __future__ import annotations

import hashlib
import hmac
import struct

from functools import lru_cache


# ---------------------------------------------------------------------------
# AES-128 (FIPS-197), encryption only: ECB, CTR and CMAC need no inverse
# ---------------------------------------------------------------------------

def _xtime(a: int) -> int:
    """Multiplication by x in GF(2^8) mod x^8 + x^4 + x^3 + x + 1."""
    a <<= 1
    return (a ^ 0x11B) if a & 0x100 else a


def _make_sbox() -> bytes:
    """The S-box: the multiplicative inverse in GF(2^8), then the affine
    map b ^ rotl(b, 1..4) ^ 0x63."""
    sbox = bytearray(256)
    p = q = 1
    while True:
        # p walks the powers of 3, q the powers of 3^-1: q = p^-1
        p ^= _xtime(p)
        q ^= q << 1
        q ^= q << 2
        q ^= q << 4
        q &= 0xFF
        if q & 0x80:
            q ^= 0x09
        x = q ^ ((q << 1) | (q >> 7)) ^ ((q << 2) | (q >> 6)) \
            ^ ((q << 3) | (q >> 5)) ^ ((q << 4) | (q >> 4))
        sbox[p] = (x ^ 0x63) & 0xFF
        if p == 1:
            break
    sbox[0] = 0x63
    return bytes(sbox)


_SBOX = _make_sbox()
_XT = bytes(_xtime(a) & 0xFF for a in range(256))
# ShiftRows on the column-major state: output byte i reads input byte
_SHIFT = tuple((i + 4 * (i % 4)) % 16 for i in range(16))


@lru_cache(maxsize=64)
def _round_keys(key: bytes) -> tuple[bytes, ...]:
    """The 11 round keys of AES-128 (FIPS-197 §5.2)."""
    if len(key) != 16:
        raise ValueError(f"AES-128 key of {len(key)} bytes")
    w = [key[4 * i:4 * i + 4] for i in range(4)]
    rcon = 1
    for i in range(4, 44):
        t = w[i - 1]
        if i % 4 == 0:
            t = bytes((_SBOX[t[1]] ^ rcon, _SBOX[t[2]], _SBOX[t[3]],
                       _SBOX[t[0]]))
            rcon = _xtime(rcon)
        w.append(bytes(a ^ b for a, b in zip(w[i - 4], t)))
    return tuple(b"".join(w[4 * r:4 * r + 4]) for r in range(11))


def _aes_ecb_encrypt(key: bytes, block: bytes) -> bytes:
    """AES-128 of one or more whole 16-byte blocks, each on its own."""
    if len(block) % 16:
        raise ValueError(f"ECB input of {len(block)} bytes")
    rk = _round_keys(bytes(key))
    out = bytearray()
    for j in range(0, len(block), 16):
        s = [a ^ b for a, b in zip(block[j:j + 16], rk[0])]
        for r in range(1, 11):
            s = [_SBOX[s[i]] for i in _SHIFT]
            if r < 10:
                m = []
                for c in range(0, 16, 4):
                    a0, a1, a2, a3 = s[c:c + 4]
                    t = a0 ^ a1 ^ a2 ^ a3
                    m += (a0 ^ t ^ _XT[a0 ^ a1], a1 ^ t ^ _XT[a1 ^ a2],
                          a2 ^ t ^ _XT[a2 ^ a3], a3 ^ t ^ _XT[a3 ^ a0])
                s = m
            s = [a ^ b for a, b in zip(s, rk[r])]
        out += bytes(s)
    return bytes(out)


def _aes_ctr(key: bytes, iv: bytes, data: bytes) -> bytes:
    """AES-128-CTR: the keystream is the encryption of the 128-bit
    big-endian counter ``iv``, ``iv + 1``, ... (mod 2^128)."""
    n = -(-len(data) // 16)
    c0 = int.from_bytes(iv, "big")
    ctr = b"".join(((c0 + i) % (1 << 128)).to_bytes(16, "big")
                   for i in range(n))
    ks = _aes_ecb_encrypt(key, ctr)
    return bytes(a ^ b for a, b in zip(data, ks))


def _xor(a: bytes, b: bytes) -> bytes:
    return bytes(x ^ y for x, y in zip(a, b))


# ---------------------------------------------------------------------------
# KDF (33.401 Annex A / 33.220): HMAC-SHA-256 over FC || P0 || L0 || ...
# ---------------------------------------------------------------------------

def kdf(key: bytes, fc: int, *params: bytes) -> bytes:
    s = bytes([fc])
    for p in params:
        s += p + struct.pack(">H", len(p))
    return hmac.new(key, s, hashlib.sha256).digest()


def generate_k_asme(ck: bytes, ik: bytes, sqn_xor_ak: bytes,
                    mcc_mnc: bytes) -> bytes:
    """33.401 A.2: K_ASME from CK||IK, SN id (PLMN), SQN^AK."""
    return kdf(ck + ik, 0x10, mcc_mnc, sqn_xor_ak)


def generate_k_enb(k_asme: bytes, nas_count: int) -> bytes:
    return kdf(k_asme, 0x11, struct.pack(">I", nas_count))


def generate_nas_keys(k_asme: bytes, enc_alg: int = 1, int_alg: int = 1
                      ) -> tuple[bytes, bytes]:
    """-> (k_nas_enc, k_nas_int) truncated to 128 bits (33.401 A.7)."""
    k_enc = kdf(k_asme, 0x15, bytes([0x01]), bytes([enc_alg]))[16:]
    k_int = kdf(k_asme, 0x15, bytes([0x02]), bytes([int_alg]))[16:]
    return k_enc, k_int


def generate_k_enb_star(key: bytes, pci: int, earfcn_dl: int) -> bytes:
    """33.401 A.5: KeNB* refresh for handover / reestablishment.

    ``key`` is the current KeNB (horizontal derivation, NCC unchanged) or
    the NH (vertical derivation, NCC advanced).
    """
    return kdf(key, 0x13, struct.pack(">H", pci),
               struct.pack(">H", earfcn_dl))


def generate_as_keys(k_enb: bytes, enc_alg: int = 1, int_alg: int = 1
                     ) -> tuple[bytes, bytes, bytes]:
    """-> (k_rrc_enc, k_rrc_int, k_up_enc)."""
    k_rrc_enc = kdf(k_enb, 0x15, bytes([0x03]), bytes([enc_alg]))[16:]
    k_rrc_int = kdf(k_enb, 0x15, bytes([0x04]), bytes([int_alg]))[16:]
    k_up_enc = kdf(k_enb, 0x15, bytes([0x05]), bytes([enc_alg]))[16:]
    return k_rrc_enc, k_rrc_int, k_up_enc


# ---------------------------------------------------------------------------
# Milenage (35.206) — f1/f1*/f2/f3/f4/f5/f5*
# ---------------------------------------------------------------------------

def milenage_op_c(k: bytes, op: bytes) -> bytes:
    return _xor(_aes_ecb_encrypt(k, op), op)


def _rot(b: bytes, r_bits: int) -> bytes:
    r = r_bits // 8
    return b[r:] + b[:r]


def milenage_f1(k: bytes, rand: bytes, sqn: bytes, amf: bytes,
                op_c: bytes | None = None, op: bytes | None = None
                ) -> tuple[bytes, bytes]:
    """-> (MAC-A, MAC-S)."""
    opc = op_c if op_c is not None else milenage_op_c(k, op)
    temp = _aes_ecb_encrypt(k, _xor(rand, opc))
    in1 = sqn + amf + sqn + amf
    # c1 = 0, r1 = 64
    t = _xor(temp, _rot(_xor(in1, opc), 64))
    out1 = _xor(_aes_ecb_encrypt(k, t), opc)
    return out1[:8], out1[8:]


def milenage_f2345(k: bytes, rand: bytes, op_c: bytes | None = None,
                   op: bytes | None = None
                   ) -> tuple[bytes, bytes, bytes, bytes]:
    """-> (RES, CK, IK, AK)."""
    opc = op_c if op_c is not None else milenage_op_c(k, op)
    temp = _aes_ecb_encrypt(k, _xor(rand, opc))

    def out(c: int, r_bits: int) -> bytes:
        cb = bytes(15) + bytes([c])
        t = _xor(_rot(_xor(temp, opc), r_bits), cb)
        return _xor(_aes_ecb_encrypt(k, t), opc)

    # 35.206: c2=1,r2=0; c3=2,r3=32; c4=4,r4=64  (c5=8,r5=96 for f5*)
    out2 = out(1, 0)
    out3 = out(2, 32)
    out4 = out(4, 64)
    res = out2[8:]
    ck = out3
    ik = out4
    ak = out2[:6]
    return res, ck, ik, ak


# ---------------------------------------------------------------------------
# 128-EEA2 (AES-CTR) and 128-EIA2 (AES-CMAC) — 33.401 Annex B
# ---------------------------------------------------------------------------

def eea2(key: bytes, count: int, bearer: int, direction: int,
         data: bytes) -> bytes:
    """AES-128-CTR with the 33.401 B.1.3 IV; encrypt == decrypt."""
    iv = struct.pack(">I", count) + bytes([((bearer & 0x1F) << 3)
                                           | ((direction & 1) << 2)]) \
        + bytes(11)
    return _aes_ctr(key, iv, data)


def _cmac_subkeys(key: bytes) -> tuple[bytes, bytes]:
    def dbl(b: bytes) -> bytes:
        n = int.from_bytes(b, "big") << 1
        if b[0] & 0x80:
            n ^= 0x87
        return (n & ((1 << 128) - 1)).to_bytes(16, "big")
    l = _aes_ecb_encrypt(key, bytes(16))
    k1 = dbl(l)
    k2 = dbl(k1)
    return k1, k2


def aes_cmac(key: bytes, msg: bytes, msg_bits: int | None = None) -> bytes:
    """AES-CMAC (RFC 4493) with bit-granular message length (needed by
    128-EIA2, whose inputs are bit strings)."""
    if msg_bits is None:
        msg_bits = 8 * len(msg)
    k1, k2 = _cmac_subkeys(key)
    m_int = int.from_bytes(msg, "big") >> (8 * len(msg) - msg_bits) \
        if msg else 0
    complete = msg_bits > 0 and msg_bits % 128 == 0
    if complete:
        total_bits = msg_bits
        last_key = k1
    else:
        pad = 128 - (msg_bits % 128) if msg_bits % 128 else 128
        m_int = (m_int << pad) | (1 << (pad - 1))
        total_bits = msg_bits + pad
        last_key = k2
    data = m_int.to_bytes(total_bits // 8, "big")
    blocks = [data[i:i + 16] for i in range(0, len(data), 16)]
    blocks[-1] = _xor(blocks[-1], last_key)
    x = bytes(16)
    for b in blocks:
        x = _aes_ecb_encrypt(key, _xor(x, b))
    return x


def eia2(key: bytes, count: int, bearer: int, direction: int,
         data: bytes, data_bits: int | None = None) -> bytes:
    """-> 4-byte MAC-I (33.401 B.2.3).  ``data_bits`` for non-byte-aligned
    messages (defaults to 8*len(data))."""
    if data_bits is None:
        data_bits = 8 * len(data)
    header = struct.pack(">I", count) + bytes([((bearer & 0x1F) << 3)
                                               | ((direction & 1) << 2)]) \
        + bytes(3)
    hdr_int = int.from_bytes(header, "big")
    msg_int = (int.from_bytes(data, "big") >> (8 * len(data) - data_bits)) \
        if data else 0
    total_bits = 64 + data_bits
    m_int = (hdr_int << data_bits) | msg_int
    nbytes = -(-total_bits // 8)
    m = (m_int << (8 * nbytes - total_bits)).to_bytes(nbytes, "big")
    return aes_cmac(key, m, total_bits)[:4]


# ---------------------------------------------------------------------------
# 128-EEA1 / 128-EIA1 (SNOW 3G, 35.215/35.216) + algorithm dispatch
# ---------------------------------------------------------------------------

from lteax_torch.stack.snow3g import eea1, eia1  # noqa: E402,F401


def eea(alg: int, key: bytes, count: int, bearer: int, direction: int,
        data: bytes) -> bytes:
    """EPS ciphering dispatch: 0 = EEA0 (null), 1 = 128-EEA1 (SNOW 3G),
    2 = 128-EEA2 (AES-CTR)."""
    if alg == 0:
        return data
    if alg == 1:
        return eea1(key, count, bearer, direction, data)
    if alg == 2:
        return eea2(key, count, bearer, direction, data)
    raise ValueError(f"unsupported EEA{alg}")


def eia(alg: int, key: bytes, count: int, bearer: int, direction: int,
        data: bytes, data_bits: int | None = None) -> bytes:
    """EPS integrity dispatch: 1 = 128-EIA1 (SNOW 3G UIA2 MAC),
    2 = 128-EIA2 (AES-CMAC)."""
    if alg == 1:
        return eia1(key, count, bearer, direction, data, data_bits)
    if alg == 2:
        return eia2(key, count, bearer, direction, data, data_bits)
    raise ValueError(f"unsupported EIA{alg}")
