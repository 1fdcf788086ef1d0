"""SNOW 3G stream cipher + 128-EEA1 / 128-EIA1 (UEA2/UIA2).

(reference capability: ``liblte/src/liblte_security.cc`` EEA1/EIA1 —
SURVEY.md §2.1 lists SNOW 3G presence as [U]; 33.401 §5.1.3/§5.1.4 name
128-EEA1/128-EIA1 as mandatory UE algorithms, so capability parity wants
them regardless.)

Implementation is from the ETSI/SAGE SNOW 3G specification (35.216) with
both S-boxes GENERATED from their algebraic definitions rather than
transcribed:

- S_R: the AES S-box (inverse in GF(2^8)/0x11B + affine transform);
- S_Q: SQ(x) = D_49(x) + 0x25 over GF(2^8)/0x169 (x^8+x^6+x^5+x^3+1),
  where D_49 is the Dickson polynomial (char-2 recurrence
  D_n = x*D_{n-1} + D_{n-2});

and validated against the published test data (35.217-class vectors in
tests/test_snow3g.py): core keystream, 128-EEA1 ciphertext.

Host-side control-plane crypto (like security.py) — not a TPU kernel.

The port's own copy of ``lteax/stack/snow3g.py`` (it imports nothing of the
JAX package); ``tests/test_torch_stack.py`` holds the two equal.
"""

from __future__ import annotations

M32 = 0xFFFFFFFF


# ---------------------------------------------------------------------------
# GF(2^8) helpers + S-box generation
# ---------------------------------------------------------------------------

def _gf_mul(a: int, b: int, poly: int) -> int:
    r = 0
    while b:
        if b & 1:
            r ^= a
        b >>= 1
        a <<= 1
        if a & 0x100:
            a ^= poly
    return r


def _aes_sbox() -> list[int]:
    """AES S-box from its definition: x^-1 in GF(2^8)/0x11B then the affine
    transform b ^= rotl(b,1)^rotl(b,2)^rotl(b,3)^rotl(b,4) ^ 0x63."""
    # inverses by exhaustion (256 elements, host-side one-time)
    inv = [0] * 256
    for a in range(1, 256):
        for b in range(1, 256):
            if _gf_mul(a, b, 0x11B) == 1:
                inv[a] = b
                break
    out = []
    for x in range(256):
        b = inv[x]
        r = 0x63
        for i in range(8):
            bit = ((b >> i) ^ (b >> ((i + 4) % 8)) ^ (b >> ((i + 5) % 8))
                   ^ (b >> ((i + 6) % 8)) ^ (b >> ((i + 7) % 8))) & 1
            r ^= bit << i
        out.append(r)
    return out


def _sq_sbox() -> list[int]:
    """SNOW 3G S_Q: SQ(x) = D_49(x) + 0x25 in GF(2^8)/0x169 (Dickson
    polynomial via the characteristic-2 recurrence)."""
    out = []
    for x in range(256):
        d_prev, d = 0, x                   # D_0 = 2 (= 0 in char 2), D_1 = x
        for _ in range(48):                # up to D_49
            d_prev, d = d, _gf_mul(x, d, 0x169) ^ d_prev
        out.append(d ^ 0x25)
    return out


SR = _aes_sbox()
SQ = _sq_sbox()
# spot-anchors from the published tables (transcription-independent check)
assert SR[:4] == [0x63, 0x7C, 0x77, 0x7B]
assert SQ[:4] == [0x25, 0x24, 0x73, 0x67]


def _mulx(v: int, c: int) -> int:
    return ((v << 1) ^ c) & 0xFF if v & 0x80 else (v << 1)


def _mulxpow(v: int, i: int, c: int) -> int:
    for _ in range(i):
        v = _mulx(v, c)
    return v


def _mix(sw: list[int], c: int) -> int:
    """AES MixColumn [2 3 1 1 / 1 2 3 1 / 1 1 2 3 / 3 1 1 2] over the
    S-boxed bytes with the given MULx constant (0x1B for S1, 0x69 for S2)."""
    w0, w1, w2, w3 = sw
    r0 = _mulx(w0, c) ^ w1 ^ w2 ^ _mulx(w3, c) ^ w3
    r1 = _mulx(w0, c) ^ w0 ^ _mulx(w1, c) ^ w2 ^ w3
    r2 = w0 ^ _mulx(w1, c) ^ w1 ^ _mulx(w2, c) ^ w3
    r3 = w0 ^ w1 ^ _mulx(w2, c) ^ w2 ^ _mulx(w3, c)
    return (r0 << 24) | (r1 << 16) | (r2 << 8) | r3


def _s1(w: int) -> int:
    return _mix([SR[(w >> s) & 0xFF] for s in (24, 16, 8, 0)], 0x1B)


def _s2(w: int) -> int:
    return _mix([SQ[(w >> s) & 0xFF] for s in (24, 16, 8, 0)], 0x69)


def _mul_alpha(c: int) -> int:
    return ((_mulxpow(c, 23, 0xA9) << 24) | (_mulxpow(c, 245, 0xA9) << 16)
            | (_mulxpow(c, 48, 0xA9) << 8) | _mulxpow(c, 239, 0xA9))


def _div_alpha(c: int) -> int:
    return ((_mulxpow(c, 16, 0xA9) << 24) | (_mulxpow(c, 39, 0xA9) << 16)
            | (_mulxpow(c, 6, 0xA9) << 8) | _mulxpow(c, 64, 0xA9))


_MUL_ALPHA = [_mul_alpha(c) for c in range(256)]
_DIV_ALPHA = [_div_alpha(c) for c in range(256)]


class Snow3G:
    """SNOW 3G keystream generator (35.216)."""

    def __init__(self, k: tuple[int, int, int, int],
                 iv: tuple[int, int, int, int]):
        """k = (k0, k1, k2, k3) with k3 = the first (most significant) key
        word; iv = (iv0, iv1, iv2, iv3) with iv3 keyed into s15, iv2 into
        s12, iv1 into s10, iv0 into s9 (the convention the 35.217-class
        test vectors validate)."""
        k0, k1, k2, k3 = k
        iv0, iv1, iv2, iv3 = iv
        inv = 0xFFFFFFFF
        s = [k0 ^ inv, k1 ^ inv, k2 ^ inv, k3 ^ inv,
             k0, k1, k2, k3,
             k0 ^ inv, (k1 ^ inv) ^ iv0, (k2 ^ inv) ^ iv1, k3 ^ inv,
             k0 ^ iv2, k1, k2, k3 ^ iv3]
        self.s = s
        self.r1 = self.r2 = self.r3 = 0
        for _ in range(32):
            f = self._clock_fsm()
            self._clock_lfsr(f)
        self._clock_fsm()
        self._clock_lfsr(None)

    def _clock_fsm(self) -> int:
        s = self.s
        f = ((s[15] + self.r1) & M32) ^ self.r2
        r = (self.r2 + (self.r3 ^ s[5])) & M32
        self.r3 = _s2(self.r2)
        self.r2 = _s1(self.r1)
        self.r1 = r
        return f

    def _clock_lfsr(self, f: int | None) -> None:
        s = self.s
        v = (((s[0] << 8) & M32) ^ _MUL_ALPHA[s[0] >> 24]
             ^ s[2] ^ (s[11] >> 8) ^ _DIV_ALPHA[s[11] & 0xFF])
        if f is not None:
            v ^= f
        s.pop(0)
        s.append(v)

    def keystream(self, n: int) -> list[int]:
        out = []
        for _ in range(n):
            f = self._clock_fsm()
            out.append(f ^ self.s[0])
            self._clock_lfsr(None)
        return out


def _key_words(key: bytes) -> tuple[int, int, int, int]:
    """CK/IK (16 bytes, network order) -> (k0, k1, k2, k3) with k3 = the
    FIRST four bytes (most significant word, 35.215 naming)."""
    w = [int.from_bytes(key[i:i + 4], "big") for i in range(0, 16, 4)]
    return w[3], w[2], w[1], w[0]


# ---------------------------------------------------------------------------
# 128-EEA1 (UEA2, 35.215 §4; 33.401 B.1.2)
# ---------------------------------------------------------------------------

def eea1(key: bytes, count: int, bearer: int, direction: int,
         data: bytes, data_bits: int | None = None) -> bytes:
    """128-EEA1 keystream XOR; involution (encrypt == decrypt).

    Trailing bits beyond ``data_bits`` are zeroed in the output per the
    LENGTH convention of 35.217-class test data."""
    n_bits = 8 * len(data) if data_bits is None else data_bits
    cw = count & M32
    bw = ((bearer & 0x1F) << 27) | ((direction & 1) << 26)
    # 35.215 f8 IV: s15 is keyed by the BEARER||DIRECTION word and s9 by
    # COUNT (validated against the 35.217/33.401 C.1 test set 1 ciphertext)
    g = Snow3G(_key_words(key), (cw, bw, cw, bw))
    n_words = (len(data) + 3) // 4
    ks = g.keystream(n_words)
    ksb = b"".join(z.to_bytes(4, "big") for z in ks)[:len(data)]
    out = bytearray(a ^ b for a, b in zip(data, ksb))
    # zero any bits past LENGTH
    if n_bits < 8 * len(out):
        full, rem = divmod(n_bits, 8)
        if rem:
            out[full] &= (0xFF00 >> rem) & 0xFF
            full += 1
        for i in range(full, len(out)):
            out[i] = 0
    return bytes(out)


# ---------------------------------------------------------------------------
# 128-EIA1 (UIA2, 35.215 §5; 33.401 B.2.3: FRESH = BEARER || 0^27)
# ---------------------------------------------------------------------------

def _mul64(v: int, p: int, c: int = 0x1B) -> int:
    """Carry-less multiply of V by P in GF(2^64) with reduction polynomial
    x^64 + x^4 + x^3 + x + 1 (low bits ``c``) — X.691-free spec §3/UIA2."""
    m64 = (1 << 64) - 1
    r = 0
    while p:
        if p & 1:
            r ^= v
        p >>= 1
        v <<= 1
        if v >> 64:
            v = (v & m64) ^ c
    return r


def eia1(key: bytes, count: int, bearer: int, direction: int,
         data: bytes, data_bits: int | None = None) -> bytes:
    """128-EIA1 32-bit MAC (UIA2 polynomial MAC over GF(2^64))."""
    n_bits = 8 * len(data) if data_bits is None else data_bits
    fresh = (bearer & 0x1F) << 27           # 33.401 B.2.3: FRESH=BEARER||0^27
    cw = count & M32
    d = direction & 1
    # 35.215 f9 IV (same s15..s9 keying order as f8):
    #   s15 <- FRESH ^ DIR<<15, s12 <- COUNT ^ DIR<<31, s10 <- FRESH,
    #   s9 <- COUNT
    g = Snow3G(_key_words(key),
               (cw, fresh, (cw ^ (d << 31)) & M32, fresh ^ (d << 15)))
    z = g.keystream(5)
    p = (z[0] << 32) | z[1]
    q = (z[2] << 32) | z[3]
    # message as 64-bit blocks, zero-padded; final block = LENGTH in bits
    d = n_bits // 64 + 1 + 1            # D = ceil(LENGTH/64) + 1 (+ partial)
    n_blocks = (n_bits + 63) // 64
    buf = bytearray(data[: (n_bits + 7) // 8])
    if n_bits % 8:
        buf[-1] &= (0xFF00 >> (n_bits % 8)) & 0xFF
    buf += bytes(8 * n_blocks - len(buf))
    eval_ = 0
    for i in range(n_blocks):
        m = int.from_bytes(buf[8 * i: 8 * i + 8], "big")
        eval_ = _mul64(eval_ ^ m, p)
    eval_ = _mul64(eval_ ^ n_bits, q)
    mac = ((eval_ >> 32) ^ z[4]) & M32
    return mac.to_bytes(4, "big")
