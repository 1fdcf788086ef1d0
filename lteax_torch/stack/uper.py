"""Unaligned PER (X.691) primitives for the hand-rolled RRC codec.

(reference capability: the bit-level helpers ``liblte_value_2_bits`` /
``liblte_bits_2_value`` that ``liblte_rrc.cc`` builds its hand-written
ASN.1-equivalent codec on.)

Only the constructs 36.331's broadcast messages need: constrained whole
numbers, enumerations (with extension marker), sequence optional bitmaps,
extension bits, fixed-size bit strings, and constrained SEQUENCE-OF lengths.

The port's own copy of ``lteax/stack/uper.py`` (numpy only; the port
imports nothing of the JAX package); ``tests/test_torch_plans.py`` holds
the two equal.
"""

from __future__ import annotations

import math

import numpy as np


class UperWriter:
    def __init__(self):
        self.bits: list[int] = []

    def bit(self, b: int):
        self.bits.append(b & 1)

    def bitstring(self, value: int, width: int):
        for i in range(width - 1, -1, -1):
            self.bits.append((value >> i) & 1)

    def cint(self, value: int, lo: int, hi: int):
        """Constrained whole number (X.691 §10.5): minimal bits for the range."""
        n = hi - lo + 1
        if n == 1:
            return
        w = math.ceil(math.log2(n))
        assert lo <= value <= hi, (value, lo, hi)
        self.bitstring(value - lo, w)

    def enum(self, index: int, n_root: int, extensible: bool = False):
        if extensible:
            self.bit(0)          # root alternative
        self.cint(index, 0, n_root - 1)

    def length(self, n: int, lo: int, hi: int):
        self.cint(n, lo, hi)

    def opt(self, present: bool):
        self.bit(1 if present else 0)

    def ulength(self, n: int):
        """General length determinant (X.691 §10.9), unfragmented forms:
        n < 128 -> '0' + 7 bits; n < 16384 -> '10' + 14 bits."""
        if n < 128:
            self.bit(0)
            self.bitstring(n, 7)
        elif n < 16384:
            self.bit(1)
            self.bit(0)
            self.bitstring(n, 14)
        else:
            raise ValueError("fragmented lengths unsupported")

    def octets(self, data: bytes, lo: int | None = None,
               hi: int | None = None):
        """OCTET STRING: fixed size (lo==hi), constrained (lo..hi), or
        unconstrained (lo=hi=None, general length determinant)."""
        if lo is None:
            self.ulength(len(data))
        elif lo != hi:
            self.length(len(data), lo, hi)
        else:
            assert len(data) == lo, (len(data), lo)
        for b in data:
            self.bitstring(b, 8)

    def small_index(self, i: int):
        """Normally small non-negative whole number (X.691 §10.6) — the
        CHOICE extension-alternative index: '0' + 6 bits for i < 64."""
        if i >= 64:
            raise ValueError("large extension indices unsupported")
        self.bit(0)
        self.bitstring(i, 6)

    def open_type(self, bits):
        """Open type field (X.691 §11.2): contents padded to a whole number
        of octets (min 1), preceded by an octet-count length determinant."""
        bits = list(bits)
        pad = (-len(bits)) % 8
        bits = bits + [0] * (pad if bits else 8)
        self.ulength(len(bits) // 8)
        self.bits.extend(int(b) & 1 for b in bits)

    def array(self) -> np.ndarray:
        return np.asarray(self.bits, dtype=np.int32)


class UperReader:
    def __init__(self, bits):
        self.bits = [int(x) for x in bits]
        self.pos = 0

    def bit(self) -> int:
        b = self.bits[self.pos]
        self.pos += 1
        return b

    def bitstring(self, width: int) -> int:
        v = 0
        for _ in range(width):
            v = (v << 1) | self.bit()
        return v

    def cint(self, lo: int, hi: int) -> int:
        n = hi - lo + 1
        if n == 1:
            return lo
        w = math.ceil(math.log2(n))
        return lo + self.bitstring(w)

    def enum(self, n_root: int, extensible: bool = False) -> int:
        if extensible and self.bit():
            raise ValueError("extended enum value not supported")
        return self.cint(0, n_root - 1)

    def length(self, lo: int, hi: int) -> int:
        return self.cint(lo, hi)

    def opt(self) -> bool:
        return bool(self.bit())

    def ulength(self) -> int:
        if self.bit() == 0:
            return self.bitstring(7)
        if self.bit() == 0:
            return self.bitstring(14)
        raise ValueError("fragmented lengths unsupported")

    def octets(self, lo: int | None = None, hi: int | None = None) -> bytes:
        if lo is None:
            n = self.ulength()
        elif lo != hi:
            n = self.length(lo, hi)
        else:
            n = lo
        return bytes(self.bitstring(8) for _ in range(n))

    def small_index(self) -> int:
        if self.bit():
            raise ValueError("large extension indices unsupported")
        return self.bitstring(6)

    def open_type(self) -> list[int]:
        """Open type field: returns the contained bits (octet-padded), and
        advances past them — unknown extensions are therefore skippable."""
        n = self.ulength()
        bits = self.bits[self.pos:self.pos + 8 * n]
        if len(bits) < 8 * n:
            raise ValueError("truncated open type")
        self.pos += 8 * n
        return bits
