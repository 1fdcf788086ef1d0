"""Tail-biting convolutional code, K=7, rate 1/3 (36.212 §5.1.3.1).

Numpy copies of ``lteax.phy.fec.conv`` (whose module imports jax); the
tests hold them equal to the originals.  Generators G0=133, G1=171,
G2=165 (octal), MSB = current input bit.  The encoder is host set-up
(PBCH test signals); the decoder's trellis wiring comes from
:func:`trellis_tables`.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np

CONV_K = 7
CONV_GEN = (0o133, 0o171, 0o165)
CONV_RATE = 3


@lru_cache(maxsize=None)
def _taps() -> np.ndarray:
    """(3, 7) uint8; taps[i, j] multiplies input bit s_{k-j}."""
    t = np.zeros((3, CONV_K), dtype=np.uint8)
    for i, g in enumerate(CONV_GEN):
        for j in range(CONV_K):
            t[i, j] = (g >> (CONV_K - 1 - j)) & 1
    return t


def conv_encode(bits: np.ndarray) -> np.ndarray:
    """Tail-biting encode.  bits (..., K) -> (..., 3, K) int32.

    The shift register starts with the last 6 input bits (tail-biting),
    which the circular ``roll`` implements exactly."""
    bits = np.asarray(bits)
    taps = _taps()
    streams = []
    for i in range(3):
        acc = np.zeros(bits.shape, dtype=np.int32)
        for j in range(CONV_K):
            if taps[i, j]:
                acc = acc + np.roll(bits, j, axis=-1).astype(np.int32)
        streams.append(acc % 2)
    return np.stack(streams, axis=-2)


@lru_cache(maxsize=None)
def trellis_tables():
    """Returns (out_signs (64, 2, 3) f32, prev_state (64, 2) int32,
    ns_input (64,) int32).

    State = the previous 6 input bits, MSB the most recent; next state
    = (b << 5) | (state >> 1).  out_signs holds 1 - 2*output_bit for
    (state, input bit); prev_state the two predecessors of each new
    state; ns_input the input bit that leads into a new state (ns >> 5).
    """
    taps = _taps()
    out = np.zeros((64, 2, 3), dtype=np.int32)
    for s in range(64):
        past = [(s >> (5 - j)) & 1 for j in range(6)]  # past[j] = s_{k-1-j}
        for b in range(2):
            window = [b] + past                          # window[j] = s_{k-j}
            for i in range(3):
                out[s, b, i] = sum(taps[i, j] * window[j]
                                   for j in range(CONV_K)) % 2
    out_signs = (1 - 2 * out).astype(np.float32)
    prev_state = np.zeros((64, 2), dtype=np.int32)
    for ns in range(64):
        low5 = ns & 31
        prev_state[ns, 0] = (low5 << 1) | 0
        prev_state[ns, 1] = (low5 << 1) | 1
    ns_input = (np.arange(64) >> 5).astype(np.int32)
    return out_signs, prev_state, ns_input
