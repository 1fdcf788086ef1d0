"""Faults planted under the timed path, for the harness's tests and for
the readings of ``benchmark/readings.py``: each must turn ``correct``
false.  A cell on one card has no exchange between chips to leave out.

- ``state_unchanged``: every turbo half-iteration returns its input as its
  output (the a priori LLRs as L, the window boundaries as they came).
- ``half_left_out``: the tail decodes the first half of the batch only;
  the other half comes back as failed blocks of zeros.  The halves are of
  transport block rows (``llr`` rows over ``c``), so with two codewords a
  subframe they take both codewords' blocks alike.
- ``half_from_rest``: the same, the other half's bits and flags copied
  from the half that was decoded.
- ``answer_altered``: the first bit of every transport block flipped
  where the tail produces it, its CRC flag kept.
"""

from __future__ import annotations

import contextlib

import torch

FAULTS = ("state_unchanged", "half_left_out", "half_from_rest",
          "answer_altered")


@contextlib.contextmanager
def planted(name: str, dec, c: int):
    """Plant fault ``name`` in the decoder ``dec`` (``c`` codeblocks a
    transport block) for the ``with`` block."""
    if name == "state_unchanged":
        import lteax_torch.kernels.turbo_mlm as turbo_mlm
        inner = turbo_mlm.half_iteration
        turbo_mlm.half_iteration = lambda u, v, a, b, *args, **kw: (u, a, b)
        try:
            yield
        finally:
            turbo_mlm.half_iteration = inner
        return
    if name not in FAULTS:
        raise ValueError(f"no fault {name!r}: one of {FAULTS}")
    inner = dec.turbo

    def turbo(llr):
        if name == "answer_altered":
            bits, ok, n_iter = inner(llr)
            bits = bits.clone()
            bits[:, 0] ^= 1
            return bits, ok, n_iter
        b = llr.shape[0] // c
        half = b // 2
        bits, ok, n_iter = inner(llr[:half * c])
        if name == "half_left_out":
            rest_bits = torch.zeros_like(bits[:b - half])
            rest_ok = torch.zeros_like(ok[:b - half])
        else:
            rest_bits, rest_ok = bits[:b - half], ok[:b - half]
        return (torch.cat([bits, rest_bits]), torch.cat([ok, rest_ok]),
                n_iter)

    dec.turbo = turbo
    try:
        yield
    finally:
        del dec.turbo
