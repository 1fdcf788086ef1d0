"""Numerics-only decoder tuning (counterpart of ``lteax.phy.tuning``).

Only the knobs that change what a decode computes are carried over;
the TPU layout and scheduling knobs (tile sizes, lane folds, layout glue,
planar boundaries, bf16 staging) have no meaning on the GPU port.  Values
are the reference's shipped defaults, so a decode with this profile is the
reference decode with ``mdtype="f32"``.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class DecoderTuning:
    """- ``win``/``acq``: max-log-MAP window and acquisition length.
    - ``ext_scale``: extrinsic damping (max-log standard 0.75).
    - ``earlystop``: CRC-based half-iteration early termination.
    - ``pinpad``: dead trellis positions carry u=+PIN in the beta sweep
      instead of a freeze blend (the only form the port implements).
    - ``n_iter``: full turbo iterations of the single-subframe decode
      (``pdsch.pdsch_decode_device``; the batch decoders take theirs as an
      argument).
    - ``retry_m``: compacted-retry subbatch size of the UL decoder; 0
      disables the retry.
    - ``retry_m_dl``: the same for the DL and HARQ decoders.
    - ``retry_m_mimo``: the same for the 2x2 MIMO decoders (both tails of
      SIC).
    - ``retry_levels``: full-batch iterations checked for compaction before
      the full-batch early-stop loop takes over.
    - ``mdtype``: trellis metric dtype; the port runs "f32" only.
    - ``mimo_detector``: "mmse" (per-RE linear demix, both codewords in one
      turbo batch) or "sic" (decode CW0, re-encode, cancel, decode CW1 from
      an MRC of the clean layer; CW0-failed subframes keep the MMSE LLRs).
    - ``mimo_chest``: "ls" (LS + linear interpolation) or "mmse" (Wiener
      frequency interpolation with the static noise prior
      ``mimo_chest_nv``); the MMSE decoder's front only, as in the
      reference.
    - ``mimo_denoise``: project the CRS estimate at the pilots onto the
      cyclic-prefix delay span (LS chest only).
    """

    win: int = 128
    acq: int = 16
    ext_scale: float = 0.75
    earlystop: bool = True
    pinpad: bool = True
    n_iter: int = 6
    retry_m: int = 128
    retry_m_dl: int = 64
    retry_m_mimo: int = 192
    retry_levels: int = 2
    mdtype: str = "f32"
    mimo_detector: str = "mmse"
    mimo_chest: str = "ls"
    mimo_denoise: bool = False
    mimo_chest_nv: float = 3e-3

    def __post_init__(self):
        if self.mdtype != "f32":
            raise NotImplementedError("the port's trellis runs in f32 only")
        if not self.pinpad:
            raise NotImplementedError("the port implements pinned padding only")
        if self.win % 2 or not 0 < self.acq <= self.win // 2:
            raise ValueError("need an even win and 0 < acq <= win/2")
        if self.n_iter < 1:
            raise ValueError("n_iter must be >= 1")
        if self.retry_m_mimo < 0:
            raise ValueError("retry_m_mimo must be >= 0")
        if self.mimo_detector not in ("mmse", "sic"):
            raise ValueError(f"mimo_detector {self.mimo_detector!r}: "
                             "\"mmse\" or \"sic\"")
        if self.mimo_chest not in ("ls", "mmse"):
            raise ValueError(f"mimo_chest {self.mimo_chest!r}: \"ls\" or "
                             "\"mmse\"")
        if not isinstance(self.mimo_denoise, bool):
            raise ValueError("mimo_denoise is a bool")
        if not self.mimo_chest_nv > 0:
            raise ValueError("mimo_chest_nv must be > 0")

    def early_crc(self, cb_crc: bool) -> str | None:
        """CRC flavour for the decoder's early stop (None when disabled)."""
        if not self.earlystop:
            return None
        return "24B" if cb_crc else "24A"


SINGLE_SUBFRAME = DecoderTuning(win=32, earlystop=False, retry_m=0,
                                retry_m_dl=0, retry_m_mimo=0)
"""The reference's single-subframe turbo settings
(``lteax.phy.fec.turbo.turbo_decode_batch`` as ``pdsch_decode_llrs``
calls it): win 32, acq 16, ext_scale 0.75, a fixed 6 iterations (no
CRC early stop) and no compacted retry.  The SI decode and
:func:`lteax_torch.phy.channels.pdsch.pdsch_decode_device` run with it."""
