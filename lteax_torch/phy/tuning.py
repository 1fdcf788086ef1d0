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
    - ``retry_m``: compacted-retry subbatch size of the UL decoder; 0
      disables the retry.
    - ``retry_m_dl``: the same for the DL and HARQ decoders.
    - ``retry_levels``: full-batch iterations checked for compaction before
      the full-batch early-stop loop takes over.
    - ``mdtype``: trellis metric dtype; the port runs "f32" only.
    """

    win: int = 128
    acq: int = 16
    ext_scale: float = 0.75
    earlystop: bool = True
    pinpad: bool = True
    retry_m: int = 128
    retry_m_dl: int = 64
    retry_levels: int = 2
    mdtype: str = "f32"

    def __post_init__(self):
        if self.mdtype != "f32":
            raise NotImplementedError("the port's trellis runs in f32 only")
        if not self.pinpad:
            raise NotImplementedError("the port implements pinned padding only")
        if self.win % 2 or not 0 < self.acq <= self.win // 2:
            raise ValueError("need an even win and 0 < acq <= win/2")

    def early_crc(self, cb_crc: bool) -> str | None:
        """CRC flavour for the decoder's early stop (None when disabled)."""
        if not self.earlystop:
            return None
        return "24B" if cb_crc else "24A"
