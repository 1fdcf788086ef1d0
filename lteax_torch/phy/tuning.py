"""Numerics-only decoder tuning (counterpart of ``lteax.phy.tuning``).

Only the knobs that change what a decode computes are carried over;
the TPU layout and scheduling knobs (tile sizes, lane folds, layout glue,
planar boundaries) have no meaning on the GPU port.  The default profile
is the exact one: the reference's shipped values with an f32 trellis, f32
demap staging and the FFT in the OFDM demod (``mdtype="f32"``,
``demap_in="f32"``, ``ofdm_dft="fft"``).  :data:`SHIPPED` is the
reference's shipped numerics: bf16 trellis, bf16 demap staging and the
factored OFDM DFT with bf16 operands.

Of the DFT forms, only ``ofdm_dft="factored"`` changes what a decode
computes.  ``"factored_hi"`` and ``ul_dft``'s ``"factored"`` and
``"matmul"`` are f32 forms of the exact transform that ``torch.fft``
computes (within 1e-5 of its peak); the reference kept them as TPU
scheduling trades (its FFT was slow at sizes that are not powers of two).
The port carries them so that every value of the reference's
``DecoderTuning`` has its counterpart; no default, no ``SHIPPED`` and no
path of the port selects them.
"""

from __future__ import annotations

from dataclasses import dataclass

OFDM_DFTS = ("fft", "factored", "factored_hi")
"""The OFDM demod's DFT forms (``phy.ofdm.samples_to_subframe``)."""
UL_DFTS = ("fft", "factored", "matmul")
"""The SC-FDMA transform's forms (``phy.channels.pusch.ul_dft``)."""


MDTYPES = ("f32", "bf16", "bf16_f32store")
"""The trellis metric dtypes of the reference's turbo kernels."""


@dataclass(frozen=True)
class DecoderTuning:
    """- ``win``/``acq``: max-log-MAP window and acquisition length.
    - ``ext_scale``: extrinsic damping (max-log standard 0.75).
    - ``earlystop``: CRC-based half-iteration early termination.
    - ``pinpad``: dead trellis positions carry u=+PIN in the beta sweep;
      False keeps the old beta there (the freeze: a select in f32, the
      blend ``m*new + (1-m)*old`` in bf16).
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
    - ``mdtype``: trellis metric dtype: "f32"; "bf16" (bf16 ACS, alpha/beta
      stores, L output and extrinsic carries; the combine sums in f32);
      "bf16_f32store" (the same trellis with f32 extrinsic carries; its
      f32 stores hold the same bf16 values, so the port runs the bf16
      kernel).  A bf16 form also carries the de-matched LLRs in bf16.
    - ``demap_in``: staging dtype of the demap kernel's inputs ("f32" or
      "bf16"; the kernel computes in f32 either way).  Only where the
      reference demaps with its kernel: an injective rate match, not the
      SIC front.
    - ``mimo_detector``: "mmse" (per-RE linear demix, both codewords in one
      turbo batch) or "sic" (decode CW0, re-encode, cancel, decode CW1 from
      an MRC of the clean layer; CW0-failed subframes keep the MMSE LLRs).
    - ``mimo_chest``: "ls" (LS + linear interpolation) or "mmse" (Wiener
      frequency interpolation with the static noise prior
      ``mimo_chest_nv``); the MMSE decoder's front only, as in the
      reference.
    - ``mimo_denoise``: project the CRS estimate at the pilots onto the
      cyclic-prefix delay span (LS chest only).
    - ``ofdm_dft``: the OFDM demod's DFT in every front that demodulates
      IQ (DL, HARQ, MIMO): "fft" (cuFFT), "factored" (the reference's
      Cooley–Tukey matmuls with operands rounded to bf16, its TPU single
      pass) or "factored_hi" (the same in f32).
    - ``ul_dft``: the UL front's transform de-precoding: "fft",
      "factored" (f32 products) or "matmul" (a dense unitary matrix).
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
    demap_in: str = "f32"
    mimo_detector: str = "mmse"
    mimo_chest: str = "ls"
    mimo_denoise: bool = False
    mimo_chest_nv: float = 3e-3
    ofdm_dft: str = "fft"
    ul_dft: str = "fft"

    def __post_init__(self):
        if self.mdtype not in MDTYPES:
            raise ValueError(f"mdtype {self.mdtype!r}: one of {MDTYPES}")
        if self.demap_in not in ("f32", "bf16"):
            raise ValueError(f"demap_in {self.demap_in!r}: \"f32\" or "
                             "\"bf16\"")
        if not isinstance(self.pinpad, bool):
            raise ValueError("pinpad is a bool")
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
        if self.ofdm_dft not in OFDM_DFTS:
            raise ValueError(f"ofdm_dft {self.ofdm_dft!r}: one of "
                             f"{OFDM_DFTS}")
        if self.ul_dft not in UL_DFTS:
            raise ValueError(f"ul_dft {self.ul_dft!r}: one of {UL_DFTS}")

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


SHIPPED = DecoderTuning(mdtype="bf16", demap_in="bf16", ofdm_dft="factored")
"""The reference's shipped numerics (``lteax.phy.tuning.DecoderTuning()``,
``configs/tuning_default.yaml``): a bf16 trellis (ACS, stores, L and the
extrinsic carries in bf16), bf16 demap staging and the factored OFDM DFT
with bf16 operands, every other numerics knob as the port's default.  The
reference computes its factored DFT in f32 on the CPU (XLA:CPU ignores the
matmul precision), so a comparison with its CPU decode that must hold bit
for bit runs ``dataclasses.replace(SHIPPED, ofdm_dft="fft")`` against the
reference at ``ofdm_dft="fft"``."""
