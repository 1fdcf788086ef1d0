"""Numerics-only decoder tuning (counterpart of ``lteax.phy.tuning``).

Only the knobs that change what a decode computes are fields; the TPU
layout and scheduling knobs (tile sizes, lane folds, layout glue, planar
boundaries) have no meaning on the GPU port.
:meth:`DecoderTuning.from_dict` and :meth:`DecoderTuning.from_yaml` read a
profile in the reference's keys (``configs/tuning_default.yaml``): a key
that changes no value is accepted, a value whose numerics the port does
not reproduce raises.  The default profile is the exact one: the
reference's shipped values with an f32 trellis, f32 demap staging and the
FFT in the OFDM demod (``mdtype="f32"``, ``demap_in="f32"``,
``ofdm_dft="fft"``).  :data:`SHIPPED` is the
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

import re
from dataclasses import dataclass, fields

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
    - ``nofreeze``: drop the beta main-sweep freeze (the reference: "LOSES
      near threshold (batch-wide early stop pays 1-2 extra iterations);
      experiment only"): a dead position of the main beta sweep is a plain
      ACS step on u = v = 0, with no pin and no freeze, so the pin is off
      whatever ``pinpad`` says; the acquisition still freezes.
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
    - ``combine_bf16``: the reference's "grouped path-metric sums/maxes in
      bf16 with only the 4 gamma-merge casts in f32": the combine's 16 sums
      and 12 maxes round to bf16, the gamma merge and L's difference stay
      f32.  A bf16 trellis only (under "bf16_f32store" one operand of each
      sum is an f32 store and the sum is f32, as without the knob), and
      only in the full-batch iterations of the reference's layout path (no
      early stop, or 0 < retry_m < C); its compacted retry and its natural
      path combine in f32.
    - ``planar_int8``: the planar demap output quantized to int8 with one
      scale per batch, ``qs = max(max|LLR|, 1e-20) / 127``, and dequantized
      after the de-match gather as ``q * qs`` in the extrinsic's dtype,
      where the reference quantizes: a front whose de-match reads the
      planar demap output (DL and UL with an injective rate match, TM3 /
      TM4 MMSE; not HARQ, not SIC) on the reference's layout path.
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
    nofreeze: bool = False
    combine_bf16: bool = False
    planar_int8: bool = False

    def __post_init__(self):
        if self.mdtype not in MDTYPES:
            raise ValueError(f"mdtype {self.mdtype!r}: one of {MDTYPES}")
        if self.demap_in not in ("f32", "bf16"):
            raise ValueError(f"demap_in {self.demap_in!r}: \"f32\" or "
                             "\"bf16\"")
        for f in ("pinpad", "nofreeze", "combine_bf16", "planar_int8"):
            if not isinstance(getattr(self, f), bool):
                raise ValueError(f"{f} is a bool")
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

    def to_dict(self) -> dict:
        """The profile by field; :meth:`from_dict` reads it back."""
        return {f.name: getattr(self, f.name) for f in fields(self)}

    @classmethod
    def from_dict(cls, d: dict) -> "DecoderTuning":
        """A profile in the reference's keys (``lteax.phy.tuning.
        DecoderTuning``'s fields, and the port's ``n_iter``); a key that is
        absent takes the reference's default, so ``from_dict({})`` is
        :data:`SHIPPED`.  The knobs resolve as the reference's decode does:
        ``planar_int8`` off its layout path (``layout_glue: false``) reads
        the planar LLRs unquantized; a ``retry_m_dl`` / ``retry_m_mimo`` of
        None inherits ``retry_m``.  ``tb``, ``gb``, ``print_iters``,
        ``struct_dematch``, ``blane_flat``, ``blane_flat_mimo`` and the
        planar boundaries change no value (``tests/torch_tuning_keys.py``
        runs the reference both ways), nor does a ``blane_unroll`` that
        keeps the bf16 renormalisation.  A value whose numerics the port
        does not reproduce raises a ValueError that names its key:
        ``pallas_demap: false`` (the XLA demap), ``fused: false`` (the
        unfused kernel's L rounds apart from the fused one's),
        ``layout_glue: false`` under a bf16 trellis (the natural path's
        extrinsic rounds in another order), a ``blane_unroll`` that moves
        the bf16 renormalisation, and a planar boundary off under
        ``planar_int8``."""
        bad = sorted(set(d) - set(REFERENCE_DEFAULTS) - {"n_iter"})
        if bad:
            raise ValueError(f"unknown tuning keys: {bad}")
        r = {**REFERENCE_DEFAULTS, **d}
        for key, ok in (
                ("pallas_demap", r["pallas_demap"]),
                ("fused", r["fused"]),
                ("blane_unroll", r["mdtype"] == "f32"
                 or _blane_renorms(r["win"], r["blane_unroll"])
                 == _blane_renorms(r["win"], 4))):
            if not ok:
                raise ValueError(f"{key}: {r[key]!r} changes the decode's "
                                 "numerics and the port has no counterpart")
        layout = bool(r["layout_glue"])
        if not layout and r["mdtype"] != "f32":
            raise ValueError(f"layout_glue: false takes the reference's "
                             f"natural path, whose {r['mdtype']} extrinsic "
                             "rounds in another order; the port's bf16 "
                             "decode follows the layout path")
        int8 = bool(r["planar_int8"]) and layout
        for key in ("ul_planar_boundary", "mimo_planar_boundary"):
            if int8 and not r[key]:
                raise ValueError(f"{key}: false with planar_int8 leaves that "
                                 "front's LLRs unquantized; the port "
                                 "quantizes every planar front")
        out = {f.name: r[f.name] for f in fields(cls)
               if f.name in REFERENCE_DEFAULTS}
        out.update(
            planar_int8=int8,
            retry_m_dl=(r["retry_m"] if r["retry_m_dl"] is None
                        else r["retry_m_dl"]),
            retry_m_mimo=(r["retry_m"] if r["retry_m_mimo"] is None
                          else r["retry_m_mimo"]))
        if "n_iter" in d:
            out["n_iter"] = d["n_iter"]
        return cls(**out)

    @classmethod
    def from_yaml(cls, path) -> "DecoderTuning":
        """:meth:`from_dict` of a YAML profile: a flat ``tuning:`` mapping
        (or a flat mapping), as ``configs/tuning_default.yaml`` is.  Read by
        :func:`read_flat_yaml`, not PyYAML, which the card's machine
        lacks."""
        with open(path) as f:
            doc = read_flat_yaml(f.read())
        return cls.from_dict(doc.get("tuning", doc))


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


REFERENCE_DEFAULTS = {
    "win": 128, "acq": 16, "tb": 16, "gb": None, "mdtype": "bf16",
    "fused": True, "nofreeze": False, "pinpad": True, "earlystop": True,
    "ext_scale": 0.75, "retry_m": 128, "retry_m_dl": 64,
    "retry_m_mimo": 192, "retry_levels": 2, "layout_glue": True,
    "mimo_chest": "ls", "mimo_denoise": False, "mimo_chest_nv": 3e-3,
    "mimo_detector": "mmse", "struct_dematch": False, "pallas_demap": True,
    "print_iters": False, "blane_flat": True, "blane_flat_mimo": True,
    "blane_unroll": 16, "combine_bf16": False, "demap_in": "bf16",
    "ul_planar_boundary": True, "mimo_planar_boundary": True,
    "ofdm_dft": "factored", "planar_int8": False, "ul_dft": "fft"}
"""The reference's ``DecoderTuning()`` by field (``lteax/phy/tuning.py``):
the keys :meth:`DecoderTuning.from_dict` reads and the values it takes for
the absent ones (``tests/test_torch_tuning_forms.py`` holds the copy equal
to the original)."""


def _blane_renorms(win: int, unroll: int) -> tuple:
    """The steps of a half window after which the reference's layout kernel
    renormalises a bf16 trellis at ``blane_unroll`` ``unroll``
    (``_make_kernel_blane``'s ``_renorm_at``: an unroll that does not divide
    win/2 falls back to 4 or 2)."""
    half = win // 2
    if unroll < 1 or half % unroll:
        unroll = 4 if half % 4 == 0 else 2
    return tuple(t for t in range(half)
                 if (t % unroll) % 4 == 3 or t % unroll == unroll - 1)


_SCALARS = ((re.compile(r"-?(?:0|[1-9][0-9]*)"), int),
            (re.compile(r"-?[0-9]+\.[0-9]*(?:[eE][-+][0-9]+)?"), float),
            (re.compile(r"[A-Za-z_][A-Za-z0-9_]*"), str))
"""The plain scalars :func:`read_flat_yaml` reads, as YAML 1.1 resolves
them."""
_WORDS = {"null": None, "true": True, "false": False}


def read_flat_yaml(text: str) -> dict:
    """The ``key: scalar`` lines of a profile, flat or under one section
    (``tuning:``, as ``configs/tuning_default.yaml``), ``#`` comments and
    blank lines skipped.  A scalar is ``null``, ``true`` / ``false``, a
    decimal int, a float with a point, or a bare word; anything else (a
    word YAML would read as another type, quotes, lists, deeper nesting)
    raises."""
    doc: dict = {}
    section = None
    for no, line in enumerate(text.splitlines(), 1):
        line = line.split("#", 1)[0].rstrip()
        if not line:
            continue
        m = re.fullmatch(r"( *)([A-Za-z_][A-Za-z0-9_]*):(?: +(\S+))?", line)
        if m and not m.group(1):
            section = None
            if m.group(3) is None:
                section = doc[m.group(2)] = {}
                continue
        elif not m or section is None:
            raise ValueError(f"line {no}: not a key: scalar line: {line!r}")
        val = m.group(3)
        if val in _WORDS:
            value = _WORDS[val]
        else:
            kind = next((k for pat, k in _SCALARS
                         if val is not None and pat.fullmatch(val)), None)
            if kind is None or (kind is str and val.lower() in (
                    *_WORDS, "yes", "no", "on", "off", "y", "n")):
                raise ValueError(f"line {no}: not a scalar this reader "
                                 f"resolves: {line!r}")
            value = kind(val)
        (doc if section is None else section)[m.group(2)] = value
    return doc
