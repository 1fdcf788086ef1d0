"""Numerics-only decoder tuning (counterpart of ``lteax.phy.tuning``).

Only the knobs that change what a decode computes are fields, every one
of them the reference's: the TPU tile and scheduling knobs (``tb``,
``gb``, ``blane_flat``, ``struct_dematch``, ``print_iters``) have no
meaning on the GPU port.  ``layout_glue``, ``fused``, ``blane_unroll``,
``pallas_demap`` and the planar boundaries are fields because each
changes a decode's numerics in the reference (its natural path's
extrinsic order, the unfused kernel, the layout kernel's bf16
renormalisation, the XLA demap, which fronts ``planar_int8``
quantizes).  :meth:`DecoderTuning.from_dict` and
:meth:`DecoderTuning.from_yaml` read a profile in the reference's keys
(``configs/tuning_default.yaml``) and resolve every value as the
reference's decode does; only an unknown key raises.  The default
profile is the exact one: the reference's shipped values with an f32
trellis, f32 demap staging and the FFT in the OFDM demod
(``mdtype="f32"``, ``demap_in="f32"``, ``ofdm_dft="fft"``).
:data:`SHIPPED` is the reference's shipped numerics: bf16 trellis, bf16
demap staging and the factored OFDM DFT with bf16 operands.

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
    - ``fused``: the fused kernels (the combine at the chains' meeting
      point).  False, or ``acq`` > win/2, runs the reference's unfused
      kernel (whole-window stores, then one combine over all states,
      summed in the metric dtype under "bf16"), with frozen padding
      (``pinpad`` and ``nofreeze`` off) on the natural path.
    - ``layout_glue``: the reference's turbo layout path where it takes it
      (no early stop, or 0 < retry_m < C).  False takes its natural path:
      under a bf16 trellis the extrinsic subtracts twice, and neither
      ``combine_bf16``, ``blane_unroll`` nor ``planar_int8`` applies.
    - ``pallas_demap``: demap with the demap kernel (LLR * 1/eff, planar
      output).  False is the reference's XLA-order front: equalise,
      extract the PDSCH REs, ``demodulate_maxlog`` (LLR / eff),
      descramble, round to bf16 under a bf16 trellis, ``soft_dematch``;
      the demap kernel is not launched and ``demap_in`` and
      ``planar_int8`` do nothing (no planes).
    - ``blane_unroll``: the layout kernel's steps a loop body; under bf16
      it places the renormalisation (``blane_renorm_unroll``): every step
      at 1, every other at 2, every 4 at a multiple of 4 (the default
      16), in the full-batch iterations of the layout path.
    - ``ul_planar_boundary`` / ``mimo_planar_boundary``: whether
      ``planar_int8`` quantizes the UL / MMSE MIMO front's planes (the
      reference's planar stage boundary of that front).
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
    fused: bool = True
    layout_glue: bool = True
    pallas_demap: bool = True
    blane_unroll: int = 16
    ul_planar_boundary: bool = True
    mimo_planar_boundary: bool = True

    def __post_init__(self):
        if self.mdtype not in MDTYPES:
            raise ValueError(f"mdtype {self.mdtype!r}: one of {MDTYPES}")
        if self.demap_in not in ("f32", "bf16"):
            raise ValueError(f"demap_in {self.demap_in!r}: \"f32\" or "
                             "\"bf16\"")
        for f in ("pinpad", "nofreeze", "combine_bf16", "planar_int8",
                  "fused", "layout_glue", "pallas_demap",
                  "ul_planar_boundary", "mimo_planar_boundary"):
            if not isinstance(getattr(self, f), bool):
                raise ValueError(f"{f} is a bool")
        if self.win % 2 or not 0 < self.acq <= self.win:
            raise ValueError("need an even win and 0 < acq <= win (above "
                             "win/2 the unfused kernel runs)")
        if isinstance(self.blane_unroll, bool) or not isinstance(
                self.blane_unroll, int) or self.blane_unroll < 1:
            raise ValueError("blane_unroll is an int >= 1")
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
        :data:`SHIPPED`.  Every value resolves as the reference's decode
        resolves it (``turbo_mlm.py:1195-1220``, ``:1300``): ``fused``
        False or acq > win/2 is the unfused kernel with frozen padding
        (``pinpad``, ``nofreeze`` off); the layout path needs
        ``layout_glue`` and the fused kernel, and off it ``planar_int8``
        reads the planes unquantized; a front whose planar boundary is off
        is not quantized; a ``retry_m_dl`` / ``retry_m_mimo`` of None
        inherits ``retry_m``.  A value that changes nothing resolves to the
        reference's default: ``layout_glue`` under f32 or off the fused
        kernel, a ``blane_unroll`` that keeps the renormalisation steps
        (or acts nowhere), a planar boundary without ``planar_int8``.
        ``tb``, ``gb``, ``print_iters``, ``struct_dematch``,
        ``blane_flat`` and ``blane_flat_mimo`` change no value
        (``tests/torch_tuning_keys.py`` runs the reference both ways).
        Only an unknown key raises."""
        bad = sorted(set(d) - set(REFERENCE_DEFAULTS) - {"n_iter"})
        if bad:
            raise ValueError(f"unknown tuning keys: {bad}")
        r = {**REFERENCE_DEFAULTS, **d}
        out = {f.name: r[f.name] for f in fields(cls)
               if f.name in REFERENCE_DEFAULTS}
        fused = bool(r["fused"]) and r["acq"] <= r["win"] // 2
        bf16 = r["mdtype"] != "f32"
        layout = bool(r["layout_glue"]) and fused
        int8 = bool(r["planar_int8"]) and layout
        default = REFERENCE_DEFAULTS["blane_unroll"]
        moves = (bf16 and layout and _blane_renorms(r["win"], r[
            "blane_unroll"]) != _blane_renorms(r["win"], default))
        out.update(
            fused=fused,
            pinpad=bool(r["pinpad"]) and fused,
            nofreeze=bool(r["nofreeze"]) and fused,
            layout_glue=layout or not (bf16 and fused),
            blane_unroll=r["blane_unroll"] if moves else default,
            planar_int8=int8,
            ul_planar_boundary=bool(r["ul_planar_boundary"]) or not int8,
            mimo_planar_boundary=bool(r["mimo_planar_boundary"]) or not int8,
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


def blane_renorm_unroll(win: int, unroll: int) -> int:
    """The layout kernel's unroll at ``blane_unroll`` ``unroll``, as
    ``_make_kernel_blane`` resolves it: an unroll that does not divide
    win/2 falls back to 4, or 2 when 4 does not divide it either."""
    half = win // 2
    if unroll < 1 or half % unroll:
        unroll = 4 if half % 4 == 0 else 2
    return unroll


def _blane_renorms(win: int, unroll: int) -> tuple:
    """The steps of a half window after which the reference's layout kernel
    renormalises a bf16 trellis at ``blane_unroll`` ``unroll``
    (``_make_kernel_blane``'s ``_renorm_at``: after step t of a loop body
    of U = :func:`blane_renorm_unroll` steps where t mod U is U - 1 or
    3 mod 4)."""
    unroll = blane_renorm_unroll(win, unroll)
    return tuple(t for t in range(win // 2)
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
