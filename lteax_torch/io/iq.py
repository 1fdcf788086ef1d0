"""IQ file readers/writers.

(reference capability: the GNU Radio ``file_source``/``file_sink`` blocks and
the int8->complex conversion path of ``LTE_fdd_dl_file_scan``.)

Formats:
  fc32 — interleaved float32 I/Q (GNU Radio gr_complex)
  sc8  — interleaved int8 I/Q (rtl-sdr style, scaled by 1/128)

The port's own copy of the numpy part of ``lteax/io/iq.py`` (the port imports
nothing of the JAX package); ``tests/test_torch_plans.py`` holds the two equal.
"""

from __future__ import annotations

import numpy as np


def to_iq_f32(x: np.ndarray) -> np.ndarray:
    """complex (...,) -> float32 (..., 2): the layout every decoder entry
    point takes (IQ float pairs, complex formed on the device)."""
    x = np.asarray(x)
    return np.stack([x.real, x.imag], axis=-1).astype(np.float32)


def from_iq_f32(x: np.ndarray) -> np.ndarray:
    """float32 (..., 2) -> complex64 (...,)."""
    x = np.asarray(x)
    return (x[..., 0] + 1j * x[..., 1]).astype(np.complex64)


def write_iq(path: str, samples: np.ndarray, fmt: str = "fc32") -> None:
    x = np.asarray(samples).astype(np.complex64)
    inter = np.empty(2 * len(x), dtype=np.float32)
    inter[0::2] = x.real
    inter[1::2] = x.imag
    if fmt == "fc32":
        inter.tofile(path)
    elif fmt == "sc8":
        np.clip(np.round(inter * 127.0), -128, 127).astype(np.int8).tofile(path)
    else:
        raise ValueError(f"unknown IQ format {fmt}")


def read_iq(path: str, fmt: str = "fc32", count: int = -1,
            offset_samples: int = 0) -> np.ndarray:
    itemsize = 8 if fmt == "fc32" else 2
    if fmt == "fc32":
        raw = np.fromfile(path, dtype=np.float32, count=-1 if count < 0 else 2 * count,
                          offset=offset_samples * itemsize)
    elif fmt == "sc8":
        raw = np.fromfile(path, dtype=np.int8, count=-1 if count < 0 else 2 * count,
                          offset=offset_samples * itemsize).astype(np.float32) / 128.0
    else:
        raise ValueError(f"unknown IQ format {fmt}")
    raw = raw[: (len(raw) // 2) * 2]
    return (raw[0::2] + 1j * raw[1::2]).astype(np.complex64)
