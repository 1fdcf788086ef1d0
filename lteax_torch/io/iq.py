"""IQ file readers/writers.

(reference capability: the GNU Radio ``file_source``/``file_sink`` blocks and
the int8->complex conversion path of ``LTE_fdd_dl_file_scan``.)

Formats:
  fc32 — interleaved float32 I/Q (GNU Radio gr_complex)
  sc8  — interleaved int8 I/Q (rtl-sdr style, scaled by 1/128)

The port's own copy of ``lteax/io/iq.py`` (the port imports nothing of the
JAX package); ``tests/test_torch_plans.py`` holds the two equal.  The
device-boundary stagings are f32, bf16 and int8 pairs (every decoder front
upcasts the pair dtype on the device); ``prefetch_to_device`` is the
double-buffered feed on a side CUDA stream.
"""

from __future__ import annotations

import collections
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch


def to_iq_f32(x: np.ndarray) -> np.ndarray:
    """complex (...,) -> float32 (..., 2): the layout every decoder entry
    point takes (IQ float pairs, complex formed on the device)."""
    x = np.asarray(x)
    return np.stack([x.real, x.imag], axis=-1).astype(np.float32)


def to_iq_bf16(x: np.ndarray) -> torch.Tensor:
    """complex (...,) -> torch.bfloat16 (..., 2): halves the device-boundary
    transfer and the front's input read.  The float32 parts round to the
    nearest bf16, ties to even (as ``ml_dtypes`` rounds)."""
    return torch.from_numpy(to_iq_f32(x)).to(torch.bfloat16)


def to_iq_sc8(x: np.ndarray, scale: float = 127.0) -> np.ndarray:
    """complex (...,) -> int8 (..., 2) rtl-sdr-style pairs (quarter-width
    device boundary; the decode chain is scale-invariant)."""
    x = np.asarray(x)
    inter = np.stack([x.real, x.imag], axis=-1) * scale
    return np.clip(np.round(inter), -128, 127).astype(np.int8)


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


def chunk_subframes(x: np.ndarray, n_samps_subframe: int,
                    start: int = 0) -> np.ndarray:
    """Trim+reshape a capture into whole subframes from ``start``:
    (n_subframes, n_samps_subframe)."""
    x = x[start:]
    n = len(x) // n_samps_subframe
    return x[: n * n_samps_subframe].reshape(n, n_samps_subframe)


def prefetch_to_device(batches, depth: int = 2, device=None):
    """Double-buffered device feed: yields device tensors while the next
    ``depth`` host batches are already in flight.

    ``batches``: numpy arrays or CPU tensors (IQ pairs in any staging).
    On the card a worker thread copies each batch into pinned host memory
    and starts its non-blocking copy on a side stream; the consumer's
    stream waits on that copy's event, and ``record_stream`` keeps the
    caching allocator from handing the buffer out while the consumer's
    work on it is in flight.  ``device`` defaults to the current CUDA
    device (without one this raises unless ``device="cpu"``); on the CPU
    the batches come back as tensors, unchanged."""
    from lteax_torch.pipeline import _resolve_device
    dev = _resolve_device(device)
    it = (torch.as_tensor(b) for b in batches)
    if dev.type != "cuda":
        yield from it
        return
    side = torch.cuda.Stream(dev)

    def put(host: torch.Tensor):
        pinned = host if host.is_pinned() else host.pin_memory()
        with torch.cuda.stream(side):
            out = pinned.to(dev, non_blocking=True)
            done = torch.cuda.Event()
            done.record(side)
        return out, done, pinned

    q = collections.deque()
    with ThreadPoolExecutor(1) as pool:
        for b in it:
            q.append(pool.submit(put, b))
            if len(q) > depth:
                yield _take(q.popleft().result(), dev)
        while q:
            yield _take(q.popleft().result(), dev)


def _take(put_out, dev: torch.device) -> torch.Tensor:
    out, done, _pinned = put_out
    cur = torch.cuda.current_stream(dev)
    cur.wait_event(done)
    out.record_stream(cur)
    return out
