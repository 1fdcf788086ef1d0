"""ctypes binding of the native C++ IQ reader and TCP ingest
(``lteax_torch/native/iq_reader.cc``, ``iq_tcp.cc``); counterpart of
``lteax.io.native``.

The library is built at first use by ``g++`` into ``build/lteax_torch/`` at
the repository root, named by a hash of the sources, the compiler and its
flags, so an edited source rebuilds and an unchanged one loads at once.  A
failed build raises with the compiler's output: there is no numpy
fallback.  ``CXX`` names another compiler.

Formats: fc32 (float32 pairs), sc8 (int8 pairs, / 128), sc16 (int16
pairs, / 32768); every reader returns float32 I/Q pairs.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from functools import lru_cache
from pathlib import Path

import numpy as np

SRC_DIR = Path(__file__).resolve().parents[1] / "native"
SOURCES = ("iq_reader.cc", "iq_tcp.cc")
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "lteax_torch"
# ``iq_tcp.cc`` calls malloc / free without including <cstdlib>; some
# libstdc++ versions do not bring it in through <thread>, so it is forced
# in here (the sources stay byte-for-byte the reference's)
CXX_FLAGS = ["-O3", "-std=c++17", "-fPIC", "-Wall", "-shared", "-include",
             "cstdlib"]
_FMT = {"fc32": 0, "sc8": 1, "sc16": 2}
_ITEMSIZE = {"fc32": 8, "sc8": 2, "sc16": 4}

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
# C entry point -> (result type, argument types)
SIGNATURES = {
    "iq_read": (_L, [ctypes.c_char_p, _I, _L, _L, _P]),
    "iq_stream_open": (_P, [ctypes.c_char_p, _I, _L]),
    "iq_stream_next": (_L, [_P, _P]),
    "iq_stream_close": (None, [_P]),
    "iq_tcp_open": (_P, [ctypes.c_uint16, _I, _L]),
    "iq_tcp_port": (_I, [_P]),
    "iq_tcp_connected": (_I, [_P]),
    "iq_tcp_dropped": (_L, [_P]),
    "iq_tcp_read": (_L, [_P, _P, _L, _I]),
    "iq_tcp_close": (None, [_P]),
}


@lru_cache(maxsize=None)
def _library(cxx: str) -> ctypes.CDLL:
    h = hashlib.sha256(" ".join([cxx, *CXX_FLAGS]).encode())
    for name in SOURCES:
        h.update(name.encode())
        h.update((SRC_DIR / name).read_bytes())
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = BUILD_DIR / f"libiqreader_{h.hexdigest()[:16]}.so"
    if not out.exists():
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        try:
            res = subprocess.run(
                [cxx, *CXX_FLAGS, "-o", str(tmp),
                 *(str(SRC_DIR / s) for s in SOURCES), "-lpthread"],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                timeout=300)
        except OSError as e:
            raise RuntimeError(f"native IQ reader: cannot run {cxx}: {e}"
                               ) from e
        if res.returncode:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"native IQ reader: {cxx} failed "
                               f"(exit {res.returncode}):\n{res.stdout}")
        os.replace(tmp, out)
    lib = ctypes.CDLL(str(out))
    for name, (restype, argtypes) in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = restype, argtypes
    return lib


def _load() -> ctypes.CDLL:
    """The built library; raises when the build fails."""
    return _library(os.environ.get("CXX", "g++"))


def available() -> bool:
    """Whether the library builds and loads (kept for the reference's
    API; the readers below raise rather than fall back)."""
    try:
        _load()
    except (RuntimeError, OSError):
        return False
    return True


def read_iq_native(path: str, fmt: str = "fc32", count: int = -1,
                   offset_samples: int = 0) -> np.ndarray:
    """-> (n, 2) float32 IQ pairs of ``count`` samples (-1: to the end)
    from ``offset_samples``."""
    lib = _load()
    if count < 0:
        count = max(0, (os.path.getsize(path)
                        - offset_samples * _ITEMSIZE[fmt]) // _ITEMSIZE[fmt])
    out = np.empty((count, 2), dtype=np.float32)
    n = lib.iq_read(path.encode(), _FMT[fmt], offset_samples, count,
                    out.ctypes.data_as(ctypes.c_void_p))
    if n < 0:
        raise IOError(f"iq_read failed for {path}")
    return out[:n]


class IqStream:
    """Background-prefetch chunked reader: a C++ thread reads and converts
    the next chunk while the caller works on this one."""

    def __init__(self, path: str, fmt: str = "fc32",
                 chunk_samples: int = 1 << 20):
        self._h = None
        self._lib = _load()
        self._chunk = chunk_samples
        self._h = self._lib.iq_stream_open(path.encode(), _FMT[fmt],
                                           chunk_samples)
        if not self._h:
            raise IOError(f"cannot open {path}")

    def __iter__(self):
        return self

    def __next__(self) -> np.ndarray:
        if not self._h:
            raise StopIteration
        out = np.empty((self._chunk, 2), dtype=np.float32)
        n = self._lib.iq_stream_next(self._h, out.ctypes.data_as(
            ctypes.c_void_p))
        if n == 0:
            raise StopIteration
        return out[:n]

    def close(self):
        if self._h:
            self._lib.iq_stream_close(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        self.close()


class IqTcpSource:
    """Native TCP IQ ingest: a C++ receive thread converts sc8/sc16/fc32
    to float32 I/Q into a ring buffer outside the GIL; what does not fit
    the ring is dropped and counted (the reference's radio overruns).
    One client at a time, on 127.0.0.1:``port`` (0: an ephemeral port).
    ``close`` (or leaving the ``with`` block) stops the thread."""

    def __init__(self, port: int = 0, fmt: str = "fc32",
                 ring_samples: int = 1 << 22):
        self._h = None
        self._lib = _load()
        self._h = self._lib.iq_tcp_open(port, _FMT[fmt], ring_samples)
        if not self._h:
            raise OSError(f"cannot bind IQ server on port {port}")
        self._port = int(self._lib.iq_tcp_port(self._h))
        self._dropped = 0

    @property
    def port(self) -> int:
        return self._port

    @property
    def connected(self) -> bool:
        return bool(self._h) and bool(self._lib.iq_tcp_connected(self._h))

    @property
    def dropped(self) -> int:
        if self._h:
            self._dropped = int(self._lib.iq_tcp_dropped(self._h))
        return self._dropped

    def read(self, max_samples: int, timeout_ms: int = 1000) -> np.ndarray:
        """Up to max_samples complex64 samples (possibly empty)."""
        if not self._h:
            return np.zeros(0, dtype=np.complex64)
        out = np.empty(2 * max_samples, dtype=np.float32)
        n = self._lib.iq_tcp_read(
            self._h, out.ctypes.data_as(ctypes.c_void_p), max_samples,
            timeout_ms)
        return out[:2 * n].view(np.complex64)

    def close(self):
        if self._h:
            self._dropped = int(self._lib.iq_tcp_dropped(self._h))
            self._lib.iq_tcp_close(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        self.close()
