"""Build and load the port's CUDA kernels.

All ``csrc/*.cu`` sources compile, with plain C entry points, into ONE
shared library by ``nvcc -gencode arch=compute_90a,code=sm_90a``, loaded
with ctypes: one ``nvcc -c`` per source, all started together, then one
link.  The library lands in ``build/lteax_torch/`` at the repository
root, named by a hash of the sources and flags, so an edited source
rebuilds and an unchanged one loads at once.

``-fmad=false``: the kernels on the CUDA cores are adds, multiplies, maxes
and mins in f32 (the ACS probe and the turbo kernel's bf16 trellis also
in packed bf16), and with no contraction into fused multiply-adds each one
equals its plain torch version bit for bit.  The one tensor-core kernel,
the PSS correlator and detect in both arithmetics (bf16, and f32 as three
bf16 planes), sums in the hardware's order and is held to its plain
version by a tolerance.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from functools import lru_cache
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "lteax_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
# C entry point -> argument types (pointers and the stream as void*)
SIGNATURES = {
    "lteax_demap": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P, _I, _I, _P],
    "lteax_turbo_half": [_P, _P, _P, _P, _P, _P, _P, *[_I] * 12, _P],
    "lteax_turbo_half_bf16_variant": [_P, _P, _P, _P, _P, _P, _P,
                                      _I, _I, _I, _I, _I, _I, _I, _I, _P],
    "lteax_turbo_glue": [_P, _L, _P, _L, _P, _L, _P, _L, _P, _P, _F,
                         _I, _I, _I, *[_P] * 8],
    "lteax_pss_corr": [_P, _P, _P, _I, _I, _I, _P],
    "lteax_pss_detect": [_P, _P, _P, _P, _P, _I, _I, _I, _P],
    "lteax_pss_corr_bf16": [_P, _P, _P, _I, _I, _I, _P],
    "lteax_pss_detect_bf16": [_P, _P, _P, _P, _P, _I, _I, _I, _P],
    "lteax_resample": [_P, _P, _P, *[_I] * 13, _P],
    "lteax_acs_chain_f32": [_P, _P, _L, _I, _P],
    "lteax_acs_chain_bf16": [_P, _P, _L, _I, _P],
}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    cands = [str(Path(home) / "bin" / "nvcc")] if home else []
    cands += [shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for c in cands:
        if c and Path(c).exists():
            return c
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (set CUDA_HOME)")


class KernelLibrary:
    """The loaded shared library plus what its build reported."""

    def __init__(self, path: Path, build_s: float, ptxas_log: str):
        self.path = path
        self.build_s = build_s          # 0.0 when loaded from a prior build
        self.ptxas_log = ptxas_log
        self.lib = ctypes.CDLL(str(path))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(self.lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int

    def call(self, name: str, *args) -> None:
        """Launch on PyTorch's current stream; raise on a launch error."""
        err = getattr(self.lib, name)(*args)
        if err != 0:
            raise RuntimeError(f"{name}: CUDA error {err}")


@lru_cache(maxsize=None)
def library() -> KernelLibrary:
    """Build (if needed) and load the kernel library."""
    sources = sorted(CSRC.glob("*.cu"))
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in sources:
        h.update(s.name.encode())
        h.update(s.read_bytes())
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = BUILD_DIR / f"liblteax_kernels_{h.hexdigest()[:16]}.so"
    log_path = out.with_suffix(".log")
    if out.exists():
        return KernelLibrary(out, 0.0, log_path.read_text()
                             if log_path.exists() else "")
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    nvcc = _nvcc()
    objs = [out.with_suffix(f".{s.stem}.{os.getpid()}.o") for s in sources]
    procs, t0 = [], time.perf_counter()
    try:
        for s, o in zip(sources, objs):
            procs.append(subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(s)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        logs = [p.communicate()[0] for p in procs]
        if any(p.returncode for p in procs):
            raise RuntimeError("nvcc failed:\n" + "".join(logs))
        link = subprocess.run([nvcc, "-shared", "-o", str(tmp),
                               *map(str, objs)], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
        logs.append(link.stdout)
        if link.returncode:
            raise RuntimeError("nvcc link failed:\n" + link.stdout)
    finally:
        for p in procs:             # an interrupted build stops every nvcc
            if p.poll() is None:
                p.kill()
                p.wait()
        for o in objs:
            o.unlink(missing_ok=True)
    build_s = time.perf_counter() - t0
    log = "".join(logs)
    log_path.write_text(log)
    os.replace(tmp, out)
    return KernelLibrary(out, build_s, log)


def stream_handle(t: torch.Tensor) -> int:
    """PyTorch's current stream on the tensor's device, as an int."""
    return torch.cuda.current_stream(t.device).cuda_stream


def check_cuda(name: str, *tensors: torch.Tensor,
               dtype: torch.dtype = torch.float32) -> None:
    """Raise unless every tensor is a contiguous CUDA tensor of ``dtype``."""
    for t in tensors:
        if not (t.is_cuda and t.dtype == dtype and t.is_contiguous()):
            raise ValueError(f"{name}: needs contiguous {dtype} CUDA "
                             f"tensors, got {t.dtype} on {t.device}")
