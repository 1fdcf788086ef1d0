"""ACS op-mix chain: R rounds of ``a = max(a + b, b); b = max(b + a, a)``
from ``b0 = a0 * 1.0009765625``, elementwise, output ``a``.

Port of the TPU probe kernel ``bench/vpu_bf16_probe.py::_kernel`` to the CUDA
kernels of ``csrc/acs_probe.cu`` (f32: one element per thread; bf16: one
packed pair per thread).  It is the add/max mix of the turbo decoder's
add-compare-select step, timed in f32 and in bf16 by
``lteax_torch.bench.acs_probe`` to see what a 16-bit trellis could gain on
the card.  :func:`acs_chain_plain` is the same chain in plain torch, each
add rounded to the tensor's dtype; :func:`acs_chain` runs it for CPU tensors
and launches the kernel for CUDA tensors.
"""

from __future__ import annotations

import torch

LAUNCHES = 0
"""Kernel launches since the last reset (plain-version calls do not count)."""

SCALE = 1.0009765625        # 1 + 2^-10: exact in f32, rounds to 1 in bf16


def acs_chain_plain(x: torch.Tensor, rounds: int) -> torch.Tensor:
    """Plain torch version, any float dtype and device."""
    a = x
    # the scale is rounded to the tensor's dtype first, as the reference's
    # array-times-scalar is
    b = a * torch.tensor(SCALE, dtype=x.dtype, device=x.device)
    for _ in range(rounds):
        a = torch.maximum(a + b, b)
        b = torch.maximum(b + a, a)
    return a


def acs_chain(x: torch.Tensor, rounds: int) -> torch.Tensor:
    """The chain over every element of ``x`` (f32 or bf16).

    CPU tensors take the plain version; CUDA tensors launch the kernel."""
    global LAUNCHES
    if rounds < 0:
        raise ValueError(f"rounds {rounds} < 0")
    if not x.is_cuda:
        return acs_chain_plain(x, rounds)
    from lteax_torch.kernels._build import library, stream_handle
    if x.dtype not in (torch.float32, torch.bfloat16) or \
            not x.is_contiguous():
        raise ValueError(f"acs_chain: needs a contiguous float32 or bfloat16 "
                         f"CUDA tensor, got {x.dtype}")
    n = x.numel()
    if x.dtype == torch.bfloat16 and n % 2:
        raise ValueError("acs_chain: the packed bf16 kernel needs an even "
                         "number of elements")
    out = torch.empty_like(x)
    if n == 0:
        return out
    if x.dtype == torch.float32:
        library().call("lteax_acs_chain_f32", x.data_ptr(), out.data_ptr(),
                       n, rounds, stream_handle(x))
    else:
        library().call("lteax_acs_chain_bf16", x.data_ptr(), out.data_ptr(),
                       n // 2, rounds, stream_handle(x))
    LAUNCHES += 1
    return out
