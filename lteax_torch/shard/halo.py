"""Overlap-save halo exchange over the ``time`` mesh axis; counterpart of
``lteax.shard.halo``.

A filter or correlator over a time-sharded capture needs ``halo`` samples
from the next shard to give valid outputs for its own region: each rank
sends its first ``halo`` samples to its left ``time`` neighbour and appends
what its right neighbour sends (one ``batch_isend_irecv`` on the ``time``
subgroup, the reference's ``ppermute``).  The last shard appends zeros,
the capture's edge.  Gloo moves host tensors only, so under gloo the halo
crosses through host memory; a 20 MHz halo (a PSS replica's 2047 samples)
is 16 kB.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from lteax_torch.shard.mesh import TIME_AXIS, _staged, axis_size


def exchange_right_halo(x: torch.Tensor, halo: int, mesh) -> torch.Tensor:
    """x (..., L) per shard -> (..., L + halo) with the next ``time``
    shard's first ``halo`` samples appended; the last shard appends
    zeros.  With one ``time`` shard there is no exchange."""
    n = axis_size(mesh, TIME_AXIS)
    zeros = x.new_zeros((*x.shape[:-1], halo))
    if n == 1:
        return torch.cat([x, zeros], dim=-1)
    group = mesh.get_group(TIME_AXIS)
    ranks = dist.get_process_group_ranks(group)
    i = mesh.get_local_rank(TIME_AXIS)
    real = torch.view_as_real if x.is_complex() else (lambda t: t)
    head = _staged(real(x[..., :halo].contiguous()).contiguous(), group)
    recv = torch.empty_like(head)
    for w in dist.batch_isend_irecv([
            dist.P2POp(dist.isend, head, ranks[(i - 1) % n], group),
            dist.P2POp(dist.irecv, recv, ranks[(i + 1) % n], group)]):
        w.wait()
    recv = recv.to(x.device)
    recv = torch.view_as_complex(recv) if x.is_complex() else recv
    return torch.cat([x, zeros if i == n - 1 else recv], dim=-1)


def overlap_save_correlate(x: torch.Tensor, taps: torch.Tensor,
                           mesh) -> torch.Tensor:
    """Sharded 'valid-start' correlation y[n] = sum_k x[n+k] conj(taps[k])
    for every n of the local shard, the tail from the halo.

    x: (..., L) complex64 local samples; taps: (K,) complex64.  Returns
    (..., L) complex64: one complex64 FFT product over the shard and its
    halo, long enough that no output wraps: the reference's XLA
    convolution to f32 rounding, and far cheaper than a direct
    convolution at the 2048 taps of a 20 MHz PSS replica."""
    k = taps.shape[-1]
    if x.shape[-1] < k - 1:
        raise ValueError(f"a shard of {x.shape[-1]} samples is shorter than "
                         f"the halo of {k - 1}")
    ext = exchange_right_halo(x, k - 1, mesh)
    m = 1 << (ext.shape[-1] - 1).bit_length()
    y = torch.fft.ifft(torch.fft.fft(ext, m) * torch.conj(
        torch.fft.fft(taps.to(ext.device, torch.complex64), m)))
    return y[..., :x.shape[-1]].to(torch.complex64)
