"""The rank mesh over ``torch.distributed``; counterpart of
``lteax.shard.mesh``.

The reference lays its devices out as a 2-D ``(chan, time)`` mesh: channel
parallelism on ``chan`` (carriers, which cross hosts with no halo) and
subframe / time-block parallelism on ``time`` (halos ride it).  Here each
device is one process ("rank") of a process group, and :func:`make_mesh`
arranges the ranks the same way: rank ``r`` sits at
``(r // n_time, r % n_time)``, as ``devs.reshape(n_chan, n_time)`` puts
device ``r``.  Programs are SPMD: every rank runs the same code on its own
slice of a global array (:func:`local_slice`, the counterpart of the
reference's ``NamedSharding``), and replicas along ``chan`` hold the same
``time`` slice, as the reference's ``in_specs`` replicate over ``chan``.

:func:`spawn` starts ``n`` ranks on one host and returns what each rank's
function returned, with the rank's kernel launch counts; the in-process
:func:`process_group` is the one-rank group of the calling process.  The
backend is ``"nccl"`` when every rank has its own card and ``"gloo"`` when
the caller asks for the CPU.  NCCL refuses two ranks on one card: such a
run names ``backend="gloo"`` itself, and nothing here switches backend for
the caller.  A rank's device is ``cuda:{rank % device_count}``, or the
CPU when the caller passes ``device="cpu"``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import datetime
import queue as queue_mod
import shutil
import tempfile
import time
import traceback
from pathlib import Path

import torch
import torch.distributed as dist

from lteax_torch.kernels import launch_counts

CHAN_AXIS = "chan"
TIME_AXIS = "time"

RANK_TIMEOUT_S = 1800.0
"""How long a collective waits for its peers, and :func:`spawn` for its
ranks, before either gives up."""


def device_type(device) -> str:
    """``None`` or ``"cuda"`` -> ``"cuda"``, which needs a CUDA device;
    ``"cpu"`` -> ``"cpu"``."""
    kind = "cuda" if device is None else torch.device(device).type
    if kind == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the ranks run on the card unless "
                           "the caller passes device=\"cpu\"")
    if kind not in ("cuda", "cpu"):
        raise ValueError(f"device {device!r}: \"cuda\" or \"cpu\"")
    return kind


def resolve_backend(kind: str, n_ranks: int, backend: str | None) -> str:
    """The process group's backend for ``n_ranks`` ranks on ``kind``:
    ``"nccl"`` on cards, ``"gloo"`` on the CPU, unless the caller names
    one.  NCCL needs a card a rank and raises otherwise."""
    backend = backend or ("nccl" if kind == "cuda" else "gloo")
    if backend == "nccl":
        n_cards = torch.cuda.device_count()
        if kind != "cuda" or n_ranks > n_cards:
            raise ValueError(
                f"backend=\"nccl\" needs one card a rank: {n_ranks} ranks, "
                f"{n_cards if kind == 'cuda' else 0} cards; ranks that share "
                f"a card (or the CPU) need backend=\"gloo\"")
    elif backend != "gloo":
        raise ValueError(f"backend {backend!r}: \"nccl\" or \"gloo\"")
    return backend


def _init_rank(rank: int, n_ranks: int, store_path: str, kind: str,
               backend: str) -> None:
    if kind == "cuda":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group(
        backend, store=dist.FileStore(store_path, n_ranks), rank=rank,
        world_size=n_ranks,
        timeout=datetime.timedelta(seconds=RANK_TIMEOUT_S))


@contextlib.contextmanager
def process_group(device=None, backend: str | None = None):
    """A process group of one rank, this process, for the duration of the
    ``with`` block: a 1x1 mesh runs every sharded path in-process."""
    kind = device_type(device)
    backend = resolve_backend(kind, 1, backend)
    tmp = tempfile.mkdtemp(prefix="lteax_pg_")
    try:
        _init_rank(0, 1, str(Path(tmp) / "store"), kind, backend)
        try:
            yield
        finally:
            dist.destroy_process_group()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def make_mesh(n_chan: int = 1, n_time: int | None = None, device=None,
              backend: str | None = None):
    """2-D ``(chan, time)`` mesh of the process group's ranks, in row-major
    order.  Defaults: all ranks on ``time``.  Every rank calls it (it makes
    the axes' subgroups).  ``device`` is the ranks' device type (default
    the card; ``"cpu"`` when asked); ``backend``, when given, must be the
    group's."""
    from torch.distributed.device_mesh import init_device_mesh
    kind = device_type(device)
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group: run inside "
                           "spawn() or process_group()")
    if backend is not None and dist.get_backend() != backend:
        raise ValueError(f"the process group runs {dist.get_backend()!r}, "
                         f"not {backend!r}")
    n = dist.get_world_size()
    if n_time is None:
        n_time = n // n_chan
    if n_chan * n_time != n:
        raise ValueError(f"{n_chan}x{n_time} mesh != {n} devices")
    return init_device_mesh(kind, (n_chan, n_time),
                            mesh_dim_names=(CHAN_AXIS, TIME_AXIS))


def mesh_device(mesh) -> torch.device:
    """This rank's device on ``mesh``."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def axis_size(mesh, mesh_axis: str) -> int:
    """The number of ranks along ``mesh_axis``."""
    return mesh.size(mesh.mesh_dim_names.index(mesh_axis))


def local_slice(x, mesh, axis: int, mesh_axis: str):
    """This rank's slice of the global array ``x`` (numpy or torch) with
    axis ``axis`` split over mesh axis ``mesh_axis``; ranks that differ
    only on the other mesh axis get the same slice."""
    n, i = axis_size(mesh, mesh_axis), mesh.get_local_rank(mesh_axis)
    if x.shape[axis] % n:
        raise ValueError(f"axis {axis} of length {x.shape[axis]} does not "
                         f"split over {n} {mesh_axis} shards")
    m = x.shape[axis] // n
    return x[(slice(None),) * axis + (slice(i * m, (i + 1) * m),)]


def _staged(t: torch.Tensor, group) -> torch.Tensor:
    """Gloo moves host tensors only: a CUDA tensor crosses through host
    memory."""
    return t.cpu() if t.is_cuda and dist.get_backend(group) == "gloo" else t


def all_reduce(t: torch.Tensor, op, mesh,
               mesh_axis: str | None = None) -> torch.Tensor:
    """``t`` reduced with ``op`` (``dist.ReduceOp``) over ``mesh_axis``, or
    over the whole mesh (the process group) without one; the result on
    ``t``'s device."""
    group = mesh.get_group(mesh_axis) if mesh_axis else dist.group.WORLD
    work = _staged(t.reshape(-1).clone(), group)
    dist.all_reduce(work, op, group=group)
    return work.reshape(t.shape).to(t.device)


def all_gather(t: torch.Tensor, mesh, mesh_axis: str) -> torch.Tensor:
    """(n, *t.shape): ``t`` of each rank along ``mesh_axis``, in its mesh
    order; on ``t``'s device."""
    group = mesh.get_group(mesh_axis)
    work = _staged(t.contiguous(), group)
    out = [torch.empty_like(work) for _ in range(axis_size(mesh, mesh_axis))]
    dist.all_gather(out, work, group=group)
    return torch.stack(out).to(t.device)


@dataclasses.dataclass
class RankResult:
    """What one rank of :func:`spawn` returned, and its kernel launch
    counts (``lteax_torch.kernels.launch_counts``) when it ended."""
    rank: int
    value: object
    launches: dict


def _rank_main(rank: int, n_ranks: int, store_path: str, kind: str,
               backend: str, fn, args: tuple, out) -> None:
    try:
        if kind == "cpu":
            torch.set_num_threads(1)        # a rank is one device
        _init_rank(rank, n_ranks, store_path, kind, backend)
        try:
            value = fn(*args)
        finally:
            dist.destroy_process_group()
        out.put((rank, True, value, launch_counts()))
    except BaseException:
        out.put((rank, False, traceback.format_exc(), launch_counts()))
        raise


def spawn(fn, n_ranks: int, device=None, backend: str | None = None,
          *args) -> list[RankResult]:
    """Run ``fn(*args)`` in ``n_ranks`` new processes (the spawn start
    method: CUDA may be initialised here already) that form one process
    group, rendezvoused through a ``FileStore`` in a temporary directory.
    ``fn`` must be importable by name and return something picklable
    (numpy or python values).  Returns each rank's result in rank order;
    a rank that raises or dies makes this raise with its traceback and
    ends the others.  The kernel library is built here first, so the
    ranks load it instead of each running nvcc."""
    kind = device_type(device)
    backend = resolve_backend(kind, n_ranks, backend)
    if kind == "cuda":
        from lteax_torch.kernels._build import library
        library()
    ctx = torch.multiprocessing.get_context("spawn")
    out = ctx.Queue()
    tmp = tempfile.mkdtemp(prefix="lteax_spawn_")
    procs = [ctx.Process(target=_rank_main,
                         args=(r, n_ranks, str(Path(tmp) / "store"), kind,
                               backend, fn, args, out), daemon=True)
             for r in range(n_ranks)]
    try:
        for p in procs:
            p.start()
        got: dict[int, RankResult] = {}
        deadline = time.monotonic() + RANK_TIMEOUT_S
        while len(got) < n_ranks:
            try:
                rank, ok, value, launches = out.get(timeout=1.0)
            except queue_mod.Empty:
                dead = [r for r, p in enumerate(procs)
                        if p.exitcode not in (None, 0) and r not in got]
                if dead or time.monotonic() > deadline:
                    raise RuntimeError(
                        f"ranks {dead} died (exit codes "
                        f"{[procs[r].exitcode for r in dead]})" if dead else
                        f"ranks timed out after {RANK_TIMEOUT_S} s")
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} of {n_ranks} failed:\n"
                                   f"{value}")
            got[rank] = RankResult(rank, value, launches)
        for p in procs:
            p.join()
        return [got[r] for r in range(n_ranks)]
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join()
        shutil.rmtree(tmp, ignore_errors=True)
