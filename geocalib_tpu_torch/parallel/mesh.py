"""Data parallelism over torch.distributed: one process per device, as DDP runs.

Port of geocalib_tpu/parallel/mesh.py. The JAX package declares a 1-D mesh
over the data axis and lets XLA emit the collectives inside shard_map; here
each process drives one device, rank r of W is the mesh's data-axis index r,
and the collectives are written out over the process group:

- ``mean_over_ranks``: ``lax.pmean`` (an all-reduce SUM, then ÷ W) with its
  transpose as backward (the cotangent ÷ W, then an all-reduce SUM). So a
  gradient through a mean over ranks is the gradient of the sum of the ranks'
  losses, as JAX differentiates pmean inside shard_map; with the step's mean
  of the parameter gradients this is DDP with synced BatchNorm;
- ``sum_over_ranks``: ``lax.psum``, its backward the same sum of the cotangent;
- ``min_over_ranks``: ``lax.pmin`` (no gradient), the step's NaN vote;
- ``replicated``: the state broadcast from rank 0, where JAX places a
  replicated sharding;
- ``barrier``: a one-element all-reduce that every rank waits for.

Only ``all_reduce`` (SUM, MIN) and ``broadcast`` are used: the collectives gloo
offers on CUDA tensors as on CPU tensors, besides NCCL. Each collective with
mesh None returns its input unchanged, so code without a group runs as on one
process; with a one-rank group a mean divides by 1 and an all-reduce copies,
so the results are bit for bit those of no group.

Layout: with one device a process, rank r holds the rows that JAX process r
holds when JAX runs one device a process (the loader's
``epoch(shard=r, num_shards=W)``). JAX's single-process layout over W devices
differs: device d takes the d-th contiguous slice of one loader batch. A
step-level comparison of the two packages therefore feeds each rank the rows
of its JAX device explicitly.

Launch one process per device with torchrun, whose environment
(``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``)
``maybe_initialize_distributed`` reads; importing this module starts nothing.
"""

import dataclasses
import datetime
import os
from typing import Any, Dict, Iterable, Optional, Union

import torch
import torch.distributed as dist

Tensor = torch.Tensor
DATA_AXIS = "data"
DEFAULT_TIMEOUT_S = 600.0
TORCHRUN_ENV = ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR")


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """This process's place in the 1-D data-parallel default group: its rank, the
    world size and the device the rank drives."""

    rank: int
    size: int
    device: torch.device


def maybe_initialize_distributed(device: Optional[Union[str, torch.device]] = None,
                                 backend: Optional[str] = None,
                                 timeout_s: float = DEFAULT_TIMEOUT_S) -> bool:
    """Initialise the default process group when torchrun's environment names one
    (``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK`` and ``MASTER_ADDR`` all set); True when
    a group is initialised after the call. The backend is `backend`, else ``nccl``
    for a card and ``gloo`` for the CPU (`device`, default ``cuda``). A group that
    fails to initialise raises; every collective waits at most `timeout_s`."""
    if dist.is_initialized():
        return True
    if not all(os.environ.get(k) for k in TORCHRUN_ENV):
        return False
    if backend is None:
        backend = "gloo" if torch.device(device or "cuda").type == "cpu" else "nccl"
    dist.init_process_group(backend, init_method="env://",
                            timeout=datetime.timedelta(seconds=timeout_s))
    return True


def process_index() -> int:
    """This process's rank in the default group; 0 without one."""
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    """The default group's world size; 1 without one."""
    return dist.get_world_size() if dist.is_initialized() else 1


def make_mesh(device: Optional[Union[str, torch.device]] = None) -> Optional[Mesh]:
    """The mesh of the default group, or None where no group is initialised.

    The device is `device` where it names one (``cuda:1``, ``cpu``), else
    ``cuda:LOCAL_RANK``; a ``LOCAL_RANK`` that is not a present card raises, and so
    does a card asked for where there is none. A card becomes the current device."""
    if not dist.is_initialized():
        return None
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("the mesh asks for a CUDA card and none is available; "
                               "pass device='cpu' to run on the CPU")
        if dev.index is None:
            local = int(os.environ.get("LOCAL_RANK", "0"))
            if local >= torch.cuda.device_count():
                raise RuntimeError(f"LOCAL_RANK {local} is not a present card "
                                   f"({torch.cuda.device_count()} visible)")
            dev = torch.device("cuda", local)
        torch.cuda.set_device(dev)
    return Mesh(dist.get_rank(), dist.get_world_size(), dev)


def axis_index(mesh: Optional[Mesh]) -> int:
    """``lax.axis_index`` of the data axis: the rank, 0 without a mesh."""
    return 0 if mesh is None else mesh.rank


def axis_size(mesh: Optional[Mesh]) -> int:
    """The number of ranks, 1 without a mesh."""
    return 1 if mesh is None else mesh.size


def _all_reduce(x: Tensor, mesh: Mesh, op=dist.ReduceOp.SUM) -> Tensor:
    """A contiguous copy of x reduced in place over the default group."""
    y = x.detach().clone(memory_format=torch.contiguous_format)
    dist.all_reduce(y, op=op)
    return y


class _SumOverRanks(torch.autograd.Function):
    """psum: forward all-reduce SUM, backward all-reduce SUM of the cotangent."""

    @staticmethod
    def forward(ctx, x: Tensor, mesh: Mesh) -> Tensor:
        ctx.mesh = mesh
        return _all_reduce(x, mesh)

    @staticmethod
    def backward(ctx, g: Tensor):
        return _all_reduce(g, ctx.mesh), None


class _MeanOverRanks(torch.autograd.Function):
    """pmean: forward all-reduce SUM ÷ W; backward (cotangent ÷ W), all-reduce SUM."""

    @staticmethod
    def forward(ctx, x: Tensor, mesh: Mesh) -> Tensor:
        ctx.mesh = mesh
        return _all_reduce(x, mesh) / mesh.size

    @staticmethod
    def backward(ctx, g: Tensor):
        return _all_reduce(g / ctx.mesh.size, ctx.mesh), None


def sum_over_ranks(x: Tensor, mesh: Optional[Mesh]) -> Tensor:
    """x summed over the ranks (``lax.psum``); x itself without a mesh."""
    return x if mesh is None else _SumOverRanks.apply(x, mesh)


def mean_over_ranks(x: Tensor, mesh: Optional[Mesh]) -> Tensor:
    """The mean of x over the ranks (``lax.pmean``); x itself without a mesh."""
    return x if mesh is None else _MeanOverRanks.apply(x, mesh)


def min_over_ranks(x: Tensor, mesh: Optional[Mesh]) -> Tensor:
    """The elementwise minimum over the ranks (``lax.pmin``, no gradient); x without
    a mesh."""
    return x if mesh is None else _all_reduce(x, mesh, dist.ReduceOp.MIN)


def barrier(mesh: Optional[Mesh]) -> None:
    """Return when every rank has reached this call (an all-reduce of one element,
    waited for on the host)."""
    if mesh is not None:
        float(_all_reduce(torch.zeros(1, device=mesh.device), mesh))


def replicated(tensors: Iterable[Tensor], mesh: Optional[Mesh]) -> None:
    """Overwrite each tensor, in place, with rank 0's: one broadcast per dtype, of
    the tensors of that dtype concatenated. Nothing happens without a mesh."""
    if mesh is None:
        return
    by_dtype: Dict[torch.dtype, list] = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for ts in by_dtype.values():
        flat = torch.cat([t.detach().reshape(-1).to(mesh.device) for t in ts])
        dist.broadcast(flat, src=0)
        with torch.no_grad():
            for t, part in zip(ts, flat.split([t.numel() for t in ts])):
                t.copy_(part.view(t.shape))


def shard_batch(batch: Dict[str, Any], device: Union[str, torch.device]) -> Dict[str, Any]:
    """This rank's rows of a batch on its device (the mesh's): the loader already deals
    each rank its own rows (``epoch(shard=rank, num_shards=W)``), so only the copy
    is left. Entries that are not tensors pass through."""
    return {k: v.to(device, non_blocking=True) if torch.is_tensor(v) else v
            for k, v in batch.items()}
