"""Processes of a data-parallel training run: ``torch.distributed``.

The counterpart of ``jax.distributed.initialize`` and of ``shard_batch``'s
multi-host half (``fast_srgan_tpu/parallel/mesh.py``). One process a device,
launched by ``torchrun`` (``python -m torch.distributed.run``); every rank
holds the whole model and a contiguous slice of each global batch, as JAX's
batch sharding lays it out over a data mesh.

  * :func:`init_from_env` reads torchrun's ``RANK``, ``WORLD_SIZE`` and
    ``LOCAL_RANK`` and joins the group (NCCL on CUDA, gloo on the CPU); with
    no such environment it returns a world of one with no group, and every
    collective here is then a no-op. :func:`init` takes the backend, the
    rendezvous (``file://``, ``tcp://``) and the rank explicitly, for tests
    and for several ranks sharing one device.
  * :func:`local_rows`: the rows of a global batch a rank holds.
  * :func:`all_reduce_mean_`, :func:`all_reduce_sum_`: in place, through one
    flat buffer a call (one collective for a whole model's gradients).
  * :func:`broadcast_module_`, :func:`broadcast_object`, :func:`barrier`.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from datetime import timedelta
from typing import Any, Optional, Sequence

import torch
import torch.distributed as dist
from torch._utils import _flatten_dense_tensors, _unflatten_dense_tensors

#: seconds a collective may wait for the other ranks before the run fails
DEFAULT_TIMEOUT_S = 600.0


@dataclass(frozen=True)
class DistInfo:
    """This process's place in the run: ``group`` is None for a world of one
    without a process group (no collective runs)."""

    rank: int = 0
    world: int = 1
    local_rank: int = 0
    group: Optional[Any] = None

    @property
    def is_main(self) -> bool:
        """Rank 0: the one process that writes files and prints."""
        return self.rank == 0

    def rows(self, local_n: int) -> slice:
        """This rank's rows of a global batch of ``local_n * world`` rows."""
        return local_rows(local_n * self.world, self.rank, self.world)


SINGLE = DistInfo()


def backend_for(device_type: str) -> str:
    return "nccl" if device_type == "cuda" else "gloo"


def init(
    backend: str,
    rank: int,
    world: int,
    init_method: str = "env://",
    local_rank: int = 0,
    timeout_s: float = DEFAULT_TIMEOUT_S,
) -> DistInfo:
    """Join a process group of ``world`` ranks as ``rank``."""
    dist.init_process_group(
        backend, init_method=init_method, rank=rank, world_size=world,
        timeout=timedelta(seconds=timeout_s),
    )
    return DistInfo(rank, world, local_rank, dist.group.WORLD)


def init_from_env(device_type: str, timeout_s: float = DEFAULT_TIMEOUT_S) -> DistInfo:
    """The group torchrun's environment names (NCCL for ``cuda``, after
    selecting ``cuda:LOCAL_RANK``; gloo for ``cpu``), or a world of one with
    no group when ``WORLD_SIZE`` is not set."""
    if "WORLD_SIZE" not in os.environ:
        return SINGLE
    rank = int(os.environ["RANK"])
    world = int(os.environ["WORLD_SIZE"])
    local_rank = int(os.environ.get("LOCAL_RANK", 0))
    if device_type == "cuda":
        torch.cuda.set_device(local_rank)
    return init(backend_for(device_type), rank, world, "env://", local_rank, timeout_s)


def destroy(info: DistInfo) -> None:
    if info.group is not None and dist.is_initialized():
        dist.destroy_process_group()


def local_rows(global_n: int, rank: int, world: int) -> slice:
    """The contiguous rows ``rank`` holds of a global batch of ``global_n``
    (rank r: rows r*n .. (r+1)*n - 1 of n = global_n / world)."""
    if global_n % world:
        raise ValueError(f"a global batch of {global_n} does not split over {world} ranks")
    n = global_n // world
    return slice(rank * n, (rank + 1) * n)


def _all_reduce_flat_(tensors: Sequence[torch.Tensor], info: DistInfo, mean: bool) -> None:
    if info.group is None or not tensors:
        return
    flat = _flatten_dense_tensors(list(tensors))
    dist.all_reduce(flat, group=info.group)
    if mean:
        flat.div_(info.world)
    torch._foreach_copy_(list(tensors), list(_unflatten_dense_tensors(flat, tensors)))


def all_reduce_mean_(tensors: Sequence[torch.Tensor], info: DistInfo) -> None:
    """Replace each tensor (one dtype and device) by its mean over the
    ranks: one all-reduce of one flat buffer."""
    _all_reduce_flat_(tensors, info, mean=True)


def all_reduce_sum_(tensors: Sequence[torch.Tensor], info: DistInfo) -> None:
    """Replace each tensor by its sum over the ranks (one flat buffer)."""
    _all_reduce_flat_(tensors, info, mean=False)


@torch.no_grad()
def broadcast_module_(module: torch.nn.Module, info: DistInfo, src: int = 0) -> None:
    """Copy rank ``src``'s parameters into every rank's ``module`` (one flat
    buffer; the parameters share a dtype)."""
    if info.group is None:
        return
    params = [p.data for p in module.parameters()]
    flat = _flatten_dense_tensors(params)
    dist.broadcast(flat, src, group=info.group)
    torch._foreach_copy_(params, list(_unflatten_dense_tensors(flat, params)))


def broadcast_object(obj: Any, info: DistInfo, src: int = 0) -> Any:
    """Rank ``src``'s ``obj`` (picklable) on every rank."""
    if info.group is None:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src, group=info.group)
    return box[0]


def barrier(info: DistInfo) -> None:
    if info.group is not None:
        dist.barrier(group=info.group)
