"""The (data x table) mesh over ``torch.distributed`` ranks (port of
``rank_tpu/parallel/mesh.py``).

JAX runs one process per host over many devices and lets GSPMD insert the
collectives. The port runs **one process per device** and writes every
collective out. A mesh of N = d x t ranks is a grid:

  * rank r sits at data index i = r // t and table index j = r % t;
  * its **table group** is the t ranks with the same i: they see the same
    rows and hold different row shards of each sharded table;
  * its **data group** is the d ranks with the same j: they see different
    rows and hold the same shard.

Dense parameters and unsharded tables are replicated on every rank; a
sharded table of padded V rows holds rows [j V/t, (j+1) V/t) on rank
(i, j) (``embedding/sharded.py``).

``init_distributed`` is the counterpart of the caller's
``jax.distributed.initialize()``: it reads ``RANK``/``WORLD_SIZE`` (and
``MASTER_ADDR``/``MASTER_PORT`` for ``env://``) as ``torchrun`` sets them.
Without an initialised process group ``make_mesh`` is the world of one: no
groups, and every collective of ``Mesh`` is the identity.

The collectives go through ``Mesh``'s methods. Two ranks on one card
use the ``gloo`` backend (NCCL refuses them): a CUDA build of torch runs
gloo's all-reduce, all-to-all and all-gather on CUDA tensors, staging each
buffer through the host itself, while the compute stays on the card.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
from typing import Dict, List, Optional, Sequence

import torch
import torch.distributed as dist

DATA_AXIS = "data"
TABLE_AXIS = "table"

_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}


def init_distributed(backend: Optional[str] = None, init_method: str = "env://",
                     rank: Optional[int] = None, world_size: Optional[int] = None,
                     timeout_s: float = 600.0) -> None:
    """Join the process group (a no-op when already joined). ``backend``
    defaults to ``nccl`` when CUDA is available and ``gloo`` otherwise;
    ``rank`` and ``world_size`` default to ``RANK`` and ``WORLD_SIZE``."""
    if dist.is_initialized():
        return
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    rank = int(os.environ.get("RANK", "0")) if rank is None else rank
    world_size = int(os.environ.get("WORLD_SIZE", "1")) if world_size is None else world_size
    dist.init_process_group(backend, init_method=init_method, rank=rank, world_size=world_size,
                            timeout=datetime.timedelta(seconds=timeout_s))
    if backend == "nccl":
        # NCCL's barrier and object collectives use the current card
        torch.cuda.set_device(local_device("cuda"))


def local_device(device="cuda") -> torch.device:
    """``device`` for this rank: in a process group, an unindexed ``cuda``
    becomes the card ``LOCAL_RANK`` (else the rank) modulo the cards
    present, so ranks share cards round-robin; anything else as it is."""
    device = torch.device(device)
    if device.type != "cuda" or device.index is not None or not dist.is_initialized():
        return device
    local = int(os.environ.get("LOCAL_RANK", dist.get_rank()))
    return torch.device("cuda", local % torch.cuda.device_count())


@dataclasses.dataclass
class Mesh:
    """One rank's view of the (data x table) grid and its collectives."""

    world_size: int = 1
    rank: int = 0
    data_index: int = 0
    table_index: int = 0
    shape: Dict[str, int] = dataclasses.field(
        default_factory=lambda: {DATA_AXIS: 1, TABLE_AXIS: 1})
    device: torch.device = torch.device("cpu")
    data_group: Optional[object] = None
    table_group: Optional[object] = None
    backend: Optional[str] = None

    def _group(self, axis: Optional[str]):
        """(process group, size) of ``axis``; ``None`` is the whole world."""
        if axis is None:
            return None, self.world_size
        if axis == DATA_AXIS:
            return self.data_group, self.shape[DATA_AXIS]
        if axis == TABLE_AXIS:
            return self.table_group, self.shape[TABLE_AXIS]
        raise ValueError(f"unknown mesh axis {axis!r}")

    def all_reduce_(self, tensor: torch.Tensor, axis: Optional[str], op: str = "sum"):
        """In-place all-reduce over ``axis``; returns ``tensor``."""
        group, size = self._group(axis)
        if size == 1:
            return tensor
        dist.all_reduce(tensor, op=_OPS[op], group=group)
        return tensor

    def all_to_all(self, tensor: torch.Tensor, axis: Optional[str],
                   out_splits: Optional[Sequence[int]] = None,
                   in_splits: Optional[Sequence[int]] = None) -> torch.Tensor:
        """``all_to_all_single`` over ``axis`` along dim 0: even blocks, or
        the given split sizes (rows sent to / received from each member)."""
        group, size = self._group(axis)
        if size == 1:
            return tensor
        rows = tensor.shape[0] if out_splits is None else sum(out_splits)
        tensor = tensor.contiguous()
        out = tensor.new_empty((rows,) + tuple(tensor.shape[1:]))
        dist.all_to_all_single(out, tensor, output_split_sizes=out_splits,
                               input_split_sizes=in_splits, group=group)
        return out

    def all_gather_object(self, obj, axis: Optional[str]) -> list:
        """Every member's picklable ``obj``, in member order."""
        group, size = self._group(axis)
        if size == 1:
            return [obj]
        out = [None] * size
        dist.all_gather_object(out, obj, group=group)
        return out

    def all_gather(self, tensor: torch.Tensor, axis: Optional[str]) -> List[torch.Tensor]:
        """Every member's ``tensor`` (same shape on each), in member order."""
        group, size = self._group(axis)
        if size == 1:
            return [tensor]
        tensor = tensor.contiguous()
        out = [torch.empty_like(tensor) for _ in range(size)]
        dist.all_gather(out, tensor, group=group)
        return out


def make_mesh(num_devices: Optional[int] = None, table_parallelism: int = 1,
              device="cuda") -> Mesh:
    """A (data x table) mesh over the ranks of the process group, one rank
    a device; ``num_devices``, where given, must be the world size."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    if num_devices is not None and num_devices != world:
        raise ValueError(
            f"num_devices={num_devices}, but the port runs one process per device "
            f"and this process group has {world}"
        )
    if world % table_parallelism:
        raise ValueError(
            f"{world} devices not divisible by table_parallelism={table_parallelism}"
        )
    t = table_parallelism
    d = world // t
    device = local_device(device)
    if world == 1:
        return Mesh(shape={DATA_AXIS: d, TABLE_AXIS: t}, device=device)
    rank = dist.get_rank()
    # dist.new_group must be called by every rank, for every group, in the
    # same order: all d table groups, then all t data groups
    table_groups = [dist.new_group([i * t + j for j in range(t)]) for i in range(d)]
    data_groups = [dist.new_group([i * t + j for i in range(d)]) for j in range(t)]
    return Mesh(world_size=world, rank=rank, data_index=rank // t, table_index=rank % t,
                shape={DATA_AXIS: d, TABLE_AXIS: t}, device=device,
                data_group=data_groups[rank % t], table_group=table_groups[rank // t],
                backend=dist.get_backend())


def is_writer() -> bool:
    """True on the rank that writes files: rank 0, or the only process."""
    return not dist.is_initialized() or dist.get_rank() == 0


def barrier() -> None:
    """Wait for every rank (a no-op in the world of one)."""
    if dist.is_initialized() and dist.get_world_size() > 1:
        dist.barrier()
