"""Row-sharded embedding tables and their explicit lookups (port of
``rank_tpu/embedding/sharded.py``).

A sharded table of V rows (padded to a multiple of the table axis t by
``pad_vocab``) keeps rows [j V/t, (j+1) V/t) on the rank at table index j
(``parallel/mesh.py``). A lookup takes the flat ids of the rank's rows,
which every rank of a table group shares, and returns their (B, D) rows:

  * ``'psum'``: each rank gathers the rows it owns (masked local gather),
    then one all-reduce over the table group sums the partial rows
    (``sharded.py:64-72``). Its backward is the **identity**, not another
    all-reduce: every rank of the table group computes the same loss from
    the same rows, so rank (i, j) already holds dL_i/d out, which is
    exactly the gradient its masked gather needs. An all-reducing backward
    (``torch.distributed.nn.functional.all_reduce``) would train the
    tables with t times the gradient.
  * ``'alltoall'``: the id-exchange schedule (``sharded.py:74-97``): each
    rank sends its ids to every table peer, each peer resolves the ids it
    owns, a second ``all_to_all`` ships the rows back, and the requester
    sums the t answers. The backward is the reverse ``all_to_all`` of the
    cotangents, scaled by 1/t: all t requesters of a table group ask for
    the same ids and backpropagate the same loss, so each owner receives
    t equal cotangents. JAX's ``shard_map`` makes the same 1/t division
    when it transposes an output replicated over the table axis with
    ``check_vma=False``. Since the t slots hold the same ids (table peers
    see the same rows, by the port's layout), the owner averages them and
    scatters once, through the masked gather's own backward: the same sum
    in the same order as ``'psum'`` and the plain gather.

Each id has exactly one owning shard, so every cross-shard sum adds exact
zeros: the lookups give the plain gather's values to the last bit.
``TableEmbedding`` is the ``nn.Embedding`` every table of the port is:
unsharded, it is the plain gather; ``shard_tables_`` pads and shards the
tables a trainer row-shards, in place.
"""

from __future__ import annotations

from typing import Iterable, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel.mesh import TABLE_AXIS, Mesh

MODES = ("gspmd", "psum", "alltoall")


def pad_vocab(table: torch.Tensor, num_shards: int) -> torch.Tensor:
    """Pad rows with zeros so the vocab axis divides ``num_shards``."""
    v = table.shape[0]
    vp = -(-v // num_shards) * num_shards
    if vp != v:
        table = torch.cat([table, table.new_zeros((vp - v,) + tuple(table.shape[1:]))])
    return table


def shard_table(table: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """This rank's rows of a (V, D) table row-sharded over the table axis."""
    t = mesh.shape[TABLE_AXIS]
    if table.shape[0] % t:
        raise ValueError(
            f"vocab {table.shape[0]} not divisible by table axis {t}; use pad_vocab first"
        )
    rows = table.shape[0] // t
    return table[mesh.table_index * rows:(mesh.table_index + 1) * rows]


class _SumOverTable(torch.autograd.Function):
    """All-reduce over the table group; identity backward (module doc)."""

    @staticmethod
    def forward(ctx, partial: torch.Tensor, mesh: Mesh):
        return mesh.all_reduce_(partial.clone(), TABLE_AXIS)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _AllToAllLookup(torch.autograd.Function):
    """The ``'alltoall'`` lookup; its backward is the reverse ``all_to_all``
    of the cotangents, averaged over the t equal slots (module doc)."""

    @staticmethod
    def forward(ctx, table_shard: torch.Tensor, ids: torch.Tensor, mesh: Mesh):
        t = mesh.shape[TABLE_AXIS]
        # slot j of the received ids holds table peer j's ids; resolve the
        # rows this shard owns, ship them back, and sum the t answers
        recv_ids = mesh.all_to_all(ids.unsqueeze(0).expand(t, -1), TABLE_AXIS)
        resolved = _masked_gather(table_shard, recv_ids, mesh)  # (t, B, D)
        ctx.mesh = mesh
        ctx.save_for_backward(table_shard, ids)
        return mesh.all_to_all(resolved, TABLE_AXIS).sum(dim=0)

    @staticmethod
    def backward(ctx, grad):
        mesh = ctx.mesh
        table_shard, ids = ctx.saved_tensors
        t = mesh.shape[TABLE_AXIS]
        slots = mesh.all_to_all(grad.unsqueeze(0).expand(t, -1, -1), TABLE_AXIS)
        with torch.enable_grad():
            shard = table_shard.detach().requires_grad_(True)
            rows = _masked_gather(shard, ids, mesh)
            (grad_shard,) = torch.autograd.grad(rows, shard, slots.sum(dim=0) / t)
        return grad_shard, None, None


def _masked_gather(table_shard: torch.Tensor, ids: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Rows of ``ids`` this shard owns; zeros for the others."""
    rows = table_shard.shape[0]
    local = ids - mesh.table_index * rows
    valid = (local >= 0) & (local < rows)
    gathered = F.embedding(torch.clamp(local, 0, rows - 1), table_shard)
    return gathered * valid.unsqueeze(-1).to(table_shard.dtype)


def sharded_lookup(table_shard: torch.Tensor, ids: torch.Tensor, mesh: Mesh,
                   mode: str = "psum") -> torch.Tensor:
    """(B,) ids of this rank's rows -> (B, D) rows of the table whose rows
    ``table_shard`` holds this rank's share of."""
    if mode == "psum":
        return _SumOverTable.apply(_masked_gather(table_shard, ids, mesh), mesh)
    if mode != "alltoall":
        raise ValueError(f"sharded lookup mode {mode!r}: psum|alltoall")
    return _AllToAllLookup.apply(table_shard, ids, mesh)


class TableEmbedding(nn.Embedding):
    """An embedding table: the plain gather, or, once ``shard_tables_``
    has sharded it, this rank's rows and a sharded lookup.

    ``feature`` names the feature whose vocabulary sizes it; ``full_rows``
    is the (padded) vocab the shards together hold."""

    feature: str = ""
    mesh: Optional[Mesh] = None
    schedule: str = "psum"
    full_rows: int = 0

    @classmethod
    def create(cls, weight: torch.Tensor, feature: str, schedule: str = "psum") -> "TableEmbedding":
        table = cls.from_pretrained(weight, freeze=False)
        table.feature = feature
        table.full_rows = weight.shape[0]
        table.schedule = schedule
        return table

    @property
    def sharded(self) -> bool:
        return self.mesh is not None

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        if self.mesh is None:
            return super().forward(ids)
        out = sharded_lookup(self.weight, ids.reshape(-1), self.mesh, self.schedule)
        return out.reshape(tuple(ids.shape) + (out.shape[-1],))


def shard_tables_(model: nn.Module, mesh: Mesh, sharded_tables: Iterable[str]) -> None:
    """Row-shard, in place, every ``TableEmbedding`` of ``model`` whose
    feature is in ``sharded_tables``: pad its rows with zeros to a multiple
    of the table axis and keep this rank's rows. Its lookup schedule is the
    one it was made with (``EmbeddingCollection`` sets it)."""
    sharded = set(sharded_tables)
    for module in model.modules():
        if not isinstance(module, TableEmbedding) or module.feature not in sharded:
            continue
        with torch.no_grad():
            full = pad_vocab(module.weight.detach(), mesh.shape[TABLE_AXIS])
            module.weight = nn.Parameter(shard_table(full, mesh).clone())
        module.num_embeddings = module.weight.shape[0]
        module.full_rows = full.shape[0]
        module.mesh = mesh
