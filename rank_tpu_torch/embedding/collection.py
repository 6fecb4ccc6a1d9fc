"""Per-field embedding collection (port of ``rank_tpu/embedding/collection.py``).

One ``nn.Embedding`` per owned table, driven by the FeatureSchema:

  * vocab sizes include the OOV slot at row 0 (``features.py``);
  * per-field embedding dims;
  * a feature with ``shares_table_with`` reads its owner's table (DIN's
    target ``feedid`` and ``his_read_comment_7d_seq``; ``manual_tag_list``
    and ``manual_tag_seq``).

Tables are registered as ``table_<name>``, the flax module names, so the
weight carry-over in ``interop.py`` maps keys mechanically. ``features``
names the features a model looks up; only their tables are made, as flax
creates only the tables a model calls (DCN's collection has no
``table_feedid``).

``mode`` names the lookup schedule on a table-sharded mesh, as in the JAX
package (``collection.py:70-127``). Without a mesh, or for a table the
trainer leaves unsharded, every mode is the plain gather. On a
table-sharded mesh (``embedding/sharded.py``; ``Trainer`` shards the
tables through ``build_model(..., mesh=, sharded_tables=)``):

  * ``'psum'`` and ``'alltoall'`` run those explicit schedules for the
    collection's sharded tables, as JAX's ``shard_map`` does;
  * ``'gspmd'``: JAX's compiler shards every table leaf that the trainer's
    ``_pick`` marks and inserts the collectives. The port has no compiler
    to insert them, so ``'gspmd'`` runs the ``'psum'`` schedule for every
    table that rule shards. It gives the same values. The FM family's and
    ``uniform_tables``' tables (``models/base.py``), which JAX leaves to
    GSPMD under every mode, take the same ``'psum'`` schedule.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence, Tuple

import torch
from torch import nn

from ..features import FeatureSchema
from .sharded import MODES, TableEmbedding


def table_specs(schema: FeatureSchema) -> Dict[str, Tuple[int, int]]:
    """name -> (vocab_size, emb_dim) for each OWNED table (shared-table
    features resolve to their owner)."""
    specs: Dict[str, Tuple[int, int]] = {}
    for f in list(schema.categorical) + list(schema.sequence):
        owner = f.shares_table_with or f.name
        if owner == f.name:
            specs[f.name] = (f.vocab_size, f.emb_dim)
    return specs


# The JAX package's families (``embedding/collection.py:50-67``; its notes
# say why N(0,1) is the default and when 'normal_small' is the better
# choice). flax's truncated_normal(0.02) cuts at two standard deviations.
INITIALIZERS: Dict[str, Callable[[torch.Tensor, Optional[torch.Generator]], torch.Tensor]] = {
    "normal": lambda t, g: nn.init.normal_(t, 0.0, 1.0, generator=g),
    "normal_small": lambda t, g: nn.init.normal_(t, 0.0, 0.1, generator=g),
    "truncated_normal": lambda t, g: nn.init.trunc_normal_(
        t, 0.0, 0.02, -0.04, 0.04, generator=g
    ),
    "xavier_uniform": lambda t, g: nn.init.xavier_uniform_(t, generator=g),
}


class EmbeddingCollection(nn.Module):
    """Owns one table per (non-shared) categorical/sequence feature. Where
    JAX's collection holds ``mesh`` and ``sharded`` for its lookup, the
    port's tables carry their own shard and mesh (``TableEmbedding``): the
    lookup is the table's, with the schedule ``mode`` gave it."""

    def __init__(
        self,
        schema: FeatureSchema,
        init_name: str = "normal",
        mode: str = "gspmd",
        generator: Optional[torch.Generator] = None,
        features: Optional[Sequence[str]] = None,
    ):
        super().__init__()
        if mode not in MODES:
            raise ValueError(f"embedding mode {mode!r}: one of {MODES}")
        self.mode = mode
        init = INITIALIZERS[init_name]
        self._owners = {
            f.name: f.shares_table_with or f.name
            for f in list(schema.categorical) + list(schema.sequence)
        }
        wanted = None if features is None else {self._owners[f] for f in features}
        for name, (vocab, dim) in table_specs(schema).items():
            if wanted is not None and name not in wanted:
                continue
            weight = init(torch.empty(vocab, dim), generator)
            schedule = "alltoall" if mode == "alltoall" else "psum"
            self.add_module(f"table_{name}", TableEmbedding.create(weight, name, schedule))

    def lookup(self, name: str, ids: torch.Tensor) -> torch.Tensor:
        """ids (B,) or (B, T) -> embeddings (B, D) / (B, T, D)."""
        return getattr(self, f"table_{self._owners[name]}")(ids)
