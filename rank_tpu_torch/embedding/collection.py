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
``table_feedid``). Only the plain gather (the JAX package's ``'gspmd'``
mode) is ported; the explicit table-sharded schedules (``'psum'`` /
``'alltoall'``) wait for the multi-device slice.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence, Tuple

import torch
from torch import nn

from ..features import FeatureSchema


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
    """Owns one table per (non-shared) categorical/sequence feature."""

    def __init__(
        self,
        schema: FeatureSchema,
        init_name: str = "normal",
        mode: str = "gspmd",
        generator: Optional[torch.Generator] = None,
        features: Optional[Sequence[str]] = None,
    ):
        super().__init__()
        if mode != "gspmd":
            raise NotImplementedError(
                f"embedding mode {mode!r} is not ported yet; only 'gspmd' "
                "(the plain gather) is"
            )
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
            self.add_module(
                f"table_{name}", nn.Embedding.from_pretrained(weight, freeze=False)
            )

    def lookup(self, name: str, ids: torch.Tensor) -> torch.Tensor:
        """ids (B,) or (B, T) -> embeddings (B, D) / (B, T, D)."""
        return getattr(self, f"table_{self._owners[name]}")(ids)
