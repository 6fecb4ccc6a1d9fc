"""Explicit-interaction tower models: xDeepFM (port of
``rank_tpu/models/cross_family.py``).

xDeepFM is README-only in the reference (README.md:26); the JAX package
implements it from Lian et al. 2018 (``cross_family.py:58-84``): a linear
term, a CIN and a DNN over the 7 ``AFM_FIELDS`` embeddings, summed into one
logit. ``manual_tag_list`` is a scalar lookup here, as in the JAX model.
DCN, DeepCrossing, FiBiNet and AutoInt wait for later slices.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..features import FeatureSchema
from ..ops.cin import CIN
from ..ops.mlp import MLPTower
from .base import AFM_FIELDS, Batch, ModelConfig, RankModel, single_task_output


class XDeepFM(RankModel):
    """CIN + DNN + linear, summed into one logit; modules under the flax
    names ``emb_*``, ``linear_*``, ``linear_dense``, ``cin``, ``cin_output``,
    ``dnn`` and ``deep_output``."""

    def __init__(
        self,
        schema: FeatureSchema,
        cfg: ModelConfig,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__(schema, cfg)
        dim = cfg.embedding_dim
        self.tables = self.uniform_tables(AFM_FIELDS, dim, "emb", generator)
        self.linear = self.uniform_tables(AFM_FIELDS, 1, "linear", generator)
        self.linear_dense = self.dense(schema.num_dense, 1, generator)
        self.cin = CIN(len(AFM_FIELDS), cfg.cin_layer_sizes, backend=cfg.kernel_backend,
                       generator=generator)
        self.cin_output = self.dense(self.cin.out_features, 1, generator)
        self.dnn = MLPTower(
            schema.num_dense + len(AFM_FIELDS) * dim,
            cfg.hidden_units,
            activation="relu",
            batch_norm=cfg.batch_norm,
            dropout_rate=cfg.dropout_rate,
            dense_init=cfg.dense_init,
            generator=generator,
        )
        self.deep_output = self.dense(self.dnn.out_features, 1, generator)

    def forward(self, batch: Batch):
        embs = torch.stack([self.tables[f](batch[f]) for f in AFM_FIELDS], dim=1)  # (B, F, D)
        dense = self.dense_input(batch)
        lin = sum(self.linear[f](batch[f]) for f in AFM_FIELDS) + self.linear_dense(dense)
        cin_logit = self.cin_output(self.cin(embs))
        deep_in = torch.cat([dense, embs.reshape(embs.shape[0], -1)], dim=-1)
        deep_logit = self.deep_output(self.dnn(deep_in))
        return single_task_output(lin + cin_logit + deep_logit)
