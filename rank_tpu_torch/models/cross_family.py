"""Explicit-interaction tower models: DCN, DeepCrossing, xDeepFM, FiBiNet
and AutoInt (port of ``rank_tpu/models/cross_family.py``).

  * DCN (``dcn.py:114-180``): x0 = [dense | 6 tower-field embeddings]; a
    cross network beside a ReLU MLP; concatenated into the logit.
  * DeepCrossing (``deepcrossing.py:106-163``): the same x0 through
    residual units into the logit.
  * xDeepFM (Lian et al. 2018): a linear term, a CIN and a DNN over the 7
    ``AFM_FIELDS`` embeddings, summed into one logit.
  * FiBiNet (Huang et al. 2019): SENET reweighting and bilinear
    interactions of the raw and the reweighted embeddings, with the dense
    features, into the tower.
  * AutoInt (Song et al. 2019): the 7 categorical fields and the 16 dense
    features (standardised by a train-mode BatchNorm ``dense_bn``, then
    each value times a learned vector ``dense_emb``) through the
    interacting layers, flattened into the logit.

``manual_tag_list`` is a scalar lookup in the ``AFM_FIELDS`` models, as in
the JAX models.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..embedding.collection import INITIALIZERS
from ..features import FeatureSchema
from ..ops.activations import BatchNorm
from ..ops.autoint import AutoIntLayer
from ..ops.cin import CIN
from ..ops.cross import CrossNetwork, ResidualStack
from ..ops.fm import pair_indices
from ..ops.mlp import MLPTower
from ..ops.senet import BilinearInteraction, SENETLayer
from .base import AFM_FIELDS, TOWER_FIELDS, Batch, ModelConfig, RankModel, single_task_output


class DCN(RankModel):
    """Modules: ``tables``, ``cross``, ``dnn`` (ReLU, no BatchNorm, no
    dropout) and ``output``."""

    def __init__(self, schema: FeatureSchema, cfg: ModelConfig,
                 generator: Optional[torch.Generator] = None):
        super().__init__(schema, cfg)
        self.tables = self.embedding_collection(generator, TOWER_FIELDS)
        width = schema.num_dense + sum(self.tower_field_dims())
        self.cross = CrossNetwork(width, cfg.num_cross_layers, cfg.dense_init,
                                  cfg.cross_frozen_random, generator)
        self.dnn = MLPTower(width, cfg.hidden_units, activation="relu", batch_norm=False,
                            dropout_rate=0.0, dense_init=cfg.dense_init, generator=generator)
        self.output = self.dense(width + self.dnn.out_features, 1, generator)

    def forward(self, batch: Batch):
        x0 = torch.cat([self.dense_input(batch)] + self.tower_field_embeddings(self.tables, batch),
                       dim=-1)
        return single_task_output(self.output(torch.cat([self.cross(x0), self.dnn(x0)], dim=-1)))


class DeepCrossing(RankModel):
    """Modules: ``tables``, ``residual`` and ``output``."""

    def __init__(self, schema: FeatureSchema, cfg: ModelConfig,
                 generator: Optional[torch.Generator] = None):
        super().__init__(schema, cfg)
        self.tables = self.embedding_collection(generator, TOWER_FIELDS)
        width = schema.num_dense + sum(self.tower_field_dims())
        self.residual = ResidualStack(width, cfg.residual_internal_dim, cfg.num_residual_units,
                                      cfg.dense_init, generator)
        self.output = self.dense(width, 1, generator)

    def forward(self, batch: Batch):
        x0 = torch.cat([self.dense_input(batch)] + self.tower_field_embeddings(self.tables, batch),
                       dim=-1)
        return single_task_output(self.output(self.residual(x0)))


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


class FiBiNet(RankModel):
    """Modules: ``emb_*``, ``senet``, ``bilinear_raw``, ``bilinear_se``,
    ``dnn`` and ``output``."""

    def __init__(self, schema: FeatureSchema, cfg: ModelConfig,
                 generator: Optional[torch.Generator] = None):
        super().__init__(schema, cfg)
        dim, fields = cfg.embedding_dim, len(AFM_FIELDS)
        self.tables = self.uniform_tables(AFM_FIELDS, dim, "emb", generator)
        self.senet = SENETLayer(fields, cfg.senet_reduction, generator)
        self.bilinear_raw = BilinearInteraction(fields, dim, cfg.bilinear_type, generator)
        self.bilinear_se = BilinearInteraction(fields, dim, cfg.bilinear_type, generator)
        pairs = len(pair_indices(fields)[0])
        self.dnn = MLPTower(schema.num_dense + 2 * pairs * dim, cfg.hidden_units,
                            activation="relu", batch_norm=cfg.batch_norm,
                            dropout_rate=cfg.dropout_rate, dense_init=cfg.dense_init,
                            generator=generator)
        self.output = self.dense(self.dnn.out_features, 1, generator)

    def forward(self, batch: Batch):
        embs = torch.stack([self.tables[f](batch[f]) for f in AFM_FIELDS], dim=1)
        p1 = self.bilinear_raw(embs)
        p2 = self.bilinear_se(self.senet(embs))
        x = torch.cat([self.dense_input(batch), p1.flatten(1), p2.flatten(1)], dim=-1)
        return single_task_output(self.output(self.dnn(x)))


class AutoInt(RankModel):
    """Modules: ``emb_*``, ``dense_bn``, the raw ``dense_emb`` (Nd, E),
    ``interact_{i}`` and ``output``. The interacting layers run at
    ``transformer_dtype`` with scores stored at ``transformer_score_dtype``
    (both bfloat16 by default), as in the JAX model."""

    def __init__(self, schema: FeatureSchema, cfg: ModelConfig,
                 generator: Optional[torch.Generator] = None):
        super().__init__(schema, cfg)
        dim = cfg.embedding_dim
        self.tables = self.uniform_tables(AFM_FIELDS, dim, "emb", generator)
        self.dense_bn = BatchNorm(schema.num_dense)
        self.dense_emb = nn.Parameter(
            INITIALIZERS[cfg.embedding_init](torch.empty(schema.num_dense, dim), generator))
        width = cfg.autoint_heads * cfg.autoint_att_dim
        d_in = dim
        for i in range(cfg.autoint_layers):
            self.add_module(f"interact_{i}", AutoIntLayer(
                d_in, cfg.autoint_heads, cfg.autoint_att_dim, cfg.transformer_dtype,
                cfg.transformer_score_dtype, generator))
            d_in = width
        fields = len(AFM_FIELDS) + schema.num_dense
        self.output = self.dense(fields * d_in, 1, generator)

    def forward(self, batch: Batch):
        cat_e = torch.stack([self.tables[f](batch[f]) for f in AFM_FIELDS], dim=1)
        dense = self.dense_bn(self.dense_input(batch))  # (B, Nd), standardised
        e = torch.cat([cat_e, dense[:, :, None] * self.dense_emb[None]], dim=1)  # (B, F, E)
        for i in range(self.cfg.autoint_layers):
            e = getattr(self, f"interact_{i}")(e)
        return single_task_output(self.output(e.flatten(1)))
