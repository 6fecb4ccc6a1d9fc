"""FM-family models: DeepFM, FwFM, FFM, AFM, PNN, Wide&Deep and FLEN (port
of ``rank_tpu/models/fm_family.py``).

  * DeepFM (``deepfm.py:73-151``): the 6 ``FM_FIELDS``, no dense features;
    dim-1 first-order and dim-E second-order tables; FM1, FM2 and the deep
    logit fused by a learned Linear(3, 1).
  * FwFM (``fwfm.py:87-139``): linear terms + r_p * <v_i, v_j> + a bias.
  * FFM (Juan et al. 2016): one (vocab, F*E) table per field, viewed as F
    partner embeddings of width E.
  * AFM (``afm.py:64-119``): a dense linear term + attention-pooled
    pairwise products of the 7 ``AFM_FIELDS``, projected by ``p``.
  * PNN (Qu et al. 2016): flat embeddings with the inner and/or outer
    product signal into the tower.
  * Wide&Deep (Cheng et al. 2016): wide per-field weights + a dense
    linear term, and the tower-field embeddings with the dense features
    through the deep tower.
  * FLEN (Feng et al. 2020): first-order terms, the field-wise
    bi-interaction of the ``flen_groups`` and an MLP, concatenated into
    the logit.

Modules carry the flax names, the auto-named ones included: the tower of
DeepFM, PNN, Wide&Deep and FLEN is ``MLPTower_0``, PNN's output layer
``Dense_0``, PNN's outer product layer ``OuterProductLayer_0``.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..features import FeatureSchema
from ..ops import fm
from ..ops.mlp import MLPTower
from ..ops.product import InnerProductLayer, OuterProductLayer
from .base import (AFM_FIELDS, FM_FIELDS, TOWER_FIELDS, Batch, ModelConfig, RankModel,
                   single_task_output)


def _tower(cfg: ModelConfig, width: int, generator: Optional[torch.Generator]) -> MLPTower:
    """The ReLU ``bn_act`` tower the FM family shares."""
    return MLPTower(width, cfg.hidden_units, activation="relu", batch_norm=cfg.batch_norm,
                    dropout_rate=cfg.dropout_rate, dense_init=cfg.dense_init,
                    generator=generator)


def _stack(tables, fields, batch: Batch) -> torch.Tensor:
    """Per-field embeddings stacked to (B, F, D)."""
    return torch.stack([tables[f](batch[f]) for f in fields], dim=1)


def _linear(tables, fields, batch: Batch) -> torch.Tensor:
    """Sum of the dim-1 per-field weights, (B, 1)."""
    return sum(tables[f](batch[f]) for f in fields)


class DeepFM(RankModel):
    def __init__(self, schema: FeatureSchema, cfg: ModelConfig,
                 generator: Optional[torch.Generator] = None):
        super().__init__(schema, cfg)
        self.first = self.uniform_tables(FM_FIELDS, 1, "first_order", generator)
        self.second = self.uniform_tables(FM_FIELDS, cfg.embedding_dim, "second_order", generator)
        self.MLPTower_0 = _tower(cfg, len(FM_FIELDS) * cfg.embedding_dim, generator)
        self.deep_output = self.dense(self.MLPTower_0.out_features, 1, generator)
        self.final_layer = self.dense(3, 1, generator)

    def forward(self, batch: Batch):
        fm1 = fm.fm_first_order(_stack(self.first, FM_FIELDS, batch))  # (B, 1)
        embs = _stack(self.second, FM_FIELDS, batch)  # (B, F, E)
        fm2 = fm.fm_second_order(embs)  # (B, 1)
        deep_logit = self.deep_output(self.MLPTower_0(embs.flatten(1)))
        return single_task_output(self.final_layer(torch.cat([fm1, fm2, deep_logit], dim=-1)))


class FwFM(RankModel):
    def __init__(self, schema: FeatureSchema, cfg: ModelConfig,
                 generator: Optional[torch.Generator] = None):
        super().__init__(schema, cfg)
        self.linear = self.uniform_tables(FM_FIELDS, 1, "linear", generator)
        self.tables = self.uniform_tables(FM_FIELDS, cfg.embedding_dim, "emb", generator)
        pairs = len(fm.pair_indices(len(FM_FIELDS))[0])
        self.field_weight = nn.Parameter(torch.empty(pairs).normal_(0.0, 1.0, generator=generator))
        self.bias = nn.Parameter(torch.zeros(1))

    def forward(self, batch: Batch):
        quad = fm.fwfm_interaction(_stack(self.tables, FM_FIELDS, batch), self.field_weight)
        return single_task_output(_linear(self.linear, FM_FIELDS, batch) + quad + self.bias)


class FFM(RankModel):
    """Field-aware FM: each field holds F embeddings, one per partner field."""

    def __init__(self, schema: FeatureSchema, cfg: ModelConfig,
                 generator: Optional[torch.Generator] = None):
        super().__init__(schema, cfg)
        self.linear = self.uniform_tables(FM_FIELDS, 1, "linear", generator)
        self.ffm = self.uniform_tables(FM_FIELDS, len(FM_FIELDS) * cfg.embedding_dim, "ffm",
                                       generator)
        self.bias = nn.Parameter(torch.zeros(1))

    def forward(self, batch: Batch):
        f_count, dim = len(FM_FIELDS), self.cfg.embedding_dim
        field_aware = torch.stack(
            [self.ffm[f](batch[f]).reshape(-1, f_count, dim) for f in FM_FIELDS], dim=1
        )  # (B, F, F_partner, E)
        quad = fm.ffm_interaction(field_aware)
        return single_task_output(_linear(self.linear, FM_FIELDS, batch) + quad + self.bias)


class AFM(RankModel):
    def __init__(self, schema: FeatureSchema, cfg: ModelConfig,
                 generator: Optional[torch.Generator] = None):
        super().__init__(schema, cfg)
        dim = cfg.embedding_dim
        self.tables = self.uniform_tables(AFM_FIELDS, dim, "emb", generator)
        self.dense_layer = self.dense(schema.num_dense, 1, generator)
        self.att_1 = self.dense(dim, cfg.attention_factor, generator)
        self.att_2 = self.dense(cfg.attention_factor, 1, generator)
        self.p = self.dense(dim, 1, generator)

    def forward(self, batch: Batch):
        pairs = fm.pairwise_hadamard(_stack(self.tables, AFM_FIELDS, batch))  # (B, P, E)
        scores = self.att_2(torch.relu(self.att_1(pairs)))  # (B, P, 1)
        pooled = (pairs * torch.softmax(scores, dim=1)).sum(dim=1)  # (B, E)
        return single_task_output(self.dense_layer(self.dense_input(batch)) + self.p(pooled))


class PNN(RankModel):
    """[flat embeddings; product signal] -> tower -> logit."""

    def __init__(self, schema: FeatureSchema, cfg: ModelConfig,
                 generator: Optional[torch.Generator] = None):
        super().__init__(schema, cfg)
        if cfg.pnn_mode not in ("inner", "outer", "both"):
            raise ValueError(f"unknown pnn_mode {cfg.pnn_mode!r}")
        dim, fields = cfg.embedding_dim, len(AFM_FIELDS)
        self.tables = self.uniform_tables(AFM_FIELDS, dim, "emb", generator)
        width = fields * dim
        self.products = []
        if cfg.pnn_mode in ("inner", "both"):
            self.products.append(InnerProductLayer())
            width += len(fm.pair_indices(fields)[0])
        if cfg.pnn_mode in ("outer", "both"):
            self.OuterProductLayer_0 = OuterProductLayer(dim, cfg.outer_outputs, generator)
            self.products.append(self.OuterProductLayer_0)
            width += cfg.outer_outputs
        self.MLPTower_0 = _tower(cfg, width, generator)
        self.Dense_0 = self.dense(self.MLPTower_0.out_features, 1, generator)

    def forward(self, batch: Batch):
        embs = _stack(self.tables, AFM_FIELDS, batch)
        feats = [embs.flatten(1)] + [product(embs) for product in self.products]
        return single_task_output(self.Dense_0(self.MLPTower_0(torch.cat(feats, dim=-1))))


class WideDeep(RankModel):
    """Wide: dense + per-field linear weights; deep: dense + the tower-field
    embeddings -> tower."""

    def __init__(self, schema: FeatureSchema, cfg: ModelConfig,
                 generator: Optional[torch.Generator] = None):
        super().__init__(schema, cfg)
        self.tables = self.embedding_collection(generator, TOWER_FIELDS)
        self.wide = self.uniform_tables(AFM_FIELDS, 1, "wide", generator)
        self.wide_dense = self.dense(schema.num_dense, 1, generator)
        self.MLPTower_0 = _tower(cfg, schema.num_dense + sum(self.tower_field_dims()), generator)
        self.deep_output = self.dense(self.MLPTower_0.out_features, 1, generator)

    def forward(self, batch: Batch):
        dense = self.dense_input(batch)
        wide = _linear(self.wide, AFM_FIELDS, batch) + self.wide_dense(dense)
        deep_in = torch.cat([dense] + self.tower_field_embeddings(self.tables, batch), dim=-1)
        return single_task_output(wide + self.deep_output(self.MLPTower_0(deep_in)))


class FLEN(RankModel):
    """logit = Dense([h_S ; h_MF + h_FM ; h_MLP]) over the field groups of
    ``cfg.flen_groups`` (user / item / tag context); the dense features
    enter h_S and the MLP."""

    def __init__(self, schema: FeatureSchema, cfg: ModelConfig,
                 generator: Optional[torch.Generator] = None):
        super().__init__(schema, cfg)
        self.fields = tuple(f for group in cfg.flen_groups for f in group)
        slices, start = [], 0
        for group in cfg.flen_groups:
            slices.append((start, start + len(group)))
            start += len(group)
        self.group_slices = tuple(slices)
        dim, m = cfg.embedding_dim, len(cfg.flen_groups)
        self.tables = self.uniform_tables(self.fields, dim, "emb", generator)
        self.linear = self.uniform_tables(self.fields, 1, "linear", generator)
        self.dense_linear = self.dense(schema.num_dense, 1, generator)
        self.r_intra = nn.Parameter(torch.ones(m))
        self.r_inter = nn.Parameter(torch.ones(m * (m - 1) // 2))
        self.MLPTower_0 = _tower(cfg, schema.num_dense + len(self.fields) * dim, generator)
        self.final = self.dense(1 + dim + self.MLPTower_0.out_features, 1, generator)

    def forward(self, batch: Batch):
        dense = self.dense_input(batch)
        emb = _stack(self.tables, self.fields, batch)
        h_s = _linear(self.linear, self.fields, batch) + self.dense_linear(dense)
        h_fwbi = fm.flen_field_wise_bi_interaction(emb, self.group_slices, self.r_intra,
                                                   self.r_inter)
        h_mlp = self.MLPTower_0(torch.cat([dense, emb.flatten(1)], dim=-1))
        return single_task_output(self.final(torch.cat([h_s, h_fwbi, h_mlp], dim=-1)))
