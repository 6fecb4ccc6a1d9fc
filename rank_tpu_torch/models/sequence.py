"""Behaviour-sequence models: DIN (port of ``rank_tpu/models/sequence.py``).

DIN — ``algorithm/DIN/din.py:225-323``: concat(dense, 6 cat embs, target
feedid emb, DIN-attention-pooled history) -> tower with Dice/PReLU
(Linear -> activation -> BN -> dropout, din.py:272-284 ordering) ->
output; optional mini-batch-aware L2 on the embedding activations
(din.py:317-322) returned as aux_loss. BST and DIEN wait for later slices.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..features import FeatureSchema
from ..ops.attention import DINAttention
from ..ops.mlp import MLPTower
from .base import Batch, ModelConfig, RankModel, single_task_output


class DIN(RankModel):
    def __init__(
        self,
        schema: FeatureSchema,
        cfg: ModelConfig,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__(schema, cfg)
        self.tables = self.embedding_collection(generator)
        dim = schema.categorical_feature("feedid").emb_dim
        self.attention = DINAttention(
            dim,
            use_softmax=cfg.use_softmax,
            backend=cfg.kernel_backend,
            dense_init=cfg.dense_init,
            generator=generator,
        )
        width = schema.num_dense + sum(self.tower_field_dims()) + 2 * dim
        self.fcn = MLPTower(
            width,
            cfg.hidden_units,
            activation=cfg.activation,
            batch_norm=cfg.batch_norm,
            dropout_rate=cfg.dropout_rate,
            order="act_bn",  # DIN ordering: Linear -> Dice -> BN -> Dropout
            dense_init=cfg.dense_init,
            generator=generator,
        )
        self.output = self.dense(self.fcn.out_features, 1, generator)

    def forward(self, batch: Batch):
        cfg = self.cfg
        field_embs = self.tower_field_embeddings(self.tables, batch)
        target_emb = self.tables.lookup("feedid", batch["feedid"])  # (B, 16)
        seq = batch[cfg.seq_feature]
        lengths = batch[cfg.seq_feature + "_length"]
        seq_emb = self.tables.lookup(cfg.seq_feature, seq)  # (B, T, 16)
        att_out = self.attention(target_emb, seq_emb, lengths)
        x = torch.cat([self.dense_input(batch)] + field_embs + [target_emb, att_out], dim=-1)
        logit = self.output(self.fcn(x))

        aux = 0.0
        if cfg.mini_batch_aware_regularization and cfg.l2_lambda > 0:
            emb_vars = torch.cat(field_embs + [target_emb, att_out], dim=-1)
            aux = cfg.l2_lambda * torch.mean(
                torch.linalg.vector_norm(emb_vars, dim=-1)
            )  # din.py:321-322
        return single_task_output(logit, aux)
