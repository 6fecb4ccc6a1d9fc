"""Behaviour-sequence models: DIN, BST and DIEN (port of
``rank_tpu/models/sequence.py``).

  * DIN (``din.py:225-323``): concat(dense, 6 cat embs, target feedid emb,
    DIN-attention-pooled history) -> tower with Dice/PReLU (Linear ->
    activation -> BN -> dropout, din.py:272-284 ordering) -> output;
    optional mini-batch-aware L2 on the embedding activations
    (din.py:317-322) returned as aux_loss.
  * BST (``bst.py:162-247``, in the BST paper's form): the history with
    the target item appended as position T (T + 1 = 51 at full width)
    through the transformer blocks, mean or sum pooled over the valid
    positions, concatenated with dense and cat embeddings into a
    LeakyReLU ``bn_act`` tower whose last layer is the logit
    (``dnn/Dense_{len(hidden_units)}``).
  * DIEN (``dien.py:166-353``): a GRU over the history, bilinear attention
    against the target, an AUGRU whose final state goes into the tower;
    optionally the auxiliary next-item loss with in-batch negatives
    (``use_aux_loss``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..features import FeatureSchema
from ..ops.attention import BilinearAttention, DINAttention
from ..ops.mlp import MLPTower, dense_layer
from ..ops.rnn import AttentionalGRU
from ..ops.transformer import BSTTransformerBlock
from ..utils import graphs
from .base import TOWER_FIELDS, Batch, ModelConfig, RankModel, single_task_output


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


class BST(RankModel):
    """Modules: ``tables``, ``transformer_{i}`` and ``dnn``."""

    def __init__(self, schema: FeatureSchema, cfg: ModelConfig,
                 generator: Optional[torch.Generator] = None):
        super().__init__(schema, cfg)
        if cfg.pooling_method not in ("sum", "mean"):
            raise ValueError(f"unknown pooling_method {cfg.pooling_method!r}")
        self.tables = self.embedding_collection(generator)
        seq = schema.sequence_feature(cfg.seq_feature)
        dim = seq.emb_dim
        for i in range(cfg.num_transformer_blocks):
            self.add_module(f"transformer_{i}", BSTTransformerBlock(
                dim, cfg.num_heads, seq.max_len + 1, dropout_rate=cfg.dropout_rate,
                compute_dtype=cfg.transformer_dtype, attn_impl=cfg.attn_impl,
                score_dtype=cfg.transformer_score_dtype, dense_init=cfg.dense_init,
                generator=generator))
        self.dnn = MLPTower(
            schema.num_dense + sum(self.tower_field_dims()) + dim,
            cfg.hidden_units,
            activation="leakyrelu",
            batch_norm=cfg.batch_norm,
            dropout_rate=cfg.dropout_rate,
            order="bn_act",  # BST ordering: Linear -> BN -> LeakyReLU -> Dropout
            dense_init=cfg.dense_init,
            generator=generator,
            final_logit=True,
        )

    def forward(self, batch: Batch):
        cfg = self.cfg
        field_embs = self.tower_field_embeddings(self.tables, batch)
        lengths = batch[cfg.seq_feature + "_length"]
        # the target item appended as the last position (paper form)
        full_seq = torch.cat([batch[cfg.seq_feature], batch["feedid"][:, None]], dim=1)
        t = full_seq.shape[1]
        pos = torch.arange(t, device=full_seq.device)[None, :]
        valid = (pos < lengths[:, None]) | (pos == t - 1)  # history + target
        h = self.tables.lookup(cfg.seq_feature, full_seq)  # (B, T+1, D)
        for i in range(cfg.num_transformer_blocks):
            h = getattr(self, f"transformer_{i}")(h, valid)
        valid_f = valid.float()
        pooled = (h * valid_f[..., None]).sum(dim=1)
        if cfg.pooling_method == "mean":  # over the valid positions
            pooled = pooled / torch.clamp_min(valid_f.sum(dim=1, keepdim=True), 1.0)
        x = torch.cat([self.dense_input(batch)] + field_embs + [pooled], dim=-1)
        return single_task_output(self.dnn(x))


class DIEN(RankModel):
    """Modules: ``tables``, ``interest_extractor``, ``attention``,
    ``interest_evolution``, ``fcn``, ``output`` and, with ``use_aux_loss``
    and ``gru_hidden_dim`` other than the embedding width, ``aux_proj``
    (flax's default Dense init, whatever ``dense_init`` says, as in the JAX
    model).

    On the card both recurrences run as sequence kernels, one launch a
    direction for all T steps (``ops/rnn.py``, ``gru_sequence``), where
    their loops dispatched about 5,300 of the step's 5,700 kernels at batch
    1024 and T = 50. With ``cuda_graphs`` a training forward on the card
    runs in five stages, each replayed with its backward from CUDA graphs
    (``utils/graphs.py``): the lookups, the GRU, the attention, the AUGRU
    (the two inside their ``rnn.*`` spans) and, without dropout, the
    tower."""

    def __init__(self, schema: FeatureSchema, cfg: ModelConfig,
                 generator: Optional[torch.Generator] = None):
        super().__init__(schema, cfg)
        self.tables = self.embedding_collection(generator)
        dim = schema.sequence_feature(cfg.seq_feature).emb_dim
        target_dim = schema.categorical_feature("feedid").emb_dim
        hidden = cfg.gru_hidden_dim
        self.interest_extractor = AttentionalGRU(dim, hidden, "gru", cfg.gru_unroll, generator,
                                                 cfg.cuda_graphs)
        self.attention = BilinearAttention(target_dim, hidden, generator)
        self.interest_evolution = AttentionalGRU(hidden, hidden, "augru", cfg.gru_unroll,
                                                 generator, cfg.cuda_graphs)
        self.fcn = MLPTower(
            schema.num_dense + sum(self.tower_field_dims()) + target_dim + hidden,
            cfg.hidden_units,
            activation=cfg.activation if cfg.activation != "relu" else "prelu",
            batch_norm=cfg.batch_norm,
            dropout_rate=cfg.dropout_rate,
            order="act_bn",
            dense_init=cfg.dense_init,
            generator=generator,
        )
        self.output = self.dense(self.fcn.out_features, 1, generator)
        if cfg.use_aux_loss and hidden != dim:
            self.aux_proj = dense_layer(dim, hidden, generator=generator)

    def _lookup_keys(self) -> Tuple[str, ...]:
        tags = "manual_tag_seq" if self.cfg.multihot_tags else "manual_tag_list"
        fields = tuple(tags if name == "manual_tag_list" else name for name in TOWER_FIELDS)
        return ("dense",) + fields + ("feedid", self.cfg.seq_feature)

    def _lookups(self, *columns: torch.Tensor):
        """(the dense input and the tower's fields (B, F), the target (B, D),
        the history (B, T, D)) from the columns ``_lookup_keys`` names."""
        batch = dict(zip(self._lookup_keys(), columns))
        head = torch.cat([self.dense_input(batch)]
                         + self.tower_field_embeddings(self.tables, batch), dim=-1)
        return (head, self.tables.lookup("feedid", batch["feedid"]),
                self.tables.lookup(self.cfg.seq_feature, batch[self.cfg.seq_feature]))

    def _attend(self, target_emb, gru_outs, lengths):
        return self.attention(target_emb, gru_outs, lengths)

    def _tower(self, head, target_emb, final_state):
        return self.output(self.fcn(torch.cat([head, target_emb, final_state], dim=-1)))

    def forward(self, batch: Batch):
        cfg = self.cfg
        seq = batch[cfg.seq_feature]
        lengths = batch[cfg.seq_feature + "_length"]
        graphed = cfg.cuda_graphs and graphs.replayable(self, seq)

        def stage(fn, modules, *args, replay=graphed):
            return graphs.call(self, fn, *args, modules=modules) if replay else fn(self, *args)

        head, target_emb, seq_emb = stage(DIEN._lookups, (self.tables,),
                                          *(batch[k] for k in self._lookup_keys()))
        gru_outs, _ = self.interest_extractor(seq_emb, lengths)  # interest extraction
        att_weights = stage(DIEN._attend, (self.attention,), target_emb, gru_outs, lengths)
        _, final_state = self.interest_evolution(gru_outs, lengths, att_weights)
        logit = stage(DIEN._tower, (self.fcn, self.output), head, target_emb, final_state,
                      replay=graphed and cfg.dropout_rate == 0.0)

        aux = 0.0
        if cfg.use_aux_loss:
            # next-item loss (dien.py:256-300): h_t should score e_{t+1} (the
            # positive) above the next row's e_{t+1} (an in-batch negative)
            h_t = gru_outs[:, :-1, :]  # (B, T-1, H)
            pos = seq_emb[:, 1:, :]  # (B, T-1, D)
            neg = torch.roll(pos, 1, dims=0)
            t = seq.shape[1]
            valid = (torch.arange(1, t, device=seq.device)[None, :] < lengths[:, None]).float()
            if h_t.shape[-1] != pos.shape[-1]:
                pos, neg = self.aux_proj(pos), self.aux_proj(neg)
            eps = 1e-7
            ll = (-torch.log(torch.sigmoid((h_t * pos).sum(-1)) + eps)
                  - torch.log(1.0 - torch.sigmoid((h_t * neg).sum(-1)) + eps))
            aux = cfg.aux_loss_weight * (ll * valid).sum() / torch.clamp_min(valid.sum(), 1.0)
        return single_task_output(logit, aux)
