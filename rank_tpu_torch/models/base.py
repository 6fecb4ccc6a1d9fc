"""Shared model plumbing: the config dataclass and common feature assembly
(port of ``rank_tpu/models/base.py``).

``ModelConfig`` is the JAX package's, field for field and default for
default, so one config names the same model on both sides. Every model is
ported; two fields are carried and ignored: ``attn_impl`` (three TPU
formulations of one function, which the port computes once) and
``gru_unroll`` (a ``lax.scan`` unroll factor). The port adds one field of
its own, ``cuda_graphs``, which changes how it dispatches DIEN's training
step and no number.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import torch
from torch import nn

from ..embedding.collection import INITIALIZERS, EmbeddingCollection
from ..embedding.sharded import TableEmbedding
from ..features import FeatureSchema
from ..ops.mlp import dense_layer

Batch = Dict[str, torch.Tensor]

# Field sets used by the reference models:
# DeepFM/FwFM: 6 cat incl. feedid, no tags (deepfm.py:42-44, fwfm.py:30)
FM_FIELDS = ("userid", "feedid", "device", "authorid", "bgm_song_id", "bgm_singer_id")
# AFM: 7 cat incl. feedid and manual_tag_list (afm.py:132-134)
AFM_FIELDS = FM_FIELDS + ("manual_tag_list",)
# DCN/DeepCrossing/DIN/BST: 6 cat with tags, no feedid (dcn.py:80-82)
TOWER_FIELDS = ("userid", "device", "authorid", "bgm_song_id", "bgm_singer_id", "manual_tag_list")


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Union of every model's hyperparameters; unused fields are ignored.

    Defaults are each reference model's best-AUC settings (BASELINE.md).
    The comments on each field are in ``rank_tpu/models/base.py``.
    """

    name: str = "deepfm"
    # tower (shared)
    hidden_units: Tuple[int, ...] = (512, 256, 128)
    dropout_rate: float = 0.1
    batch_norm: bool = True
    # uniform-dim embedding models (DeepFM/FwFM/AFM/FFM/PNN/xDeepFM/FiBiNet)
    embedding_dim: int = 16
    embedding_init: str = "normal"
    # dense-layer init family: 'lecun' (flax default) or 'torch'
    dense_init: str = "lecun"
    # DIN
    activation: str = "dice"
    use_softmax: bool = True
    l2_lambda: float = 0.2
    mini_batch_aware_regularization: bool = False
    # DCN
    num_cross_layers: int = 3
    cross_frozen_random: bool = False
    # DeepCrossing
    residual_internal_dim: int = 256
    num_residual_units: int = 2
    # AFM
    attention_factor: int = 64
    # BST
    num_heads: int = 2
    num_transformer_blocks: int = 2
    pooling_method: str = "mean"  # sum | mean
    transformer_dtype: str = "bfloat16"
    transformer_score_dtype: str = "bfloat16"
    attn_impl: str = "vpu"
    # xDeepFM
    cin_layer_sizes: Tuple[int, ...] = (128, 128)
    # FiBiNet
    bilinear_type: str = "interaction"
    senet_reduction: int = 3
    # AutoInt
    autoint_layers: int = 3
    autoint_heads: int = 2
    autoint_att_dim: int = 32
    # PNN
    pnn_mode: str = "inner"  # inner | outer | both
    # FLEN field groups
    flen_groups: Tuple[Tuple[str, ...], ...] = (
        ("userid", "device"),
        ("feedid", "authorid", "bgm_song_id", "bgm_singer_id"),
        ("manual_tag_list",),
    )
    outer_outputs: int = 64
    # DIEN
    gru_hidden_dim: int = 16
    use_aux_loss: bool = False
    aux_loss_weight: float = 1.0
    gru_unroll: int = 5
    # the port's own: DIEN trains on the card from CUDA graphs, stage by
    # stage (models/sequence.py, utils/graphs.py); off by default, since
    # each new batch shape (a ragged last batch) costs a capture and keeps
    # its graphs' memory
    cuda_graphs: bool = False
    # multi-task (ESMM/MMOE/PLE)
    tasks: Tuple[str, ...] = ("read_comment", "like", "click_avatar")
    task_weighting: str = "sum"
    gradnorm_alpha: float = 1.5
    gradnorm_lr: float = 0.025
    num_experts: int = 4
    expert_units: Tuple[int, ...] = (256, 128)
    tower_units: Tuple[int, ...] = (64,)
    # PLE
    num_levels: int = 2
    specific_experts_per_task: int = 2
    shared_experts: int = 2
    # multi-hot tags: mean-pool the tag sequence instead of the reference's
    # scalar manual_tag_list lookup
    multihot_tags: bool = True
    # sequence feature used by DIN/BST/DIEN
    seq_feature: str = "his_read_comment_7d_seq"
    # embedding lookup schedule on a table-sharded mesh: gspmd | psum |
    # alltoall (embedding/collection.py)
    embedding_mode: str = "gspmd"
    # DIN attention and xDeepFM's CIN: 'auto' runs the CUDA kernel on the
    # card and the plain version on the CPU; 'pallas' asks for the kernel,
    # 'jnp' for the plain version (ops/attention.py, ops/cin.py)
    kernel_backend: str = "auto"

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


PORT_ONLY_FIELDS = ("cuda_graphs",)


def jax_fields(cfg: ModelConfig) -> dict:
    """``cfg``'s fields that the JAX package's ``ModelConfig`` has too."""
    return {k: v for k, v in dataclasses.asdict(cfg).items() if k not in PORT_ONLY_FIELDS}


class RankModel(nn.Module):
    """Base: every model takes the full batch and returns an output dict
    {"logits": (B,), "aux_loss": scalar}."""

    def __init__(self, schema: FeatureSchema, cfg: ModelConfig):
        super().__init__()
        self.schema = schema
        self.cfg = cfg

    def embedding_collection(
        self,
        generator: Optional[torch.Generator],
        features: Optional[Sequence[str]] = None,
    ) -> EmbeddingCollection:
        """The collection, named ``tables`` by the caller; ``features`` are
        the ones the model looks up (every table when None)."""
        return EmbeddingCollection(
            self.schema, self.cfg.embedding_init, mode=self.cfg.embedding_mode,
            generator=generator, features=features,
        )

    def dense_input(self, batch: Batch) -> torch.Tensor:
        return batch["dense"]

    def dense(self, fan_in: int, features: int, generator: Optional[torch.Generator]) -> nn.Linear:
        """nn.Linear honouring ``cfg.dense_init`` (ops/mlp.py)."""
        return dense_layer(fan_in, features, self.cfg.dense_init, generator)

    def uniform_tables(
        self,
        fields: Sequence[str],
        dim: int,
        prefix: str,
        generator: Optional[torch.Generator],
    ) -> Dict[str, TableEmbedding]:
        """One table of width ``dim`` per field (FM-family models), drawn
        with ``cfg.embedding_init`` and registered as ``{prefix}_{field}``,
        the flax module name. On a table-sharded mesh they look up through
        the ``'psum'`` schedule under every ``embedding_mode``, as JAX
        leaves them to GSPMD (``embedding/collection.py``)."""
        init = INITIALIZERS[self.cfg.embedding_init]
        tables = {}
        for name in fields:
            vocab = self.schema.categorical_feature(name).vocab_size
            table = TableEmbedding.create(init(torch.empty(vocab, dim), generator), name)
            self.add_module(f"{prefix}_{name}", table)
            tables[name] = table
        return tables

    def tower_field_dims(self) -> List[int]:
        """Widths of ``tower_field_embeddings``' outputs, in order."""
        return [self.schema.categorical_feature(name).emb_dim for name in TOWER_FIELDS]

    def tower_field_embeddings(
        self, collection: EmbeddingCollection, batch: Batch
    ) -> List[torch.Tensor]:
        """Per-field-dim embeddings for the 6 tower fields, with optional
        multi-hot tag pooling (mean over valid tags)."""
        outs = []
        for name in TOWER_FIELDS:
            if name == "manual_tag_list" and self.cfg.multihot_tags:
                seq = batch["manual_tag_seq"]  # (B, T)
                emb = collection.lookup("manual_tag_seq", seq)  # (B, T, D)
                mask = (seq > 0)[..., None].to(emb.dtype)
                # mean over non-OOV tags: denominator counts the same tags
                # the numerator keeps (an OOV tag id 0 contributes nothing)
                denom = torch.clamp_min(torch.sum(mask, dim=1), 1.0)
                outs.append(torch.sum(emb * mask, dim=1) / denom)
            else:
                outs.append(collection.lookup(name, batch[name]))
        return outs


def single_task_output(logits: torch.Tensor, aux_loss=0.0) -> Dict:
    return {
        "logits": logits.reshape(-1),
        "aux_loss": torch.as_tensor(aux_loss, dtype=torch.float32, device=logits.device),
    }
