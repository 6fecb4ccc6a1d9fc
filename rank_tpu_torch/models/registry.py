"""Model registry (port of ``rank_tpu/models/registry.py``).

``DEFAULT_CONFIGS`` is the JAX package's, whole: each reference model's
best-AUC hyperparameters (BASELINE.md). ``MODEL_CLASSES`` holds all 18
models of the JAX registry: the 15 single-task models and the multi-task
ESMM, MMOE and PLE (``MULTI_TASK_MODELS``).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Type

import torch

from ..embedding.sharded import shard_tables_
from ..features import FeatureSchema
from ..ops.activations import BatchNorm
from ..parallel.mesh import DATA_AXIS, Mesh
from .base import ModelConfig, RankModel
from .cross_family import DCN, AutoInt, DeepCrossing, FiBiNet, XDeepFM
from .fm_family import AFM, FFM, FLEN, PNN, DeepFM, FwFM, WideDeep
from .multitask import ESMM, MMOE, PLE
from .sequence import BST, DIEN, DIN

MODEL_CLASSES: Dict[str, Type[RankModel]] = {
    "ffm": FFM,
    "deepcrossing": DeepCrossing,
    "pnn": PNN,
    "widedeep": WideDeep,
    "deepfm": DeepFM,
    "dcn": DCN,
    "afm": AFM,
    "xdeepfm": XDeepFM,
    "fwfm": FwFM,
    "din": DIN,
    "dien": DIEN,
    "fibinet": FiBiNet,
    "autoint": AutoInt,
    "flen": FLEN,
    "bst": BST,
    "esmm": ESMM,
    "mmoe": MMOE,
    "ple": PLE,
}

MULTI_TASK_MODELS = {"esmm", "mmoe", "ple"}

# Best-AUC hyperparameters from each model's result.md sweep (BASELINE.md).
DEFAULT_CONFIGS: Dict[str, ModelConfig] = {
    "deepfm": ModelConfig(name="deepfm", embedding_dim=16),
    "fwfm": ModelConfig(name="fwfm", embedding_dim=16),
    "ffm": ModelConfig(name="ffm", embedding_dim=8),
    "afm": ModelConfig(name="afm", embedding_dim=32, attention_factor=64),
    "pnn": ModelConfig(name="pnn", embedding_dim=16, pnn_mode="inner"),
    "widedeep": ModelConfig(name="widedeep"),
    "dcn": ModelConfig(name="dcn", num_cross_layers=3, hidden_units=(512, 256, 128)),
    "deepcrossing": ModelConfig(
        name="deepcrossing", residual_internal_dim=256, num_residual_units=2
    ),
    "xdeepfm": ModelConfig(name="xdeepfm", embedding_dim=16, cin_layer_sizes=(128, 128)),
    "fibinet": ModelConfig(name="fibinet", embedding_dim=16),
    "autoint": ModelConfig(name="autoint", embedding_dim=16),
    "flen": ModelConfig(name="flen", embedding_dim=16),
    "din": ModelConfig(
        name="din", activation="dice", use_softmax=True,
        mini_batch_aware_regularization=False,
    ),
    "bst": ModelConfig(
        name="bst", num_transformer_blocks=2, num_heads=2, pooling_method="mean"
    ),
    "dien": ModelConfig(name="dien", gru_hidden_dim=16, activation="prelu"),
    "esmm": ModelConfig(name="esmm", tasks=("read_comment", "like")),
    "mmoe": ModelConfig(name="mmoe"),
    "ple": ModelConfig(name="ple"),
}


def default_config(name: str, **overrides) -> ModelConfig:
    cfg = DEFAULT_CONFIGS[name]
    return cfg.replace(**overrides) if overrides else cfg


def resolve_device(device) -> torch.device:
    """``device`` as a torch.device; raises for a CUDA device when there is
    none, rather than carrying on on the CPU."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU"
        )
    return device


def build_model(
    schema: FeatureSchema,
    cfg: ModelConfig,
    device="cuda",
    generator: Optional[torch.Generator] = None,
    mesh: Optional[Mesh] = None,
    sharded_tables: Sequence[str] = (),
) -> RankModel:
    """Build ``cfg.name`` with weights drawn from ``generator`` (seed 0 when
    None) on the CPU, then move it to ``device``.

    On a ``mesh``, every table of a feature in ``sharded_tables`` is padded
    with zero rows to a multiple of the table axis and keeps this rank's
    rows (``embedding/sharded.py:shard_tables_``), after the whole model is
    drawn: a table-sharded model starts from the weights of the unsharded
    one. With more than one data rank, BatchNorm takes its statistics over
    the global batch (``ops/activations.py``)."""
    device = resolve_device(device)
    if cfg.name not in MODEL_CLASSES:
        raise ValueError(
            f"unknown model {cfg.name!r}; available: {sorted(DEFAULT_CONFIGS)}"
        )
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    model = MODEL_CLASSES[cfg.name](schema, cfg, generator=generator)
    if mesh is not None:
        shard_tables_(model, mesh, sharded_tables)
        if mesh.shape[DATA_AXIS] > 1:
            for module in model.modules():
                if isinstance(module, BatchNorm):
                    module.mesh = mesh
    return model.to(device)
