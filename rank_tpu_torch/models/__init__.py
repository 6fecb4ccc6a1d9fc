from .base import ModelConfig, RankModel
from .registry import (
    DEFAULT_CONFIGS,
    MODEL_CLASSES,
    MULTI_TASK_MODELS,
    build_model,
    default_config,
)

__all__ = [
    "ModelConfig",
    "RankModel",
    "DEFAULT_CONFIGS",
    "MODEL_CLASSES",
    "MULTI_TASK_MODELS",
    "build_model",
    "default_config",
]
