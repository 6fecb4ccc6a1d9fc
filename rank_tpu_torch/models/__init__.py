from .base import ModelConfig, RankModel
from .registry import DEFAULT_CONFIGS, MODEL_CLASSES, build_model, default_config

__all__ = [
    "ModelConfig",
    "RankModel",
    "DEFAULT_CONFIGS",
    "MODEL_CLASSES",
    "build_model",
    "default_config",
]
