"""rank_tpu_torch — the PyTorch/CUDA port of rank_tpu for NVIDIA Hopper.

A second package beside ``rank_tpu`` (the JAX reference, which stays as
it is). It imports torch and numpy, never JAX, flax or ``rank_tpu``.
Module names mirror ``rank_tpu``'s so each counterpart is easy to find.
Entry points (``build_model``, ``Predictor``, ``load_serving_artifact``,
``train.Trainer`` and the CLI, ``python -m rank_tpu_torch.cli``) run on
the card unless the caller passes ``device="cpu"`` (``--device=cpu``);
with no CUDA device they raise.
"""

from .features import WECHAT_SCHEMA, FeatureSchema, tiny_schema
from .models import ModelConfig, build_model, default_config
from .serve import Predictor, export_serving_artifact, load_serving_artifact

__all__ = [
    "WECHAT_SCHEMA",
    "FeatureSchema",
    "tiny_schema",
    "ModelConfig",
    "build_model",
    "default_config",
    "Predictor",
    "export_serving_artifact",
    "load_serving_artifact",
]
