"""Inference/serving path (port of ``rank_tpu/serve.py``).

``Predictor`` serves padded request batches from a model in eval mode.
Requests are padded up to the nearest power-of-two bucket (>= min_bucket)
by repeating row 0, so the kernels see a handful of shapes, as the JAX
package's compiled programs do.

Heads, as in the JAX ``apply_fn``: ``{"score"}`` for a single-task model,
``{task}`` (sigmoid of each task's logit) for MMOE and PLE, and ESMM's
``{"ctr", "ctcvr"}`` probabilities.

``model_dir`` is read as the port's CLI writes it: the ``best_model``
state dict (``train/checkpoint.py``). Not ported yet: ``weights_dtype``
and ``export_serving_artifact`` (ROADMAP A10).
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional

import numpy as np
import torch

from .features import FeatureSchema
from .models.base import ModelConfig
from .models.registry import build_model, resolve_device
from .train.checkpoint import CheckpointManager


def _bucket(n: int, min_bucket: int) -> int:
    b = min_bucket
    while b < n:
        b *= 2
    return b


class Predictor:
    def __init__(
        self,
        schema: FeatureSchema,
        model_cfg: ModelConfig,
        model_dir: Optional[str] = None,
        state_dict: Optional[Mapping[str, torch.Tensor]] = None,
        min_bucket: int = 256,
        device="cuda",
    ):
        """``state_dict`` is the port's counterpart of the JAX Predictor's
        ``variables=`` (``interop.state_dict_from_flax`` converts them);
        without it, the best model saved in ``model_dir`` is served."""
        self.device = resolve_device(device)
        if state_dict is None:
            if model_dir is None:
                raise ValueError("need model_dir or state_dict")
            mgr = CheckpointManager(model_dir)
            if not mgr.has_best():
                raise FileNotFoundError(f"no best_model in {mgr.model_dir}")
            state_dict = mgr.load_best_state_dict(self.device)
        self.schema = schema
        self.model_cfg = model_cfg
        self.min_bucket = min_bucket
        self.model = build_model(schema, model_cfg, device=self.device)
        self.model.load_state_dict(state_dict)
        self.model.eval()

    def __call__(self, batch: Mapping[str, np.ndarray]) -> Dict[str, np.ndarray]:
        """batch: loader-layout feature dict (no labels required).
        Returns {head: (N,) probabilities}."""
        n = next(iter(batch.values())).shape[0]
        b = _bucket(n, self.min_bucket)
        padded = {}
        for k, v in batch.items():
            if k in ("labels", "_valid"):
                continue
            v = np.asarray(v)
            if b != n:
                v = np.concatenate([v, np.repeat(v[:1], b - n, axis=0)], axis=0)
            padded[k] = torch.from_numpy(v).to(self.device)
        with torch.inference_mode():
            out = self.model(padded)
            if "probs" in out:
                heads = out["probs"]
            elif isinstance(out["logits"], dict):
                heads = {task: torch.sigmoid(logit) for task, logit in out["logits"].items()}
            else:
                heads = {"score": torch.sigmoid(out["logits"])}
            return {head: p[:n].cpu().numpy() for head, p in heads.items()}
