"""Checkpoints with the reference's selection semantics (port of
``rank_tpu/train/checkpoint.py``), written with ``torch.save``.

  * ``best_model``: the model's ``state_dict``, saved whenever eval AUC
    improves and reloaded before the predictions are exported;
  * ``checkpoint_epoch_N``: the model, the optimizer, the step, the epoch
    and the random generators' states, every ``save_checkpoints_steps``
    epochs, with the metrics in a JSON sidecar
    ``checkpoint_epoch_N_metrics.json``; ``--resume`` restores the latest.
    GradNorm's state (``mtl``: weights, initial losses) and PCGrad's
    generator go with it, as the JAX package saves its whole state.

A training state is the dict ``Trainer.init_state`` returns: ``model``,
``optimizer`` and ``step``, and ``mtl`` or ``pcgrad_generator`` under
those task weightings.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch


def _rng_states() -> Dict[str, Any]:
    states = {"cpu": torch.get_rng_state()}
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        states["cuda"] = torch.cuda.get_rng_state_all()
    return states


def _set_rng_states(states: Dict[str, Any]) -> None:
    torch.set_rng_state(states["cpu"])
    if "cuda" in states and torch.cuda.is_available():
        torch.cuda.set_rng_state_all(states["cuda"])


def _device_of(state: Dict[str, Any]) -> torch.device:
    return next(state["model"].parameters()).device


class CheckpointManager:
    def __init__(self, model_dir: str):
        self.model_dir = os.path.abspath(model_dir)

    def _path(self, name: str) -> str:
        return os.path.join(self.model_dir, name)

    def _save_path(self, name: str) -> str:
        os.makedirs(self.model_dir, exist_ok=True)
        return self._path(name)

    # -- best model (the model's state only, like best_model.pth) ----------

    def save_best(self, state: Dict[str, Any]) -> None:
        torch.save(state["model"].state_dict(), self._save_path("best_model"))

    def load_best_state_dict(self, device) -> Dict[str, torch.Tensor]:
        return torch.load(self._path("best_model"), map_location=device, weights_only=True)

    def restore_best(self, state: Dict[str, Any]) -> Dict[str, Any]:
        state["model"].load_state_dict(self.load_best_state_dict(_device_of(state)))
        return state

    def has_best(self) -> bool:
        return os.path.exists(self._path("best_model"))

    # -- full checkpoints (resume) ------------------------------------------

    def save_epoch(self, state: Dict[str, Any], epoch: int, metrics: Dict[str, float]) -> None:
        payload = {
            "model": state["model"].state_dict(),
            "optimizer": state["optimizer"].state_dict(),
            "step": int(state["step"]),
            "epoch": int(epoch),
            "rng": _rng_states(),
        }
        if "mtl" in state:
            payload["mtl"] = state["mtl"]
        if "pcgrad_generator" in state:
            payload["pcgrad_generator"] = state["pcgrad_generator"].get_state()
        torch.save(payload, self._save_path(f"checkpoint_epoch_{epoch}"))
        with open(self._path(f"checkpoint_epoch_{epoch}_metrics.json"), "w") as f:
            json.dump({k: float(v) for k, v in metrics.items()}, f)

    def epoch_metrics(self, epoch: int) -> Dict[str, float]:
        path = self._path(f"checkpoint_epoch_{epoch}_metrics.json")
        if not os.path.exists(path):
            return {}
        with open(path) as f:
            return json.load(f)

    def latest_epoch(self) -> Optional[int]:
        if not os.path.isdir(self.model_dir):
            return None
        epochs = []
        for d in os.listdir(self.model_dir):
            if d.startswith("checkpoint_epoch_"):
                try:
                    epochs.append(int(d.rsplit("_", 1)[1]))
                except ValueError:
                    pass
        return max(epochs) if epochs else None

    def restore_epoch(self, state: Dict[str, Any], epoch: int) -> Tuple[Dict[str, Any], int]:
        payload = torch.load(
            self._path(f"checkpoint_epoch_{epoch}"), map_location=_device_of(state),
            weights_only=True,
        )
        state["model"].load_state_dict(payload["model"])
        state["optimizer"].load_state_dict(payload["optimizer"])
        state["step"] = payload["step"]
        if "mtl" in state:
            state["mtl"] = payload["mtl"]
        if "pcgrad_generator" in state:
            state["pcgrad_generator"].set_state(payload["pcgrad_generator"])
        _set_rng_states(payload["rng"])
        return state, payload["epoch"]


def export_predictions(
    output_dir: str,
    labels: np.ndarray,
    probabilities: np.ndarray,
    label_name: str = "read_comment",
    extra_columns: Optional[Dict[str, np.ndarray]] = None,
) -> str:
    """predictions.csv with label and probability columns; ``extra_columns``
    go first (FwFM's variant adds ids)."""
    os.makedirs(output_dir, exist_ok=True)
    path = os.path.join(output_dir, "predictions.csv")
    cols = {label_name: labels, "probability": probabilities}
    if extra_columns:
        cols = {**extra_columns, **cols}
    names = list(cols)
    with open(path, "w") as f:
        f.write(",".join(names) + "\n")
        arrays = [np.asarray(cols[n]) for n in names]
        for row in zip(*arrays):
            f.write(",".join(str(x) for x in row) + "\n")
    return path
