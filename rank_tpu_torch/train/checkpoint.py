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
those task weightings. The ``save_*`` methods also take the tree of state
dicts that ``Trainer.depad_state`` gives (the checkpoint normal form of a
table-sharded run, with each data rank's generators); ``load_into`` puts
a loaded tree back into a live state.

In a process group rank 0 alone writes the files and the metrics sidecar
(``rank_tpu/train/checkpoint.py:66``), and every rank waits at a barrier
before going on, so none reads a file before it is whole.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ..parallel.mesh import barrier, is_writer


def rng_states() -> Dict[str, Any]:
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


def _state_dict(x):
    """A module's or an optimizer's state dict; a state dict as it is."""
    return x.state_dict() if hasattr(x, "state_dict") else x


def load_into(state: Dict[str, Any], tree: Dict[str, Any], data_index: int = 0) -> Dict[str, Any]:
    """Load a checkpoint tree into the live ``state``: the model, and where
    the tree has them the optimizer, the step, GradNorm's state, PCGrad's
    generator and the random generators (data rank ``data_index``'s, where
    the tree holds one set a data rank)."""
    state["model"].load_state_dict(tree["model"])
    if "optimizer" in tree:
        state["optimizer"].load_state_dict(tree["optimizer"])
    if "step" in tree:
        state["step"] = tree["step"]
    if "mtl" in state and "mtl" in tree:
        state["mtl"] = {k: v.to(_device_of(state)) for k, v in tree["mtl"].items()}
    if "pcgrad_generator" in state and "pcgrad_generator" in tree:
        state["pcgrad_generator"].set_state(tree["pcgrad_generator"])
    by_rank = tree.get("rng_by_data_index")
    if by_rank is not None and data_index < len(by_rank):
        _set_rng_states(by_rank[data_index])
    elif "rng" in tree:
        _set_rng_states(tree["rng"])
    return state


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
        if is_writer():
            torch.save(_state_dict(state["model"]), self._save_path("best_model"))
        barrier()

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
            "model": _state_dict(state["model"]),
            "optimizer": _state_dict(state["optimizer"]),
            "step": int(state["step"]),
            "epoch": int(epoch),
            "rng": state["rng"] if "rng" in state else rng_states(),
        }
        if "rng_by_data_index" in state:
            payload["rng_by_data_index"] = state["rng_by_data_index"]
        if "mtl" in state:
            payload["mtl"] = state["mtl"]
        if "pcgrad_generator" in state:
            payload["pcgrad_generator"] = state["pcgrad_generator"].get_state()
        if is_writer():
            torch.save(payload, self._save_path(f"checkpoint_epoch_{epoch}"))
            with open(self._path(f"checkpoint_epoch_{epoch}_metrics.json"), "w") as f:
                json.dump({k: float(v) for k, v in metrics.items()}, f)
        barrier()

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

    def load_epoch(self, epoch: int, device) -> Dict[str, Any]:
        """The ``checkpoint_epoch_N`` tree, tensors on ``device``."""
        return torch.load(self._path(f"checkpoint_epoch_{epoch}"), map_location=device,
                          weights_only=True)

    def restore_epoch(self, state: Dict[str, Any], epoch: int) -> Tuple[Dict[str, Any], int]:
        payload = self.load_epoch(epoch, _device_of(state))
        return load_into(state, payload), payload["epoch"]


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
