"""Config-driven train/eval loop, single-task path (port of ``rank_tpu/train/loop.py``).

  * loss: BCE-with-logits weighted by ``_valid`` (padding rows add nothing),
    plus the model's ``aux_loss``;
  * optimizer: ``torch.optim.Adam(lr, betas=(0.9, 0.999), eps=1e-8)`` over
    every parameter, embedding tables included with dense gradients, as
    ``optax.adam`` is applied in the JAX package; optional clipping by
    global norm with optax's formula, ``g * c / max(|g|, c)``;
  * meters (loss, accuracy counts, the streaming-AUC histograms) stay on
    the device and the host reads them once an epoch (and at each log
    line);
  * eval keeps predictions on the device and computes the exact AUC there,
    then fetches predictions, labels and the ``_valid`` mask once.

A training state is a dict: ``model``, ``optimizer`` and ``step``. The loop
updates it in place and returns it, so callers read as the JAX CLI does.

Not ported yet, and raising when asked for: the multi-task branches
(``ROADMAP.md`` slice 5) with ``task_weighting`` pcgrad/gradnorm, the
table-sharded mesh with its vocab padding (``depad_state``/``repad_state``,
``table_parallelism > 1``; ROADMAP A13), ``matmul_precision`` and
``profile_dir`` (ROADMAP A14).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, Iterable, Mapping, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..features import FeatureSchema
from ..models import MULTI_TASK_MODELS, ModelConfig, build_model
from ..models.registry import resolve_device
from . import metrics as M

State = Dict[str, Any]


@dataclasses.dataclass
class TrainConfig:
    """The JAX package's fields and defaults (reference CLI names)."""

    model_dir: str = "./model_dir"
    output_dir: str = "./output_dir"
    num_epochs: int = 1
    batch_size: int = 1024
    learning_rate: float = 0.005
    save_checkpoints_steps: int = 1000  # epochs, as in the reference
    seed: int = 42
    label: str = "read_comment"
    table_parallelism: int = 1
    log_every: int = 100
    profile_dir: Optional[str] = None
    min_rows_to_shard: int = 1024
    matmul_precision: Optional[str] = None
    # global-norm gradient clipping; 0 disables (the reference trains unclipped)
    gradient_clip_norm: float = 0.0


def _labels_for(model_cfg: ModelConfig, train_cfg: TrainConfig, schema: FeatureSchema):
    """task name -> column index into the (B, 7) label matrix."""
    cols = {name: i for i, name in enumerate(schema.labels)}
    if model_cfg.name in MULTI_TASK_MODELS:
        return {t: cols[t] for t in model_cfg.tasks}
    return {train_cfg.label: cols[train_cfg.label]}


def make_loss_fn(model_cfg: ModelConfig, label_cols: Mapping[str, int]) -> Callable:
    """``loss_fn(out, batch) -> (loss, {task: probs})`` for the model output
    ``out`` on ``batch``: the single-task branch of the JAX ``make_loss_fn``."""
    if model_cfg.name in MULTI_TASK_MODELS:
        raise NotImplementedError(
            f"multi-task training ({model_cfg.name!r}) is not ported yet (ROADMAP slice 5)"
        )
    ((task, col),) = label_cols.items()

    def loss_fn(out: Mapping[str, torch.Tensor], batch: Mapping[str, torch.Tensor]):
        logit = out["logits"]
        y = batch["labels"][:, col]
        valid = batch.get("_valid")
        if valid is None:
            valid = torch.ones_like(y)
        denom = torch.clamp_min(valid.sum(), 1.0)
        ll = F.binary_cross_entropy_with_logits(logit, y, reduction="none")
        total = (ll * valid).sum() / denom + out["aux_loss"]
        return total, {task: torch.sigmoid(logit)}

    return loss_fn


def clip_by_global_norm_(grads, max_norm: float) -> None:
    """optax's ``clip_by_global_norm``, in place: every gradient times
    ``max_norm / |g|`` when the global norm ``|g|`` reaches ``max_norm``."""
    norm = torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(g) for g in grads]))
    keep = norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, g / norm * max_norm))


class Trainer:
    def __init__(
        self,
        schema: FeatureSchema,
        model_cfg: ModelConfig,
        train_cfg: TrainConfig = TrainConfig(),
        device="cuda",
    ):
        if train_cfg.table_parallelism > 1:
            raise NotImplementedError(
                "table_parallelism > 1 (the table-sharded mesh) is not ported yet (ROADMAP A13)"
            )
        if train_cfg.matmul_precision is not None:
            raise NotImplementedError("matmul_precision is not ported yet (ROADMAP A14)")
        if train_cfg.profile_dir is not None:
            raise NotImplementedError("profile_dir is not ported yet (ROADMAP A14)")
        if model_cfg.task_weighting in ("pcgrad", "gradnorm"):
            raise NotImplementedError(
                f"task_weighting={model_cfg.task_weighting!r} is not ported yet (ROADMAP slice 5)"
            )
        self.device = resolve_device(device)
        self.schema = schema
        self.model_cfg = model_cfg
        self.cfg = train_cfg
        self.label_cols = _labels_for(model_cfg, train_cfg, schema)
        self.loss_fn = make_loss_fn(model_cfg, self.label_cols)

    # -- state ---------------------------------------------------------------

    def init_state(self) -> State:
        """The model, drawn from a generator seeded with ``cfg.seed``, and
        its optimizer. Dropout draws from torch's default generators,
        seeded here with ``cfg.seed + 1`` (the JAX trainer's dropout key)."""
        generator = torch.Generator().manual_seed(self.cfg.seed)
        model = build_model(self.schema, self.model_cfg, device=self.device, generator=generator)
        torch.manual_seed(self.cfg.seed + 1)
        optimizer = torch.optim.Adam(
            model.parameters(), lr=self.cfg.learning_rate, betas=(0.9, 0.999), eps=1e-8
        )
        return {"model": model, "optimizer": optimizer, "step": 0}

    def to_device(self, batch: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
        return {k: torch.as_tensor(v).to(self.device, non_blocking=True) for k, v in batch.items()}

    # -- steps ---------------------------------------------------------------

    def meters_init(self) -> Dict[str, torch.Tensor]:
        meters = M.auc_state_init(device=self.device)
        for name in ("loss", "correct", "count", "steps"):
            meters[name] = torch.zeros((), device=self.device)
        return meters

    def _primary(self, batch):
        task = next(iter(self.label_cols))
        return task, batch["labels"][:, self.label_cols[task]]

    def train_step(self, state: State, meters: Dict[str, torch.Tensor], batch) -> None:
        """One optimizer step on a device batch; folds its metrics into
        ``meters`` on the device. The parameters' ``.grad`` hold this step's
        gradients afterwards."""
        model, optimizer = state["model"], state["optimizer"]
        model.train()
        loss, probs = self.loss_fn(model(batch), batch)
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        if self.cfg.gradient_clip_norm > 0:
            grads = [p.grad for p in model.parameters() if p.grad is not None]
            clip_by_global_norm_(grads, self.cfg.gradient_clip_norm)
        optimizer.step()
        state["step"] += 1
        with torch.no_grad():
            task, y = self._primary(batch)
            valid = batch.get("_valid")
            M.auc_state_update_(meters, probs[task], y, valid)
            correct, count = M.binary_accuracy(probs[task], y, valid)
            meters["loss"] += loss.detach()
            meters["correct"] += correct
            meters["count"] += count
            meters["steps"] += 1.0

    # -- epochs --------------------------------------------------------------

    def train_epoch(self, state: State, batches: Iterable[Mapping[str, Any]], epoch: int = 1):
        """One pass over ``batches`` (numpy or device batches). The meters
        stay on the device; the host reads them at each log line and once
        at the end, which is also the timing fence."""
        meters = self.meters_init()
        nsteps = 0
        t0 = time.time()
        for batch in batches:
            self.train_step(state, meters, self.to_device(batch))
            nsteps += 1
            if self.cfg.log_every and nsteps % self.cfg.log_every == 0:
                eps = float(meters["count"]) / max(time.time() - t0, 1e-9)
                print(
                    f"epoch {epoch} step {nsteps}: "
                    f"loss={float(meters['loss']) / nsteps:.4f} "
                    f"examples/s={eps:,.0f}"
                )
        loss_sum, correct, count, auc = (
            float(x) for x in torch.stack([
                meters["loss"], meters["correct"], meters["count"], M.auc_state_result(meters)
            ]).cpu()
        )
        dt = time.time() - t0
        out = {
            "loss": loss_sum / max(nsteps, 1),
            "accuracy": correct / max(count, 1),
            "auc": auc,
            "count": count,  # _valid rows trained this epoch
            "examples_per_s": count / max(dt, 1e-9),
        }
        if not np.isfinite(out["loss"]):
            raise FloatingPointError(
                f"non-finite training loss at epoch {epoch} "
                f"(loss={out['loss']}); the last good checkpoint can be "
                "resumed with --resume=true; consider --gradient_clip_norm"
            )
        print(
            f"Epoch {epoch}, Train Loss: {out['loss']:.4f}, "
            f"Train Accuracy: {out['accuracy']:.4f}, Train AUC: {out['auc']:.4f} "
            f"({out['examples_per_s']:,.0f} examples/s)"
        )
        return state, out

    def evaluate(self, state: State, batches: Iterable[Mapping[str, Any]], epoch: int = 1):
        """Full eval pass: loss, accuracy and the exact AUC per task, all
        computed on the device; predictions, labels and ``_valid`` come to
        the host once, at the end."""
        model = state["model"]
        model.eval()
        loss_acc = torch.zeros((), device=self.device)
        nsteps = 0
        probs_dev: Dict[str, list] = {}
        labels_dev, valid_dev = [], []
        with torch.no_grad():
            for batch in batches:
                batch = self.to_device(batch)
                loss, probs = self.loss_fn(model(batch), batch)
                loss_acc += loss
                nsteps += 1
                for k, v in probs.items():
                    probs_dev.setdefault(k, []).append(v)
                labels_dev.append(batch["labels"])
                valid_dev.append(batch["_valid"])
            labels = torch.cat(labels_dev)
            valid = torch.cat(valid_dev)
            preds = {k: torch.cat(v) for k, v in probs_dev.items()}
            task_aucs = {
                task: M.exact_auc(p, labels[:, self.label_cols[task]], valid)
                for task, p in preds.items()
            }
            primary = next(iter(self.label_cols))
            correct, count = M.binary_accuracy(
                preds[primary], labels[:, self.label_cols[primary]], valid
            )
            accuracy = correct / torch.clamp_min(count, 1.0)
        out = {
            "loss": float(loss_acc) / max(nsteps, 1),
            "accuracy": float(accuracy),
            "auc": float(task_aucs[primary]),
            "task_aucs": {k: float(v) for k, v in task_aucs.items()},
            "predictions": {k: v.cpu().numpy() for k, v in preds.items()},
            "labels": labels.cpu().numpy(),
            "valid": valid.cpu().numpy(),
        }
        print(
            f"Epoch {epoch}, Eval Loss: {out['loss']:.4f}, "
            f"Eval Accuracy: {out['accuracy']:.4f}, Eval AUC: {out['auc']:.4f}"
            + (f", task AUCs: {out['task_aucs']}" if len(task_aucs) > 1 else "")
        )
        return out
