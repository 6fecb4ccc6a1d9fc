"""Config-driven train/eval loop (port of ``rank_tpu/train/loop.py``).

  * loss: BCE-with-logits weighted by ``_valid`` (padding rows add nothing),
    plus the model's ``aux_loss``. Multi-task models sum one such loss a
    task (MMOE, PLE), with Kendall's exp(-s)*L + s/2 under uncertainty
    weighting; ESMM takes BCE on its clipped probabilities, the CTCVR label
    being the product of the two task labels;
  * ``task_weighting`` pcgrad or gradnorm (MMOE, PLE): one forward pass and
    T backward passes give per-task gradients of every parameter, which
    ``train/mtl.py`` combines into the one gradient the optimizer takes;
  * optimizer: ``torch.optim.Adam(lr, betas=(0.9, 0.999), eps=1e-8)`` over
    every parameter, embedding tables included with dense gradients, as
    ``optax.adam`` is applied in the JAX package; optional clipping by
    global norm with optax's formula, ``g * c / max(|g|, c)``;
  * meters (loss, accuracy counts, the streaming-AUC histograms) stay on
    the device and the host reads them once an epoch (and at each log
    line); they follow the primary head: the first task, or ESMM's ``ctr``;
  * eval keeps predictions on the device and computes the exact AUC of
    every head there, then fetches predictions, labels and the ``_valid``
    mask once.

A training state is a dict: ``model``, ``optimizer`` and ``step``, plus
``mtl`` (GradNorm's weights and initial losses) under gradnorm and
``pcgrad_generator`` (the task orders' generator, seeded ``seed + 2`` as
the JAX trainer's step key) under pcgrad. The loop updates it in place and
returns it, so callers read as the JAX CLI does.

Not ported yet, and raising when asked for: the table-sharded mesh with
its vocab padding (``depad_state``/``repad_state``, ``table_parallelism >
1``; ROADMAP A13), ``matmul_precision`` and ``profile_dir`` (ROADMAP A14).
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
from . import mtl

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


def _mean_bce(logit: torch.Tensor, y: torch.Tensor, valid: torch.Tensor, denom) -> torch.Tensor:
    """BCE-with-logits averaged over the ``_valid`` rows."""
    ll = F.binary_cross_entropy_with_logits(logit, y, reduction="none")
    return (ll * valid).sum() / denom


def _valid_and_denom(batch: Mapping[str, torch.Tensor]):
    valid = batch.get("_valid")
    if valid is None:
        valid = torch.ones_like(batch["labels"][:, 0])
    return valid, torch.clamp_min(valid.sum(), 1.0)


def make_task_losses_fn(model_cfg: ModelConfig, label_cols: Mapping[str, int]) -> Callable:
    """``task_losses_fn(out, batch) -> ((T,) losses, {task: probs})`` for the
    logit-head multi-task models (MMOE, PLE); PCGrad and GradNorm take
    each task's gradient from it. ESMM's CTCVR loss does not split by task."""

    def task_losses_fn(out, batch):
        valid, denom = _valid_and_denom(batch)
        losses, probs = [], {}
        for task in model_cfg.tasks:
            logit = out["logits"][task]
            losses.append(_mean_bce(logit, batch["labels"][:, label_cols[task]], valid, denom))
            probs[task] = torch.sigmoid(logit)
        return torch.stack(losses), probs

    return task_losses_fn


def make_loss_fn(model_cfg: ModelConfig, label_cols: Mapping[str, int]) -> Callable:
    """``loss_fn(out, batch) -> (loss, {head: probs})`` for the model output
    ``out`` on ``batch``: the JAX ``make_loss_fn``'s three branches."""
    tasks = model_cfg.tasks
    task_losses_fn = make_task_losses_fn(model_cfg, label_cols)

    def esmm_loss(out, batch):
        # BCE on probabilities clipped to [eps, 1 - eps], with both log terms
        # written out: torch's binary_cross_entropy clamps each log at -100
        # and does not clip, which differs near 0 and 1
        eps = 1e-7
        valid, denom = _valid_and_denom(batch)
        y_ctr = batch["labels"][:, label_cols[tasks[0]]]
        y_ctcvr = y_ctr * batch["labels"][:, label_cols[tasks[1]]]
        total, probs = 0.0, {}
        for head, y in (("ctr", y_ctr), ("ctcvr", y_ctcvr)):
            p = torch.clamp(out["probs"][head], eps, 1.0 - eps)
            ll = -(y * torch.log(p) + (1 - y) * torch.log(1 - p))
            total = total + (ll * valid).sum() / denom
            probs[head] = p
        return total + out["aux_loss"], probs

    def multi_task_loss(out, batch):
        losses, probs = task_losses_fn(out, batch)
        log_vars = out.get("task_log_vars", {})
        if log_vars:
            # uncertainty weighting (Kendall et al. 2018), s = log sigma^2
            s = torch.stack([log_vars[task] for task in tasks])
            losses = torch.exp(-s) * losses + 0.5 * s
        return losses.sum() + out["aux_loss"], probs

    def single_task_loss(out, batch):
        ((task, col),) = label_cols.items()
        valid, denom = _valid_and_denom(batch)
        logit = out["logits"]
        total = _mean_bce(logit, batch["labels"][:, col], valid, denom)
        return total + out["aux_loss"], {task: torch.sigmoid(logit)}

    if model_cfg.name == "esmm":
        return esmm_loss
    return multi_task_loss if model_cfg.name in MULTI_TASK_MODELS else single_task_loss


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
        self.device = resolve_device(device)
        self.schema = schema
        self.model_cfg = model_cfg
        self.cfg = train_cfg
        self.label_cols = _labels_for(model_cfg, train_cfg, schema)
        self.loss_fn = make_loss_fn(model_cfg, self.label_cols)
        self.mtl_mode = None
        if model_cfg.task_weighting in ("pcgrad", "gradnorm"):
            if model_cfg.name not in MULTI_TASK_MODELS or model_cfg.name == "esmm":
                raise ValueError(
                    f"task_weighting={model_cfg.task_weighting!r} needs a "
                    "logit-head multi-task model (mmoe/ple), got "
                    f"{model_cfg.name!r}"
                )
            self.mtl_mode = model_cfg.task_weighting
            self.task_losses_fn = make_task_losses_fn(model_cfg, self.label_cols)

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
        state = {"model": model, "optimizer": optimizer, "step": 0}
        if self.mtl_mode == "gradnorm":
            state["mtl"] = mtl.gradnorm_init(len(self.model_cfg.tasks), self.device)
        elif self.mtl_mode == "pcgrad":
            state["pcgrad_generator"] = torch.Generator().manual_seed(self.cfg.seed + 2)
        return state

    def to_device(self, batch: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
        return {k: torch.as_tensor(v).to(self.device, non_blocking=True) for k, v in batch.items()}

    # -- steps ---------------------------------------------------------------

    def meters_init(self) -> Dict[str, torch.Tensor]:
        meters = M.auc_state_init(device=self.device)
        for name in ("loss", "correct", "count", "steps"):
            meters[name] = torch.zeros((), device=self.device)
        return meters

    def head_labels(self, head: str, labels: torch.Tensor) -> torch.Tensor:
        """The label column a head predicts: its task's, or for ESMM's heads
        the first task's (``ctr``) and the product of the two (``ctcvr``)."""
        tasks = self.model_cfg.tasks
        if head == "ctr":
            return labels[:, self.label_cols[tasks[0]]]
        if head == "ctcvr":
            return labels[:, self.label_cols[tasks[0]]] * labels[:, self.label_cols[tasks[1]]]
        return labels[:, self.label_cols[head]]

    def primary_head(self, heads) -> str:
        """The head the meters, the eval AUC and the predictions export follow."""
        return "ctr" if "ctr" in heads else next(iter(self.label_cols))

    def _mtl_gradients(self, state: State, out, batch):
        """PCGrad or GradNorm: per-task gradients of every parameter (zeros
        where a task does not reach one, as ``jax.jacrev`` gives), combined
        into ``.grad``. Returns (loss, probs)."""
        model = state["model"]
        task_losses, probs = self.task_losses_fn(out, batch)
        named = list(model.named_parameters())
        params = [p for _, p in named]
        per_task = [
            torch.autograd.grad(task_losses[t], params, retain_graph=t + 1 < len(task_losses),
                                allow_unused=True)
            for t in range(len(task_losses))
        ]
        stacked = {
            name: torch.stack([g[i] if g[i] is not None else torch.zeros_like(p) for g in per_task])
            for i, (name, p) in enumerate(named)
        }
        task_losses = task_losses.detach()
        if self.mtl_mode == "pcgrad":
            orders = mtl.pcgrad_orders(len(task_losses), state["pcgrad_generator"])
            weights = mtl.pcgrad_weights(mtl.gram_matrix(stacked), orders)
            loss = task_losses.sum()
        else:  # gradnorm, with the pre-update weights
            mask = mtl.shared_param_mask(stacked, mtl.default_task_specific)
            norms = mtl.shared_grad_norms(stacked, mask)
            weights, state["mtl"] = mtl.gradnorm_update(
                state["mtl"], task_losses, norms,
                self.model_cfg.gradnorm_alpha, self.model_cfg.gradnorm_lr,
            )
            loss = (weights * task_losses).sum()
        for (name, p), g in zip(named, mtl.combine_stacked(stacked, weights).values()):
            p.grad = g
        return loss, probs

    def train_step(self, state: State, meters: Dict[str, torch.Tensor], batch) -> None:
        """One optimizer step on a device batch; folds its metrics into
        ``meters`` on the device. The parameters' ``.grad`` hold this step's
        gradients afterwards."""
        model, optimizer = state["model"], state["optimizer"]
        model.train()
        out = model(batch)
        optimizer.zero_grad(set_to_none=True)
        if self.mtl_mode is None:
            loss, probs = self.loss_fn(out, batch)
            loss.backward()
        else:
            loss, probs = self._mtl_gradients(state, out, batch)
        if self.cfg.gradient_clip_norm > 0:
            grads = [p.grad for p in model.parameters() if p.grad is not None]
            clip_by_global_norm_(grads, self.cfg.gradient_clip_norm)
        optimizer.step()
        state["step"] += 1
        with torch.no_grad():
            task = self.primary_head(probs)
            y = self.head_labels(task, batch["labels"])
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
                head: M.exact_auc(p, self.head_labels(head, labels), valid)
                for head, p in preds.items()
            }
            primary = self.primary_head(preds)
            correct, count = M.binary_accuracy(
                preds[primary], self.head_labels(primary, labels), valid
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
