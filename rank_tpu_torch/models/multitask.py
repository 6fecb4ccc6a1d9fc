"""Multi-task models: ESMM, MMOE and PLE (port of ``rank_tpu/models/multitask.py``).

All three share one input, ``[dense | 6 tower-field embeddings | feedid]``
(multi-hot tags mean-pooled, as ``RankModel.tower_field_embeddings``), and
the README's 3-task setting read_comment / like / click_avatar.

  * MMOE (Ma et al. KDD'18): ``num_experts`` ReLU experts, a softmax gate
    and a tower per task;
  * PLE (Tang et al. RecSys'20): ``num_levels`` CGC layers of
    task-specific and shared experts; each task's gate mixes its own
    experts with the shared ones, and the shared gate mixes them all (no
    shared gate at the last level, whose shared output is unused);
  * ESMM (Ma et al. SIGIR'18): a CTR and a CVR tower, each
    ``expert_units + tower_units`` wide; the CTCVR head is
    pCTR * pCVR, so ESMM returns probabilities and trains with BCE on
    them (``train/loop.py``).

Outputs, as in the JAX package: ``{"logits": {task: (B,)}, "aux_loss": 0,
"task_log_vars": {task: s}}`` for MMOE and PLE, ``{"probs": {"ctr",
"ctcvr"}, "aux_loss": 0}`` for ESMM. Submodules carry the flax names
(``expert_{i}``, ``gate_{task}``, ``tower_{task}``, ``L{l}_t{ti}_e{k}``,
``L{l}_shared_e{k}``, ``L{l}_gate_t{ti}``, ``L{l}_gate_shared``,
``ctr_tower``, ``cvr_tower``, each tower's ``Dense_{j}``) and the
uncertainty weights are scalar parameters ``task_log_var_{task}`` on the
model itself, so ``interop.state_dict_from_flax`` maps every key.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch
from torch import nn

from ..features import FeatureSchema
from ..ops.mlp import MLPTower
from .base import TOWER_FIELDS, Batch, ModelConfig, RankModel


def _expert(fan_in: int, cfg: ModelConfig, generator) -> MLPTower:
    """ReLU Dense stack ``cfg.expert_units`` wide (flax ``_Expert``)."""
    return MLPTower(fan_in, cfg.expert_units, activation="relu", batch_norm=False,
                    dropout_rate=0.0, dense_init=cfg.dense_init, generator=generator)


def _tower(fan_in: int, units, cfg: ModelConfig, generator) -> MLPTower:
    """ReLU Dense stack ending in a 1-unit Dense (flax ``_TaskTower``)."""
    return MLPTower(fan_in, units, activation="relu", batch_norm=False, dropout_rate=0.0,
                    dense_init=cfg.dense_init, generator=generator, final_logit=True)


def _mix(gate: torch.Tensor, pool: torch.Tensor) -> torch.Tensor:
    """Softmax-gated sum of the experts: gate logits (B, E), pool (B, E, H)."""
    return torch.einsum("be,beh->bh", torch.softmax(gate, dim=-1), pool)


class _MultiTaskModel(RankModel):
    """The shared input and the uncertainty weights of all three models."""

    def __init__(self, schema: FeatureSchema, cfg: ModelConfig,
                 generator: Optional[torch.Generator]):
        super().__init__(schema, cfg)
        self.tables = self.embedding_collection(generator, TOWER_FIELDS + ("feedid",))
        self.input_width = (schema.num_dense + sum(self.tower_field_dims())
                            + schema.categorical_feature("feedid").emb_dim)

    def shared_input(self, batch: Batch) -> torch.Tensor:
        target = self.tables.lookup("feedid", batch["feedid"])
        return torch.cat([self.dense_input(batch)]
                         + self.tower_field_embeddings(self.tables, batch) + [target], dim=-1)

    def add_task_log_vars(self) -> None:
        """Learned per-task log-variances for uncertainty weighting (Kendall,
        Gal & Cipolla, CVPR 2018), zero-initialised: the loss applies
        exp(-s)*L + s/2 per task, which is the plain sum at step 0."""
        if self.cfg.task_weighting == "uncertainty":
            for task in self.cfg.tasks:
                self.register_parameter(f"task_log_var_{task}", nn.Parameter(torch.zeros(())))

    def task_log_vars(self) -> Dict[str, torch.Tensor]:
        if self.cfg.task_weighting != "uncertainty":
            return {}
        return {task: getattr(self, f"task_log_var_{task}") for task in self.cfg.tasks}

    def task_output(self, logits: Dict[str, torch.Tensor], x0: torch.Tensor) -> Dict:
        return {"logits": logits, "aux_loss": x0.new_zeros(()),
                "task_log_vars": self.task_log_vars()}


class MMOE(_MultiTaskModel):
    def __init__(self, schema: FeatureSchema, cfg: ModelConfig,
                 generator: Optional[torch.Generator] = None):
        super().__init__(schema, cfg, generator)
        width = self.input_width
        for i in range(cfg.num_experts):
            self.add_module(f"expert_{i}", _expert(width, cfg, generator))
        for task in cfg.tasks:
            self.add_module(f"gate_{task}", self.dense(width, cfg.num_experts, generator))
            self.add_module(f"tower_{task}",
                            _tower(cfg.expert_units[-1], cfg.tower_units, cfg, generator))
        self.add_task_log_vars()

    def forward(self, batch: Batch):
        x0 = self.shared_input(batch)
        experts = torch.stack(
            [getattr(self, f"expert_{i}")(x0) for i in range(self.cfg.num_experts)], dim=1
        )  # (B, E, H)
        logits = {}
        for task in self.cfg.tasks:
            mixed = _mix(getattr(self, f"gate_{task}")(x0), experts)
            logits[task] = getattr(self, f"tower_{task}")(mixed)[..., 0]
        return self.task_output(logits, x0)


class PLE(_MultiTaskModel):
    """Progressive Layered Extraction with ``num_levels`` CGC layers. Level
    0's experts and gates read the shared input; later levels read the
    ``expert_units[-1]``-wide mixtures of the level before."""

    def __init__(self, schema: FeatureSchema, cfg: ModelConfig,
                 generator: Optional[torch.Generator] = None):
        super().__init__(schema, cfg, generator)
        n_tasks, per_task = len(cfg.tasks), cfg.specific_experts_per_task
        for level in range(cfg.num_levels):
            fan_in = self.input_width if level == 0 else cfg.expert_units[-1]
            for ti in range(n_tasks):
                for k in range(per_task):
                    self.add_module(f"L{level}_t{ti}_e{k}", _expert(fan_in, cfg, generator))
            for k in range(cfg.shared_experts):
                self.add_module(f"L{level}_shared_e{k}", _expert(fan_in, cfg, generator))
            for ti in range(n_tasks):
                self.add_module(f"L{level}_gate_t{ti}",
                                self.dense(fan_in, per_task + cfg.shared_experts, generator))
            if level < cfg.num_levels - 1:
                self.add_module(f"L{level}_gate_shared", self.dense(
                    fan_in, n_tasks * per_task + cfg.shared_experts, generator))
        for task in cfg.tasks:
            self.add_module(f"tower_{task}",
                            _tower(cfg.expert_units[-1], cfg.tower_units, cfg, generator))
        self.add_task_log_vars()

    def _experts(self, prefix: str, count: int, x: torch.Tensor) -> torch.Tensor:
        return torch.stack([getattr(self, f"{prefix}{k}")(x) for k in range(count)], dim=1)

    def forward(self, batch: Batch):
        cfg = self.cfg
        n_tasks = len(cfg.tasks)
        x0 = self.shared_input(batch)
        inputs: List[torch.Tensor] = [x0] * (n_tasks + 1)  # one per task, then the shared one
        for level in range(cfg.num_levels):
            task_experts = [self._experts(f"L{level}_t{ti}_e", cfg.specific_experts_per_task,
                                          inputs[ti]) for ti in range(n_tasks)]
            shared = self._experts(f"L{level}_shared_e", cfg.shared_experts, inputs[-1])
            new_inputs = [
                _mix(getattr(self, f"L{level}_gate_t{ti}")(inputs[ti]),
                     torch.cat([task_experts[ti], shared], dim=1))
                for ti in range(n_tasks)
            ]
            if level < cfg.num_levels - 1:
                new_inputs.append(_mix(getattr(self, f"L{level}_gate_shared")(inputs[-1]),
                                       torch.cat(task_experts + [shared], dim=1)))
            else:
                new_inputs.append(new_inputs[-1])  # unused
            inputs = new_inputs
        logits = {task: getattr(self, f"tower_{task}")(inputs[ti])[..., 0]
                  for ti, task in enumerate(cfg.tasks)}
        return self.task_output(logits, x0)


class ESMM(_MultiTaskModel):
    """Entire-space multi-task: a pCTR head and pCTCVR = pCTR * pCVR.
    tasks[0] is the click label (CTR), tasks[1] the conversion label; the
    loss builds the CTCVR label as their product."""

    def __init__(self, schema: FeatureSchema, cfg: ModelConfig,
                 generator: Optional[torch.Generator] = None):
        super().__init__(schema, cfg, generator)
        units = cfg.expert_units + cfg.tower_units
        self.ctr_tower = _tower(self.input_width, units, cfg, generator)
        self.cvr_tower = _tower(self.input_width, units, cfg, generator)

    def forward(self, batch: Batch):
        x0 = self.shared_input(batch)
        p_ctr = torch.sigmoid(self.ctr_tower(x0)[..., 0])
        p_ctcvr = p_ctr * torch.sigmoid(self.cvr_tower(x0)[..., 0])
        return {"probs": {"ctr": p_ctr, "ctcvr": p_ctcvr}, "aux_loss": x0.new_zeros(())}
