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

On a mesh of d x t ranks (``parallel/mesh.py``; one process per device)
each rank trains on its data shard's rows of every global batch:

  * tables of at least ``min_rows_to_shard`` rows are padded to a multiple
    of t (``table_padding``; the suffix check of ``loop.py:206-224``) and
    row-sharded (``sharded_table_names``, ``shard_decisions`` and the two
    ``[sharding]`` lines, as JAX's ``_pick`` prints them); the model is
    drawn whole from the seed on every rank first, so a sharded run starts
    from the weights of an unsharded one. Adam's moments follow the
    shards: they are each rank's optimizer state;
  * the ``_valid``-weighted losses divide by the **global** valid count,
    all-reduced over the data group; terms that do not depend on the rows
    (uncertainty weighting's s/2, the models' ``aux_loss``) count 1/d on
    each data rank. DIEN's ``use_aux_loss`` takes its in-batch negatives
    and valid count from the rank's rows, where JAX's global batch takes
    them from every row;
  * after ``backward`` every gradient is summed over the data group: a
    sharded table's over its data group, a replicated parameter's over all
    ranks and divided by t (its t table peers computed it from the same
    rows; the mean keeps the replicas bitwise equal, which CUDA's
    embedding backward alone does not), one flat buffer each. No
    ``DistributedDataParallel``: it averages over the whole world, which
    would mix table shards and scale by 1/N;
  * global-norm clipping, PCGrad's Gram matrix and GradNorm's shared norms
    sum a sharded table's squares over the table group once, and a
    replicated leaf's once; PCGrad and GradNorm combine per-task gradients
    all-reduced first, GradNorm from the global task losses;
  * meters are all-reduced over the data group when the host reads them;
    ``evaluate`` gathers predictions, labels and ``_valid`` over the data
    group in step-major order (``_host_all_steps``) for the exact AUC;
  * checkpoints are in the normal form (``depad_state``: tables gathered
    over the table group and sliced back to the caller's vocab), so they
    restore into ``Predictor`` and into runs of any t (``repad_state``,
    ``commit_state``).

Measurement (``rank_tpu/train/loop.py:462-466,597-630``):

  * ``matmul_precision`` sets torch's float32 matmul precision around each
    ``train_step`` only, and puts the caller's back after it, also when the
    step raises (``matmul_precision_scope``): ``bfloat16`` is torch's
    ``'medium'`` (TF32 products on the card, bf16 ones on a CPU with
    AMX), ``float32`` and ``highest`` are ``'highest'``, None leaves it
    alone. The hand-written kernels compute 3xTF32 under every setting;
  * ``profile_dir`` traces epoch 1 with ``torch.profiler`` (CPU activity,
    and CUDA activity on a CUDA trainer) and writes one chrome trace a
    rank, ``trace_rank{rank}.json``. A profiler that cannot start raises,
    and so does a trace of a CUDA trainer that holds no device activity.
    On the card the profiler first sees ``PROFILER_WARMUP_S`` of tiny
    kernels, for it has lost records of the first kernels it saw;
  * ``restoring`` runs a measured step (``utils/roofline.py:step_costs``,
    ``StagedRunner.step_memory_analysis``) and puts the state back;
  * while a profiler records, ``train_step`` opens the spans
    ``rank_tpu_torch.trainer.step`` and, inside it, ``.forward`` (the
    model and the loss), ``.backward`` (zeroing, backward, the sums over
    ranks, clipping), ``.optimizer`` and ``.meters`` (``utils/tracing.py``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import time
from typing import Any, Callable, Dict, Iterable, Iterator, Mapping, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils._pytree import tree_map

from ..embedding.collection import table_specs
from ..embedding.sharded import TableEmbedding, shard_table
from ..features import FeatureSchema
from ..models import MULTI_TASK_MODELS, ModelConfig, build_model
from ..models.registry import resolve_device
from ..parallel.mesh import DATA_AXIS, TABLE_AXIS, Mesh, local_device, make_mesh
from ..utils import tracing
from . import metrics as M
from . import mtl
from .checkpoint import load_into, rng_states

State = Dict[str, Any]

# TrainConfig.matmul_precision -> torch.set_float32_matmul_precision
MATMUL_PRECISIONS = {"bfloat16": "medium", "float32": "highest", "highest": "highest"}
# seconds of tiny kernels the profiler sees before a profiled epoch's first step
PROFILER_WARMUP_S = 0.02


@contextlib.contextmanager
def matmul_precision_scope(name: Optional[str]) -> Iterator[None]:
    """torch's float32 matmul precision for ``name`` (``MATMUL_PRECISIONS``)
    inside the block, the caller's after it; None changes nothing."""
    if name is None:
        yield
        return
    before = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision(MATMUL_PRECISIONS[name])
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(before)


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


def _valid_and_denom(batch: Mapping[str, torch.Tensor], mesh: Optional[Mesh] = None):
    """The rows' ``_valid`` mask and the global valid count (at least 1)."""
    valid = batch.get("_valid")
    if valid is None:
        valid = torch.ones_like(batch["labels"][:, 0])
    count = valid.sum()
    if mesh is not None and mesh.shape[DATA_AXIS] > 1:
        count = mesh.all_reduce_(count.detach().clone(), DATA_AXIS)
    return valid, torch.clamp_min(count, 1.0)


def _replicated_share(mesh: Optional[Mesh]) -> Callable:
    """Scales a loss term that does not depend on the rows by 1/d, so that
    the data ranks' partial losses sum to it once."""
    d = 1 if mesh is None else mesh.shape[DATA_AXIS]
    return (lambda x: x) if d == 1 else (lambda x: x / d)


def make_task_losses_fn(model_cfg: ModelConfig, label_cols: Mapping[str, int],
                        mesh: Optional[Mesh] = None) -> Callable:
    """``task_losses_fn(out, batch) -> ((T,) losses, {task: probs})`` for the
    logit-head multi-task models (MMOE, PLE); PCGrad and GradNorm take
    each task's gradient from it. ESMM's CTCVR loss does not split by task.
    On a mesh the losses are this data rank's share of the global ones."""

    def task_losses_fn(out, batch):
        valid, denom = _valid_and_denom(batch, mesh)
        losses, probs = [], {}
        for task in model_cfg.tasks:
            logit = out["logits"][task]
            losses.append(_mean_bce(logit, batch["labels"][:, label_cols[task]], valid, denom))
            probs[task] = torch.sigmoid(logit)
        return torch.stack(losses), probs

    return task_losses_fn


def make_loss_fn(model_cfg: ModelConfig, label_cols: Mapping[str, int],
                 mesh: Optional[Mesh] = None) -> Callable:
    """``loss_fn(out, batch) -> (loss, {head: probs})`` for the model output
    ``out`` on ``batch``: the JAX ``make_loss_fn``'s three branches. On a
    mesh the loss is this data rank's share: the shares sum to the loss of
    the global batch."""
    tasks = model_cfg.tasks
    task_losses_fn = make_task_losses_fn(model_cfg, label_cols, mesh)
    share = _replicated_share(mesh)

    def esmm_loss(out, batch):
        # BCE on probabilities clipped to [eps, 1 - eps], with both log terms
        # written out: torch's binary_cross_entropy clamps each log at -100
        # and does not clip, which differs near 0 and 1
        eps = 1e-7
        valid, denom = _valid_and_denom(batch, mesh)
        y_ctr = batch["labels"][:, label_cols[tasks[0]]]
        y_ctcvr = y_ctr * batch["labels"][:, label_cols[tasks[1]]]
        total, probs = 0.0, {}
        for head, y in (("ctr", y_ctr), ("ctcvr", y_ctcvr)):
            p = torch.clamp(out["probs"][head], eps, 1.0 - eps)
            ll = -(y * torch.log(p) + (1 - y) * torch.log(1 - p))
            total = total + (ll * valid).sum() / denom
            probs[head] = p
        return total + share(out["aux_loss"]), probs

    def multi_task_loss(out, batch):
        losses, probs = task_losses_fn(out, batch)
        log_vars = out.get("task_log_vars", {})
        if log_vars:
            # uncertainty weighting (Kendall et al. 2018), s = log sigma^2
            s = torch.stack([log_vars[task] for task in tasks])
            losses = torch.exp(-s) * losses + share(0.5 * s)
        return losses.sum() + share(out["aux_loss"]), probs

    def single_task_loss(out, batch):
        ((task, col),) = label_cols.items()
        valid, denom = _valid_and_denom(batch, mesh)
        logit = out["logits"]
        total = _mean_bce(logit, batch["labels"][:, col], valid, denom)
        return total + share(out["aux_loss"]), {task: torch.sigmoid(logit)}

    if model_cfg.name == "esmm":
        return esmm_loss
    return multi_task_loss if model_cfg.name in MULTI_TASK_MODELS else single_task_loss


def clip_by_global_norm_(grads, max_norm: float, sharded_grads=(),
                         table_sum: Optional[Callable] = None) -> None:
    """optax's ``clip_by_global_norm``, in place: every gradient times
    ``max_norm / |g|`` when the global norm ``|g|`` reaches ``max_norm``.
    ``sharded_grads`` are this rank's shards of row-sharded tables: their
    squares are summed over the table group by ``table_sum``."""
    norms = [torch.linalg.vector_norm(g) for g in grads]
    if sharded_grads:
        squares = sum(torch.linalg.vector_norm(g).square() for g in sharded_grads)
        norms.append(torch.sqrt(table_sum(squares)))
    norm = torch.linalg.vector_norm(torch.stack(norms))
    keep = norm < max_norm
    for g in (*grads, *sharded_grads):
        g.copy_(torch.where(keep, g, g / norm * max_norm))


def _leaf_record(module_name: str, shape) -> str:
    """A table leaf as the JAX trainer's ``_pick`` records it:
    ``jax.tree_util.keystr`` of its flax path and its (padded) shape."""
    path = ("params", *module_name.split("."), "embedding")
    return "".join(f"['{p}']" for p in path) + str(tuple(shape))


class Trainer:
    def __init__(
        self,
        schema: FeatureSchema,
        model_cfg: ModelConfig,
        train_cfg: TrainConfig = TrainConfig(),
        device="cuda",
        mesh: Optional[Mesh] = None,
    ):
        if train_cfg.matmul_precision not in (None, *MATMUL_PRECISIONS):
            raise ValueError(f"matmul_precision {train_cfg.matmul_precision!r}: one of "
                             f"{sorted(MATMUL_PRECISIONS)} or None")
        self.device = local_device(resolve_device(device))
        self.mesh = mesh if mesh is not None else make_mesh(
            table_parallelism=train_cfg.table_parallelism, device=self.device)
        self.model_cfg = model_cfg
        self.cfg = train_cfg
        # Pad vocab rows up to a multiple of the table axis so that
        # row-sharding is never silently skipped: the real vocab sizes (+1
        # OOV) are odd for the biggest tables (feedid 106,445). Padding rows
        # are ids the encoders never emit, so they are gradient-dead. The
        # data and the model's draw keep the caller's schema
        # (``caller_schema``); only the tables' shapes change.
        self.caller_schema = schema
        self.table_padding = {}
        t = self.mesh.shape[TABLE_AXIS]
        if t > 1:
            schema, self.table_padding = schema.padded_for_table_sharding(
                t, min_rows=train_cfg.min_rows_to_shard)
            if self.table_padding:
                pads = ", ".join(f"{k}: {a}->{b}" for k, (a, b) in self.table_padding.items())
                print(f"[sharding] padded vocab rows to table={t} multiple: {pads}")
                # _padded_table_dims matches table modules by name suffix
                # ("_" + feature): a feature whose name extends a padded one
                # would match it too, and depad/repad could pick the wrong
                # dims. Refuse such a schema (rank_tpu/train/loop.py:206-224).
                for f1 in self.table_padding:
                    for f2 in table_specs(schema):
                        if f1 != f2 and (f2.endswith("_" + f1) or f2 == "table_" + f1):
                            raise ValueError(
                                f"padded feature name {f1!r} is a suffix of {f2!r}: "
                                "table-module suffix matching in _padded_table_dims "
                                "would be ambiguous — rename one feature"
                            )
        self.schema = schema
        # the tables row-sharded over the table axis (JAX's _pick rule:
        # divisible rows after padding, and big enough to scatter)
        self.sharded_table_names = tuple(sorted(
            name for name, (vocab, _) in table_specs(schema).items()
            if t > 1 and vocab % t == 0 and vocab >= train_cfg.min_rows_to_shard
        ))
        self.label_cols = _labels_for(model_cfg, train_cfg, schema)
        self.loss_fn = make_loss_fn(model_cfg, self.label_cols, self.mesh)
        self.mtl_mode = None
        if model_cfg.task_weighting in ("pcgrad", "gradnorm"):
            if model_cfg.name not in MULTI_TASK_MODELS or model_cfg.name == "esmm":
                raise ValueError(
                    f"task_weighting={model_cfg.task_weighting!r} needs a "
                    "logit-head multi-task model (mmoe/ple), got "
                    f"{model_cfg.name!r}"
                )
            self.mtl_mode = model_cfg.task_weighting
            self.task_losses_fn = make_task_losses_fn(model_cfg, self.label_cols, self.mesh)
        # filled by init_state with the per-table decisions
        self.shard_decisions = {"sharded": [], "replicated": []}

    @property
    def _data_ranks(self) -> int:
        return self.mesh.shape[DATA_AXIS]

    def _table_sum(self, x: torch.Tensor) -> torch.Tensor:
        return self.mesh.all_reduce_(x.clone(), TABLE_AXIS)

    # -- state ---------------------------------------------------------------

    def init_state(self) -> State:
        """The model, drawn whole from a generator seeded with ``cfg.seed``
        and then row-sharded on a table-sharded mesh, and its optimizer.
        Dropout draws from torch's default generators, seeded here with
        ``cfg.seed + 1`` (the JAX trainer's dropout key); data rank i adds
        ``i << 32``, so table peers draw alike and data ranks do not."""
        generator = torch.Generator().manual_seed(self.cfg.seed)
        model = build_model(self.caller_schema, self.model_cfg, device=self.device,
                            generator=generator, mesh=self.mesh,
                            sharded_tables=self.sharded_table_names)
        t = self.mesh.shape[TABLE_AXIS]
        decisions = {"sharded": [], "replicated": []}
        if t > 1:
            # in the order of JAX's tree walk: sorted by flax path
            tables = sorted((tuple(name.split(".")), m) for name, m in model.named_modules()
                            if isinstance(m, TableEmbedding))
            for path, m in tables:
                record = _leaf_record(".".join(path), (m.full_rows, m.embedding_dim))
                decisions["sharded" if m.sharded else "replicated"].append(record)
            print(
                f"[sharding] row-sharded {len(decisions['sharded'])} tables "
                f"over table={t}: {decisions['sharded']}; "
                f"replicated (small/indivisible): {decisions['replicated']}"
            )
        self.shard_decisions = decisions
        torch.manual_seed(self.cfg.seed + 1 + (self.mesh.data_index << 32))
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

    @staticmethod
    def _sharded_tables(model) -> Dict[str, TableEmbedding]:
        """{state-dict key of the weight: table} of the row-sharded tables."""
        return {f"{name}.weight": m for name, m in model.named_modules()
                if isinstance(m, TableEmbedding) and m.sharded}

    # -- checkpoint normal form (padded, sharded tables) -----------------------

    def _padded_table_dims(self, key: str, shape):
        """(orig_rows, padded_rows) if the state-dict entry ``key`` is a
        row-padded table (matched by module name AND row count), else None."""
        if not self.table_padding:
            return None
        parts = key.split(".")
        if len(parts) < 2 or parts[-1] != "weight" or len(shape) < 1:
            return None
        seg = parts[-2]
        for f, (orig, padded) in self.table_padding.items():
            named = seg == f or seg == f"table_{f}" or seg.endswith("_" + f)
            if named and shape[0] in (orig, padded):
                return orig, padded
        return None

    @staticmethod
    def _map_tables(tree: Mapping[str, Any], names, fn) -> Dict[str, Any]:
        """``tree`` with ``fn(key, tensor)`` applied to every model entry
        and to the Adam moments of every parameter, keyed by the
        parameter's name (``names``: the parameters in optimizer order)."""
        out = {**tree, "model": {k: fn(k, v) for k, v in tree["model"].items()}}
        opt = tree.get("optimizer")
        if opt is not None:
            out["optimizer"] = {**opt, "state": {
                idx: {k: fn(names[idx], v) if torch.is_tensor(v) and v.dim() else v
                      for k, v in moments.items()}
                for idx, moments in opt["state"].items()}}
        return out

    def _full_state(self, state: State) -> Dict[str, Any]:
        """The live state as a tree of state dicts (and this data rank's
        random generators), each sharded table and its Adam moments
        all-gathered over the table group: padded, not yet the normal form."""
        model = state["model"]
        tree = {**state, "model": model.state_dict(),
                "optimizer": state["optimizer"].state_dict(), "rng": rng_states()}
        if self._data_ranks > 1:
            tree["rng_by_data_index"] = self.mesh.all_gather_object(tree["rng"], DATA_AXIS)
        sharded = self._sharded_tables(model)
        if not sharded:
            return tree

        def gather(key, v):
            return torch.cat(self.mesh.all_gather(v, TABLE_AXIS)) if key in sharded else v

        return self._map_tables(tree, [n for n, _ in model.named_parameters()], gather)

    def depad_state(self, state: State) -> Dict[str, Any]:
        """The checkpoint normal form of a live state: state dicts with every
        table whole (gathered over the table group) and sliced back to the
        caller-schema vocab sizes, Adam moments alike, so that it restores
        into ``Predictor`` and into runs of any table parallelism. The
        sliced-off rows are unreachable ids: nothing trained is lost."""
        tree = self._full_state(state)
        if not self.table_padding:
            return tree

        def depad(key, v):
            dims = self._padded_table_dims(key, tuple(v.shape))
            if dims and dims[0] != dims[1] and v.shape[0] == dims[1]:
                return v[: dims[0]]
            return v

        return self._map_tables(tree, [n for n, _ in state["model"].named_parameters()], depad)

    def repad_state(self, tree: Mapping[str, Any], like: State, legacy: bool = False):
        """Inverse of ``depad_state`` for this rank: zero-fill each padded
        table back to its padded rows and keep this rank's shard of every
        sharded table (``like`` is a live state of this trainer). A padded
        table in the tree is not the normal form and raises ``ValueError``,
        unless ``legacy``: then it is taken as this mesh's padding."""
        model = like["model"]
        sharded = self._sharded_tables(model)
        if not sharded:
            return tree

        def repad(key, v):
            if key not in sharded:
                return v
            full_rows = sharded[key].full_rows
            dims = self._padded_table_dims(key, tuple(v.shape))
            if v.shape[0] != full_rows:
                if not (dims and v.shape[0] == dims[0]):
                    raise ValueError(f"{key} has {v.shape[0]} rows; this run's table holds "
                                     f"{full_rows}")
                v = torch.cat([v, v.new_zeros((full_rows - v.shape[0],) + tuple(v.shape[1:]))])
            elif dims and dims[0] != dims[1] and not legacy:
                raise ValueError(f"{key} holds {full_rows} rows, its padded size: the "
                                 "checkpoint is not in the depadded normal form")
            return shard_table(v, self.mesh).clone()

        return self._map_tables(tree, [n for n, _ in model.named_parameters()], repad)

    def commit_state(self, state: State, tree: Mapping[str, Any]) -> State:
        """Load a tree (``repad_state``'s, or a checkpoint of an unsharded
        run) into the live ``state``: the model, and where the tree has
        them the optimizer, step, GradNorm or PCGrad state and this data
        rank's random generators."""
        return load_into(state, tree, data_index=self.mesh.data_index)

    # -- steps ---------------------------------------------------------------

    def meters_init(self) -> Dict[str, torch.Tensor]:
        meters = M.auc_state_init(device=self.device)
        for name in ("loss", "correct", "count", "steps"):
            meters[name] = torch.zeros((), device=self.device)
        return meters

    def read_meters(self, meters: Dict[str, torch.Tensor]) -> Dict[str, float]:
        """The meters on the host, summed over the data group: loss,
        correct, count and the streaming AUC."""
        keys = ("loss", "correct", "count")
        if self._data_ranks > 1:
            flat = torch.cat([meters[k].reshape(1) for k in keys] + [meters["pos"], meters["neg"]])
            self.mesh.all_reduce_(flat, DATA_AXIS)
            nb = meters["pos"].shape[0]
            meters = {**dict(zip(keys, flat[:3])), "pos": flat[3:3 + nb], "neg": flat[3 + nb:]}
        values = torch.stack([meters[k] for k in keys] + [M.auc_state_result(meters)]).cpu()
        return dict(zip(keys + ("auc",), (float(x) for x in values)))

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

    def _flat_all_reduce_(self, grads, axis) -> None:
        """Sum ``grads`` over ``axis``, in place, as one flat buffer."""
        if not grads:
            return
        flat = self.mesh.all_reduce_(torch.cat([g.reshape(-1) for g in grads]), axis)
        offset = 0
        for g in grads:
            g.copy_(flat[offset:offset + g.numel()].view_as(g))
            offset += g.numel()

    def _sync_gradients(self, named_grads: Mapping[str, torch.Tensor], sharded) -> None:
        """Sum the gradients over the data group, in place. A sharded
        table's gradient is summed over its data group. A replicated
        parameter's is summed over every rank and divided by t: its t table
        peers computed it from the same rows, and CUDA's embedding backward
        is not bitwise reproducible, so the mean keeps the replicas equal
        (exact when the t copies are)."""
        if self.mesh.world_size == 1:
            return
        t = self.mesh.shape[TABLE_AXIS]
        replicated = [g for name, g in named_grads.items() if name not in sharded]
        self._flat_all_reduce_(replicated, None)
        if t > 1:
            for g in replicated:
                g.div_(t)
        self._flat_all_reduce_([g for name, g in named_grads.items() if name in sharded],
                               DATA_AXIS)

    def _mtl_gradients(self, state: State, out, batch):
        """PCGrad or GradNorm: per-task gradients of every parameter (zeros
        where a task does not reach one, as ``jax.jacrev`` gives), summed
        over the data group and combined into ``.grad``. Returns (this data
        rank's share of the loss, probs)."""
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
        sharded = set(self._sharded_tables(model))
        self._sync_gradients(stacked, sharded)
        share = task_losses.detach()
        task_losses = self.mesh.all_reduce_(share.clone(), DATA_AXIS)
        replicated = {k: v for k, v in stacked.items() if k not in sharded}
        shards = {k: v for k, v in stacked.items() if k in sharded}
        if self.mtl_mode == "pcgrad":
            orders = mtl.pcgrad_orders(len(task_losses), state["pcgrad_generator"])
            gram = mtl.gram_matrix(replicated)
            if shards:
                gram = gram + self._table_sum(mtl.gram_matrix(shards))
            weights = mtl.pcgrad_weights(gram, orders)
            loss = share.sum()
        else:  # gradnorm, with the pre-update weights
            mask = mtl.shared_param_mask(stacked, mtl.default_task_specific)
            squares = mtl.shared_grad_squares(replicated, mask)
            if shards:
                squares = squares + self._table_sum(mtl.shared_grad_squares(shards, mask))
            norms = mtl.norms_from_squares(squares)
            weights, state["mtl"] = mtl.gradnorm_update(
                state["mtl"], task_losses, norms,
                self.model_cfg.gradnorm_alpha, self.model_cfg.gradnorm_lr,
            )
            loss = (weights * share).sum()
        for (name, p), g in zip(named, mtl.combine_stacked(stacked, weights).values()):
            p.grad = g
        return loss, probs

    @contextlib.contextmanager
    def restoring(self, state: State) -> Iterator[State]:
        """``state`` inside the block, then put back as it was on entry:
        the model, the optimizer, the step, GradNorm's state, PCGrad's
        generator and the random generators, from a host copy taken on
        entry. For a step run only to be measured."""
        tree = {"model": state["model"].state_dict(),
                "optimizer": state["optimizer"].state_dict(), "step": state["step"],
                "rng": rng_states()}
        if "mtl" in state:
            tree["mtl"] = state["mtl"]
        if "pcgrad_generator" in state:
            tree["pcgrad_generator"] = state["pcgrad_generator"].get_state()
        saved = tree_map(
            lambda x: x.detach().to("cpu", copy=True) if torch.is_tensor(x) else x, tree)
        try:
            yield state
        finally:
            load_into(state, saved)

    def train_step(self, state: State, meters: Dict[str, torch.Tensor], batch) -> None:
        """One optimizer step on a device batch; folds its metrics into
        ``meters`` on the device. The parameters' ``.grad`` hold this step's
        gradients afterwards (summed over the data group). Runs under
        ``cfg.matmul_precision``."""
        with tracing.span("trainer.step"), matmul_precision_scope(self.cfg.matmul_precision):
            self._train_step(state, meters, batch)

    def _train_step(self, state: State, meters: Dict[str, torch.Tensor], batch) -> None:
        model, optimizer = state["model"], state["optimizer"]
        with tracing.span("trainer.forward"):
            model.train()
            out = model(batch)
            if self.mtl_mode is None:
                loss, probs = self.loss_fn(out, batch)
        with tracing.span("trainer.backward"):
            optimizer.zero_grad(set_to_none=True)
            if self.mtl_mode is None:
                loss.backward()
                self._sync_gradients({name: p.grad for name, p in model.named_parameters()
                                      if p.grad is not None}, self._sharded_tables(model))
            else:
                loss, probs = self._mtl_gradients(state, out, batch)
            if self.cfg.gradient_clip_norm > 0:
                sharded = {id(m.weight) for m in self._sharded_tables(model).values()}
                grads = [p.grad for p in model.parameters()
                         if p.grad is not None and id(p) not in sharded]
                shards = [p.grad for p in model.parameters()
                          if p.grad is not None and id(p) in sharded]
                clip_by_global_norm_(grads, self.cfg.gradient_clip_norm, shards, self._table_sum)
        with tracing.span("trainer.optimizer"):
            optimizer.step()
            state["step"] += 1
        with tracing.span("trainer.meters"), torch.no_grad():
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

    def _profiler(self) -> torch.profiler.profile:
        activities = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        return torch.profiler.profile(activities=activities)

    def _write_trace(self, prof: torch.profiler.profile) -> None:
        """Export epoch 1's chrome trace; raise if a CUDA trainer's trace
        holds no device activity (a profiler that did not reach the card)."""
        if self.device.type == "cuda" and not any(
                e.device_type == torch.autograd.DeviceType.CUDA for e in prof.events()):
            raise RuntimeError("the profiler recorded no CUDA activity: no trace of the "
                               "card was taken")
        os.makedirs(self.cfg.profile_dir, exist_ok=True)
        prof.export_chrome_trace(
            os.path.join(self.cfg.profile_dir, f"trace_rank{self.mesh.rank}.json"))
        print(f"profile trace written to {self.cfg.profile_dir}")

    def _warm_profiler(self) -> None:
        """On the H100 a trace lacked the device records of some of the
        first kernels the profiler saw (their launch records were there):
        up to 5 ms of launches, also when the first step came 0.1 s after
        its start. So the profiler first sees ``PROFILER_WARMUP_S`` of
        tiny kernels."""
        warm = torch.zeros((), device=self.device)
        end = time.perf_counter() + PROFILER_WARMUP_S
        while time.perf_counter() < end:
            warm.add_(1.0)
        torch.cuda.synchronize(self.device)

    def train_epoch(self, state: State, batches: Iterable[Mapping[str, Any]], epoch: int = 1):
        """One pass over ``batches`` (numpy or device batches). The meters
        stay on the device; the host reads them at each log line and once
        at the end, which is also the timing fence. Epoch 1 runs under the
        profiler when ``cfg.profile_dir`` is set."""
        profiled = bool(self.cfg.profile_dir) and epoch == 1
        meters = self.meters_init()
        nsteps = 0
        with self._profiler() if profiled else contextlib.nullcontext() as prof:
            if profiled and self.device.type == "cuda":
                self._warm_profiler()
            t0 = time.time()
            for batch in batches:
                self.train_step(state, meters, self.to_device(batch))
                nsteps += 1
                if self.cfg.log_every and nsteps % self.cfg.log_every == 0:
                    read = self.read_meters(meters)
                    eps = read["count"] / max(time.time() - t0, 1e-9)
                    print(
                        f"epoch {epoch} step {nsteps}: "
                        f"loss={read['loss'] / nsteps:.4f} "
                        f"examples/s={eps:,.0f}"
                    )
            read = self.read_meters(meters)
        dt = time.time() - t0
        if profiled:
            self._write_trace(prof)
        out = {
            "loss": read["loss"] / max(nsteps, 1),
            "accuracy": read["correct"] / max(read["count"], 1),
            "auc": read["auc"],
            "count": read["count"],  # _valid rows trained this epoch
            "examples_per_s": read["count"] / max(dt, 1e-9),
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

    def _host_all_steps(self, chunks) -> torch.Tensor:
        """Per-step tensors of this data rank -> the global tensor in
        step-major order: step s holds data rank 0's rows, then rank 1's."""
        if self._data_ranks == 1:
            return torch.cat(chunks)
        steps = torch.stack(self.mesh.all_gather(torch.stack(chunks), DATA_AXIS), dim=1)
        return steps.reshape((-1,) + tuple(steps.shape[3:]))  # (S, d, B_local, ...) flattened

    def evaluate(self, state: State, batches: Iterable[Mapping[str, Any]], epoch: int = 1):
        """Full eval pass: loss, accuracy and the exact AUC per task, all
        computed on the device over the global eval set; predictions,
        labels and ``_valid`` come to the host once, at the end."""
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
            self.mesh.all_reduce_(loss_acc, DATA_AXIS)
            labels = self._host_all_steps(labels_dev)
            valid = self._host_all_steps(valid_dev)
            preds = {k: self._host_all_steps(v) for k, v in probs_dev.items()}
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
