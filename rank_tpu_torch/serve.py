"""Inference/serving path (port of ``rank_tpu/serve.py``).

``Predictor`` serves padded request batches from a model in eval mode.
Requests are padded up to the nearest power-of-two bucket (>= min_bucket)
by repeating row 0, so the kernels see a handful of shapes, as the JAX
package's compiled programs do.

Heads, as in the JAX ``apply_fn``: ``{"score"}`` for a single-task model,
``{task}`` (sigmoid of each task's logit) for MMOE and PLE, and ESMM's
``{"ctr", "ctcvr"}`` probabilities. They come back as f32 numpy arrays,
also where a bf16 model computes a head in bf16.

``model_dir`` is read as the port's CLI writes it: the ``best_model``
state dict (``train/checkpoint.py``). ``weights_dtype='bfloat16'`` casts
the floating parameters after loading, as the JAX Predictor does; every
dense product then computes in the dtype its operands promote to
(``ops/mlp.py``), as flax's do.

``export_serving_artifact`` writes a ``torch.export`` program of the eval
forward and its heads at a fixed batch size, with the weights in it;
``load_serving_artifact`` runs it without the model code or a
checkpoint. The DIN attention and CIN kernels are registered operators
(``ops/kernels``), so the program holds them as nodes and, on the card,
launches the hand-written kernels.
"""

from __future__ import annotations

import json
from typing import Callable, Dict, Mapping, Optional, Union

import numpy as np
import torch
from torch import nn

from .features import FeatureSchema
from .models.base import ModelConfig
from .models.registry import build_model, resolve_device
from .ops.autoint import DTYPES
from .train.checkpoint import CheckpointManager
from .utils import tracing

# what an artifact records beside its program: its inputs, names and dtypes
_ARTIFACT_META = "serving.json"


def _bucket(n: int, min_bucket: int) -> int:
    b = min_bucket
    while b < n:
        b *= 2
    return b


def serving_heads(out: Dict) -> Dict[str, torch.Tensor]:
    """A model's output dict -> ``{head: (B,) probabilities}``."""
    if "probs" in out:
        return out["probs"]
    if isinstance(out["logits"], dict):
        return {task: torch.sigmoid(logit) for task, logit in out["logits"].items()}
    return {"score": torch.sigmoid(out["logits"])}


def cast_parameters_(model: nn.Module, dtype: torch.dtype) -> None:
    """Cast every floating parameter of ``model`` to ``dtype`` in place;
    buffers (BatchNorm's running statistics) keep theirs, as the JAX
    Predictor casts ``params`` and not ``batch_stats``."""
    with torch.no_grad():
        for p in model.parameters():
            if p.is_floating_point():
                p.data = p.data.to(dtype)


class Predictor:
    def __init__(
        self,
        schema: FeatureSchema,
        model_cfg: ModelConfig,
        model_dir: Optional[str] = None,
        state_dict: Optional[Mapping[str, torch.Tensor]] = None,
        min_bucket: int = 256,
        weights_dtype: Optional[str] = None,
        device="cuda",
    ):
        """``state_dict`` is the port's counterpart of the JAX Predictor's
        ``variables=`` (``interop.state_dict_from_flax`` converts them);
        without it, the best model saved in ``model_dir`` is served.
        ``weights_dtype`` ('bfloat16' or 'float32') casts the floating
        parameters after loading (``cast_parameters_``)."""
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
        if weights_dtype is not None:
            if weights_dtype not in DTYPES:
                raise ValueError(f"weights_dtype {weights_dtype!r} is not one of {sorted(DTYPES)}")
            cast_parameters_(self.model, DTYPES[weights_dtype])
        self.model.eval()

    def __call__(self, batch: Mapping[str, np.ndarray]) -> Dict[str, np.ndarray]:
        """batch: loader-layout feature dict (no labels required).
        Returns {head: (N,) probabilities}. Every column is padded on the
        host first, then each is copied to the device."""
        with tracing.span("predictor.call"):
            n = next(iter(batch.values())).shape[0]
            b = _bucket(n, self.min_bucket)
            with tracing.span("predictor.pad"):
                cols = {}
                for k, v in batch.items():
                    if k in ("labels", "_valid"):
                        continue
                    v = np.asarray(v)
                    if b != n:
                        v = np.concatenate([v, np.repeat(v[:1], b - n, axis=0)], axis=0)
                    cols[k] = v
            with tracing.span("predictor.h2d"):
                padded = {k: torch.from_numpy(v).to(self.device) for k, v in cols.items()}
            with torch.inference_mode():
                with tracing.span("predictor.forward"):
                    heads = serving_heads(self.model(padded))
                with tracing.span("predictor.d2h"):
                    return {head: p[:n].float().cpu().numpy() for head, p in heads.items()}


# -- portable serving artifacts (torch.export) ---------------------------------------


class ServingModule(nn.Module):
    """The eval forward of ``model`` and its heads, as ``Predictor.__call__``
    computes them; the batch includes ``labels``, which no model reads in
    eval (the JAX artifact takes them too)."""

    def __init__(self, model: nn.Module):
        super().__init__()
        self.model = model

    def forward(self, batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        return serving_heads(self.model(batch))


def export_serving_artifact(predictor: Predictor, path: str, batch_size: int = 256) -> None:
    """Write ``torch.export`` of the predictor's eval forward to ``path``.

    The counterpart of the JAX package's StableHLO artifact: the weights
    (bf16 ones included) are saved in the program, the batch shape is
    fixed at ``batch_size`` and ``labels`` are an input fed zeros. The
    program is traced on the predictor's device and holds the kernels as
    the registered operators ``rank_tpu_torch::din_attention``,
    ``rank_tpu_torch::cin_layer_t`` and, traced on the card, DIEN's
    ``rank_tpu_torch::gru_seq_fwd``.
    """
    from .data.synthetic import make_synthetic_dataset

    sample = make_synthetic_dataset(predictor.schema, num_rows=batch_size, seed=0)
    sample = {k: v for k, v in sample.items() if k not in ("labels", "_valid")}
    sample["labels"] = np.zeros((batch_size, len(predictor.schema.labels)), np.float32)
    batch = {k: torch.from_numpy(v).to(predictor.device) for k, v in sample.items()}
    module = ServingModule(predictor.model).eval()
    with torch.no_grad():
        program = torch.export.export(module, (batch,), strict=False)
    meta = {"batch_size": batch_size, "device": str(predictor.device),
            "inputs": {k: [list(v.shape), str(v.dtype)] for k, v in sample.items()}}
    torch.export.save(program, path, extra_files={_ARTIFACT_META: json.dumps(meta)})


def load_serving_artifact(
    path: str, device: Union[str, torch.device] = "cuda",
) -> Callable[[Mapping[str, np.ndarray]], Dict[str, np.ndarray]]:
    """Load an ``export_serving_artifact`` file onto ``device`` (the card
    unless the caller asks for the CPU; raises when there is no CUDA
    device). Returns ``fn(batch) -> {head: (batch_size,) f32 numpy}`` for
    batches of exactly the exported batch size (pad as
    ``Predictor.__call__`` does); ``labels`` may be left out and are fed
    zeros. On the card the program launches the hand-written kernels, or
    raises where they cannot build or launch."""
    from .ops import kernels  # noqa: F401  (registers the operators the program names)

    device = resolve_device(device)
    extra = {_ARTIFACT_META: ""}
    program = torch.export.load(path, extra_files=extra)
    meta = json.loads(extra[_ARTIFACT_META])
    if torch.device(meta["device"]) != device:
        from torch.export.passes import move_to_device_pass

        program = move_to_device_pass(program, device)
    module = program.module()
    inputs = {k: (tuple(shape), np.dtype(dtype)) for k, (shape, dtype) in meta["inputs"].items()}

    def fn(batch: Mapping[str, np.ndarray]) -> Dict[str, np.ndarray]:
        tensors = {}
        for k, (shape, dtype) in inputs.items():
            v = np.zeros(shape, dtype) if k == "labels" and k not in batch else batch[k]
            v = np.asarray(v, dtype)
            if v.shape != shape:
                raise ValueError(f"{k} has shape {v.shape}; the artifact takes {shape}")
            tensors[k] = torch.from_numpy(v).to(device)
        with torch.no_grad():
            out = module(tensors)
        return {head: p.float().cpu().numpy() for head, p in out.items()}

    return fn
