"""Carry weights into the port's modules: the JAX package's, and the
original repo's trained checkpoints.

``state_dict_from_flax(model, variables)`` takes flax variables as a
nested dict of arrays, ``{"params": ..., "batch_stats": ...}`` (unboxed:
``flax.linen.meta.unbox`` strips the ``nn.Partitioned`` wrappers of the
embedding tables), and returns ``model``'s ``state_dict``.

The port registers its submodules under the flax module names (``tables``,
``table_<name>``, ``attention``, ``fcn``, ``Dense_i``, ``Dice_i``,
``BatchNorm_i``, ``output``), so the module path maps 1:1 and only the
leaf changes with the module's type:

  * ``nn.Linear``: ``weight`` <- ``kernel`` transposed from (in, out) to
    (out, in); ``bias`` <- ``bias``. A bias-free layer (flax's
    ``use_bias=False``: FiBiNet's ``senet``, AutoInt's ``w_res``) has
    ``weight`` only, and flax ``kernel`` only;
  * ``nn.Embedding``: ``weight`` <- ``embedding``, rows 1:1;
  * BatchNorm: ``weight``/``bias`` <- ``scale``/``bias`` in ``params``;
    ``running_mean``/``running_var`` <- ``mean``/``var`` in
    ``batch_stats``; ``num_batches_tracked`` has no flax counterpart and
    is set to 0 (Dice's BatchNorm has no affine parameters);
  * ``nn.LayerNorm`` (the BST block's ``norm1``/``norm2``): ``weight`` <-
    ``scale``, ``bias`` <- ``bias``;
  * any other parameter (DINAttention's ``w1..b3``, Dice's ``alpha``, the
    cross weights, the GRU kernels, AutoInt's ``DenseGeneral`` ``kernel``
    in flax's (D_in, heads, att_dim) layout) <- the flax param of the same
    name, in the same layout.

Every key must match: a missing flax entry, a wrong shape or a flax entry
left over raises. A bf16 leaf (the variables of a JAX Predictor built with
``weights_dtype='bfloat16'``, ml_dtypes' ``bfloat16``, which
``torch.from_numpy`` refuses) is carried over exactly, through f32, as a
bf16 tensor; every other leaf takes the model's dtype.

``import_reference_checkpoint(path, model_name, state_dict)`` is the port
of ``rank_tpu/interop.py``: it warm-starts dcn or deepcrossing from the
original repo's ``best_model.pth``. Every tensor the original trained and
saved (embedding tables, DCN's MLP tower, the output layer) lands on the
port's parameter of the same role; layers the original created fresh in
``forward`` and never saved (DCN's cross weights, DeepCrossing's residual
units) keep their fresh initialisation. Both sides are torch layouts
(``nn.Linear`` weights (out, in), embedding rows 1:1 with the +1 OOV row),
so no tensor is transposed, where the JAX import transposes every kernel.
"""

from __future__ import annotations

from typing import Dict, Iterator, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn

Path = Tuple[str, ...]


def _flatten(tree: Mapping, prefix: Path = ()) -> Iterator[Tuple[Path, np.ndarray]]:
    for key, value in tree.items():
        if isinstance(value, Mapping):
            yield from _flatten(value, prefix + (key,))
        else:
            yield prefix + (key,), np.asarray(value)


def _flax_source(module: nn.Module, scope: Path, leaf: str) -> Optional[Tuple[Path, bool]]:
    """(flax path, transpose) for a state_dict entry, or None when flax has
    no counterpart."""
    if isinstance(module, nn.Linear):
        return ("params", *scope, {"weight": "kernel", "bias": "bias"}[leaf]), leaf == "weight"
    if isinstance(module, nn.Embedding):
        return ("params", *scope, "embedding"), False
    if isinstance(module, nn.LayerNorm):
        return ("params", *scope, {"weight": "scale", "bias": "bias"}[leaf]), False
    if isinstance(module, nn.modules.batchnorm._BatchNorm):
        if leaf == "num_batches_tracked":
            return None
        if leaf.startswith("running_"):
            return ("batch_stats", *scope, leaf[len("running_"):]), False
        return ("params", *scope, {"weight": "scale", "bias": "bias"}[leaf]), False
    return ("params", *scope, leaf), False


def state_dict_from_flax(model: nn.Module, variables: Mapping) -> Dict[str, torch.Tensor]:
    flat = dict(_flatten(variables))
    out: Dict[str, torch.Tensor] = {}
    for key, want in model.state_dict().items():
        module_path, _, leaf = key.rpartition(".")
        scope = tuple(module_path.split(".")) if module_path else ()
        source = _flax_source(model.get_submodule(module_path), scope, leaf)
        if source is None:
            out[key] = torch.zeros_like(want, device="cpu")
            continue
        path, transpose = source
        if path not in flat:
            raise KeyError(f"flax variables have no {'/'.join(path)} for {key}")
        value = flat.pop(path)
        if transpose:
            value = value.T
        if value.shape != tuple(want.shape):
            raise ValueError(
                f"{'/'.join(path)} has shape {value.shape}; {key} needs {tuple(want.shape)}"
            )
        if value.dtype.name == "bfloat16":  # exact: f32 holds every bf16 value
            out[key] = torch.from_numpy(value.astype(np.float32)).to(torch.bfloat16)
        else:
            out[key] = torch.tensor(value, dtype=want.dtype)
    if flat:
        raise KeyError(
            "flax variables with no counterpart in the model: "
            + ", ".join("/".join(p) for p in sorted(flat))
        )
    return out


# -- the original repo's checkpoints -----------------------------------------

REFERENCE_FIELDS = (
    "userid", "device", "authorid", "bgm_song_id", "bgm_singer_id",
    "manual_tag_list",
)


def reference_mapping(model_name: str) -> Dict[str, str]:
    """The original repo's state_dict key -> the port's state_dict key."""
    mapping = {f"embeddings.{f}.weight": f"tables.table_{f}.weight" for f in REFERENCE_FIELDS}
    if model_name == "dcn":
        for i, li in enumerate((0, 2, 4)):  # torch Sequential Linear slots
            mapping[f"dnn.{li}.weight"] = f"dnn.Dense_{i}.weight"
            mapping[f"dnn.{li}.bias"] = f"dnn.Dense_{i}.bias"
    elif model_name != "deepcrossing":
        raise ValueError(
            f"no reference checkpoint mapping for {model_name!r}; the "
            "reference ships .pth files for dcn and deepcrossing only"
        )
    mapping["output_layer.weight"] = "output.weight"
    mapping["output_layer.bias"] = "output.bias"
    return mapping


def import_reference_checkpoint(
    path: str, model_name: str, state_dict: Mapping[str, torch.Tensor]
) -> Tuple[Dict[str, torch.Tensor], Dict[str, str]]:
    """Load an original ``best_model.pth`` and copy its tensors into a copy
    of ``state_dict`` (a model's; each tensor takes that entry's dtype and
    device). Returns (state_dict, report), where report maps every
    checkpoint tensor to the key it landed on. Raises if a checkpoint
    tensor has no home or a shape differs: a partial import would be worse
    than an error. The port has no table sharding, so a table with fewer
    rows than the model's raises too (``rank_tpu``'s import with
    ``table_padding=None``)."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    mapping = reference_mapping(model_name)
    unmapped = set(sd) - set(mapping)
    if unmapped:
        raise ValueError(f"checkpoint tensors with no home in the model: {sorted(unmapped)}")
    out = dict(state_dict)
    report: Dict[str, str] = {}
    for ref_key, key in mapping.items():
        if ref_key not in sd:
            continue  # mapping is a superset for models with optional parts
        if key not in out:
            raise KeyError(f"the model has no {key} for {ref_key}")
        have, want = tuple(out[key].shape), tuple(sd[ref_key].shape)
        if have != want:
            raise ValueError(f"shape mismatch at {key}: model {have} vs import {want}")
        out[key] = sd[ref_key].to(dtype=out[key].dtype, device=out[key].device)
        report[ref_key] = key
    return out, report
