"""Carry the JAX package's weights over into the port's modules.

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
left over raises.
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
        out[key] = torch.tensor(value, dtype=want.dtype)
    if flat:
        raise KeyError(
            "flax variables with no counterpart in the model: "
            + ", ".join("/".join(p) for p in sorted(flat))
        )
    return out
