"""Configurable MLP tower (port of ``rank_tpu/ops/mlp.py``).

``order`` keeps each reference model's layer ordering:

  * ``bn_act``: Linear -> BN -> activation -> Dropout (DeepFM, BST)
  * ``act_bn``: Linear -> activation -> BN -> Dropout (DIN)

Layers are registered under the flax module names (``Dense_i``,
``BatchNorm_i``, ``Dice_i``, ``PReLU_i``; ``final_logit``'s output layer is
``Dense_{len(hidden_units)}``) so ``interop.py`` maps the JAX package's
variables mechanically. BatchNorm (``activations.BatchNorm``) uses eps 1e-5
and flax's decay 0.99, and trains as flax's does.

The initialisers of flax's ``nn.initializers`` that the zoo's raw
parameters use live here too, with flax's fan rule.

Dtype promotion. flax's ``nn.Dense`` and ``nn.BatchNorm`` with ``dtype=None``
and jnp's ``@``/``einsum`` compute in the dtype their operands promote to,
so bf16 weights times f32 activations give an f32 product (the bf16
serving ``Predictor``). torch's ``F.linear``, ``@``, ``einsum`` and
``F.batch_norm`` raise on mixed dtypes instead. ``promote`` casts the
operands to ``torch.promote_types`` of them; ``matmul``, ``einsum`` and
``Linear`` apply it at each product that flax promotes. ``linear_in`` is
the other rule: flax's explicit ``dtype=`` (the BST and AutoInt blocks),
which casts the weights to the activations' dtype.
"""

from __future__ import annotations

import functools
import math
from typing import Callable, List, Optional, Sequence, Tuple

import torch
from torch import nn

from .activations import BatchNorm, Dice, PReLU, batch_norm_last, leaky_relu

# standard deviation of a unit normal truncated to [-2, 2]; flax's
# truncated-normal initialisers divide by it so the draw keeps its variance
_TRUNC_STD = 0.87962566103423978


def init_dense_(
    kernel: torch.Tensor,
    bias: Optional[torch.Tensor],
    fan_in: int,
    dense_init: str,
    generator: Optional[torch.Generator],
) -> None:
    """Fill a dense layer's kernel and bias in place.

    ``lecun`` -> flax's defaults (lecun_normal kernel, zero bias);
    ``torch`` -> torch nn.Linear's defaults (uniform +-1/sqrt(fan_in) for
    kernel AND bias). Entries are i.i.d., so the kernel's layout does not
    matter; ``fan_in`` is passed explicitly.
    """
    with torch.no_grad():
        if dense_init == "torch":
            bound = float(fan_in) ** -0.5
            nn.init.uniform_(kernel, -bound, bound, generator=generator)
            if bias is not None:
                nn.init.uniform_(bias, -bound, bound, generator=generator)
        elif dense_init == "lecun":
            lecun_normal_(kernel, fan_in, generator)
            if bias is not None:
                bias.zero_()
        else:
            raise ValueError(f"unknown dense_init {dense_init!r}")


def flax_fans(shape: Sequence[int]) -> Tuple[int, int]:
    """(fan_in, fan_out) as flax's ``variance_scaling`` counts them: the
    last two axes are in and out, every leading axis is receptive field.
    torch's ``nn.init`` counts axes 1 and 0 instead, which gives other
    bounds for the zoo's 3-D weights (CIN's (O, H, F), the bilinear
    (P, D, D), the outer product's (K, D, D))."""
    receptive = math.prod(shape[:-2])
    return shape[-2] * receptive, shape[-1] * receptive


def xavier_uniform_(w: torch.Tensor, generator: Optional[torch.Generator]) -> torch.Tensor:
    """flax's ``xavier_uniform``: U(+-sqrt(6 / (fan_in + fan_out)))."""
    fan_in, fan_out = flax_fans(w.shape)
    bound = math.sqrt(6.0 / (fan_in + fan_out))
    with torch.no_grad():
        return w.uniform_(-bound, bound, generator=generator)


def truncated_normal_(w: torch.Tensor, variance: float, generator: Optional[torch.Generator]) -> torch.Tensor:
    """flax's ``truncated_normal`` variance scaling: a normal cut at two
    standard deviations and rescaled so the draw keeps ``variance``."""
    std = math.sqrt(variance) / _TRUNC_STD
    with torch.no_grad():
        return nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std, generator=generator)


def xavier_normal_(w: torch.Tensor, generator: Optional[torch.Generator]) -> torch.Tensor:
    """flax's ``xavier_normal`` (truncated): variance 2 / (fan_in + fan_out)."""
    fan_in, fan_out = flax_fans(w.shape)
    return truncated_normal_(w, 2.0 / (fan_in + fan_out), generator)


def lecun_normal_(w: torch.Tensor, fan_in: int, generator: Optional[torch.Generator]) -> torch.Tensor:
    """flax's ``lecun_normal`` (truncated): variance 1 / fan_in."""
    return truncated_normal_(w, 1.0 / fan_in, generator)


def promoted_dtype(*tensors: torch.Tensor) -> torch.dtype:
    """The dtype the operands promote to: bf16 with f32 gives f32."""
    return functools.reduce(torch.promote_types, (t.dtype for t in tensors))


def promote(*tensors: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """The operands cast to ``promoted_dtype`` of them (flax's
    ``promote_dtype``); like dtypes are left as they are, without a call
    to ``.to``, which costs host time on every product."""
    dtype = promoted_dtype(*tensors)
    return tuple(t if t.dtype == dtype else t.to(dtype) for t in tensors)


def cast_contiguous(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``t`` as a contiguous ``dtype`` tensor; ``t`` itself, without a call
    to ``.to`` or ``.contiguous``, where it already is one (the kernels'
    operators take this on every launch)."""
    if t.dtype == dtype and t.is_contiguous():
        return t
    return t.to(dtype).contiguous()


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` in the promoted dtype, as jnp's ``@``."""
    return torch.matmul(*promote(a, b))


def einsum(equation: str, *operands: torch.Tensor) -> torch.Tensor:
    """``torch.einsum`` in the promoted dtype, as ``jnp.einsum``."""
    return torch.einsum(equation, *promote(*operands))


class Linear(nn.Linear):
    """``nn.Linear`` that computes in the promoted dtype of its input and
    parameters, as flax's ``nn.Dense`` with ``dtype=None``."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.bias is None:
            return torch.nn.functional.linear(*promote(x, self.weight))
        return torch.nn.functional.linear(*promote(x, self.weight, self.bias))


def dense_layer(
    fan_in: int,
    features: int,
    dense_init: str = "lecun",
    generator: Optional[torch.Generator] = None,
    bias: bool = True,
) -> nn.Linear:
    """``Linear`` initialised as the JAX package's ``nn.Dense`` under
    ``dense_init``, drawing only from ``generator``; ``bias=False`` is
    flax's ``use_bias=False``."""
    layer = Linear(fan_in, features, bias=bias, device="meta").to_empty(device="cpu")
    init_dense_(layer.weight, layer.bias, fan_in, dense_init, generator)
    return layer


def linear_in(layer: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    """``layer`` applied in ``x``'s dtype: flax's ``nn.Dense(dtype=...)``,
    which keeps f32 parameters and casts them at the call."""
    bias = None if layer.bias is None else layer.bias.to(x.dtype)
    return torch.nn.functional.linear(x, layer.weight.to(x.dtype), bias)


ACTIVATIONS = ("relu", "dice", "prelu", "leakyrelu")


class MLPTower(nn.Module):
    def __init__(
        self,
        in_features: int,
        hidden_units: Sequence[int],
        activation: str = "relu",
        batch_norm: bool = True,
        dropout_rate: float = 0.1,
        order: str = "bn_act",
        dense_init: str = "lecun",
        generator: Optional[torch.Generator] = None,
        final_logit: bool = False,
    ):
        super().__init__()
        if activation not in ACTIVATIONS:
            raise ValueError(f"unknown activation {activation!r}")
        if order not in ("bn_act", "act_bn"):
            raise ValueError(f"unknown order {order!r}")
        self.order = order
        # (dense, activation, batch norm or None, dropout or None) per layer;
        # the modules themselves are registered under their flax names
        self._layers: List[Tuple[nn.Linear, Callable, Optional[BatchNorm], Optional[nn.Dropout]]] = []
        width_in = in_features
        for i, width in enumerate(hidden_units):
            dense = dense_layer(width_in, width, dense_init, generator)
            self.add_module(f"Dense_{i}", dense)
            if activation == "relu":
                act = torch.relu
            elif activation == "leakyrelu":
                act = leaky_relu
            else:
                act = Dice(width) if activation == "dice" else PReLU()
                self.add_module(f"{type(act).__name__}_{i}", act)
            norm = None
            if batch_norm:
                norm = BatchNorm(width)
                self.add_module(f"BatchNorm_{i}", norm)
            drop = None
            if dropout_rate > 0:
                drop = nn.Dropout(dropout_rate)
                self.add_module(f"Dropout_{i}", drop)
            self._layers.append((dense, act, norm, drop))
            width_in = width
        # final_logit: a Dense(1) output layer, as the JAX tower appends it
        self._final = f"Dense_{len(hidden_units)}" if final_logit else None
        if final_logit:
            self.add_module(self._final, dense_layer(width_in, 1, dense_init, generator))
            width_in = 1
        self.out_features = width_in

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for dense, act, norm, drop in self._layers:
            x = dense(x)
            if self.order == "bn_act":
                if norm is not None:
                    x = batch_norm_last(norm, x)
                x = act(x)
            else:  # act_bn — DIN ordering
                x = act(x)
                if norm is not None:
                    x = batch_norm_last(norm, x)
            if drop is not None:
                x = drop(x)
        return x if self._final is None else getattr(self, self._final)(x)
