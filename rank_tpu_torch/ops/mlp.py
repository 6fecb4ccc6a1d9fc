"""Configurable MLP tower (port of ``rank_tpu/ops/mlp.py``).

``order`` keeps each reference model's layer ordering:

  * ``bn_act``: Linear -> BN -> activation -> Dropout (DeepFM, BST)
  * ``act_bn``: Linear -> activation -> BN -> Dropout (DIN)

Layers are registered under the flax module names (``Dense_i``,
``BatchNorm_i``, ``Dice_i``, ``PReLU_i``) so ``interop.py`` maps the JAX
package's variables mechanically. BatchNorm (``activations.BatchNorm``)
uses eps 1e-5 and flax's decay 0.99, and trains as flax's does.
"""

from __future__ import annotations

import math
from typing import Callable, List, Optional, Sequence, Tuple

import torch
from torch import nn

from .activations import BatchNorm, Dice, PReLU, batch_norm_last, leaky_relu

# standard deviation of a unit normal truncated to [-2, 2]; flax's
# lecun_normal divides by it so the truncated draw keeps variance 1/fan_in
_TRUNC_STD = 0.87962566103423978


def init_dense_(
    kernel: torch.Tensor,
    bias: torch.Tensor,
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
            nn.init.uniform_(bias, -bound, bound, generator=generator)
        elif dense_init == "lecun":
            std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
            nn.init.trunc_normal_(kernel, 0.0, std, -2 * std, 2 * std, generator=generator)
            bias.zero_()
        else:
            raise ValueError(f"unknown dense_init {dense_init!r}")


def dense_layer(
    fan_in: int,
    features: int,
    dense_init: str = "lecun",
    generator: Optional[torch.Generator] = None,
) -> nn.Linear:
    """``nn.Linear`` initialised as the JAX package's ``nn.Dense`` under
    ``dense_init``, drawing only from ``generator``."""
    layer = nn.Linear(fan_in, features, device="meta").to_empty(device="cpu")
    init_dense_(layer.weight, layer.bias, fan_in, dense_init, generator)
    return layer


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
        return x
