"""DCN cross network and DeepCrossing residual units (port of ``rank_tpu/ops/cross.py``).

  * Cross layer: x_{l+1} = x0 * (x_l . w_l) + b_l + x_l, with registered
    weights (the reference re-creates them on every call, so it never
    trains them; see the JAX module).
  * Residual unit: ReLU(x + W2 ReLU(W1 x)).

Parameters carry the flax names: ``w_{l}`` (d, 1) and ``b_{l}`` (d,) in
``CrossNetwork``; ``ResidualUnit_{i}/Dense_{0,1}`` in ``ResidualStack``.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from .mlp import dense_layer, matmul, xavier_normal_


class CrossNetwork(nn.Module):
    """Stack of DCN-v1 cross layers over a shared x0.

    Initialisation follows the JAX module: flax's truncated xavier_normal
    under ``dense_init='lecun'``, N(0, 0.02) under ``'torch'``.
    ``frozen_random`` reproduces the reference's untrained random cross
    stack: N(0, 1) weights and zero biases that forward uses detached (the
    JAX ``stop_gradient``). They stay in the state dict, get no gradient,
    and Adam leaves them as they are, as optax's zero update does.
    """

    def __init__(
        self,
        dim: int,
        num_layers: int,
        dense_init: str = "lecun",
        frozen_random: bool = False,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.num_layers = num_layers
        self.frozen_random = frozen_random
        for l in range(num_layers):
            w = torch.empty(dim, 1)
            with torch.no_grad():
                if frozen_random:
                    w.normal_(0.0, 1.0, generator=generator)
                elif dense_init == "torch":
                    w.normal_(0.0, 0.02, generator=generator)
                else:
                    xavier_normal_(w, generator)
            self.register_parameter(f"w_{l}", nn.Parameter(w))
            self.register_parameter(f"b_{l}", nn.Parameter(torch.zeros(dim)))

    def forward(self, x0: torch.Tensor) -> torch.Tensor:
        """x0: (B, d) -> (B, d)."""
        x = x0
        for l in range(self.num_layers):
            w, b = getattr(self, f"w_{l}"), getattr(self, f"b_{l}")
            if self.frozen_random:
                w, b = w.detach(), b.detach()
            x = x0 * matmul(x, w) + b + x
        return x


class ResidualUnit(nn.Module):
    """DeepCrossing residual block: ReLU(x + W2 ReLU(W1 x))."""

    def __init__(self, dim: int, internal_dim: int, dense_init: str = "lecun",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.Dense_0 = dense_layer(dim, internal_dim, dense_init, generator)
        self.Dense_1 = dense_layer(internal_dim, dim, dense_init, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.relu(x + self.Dense_1(torch.relu(self.Dense_0(x))))


class ResidualStack(nn.Sequential):
    def __init__(self, dim: int, internal_dim: int, num_units: int, dense_init: str = "lecun",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        for i in range(num_units):
            self.add_module(f"ResidualUnit_{i}",
                            ResidualUnit(dim, internal_dim, dense_init, generator))
