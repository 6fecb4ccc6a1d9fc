"""Activations: Dice, PReLU, LeakyReLU (port of ``rank_tpu/ops/activations.py``).

  * Dice: ``alpha*(1-p)*x + p*x`` with ``p = sigmoid(BatchNorm(x))``,
    BatchNorm without affine parameters, eps 1e-5 and torch momentum 0.01
    (flax decay 0.99). Its BatchNorm is registered as ``BatchNorm_0``, the
    flax name, so ``interop.py`` maps it mechanically.
  * PReLU: one shared alpha initialised to 0.25, as torch ``nn.PReLU()``.
  * leaky_relu: BST's ``f1*x + f2*|x|`` form.
"""

from __future__ import annotations

import torch
from torch import nn


def batch_norm_last(norm: nn.BatchNorm1d, x: torch.Tensor) -> torch.Tensor:
    """Apply ``norm`` over every axis but the last, as flax's BatchNorm does."""
    return norm(x.reshape(-1, x.shape[-1])).reshape(x.shape)


class Dice(nn.Module):
    """Data-adaptive activation from the DIN paper, with learned alpha."""

    def __init__(self, num_features: int, momentum: float = 0.01, epsilon: float = 1e-5):
        super().__init__()
        self.alpha = nn.Parameter(torch.zeros(num_features))
        self.BatchNorm_0 = nn.BatchNorm1d(
            num_features, eps=epsilon, momentum=momentum, affine=False
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        p = torch.sigmoid(batch_norm_last(self.BatchNorm_0, x))
        return self.alpha * (1.0 - p) * x + p * x


class PReLU(nn.Module):
    """Parametric ReLU with one learned alpha, shared by every channel."""

    def __init__(self, init: float = 0.25):
        super().__init__()
        self.alpha = nn.Parameter(torch.full((1,), init))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.clamp_min(x, 0.0) + self.alpha * torch.clamp_max(x, 0.0)


def leaky_relu(x: torch.Tensor, leak: float = 0.01) -> torch.Tensor:
    """BST's |x|-form LeakyReLU; identical to max(x, leak*x)."""
    f1 = 0.5 * (1.0 + leak)
    f2 = 0.5 * (1.0 - leak)
    return f1 * x + f2 * torch.abs(x)
