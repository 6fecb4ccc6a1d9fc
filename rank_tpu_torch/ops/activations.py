"""Activations: Dice, PReLU, LeakyReLU (port of ``rank_tpu/ops/activations.py``),
and the BatchNorm they and the tower share.

  * BatchNorm: flax's ``nn.BatchNorm`` in train mode, torch's in eval mode
    (the two agree there). See its docstring for what differs from torch's
    train mode.
  * Dice: ``alpha*(1-p)*x + p*x`` with ``p = sigmoid(BatchNorm(x))``,
    BatchNorm without affine parameters, eps 1e-5 and flax decay 0.99.
    Its BatchNorm is registered as ``BatchNorm_0``, the flax name, so
    ``interop.py`` maps it mechanically.
  * PReLU: one shared alpha initialised to 0.25, as torch ``nn.PReLU()``.
  * leaky_relu: BST's ``f1*x + f2*|x|`` form.
"""

from __future__ import annotations

import functools

import torch
from torch import nn


class BatchNorm(nn.BatchNorm1d):
    """BatchNorm over (N, C) that trains as flax's ``nn.BatchNorm`` does.

    In train mode it normalises with the batch mean and the BIASED batch
    variance, computed as flax computes them (``E[x^2] - E[x]^2``, clipped
    at 0), and updates the running statistics as
    ``running = m * running + (1 - m) * batch`` with flax's decay ``m``
    (0.99), the variance biased too. torch's own train mode would store the
    unbiased variance. Eval mode is torch's, which normalises with the
    running statistics exactly as flax's eval mode does. The state-dict
    keys are torch's (``weight``, ``bias``, ``running_mean``,
    ``running_var``, ``num_batches_tracked``), so ``interop.py`` maps them.

    Dtypes follow flax's ``_normalize``: under bf16 parameters (the bf16
    serving ``Predictor``) the statistics stay f32, the arithmetic runs in
    f32 and the output takes the dtype that x, scale and bias promote to.
    """

    def __init__(self, num_features: int, eps: float = 1e-5, decay: float = 0.99,
                 affine: bool = True):
        super().__init__(num_features, eps=eps, momentum=1.0 - decay, affine=affine)
        self.decay = decay

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            affine = (self.weight, self.bias) if self.affine else ()
            out = functools.reduce(torch.promote_types, (p.dtype for p in affine), x.dtype)
            y = torch.nn.functional.batch_norm(
                *(_f32(t) for t in (x, self.running_mean, self.running_var, self.weight,
                                    self.bias)), False, 0.0, self.eps)
            return y if y.dtype == out else y.to(out)
        mean = x.mean(dim=0)
        var = torch.clamp_min((x * x).mean(dim=0) - mean * mean, 0.0)
        with torch.no_grad():
            self.running_mean.mul_(self.decay).add_(mean.detach(), alpha=1.0 - self.decay)
            self.running_var.mul_(self.decay).add_(var.detach(), alpha=1.0 - self.decay)
            self.num_batches_tracked.add_(1)
        mul = torch.rsqrt(var + self.eps)
        if self.affine:
            mul = mul * self.weight
        y = (x - mean) * mul
        return y + self.bias if self.affine else y


def _f32(t):
    """``t`` in f32; an f32 tensor or None as it is, without a call to
    ``.float()``, which costs host time on every eval forward."""
    return t if t is None or t.dtype == torch.float32 else t.float()


def batch_norm_last(norm: nn.BatchNorm1d, x: torch.Tensor) -> torch.Tensor:
    """Apply ``norm`` over every axis but the last, as flax's BatchNorm does."""
    return norm(x.reshape(-1, x.shape[-1])).reshape(x.shape)


class Dice(nn.Module):
    """Data-adaptive activation from the DIN paper, with learned alpha."""

    def __init__(self, num_features: int, momentum: float = 0.01, epsilon: float = 1e-5):
        super().__init__()
        self.alpha = nn.Parameter(torch.zeros(num_features))
        self.BatchNorm_0 = BatchNorm(num_features, eps=epsilon, decay=1.0 - momentum, affine=False)

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
