"""Weights drawn on the device from the seed, in one call.

The port builds a model by drawing each leaf on the host from a generator
(``build_model``). The benchmark builds it once with a fixed seed, then
draws every leaf anew on the device from the run's seed, keeping the scale
of the model's own initialiser:

  * ``trained`` (a model about to train): a leaf that its module fills with
    one constant (biases, BatchNorm's scale and shift, Dice's alpha) keeps
    it; every other leaf becomes N(0, s^2), s the standard deviation of the
    module's own draw;
  * ``served`` (a model as if trained): constant leaves are moved by
    N(0, 0.1^2) too, and BatchNorm's running statistics are drawn
    (mean N(0, 0.1^2), variance exp(N(0, 0.2^2))), so that eval-mode
    normalisation does work.
"""

from __future__ import annotations

import torch
from torch import nn


@torch.no_grad()
def redraw_(model: nn.Module, gen: torch.Generator, served: bool = False) -> None:
    leaves = []
    for name, p in model.named_parameters():
        constant = bool(p.min() == p.max())
        if not constant:
            leaves.append((p, float(p.std()), 0.0))
        elif served:
            leaves.append((p, 0.1, 1.0))
    if served:
        for name, b in model.named_buffers():
            if name.endswith("running_mean"):
                leaves.append((b, 0.1, 0.0))
            elif name.endswith("running_var"):
                leaves.append((b, 0.2, None))
    total = sum(p.numel() for p, _, _ in leaves)
    flat = torch.randn(total, generator=gen, device=gen.device)
    start = 0
    for p, scale, keep in leaves:
        draw = flat[start:start + p.numel()].view_as(p) * scale
        start += p.numel()
        if keep is None:  # a variance: exp of the draw
            p.copy_(torch.exp(draw))
        else:
            p.copy_(keep * p + draw)
