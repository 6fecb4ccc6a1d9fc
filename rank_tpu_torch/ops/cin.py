"""Compressed Interaction Network, xDeepFM's CIN (port of ``rank_tpu/ops/cin.py``).

Layer k maps X^k (B, H_k, D) to X^{k+1} (B, H_{k+1}, D):

    X^{k+1}[:, o, :] = sum_{h, f} W^{k+1}[o, h, f] * X^k[:, h, :] * X^0[:, f, :]

Every backend runs the stack in the transposed (B, D, .) layout of the
fused kernel (``kernels/cin.py``): one transpose of x0 at entry, a
split_half split along the last axis, and a sum over D for pooling, so no
per-layer transpose is made. The contraction is the same as the JAX
module's standard-layout one.

backend:
  * ``'auto'``: the registered operator ``rank_tpu_torch::cin_layer_t``:
    the hand-written CUDA kernel for every layer on CUDA tensors (layer 0,
    with H = F, included; any H and F), the plain version on CPU tensors.
    The JAX package's per-layer size threshold (``cin_layer_auto_t``)
    decides TPU dispatch and is not ported;
  * ``'pallas'``: the same operator (the JAX package's name for its kernel
    backend); raises on CPU tensors;
  * ``'jnp'``: the plain torch version, on any device.
Both kernel backends train through the operator's gradient, which
recomputes through the plain version.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from .kernels import cin as kernels
from .mlp import xavier_uniform_  # flax's fans: fan_in = H*O, fan_out = F*O on (O, H, F)


class CIN(nn.Module):
    def __init__(
        self,
        num_fields: int,
        layer_sizes: Sequence[int] = (128, 128),
        split_half: bool = True,
        backend: str = "auto",
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        if backend not in ("auto", "pallas", "jnp"):
            raise ValueError(f"unknown kernel backend {backend!r}")
        self.layer_sizes = tuple(layer_sizes)
        self.split_half = split_half
        self.backend = backend
        h = num_fields
        self.out_features = 0
        for i, size in enumerate(self.layer_sizes):
            last = i == len(self.layer_sizes) - 1
            if split_half and not last and size % 2:
                raise ValueError("split_half requires even CIN layer sizes")
            w = nn.Parameter(torch.empty(size, h, num_fields))
            xavier_uniform_(w, generator)
            self.register_parameter(f"w_{i}", w)
            h = size // 2 if split_half and not last else size
            self.out_features += h if split_half and not last else size

    def forward(self, x0: torch.Tensor) -> torch.Tensor:
        """x0: (B, F, D) field embeddings -> (B, sum of pooled map counts)."""
        layer = {
            "auto": kernels.cin_layer_t,
            "pallas": kernels.cin_layer_cuda_fn_t,
            "jnp": kernels.cin_layer_plain_t,
        }[self.backend]
        x0_t = x0.transpose(1, 2).contiguous()  # (B, D, F)
        xk_t = x0_t
        pooled = []
        for i, size in enumerate(self.layer_sizes):
            xnext_t = layer(xk_t, x0_t, getattr(self, f"w_{i}"))  # (B, D, size)
            if self.split_half and i < len(self.layer_sizes) - 1:
                next_in, direct = torch.split(xnext_t, size // 2, dim=2)
                next_in = next_in.contiguous()  # the kernel takes contiguous rows
            else:
                next_in, direct = xnext_t, xnext_t
            pooled.append(direct.sum(dim=1))  # sum over D -> (B, maps)
            xk_t = next_in
        return torch.cat(pooled, dim=-1)
