"""PNN product layers, inner and outer (port of ``rank_tpu/ops/product.py``;
Qu et al., ICDM 2016).

  * inner: all pairwise inner products <v_i, v_j>, (B, P);
  * outer: with the paper's sum-pooling p = (sum_f v)(sum_f v)^T, each of
    K outputs is the quadratic form s^T W_k s, computed as one einsum so
    the (B, D, D) outer product is never formed.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from .fm import pairwise_dot
from .mlp import einsum, xavier_uniform_


class InnerProductLayer(nn.Module):
    def forward(self, emb: torch.Tensor) -> torch.Tensor:
        """(B, F, D) -> (B, P) pairwise inner products."""
        return pairwise_dot(emb)


class OuterProductLayer(nn.Module):
    """``w`` is (K, D, D) under flax's xavier_uniform (fans D*K each)."""

    def __init__(self, dim: int, num_outputs: int = 64,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.w = nn.Parameter(xavier_uniform_(torch.empty(num_outputs, dim, dim), generator))

    def forward(self, emb: torch.Tensor) -> torch.Tensor:
        """(B, F, D) -> (B, num_outputs)."""
        s = emb.sum(dim=1)  # (B, D) sum pooling, paper eq. (9)
        return einsum("bd,kde,be->bk", s, self.w, s)
