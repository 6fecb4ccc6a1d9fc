"""SENET field reweighting and bilinear field interaction, FiBiNet's two
blocks (port of ``rank_tpu/ops/senet.py``; Huang et al., RecSys 2019).

  * SENET: squeeze the field embeddings (mean over D), excite through
    F -> F/r -> F with ReLU after both bias-free layers (``Dense_0``,
    ``Dense_1``, flax's lecun_normal), reweight each field by its scalar.
  * Bilinear interaction: p_ij = (v_i W) * v_j for each field pair, W
    shared by all pairs (``'all'``, (D, D)), one per field (``'each'``,
    (F, D, D)) or one per pair (``'interaction'``, (P, D, D)); ``w`` under
    flax's xavier_uniform.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from .fm import pair_index_tensors, pair_indices
from .mlp import dense_layer, einsum, matmul, xavier_uniform_


class SENETLayer(nn.Module):
    def __init__(self, num_fields: int, reduction_ratio: int = 3,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        mid = max(1, num_fields // reduction_ratio)
        self.Dense_0 = dense_layer(num_fields, mid, generator=generator, bias=False)
        self.Dense_1 = dense_layer(mid, num_fields, generator=generator, bias=False)

    def forward(self, emb: torch.Tensor) -> torch.Tensor:
        """emb: (B, F, D) -> reweighted (B, F, D)."""
        a = torch.relu(self.Dense_1(torch.relu(self.Dense_0(emb.mean(dim=-1)))))
        return emb * a[:, :, None]


class BilinearInteraction(nn.Module):
    def __init__(self, num_fields: int, dim: int, bilinear_type: str = "interaction",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        shapes = {"all": (dim, dim), "each": (num_fields, dim, dim),
                  "interaction": (len(pair_indices(num_fields)[0]), dim, dim)}
        if bilinear_type not in shapes:
            raise ValueError(f"unknown bilinear_type {bilinear_type!r}")
        self.bilinear_type = bilinear_type
        self.w = nn.Parameter(xavier_uniform_(torch.empty(shapes[bilinear_type]), generator))

    def forward(self, emb: torch.Tensor) -> torch.Tensor:
        """emb: (B, F, D) -> (B, P, D) pair interactions."""
        i, j = pair_index_tensors(emb.shape[1], emb.device)
        if self.bilinear_type == "all":
            left = matmul(emb, self.w)
            return left[:, i, :] * emb[:, j, :]
        if self.bilinear_type == "each":
            left = einsum("bfd,fde->bfe", emb, self.w)
            return left[:, i, :] * emb[:, j, :]
        left = einsum("bpd,pde->bpe", emb[:, i, :], self.w)
        return left * emb[:, j, :]
