"""AutoInt interacting layer: multi-head self-attention over fields (port
of ``rank_tpu/ops/autoint.py``; Song et al., CIKM 2019, eq. (4)-(7)).

Per head, plain inner-product scores (no sqrt(d) scaling, per the paper)
and a softmax over fields; the heads are concatenated, a bias-free
residual projection ``w_res`` is added, then ReLU, returned in f32.

Precision follows the JAX layer: parameters are f32 and are cast to
``compute_dtype`` at the call (flax's ``dtype=``). With ``score_dtype``
bfloat16 and a bf16 compute dtype the (B, F, F) scores and weights are
stored in bf16 with an f32 exp and sum (``softmax_lowp``); otherwise the
softmax runs in f32 and its weights are cast to the compute dtype. The JAX
layer's ``attn_impl`` formulations ('vpu', 'einsum') compute one function,
computed here once by batched matmuls.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from .attention import softmax_lowp
from .mlp import dense_layer, lecun_normal_, linear_in

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


class DenseGeneral(nn.Module):
    """flax's bias-free ``nn.DenseGeneral`` from D_in to (heads, att_dim):
    the raw ``kernel`` (D_in, heads, att_dim), lecun_normal over fan_in D_in."""

    def __init__(self, d_in: int, heads: int, att_dim: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.kernel = nn.Parameter(lecun_normal_(torch.empty(d_in, heads, att_dim), d_in, generator))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, F, D_in) -> (B, F, heads, att_dim), in ``x``'s dtype."""
        return torch.einsum("bfd,dhe->bfhe", x, self.kernel.to(x.dtype))


class AutoIntLayer(nn.Module):
    def __init__(
        self,
        d_in: int,
        num_heads: int = 2,
        att_dim: int = 32,
        compute_dtype: str = "bfloat16",
        score_dtype: str = "float32",
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.num_heads, self.att_dim = num_heads, att_dim
        self.compute_dtype = DTYPES[compute_dtype]
        self.lowp_scores = score_dtype == "bfloat16" and self.compute_dtype != torch.float32
        for name in ("w_q", "w_k", "w_v"):
            self.add_module(name, DenseGeneral(d_in, num_heads, att_dim, generator))
        self.w_res = dense_layer(d_in, num_heads * att_dim, generator=generator, bias=False)

    def forward(self, e: torch.Tensor) -> torch.Tensor:
        """e: (B, F, D_in) -> (B, F, num_heads * att_dim) in f32."""
        b, f, _ = e.shape
        ec = e.to(self.compute_dtype)
        q, k, v = self.w_q(ec), self.w_k(ec), self.w_v(ec)
        scores = torch.einsum("bfhd,bghd->bhfg", q, k)  # unscaled, per the paper
        if self.lowp_scores:
            weights = softmax_lowp(scores)
        else:
            weights = torch.softmax(scores.float(), dim=-1).to(self.compute_dtype)
        out = torch.einsum("bhfg,bghd->bfhd", weights, v).reshape(b, f, -1)
        return torch.relu(out + linear_in(self.w_res, ec)).float()
