"""BST transformer block (port of ``rank_tpu/ops/transformer.py``).

As the JAX block, and the reference's class variant (``bst.py:42-91``):

  * a learned positional embedding (``position_embedding``, flax's default
    embed init N(0, 1/d)) is added to the query and key inputs only; the
    values come from ``x`` itself;
  * multi-head attention with a key-padding mask. A fully masked row gets
    zero attention output (the masked softmax), where torch's SDPA would
    give NaN;
  * ``norm1`` takes ``queries + out``, where ``queries`` already holds the
    positions (not the textbook ``x + out``), then a d -> d LeakyReLU FFN,
    a residual and ``norm2``. Both LayerNorms use flax's epsilon, 1e-6
    (torch's default is 1e-5), and run in f32.

Precision: parameters are f32 and cast to ``compute_dtype`` at the call
(flax's ``dtype=``). With ``score_dtype`` bfloat16 and a bf16 compute
dtype the (B, h, T, T) scores and weights are stored in bf16 with an f32
exp and sum (``masked_softmax_lowp``); otherwise the scores are scaled and
softmaxed in f32 and the weights cast to the compute dtype.

``attn_impl``: the JAX block has three TPU formulations of one function
('vpu', 'vpu2', 'einsum'). The port accepts the three names and computes
the function once, by batched matmuls.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from .attention import masked_softmax, masked_softmax_lowp
from .autoint import DTYPES
from .mlp import dense_layer, linear_in

ATTN_IMPLS = ("vpu", "vpu2", "einsum")


class BSTTransformerBlock(nn.Module):
    def __init__(
        self,
        d_model: int,
        num_heads: int,
        max_len: int,
        dropout_rate: float = 0.1,
        compute_dtype: str = "bfloat16",
        attn_impl: str = "vpu",
        score_dtype: str = "float32",
        dense_init: str = "lecun",
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        if d_model % num_heads:
            raise ValueError(f"d_model {d_model} is not divisible by {num_heads} heads")
        if attn_impl not in ATTN_IMPLS:
            raise ValueError(f"unknown attn_impl {attn_impl!r}; one of {ATTN_IMPLS}")
        self.num_heads = num_heads
        self.compute_dtype = DTYPES[compute_dtype]
        self.lowp_scores = score_dtype == "bfloat16" and self.compute_dtype != torch.float32
        table = torch.empty(max_len, d_model).normal_(0.0, d_model ** -0.5, generator=generator)
        self.position_embedding = nn.Embedding.from_pretrained(table, freeze=False)
        # every dense layer of the block is d -> d
        for name in ("w_q", "w_k", "w_v", "w_o", "ffn_1", "ffn_2"):
            self.add_module(name, dense_layer(d_model, d_model, dense_init, generator))
        self.norm1 = nn.LayerNorm(d_model, eps=1e-6)
        self.norm2 = nn.LayerNorm(d_model, eps=1e-6)
        self.dropout = nn.Dropout(dropout_rate)

    def forward(self, x: torch.Tensor, key_valid: torch.Tensor) -> torch.Tensor:
        """x: (B, T, D) f32; key_valid: (B, T), True at real positions.
        Returns (B, T, D) f32."""
        b, t, d = x.shape
        h, cdt = self.num_heads, self.compute_dtype
        queries = (x + self.position_embedding.weight[:t]).to(cdt)
        heads = lambda y: y.reshape(b, t, h, d // h).transpose(1, 2)  # (B, h, T, dh)
        q = heads(linear_in(self.w_q, queries))
        k = heads(linear_in(self.w_k, queries))
        v = heads(linear_in(self.w_v, x.to(cdt)))
        scores = q @ k.transpose(-1, -2)  # (B, h, T, T)
        mask = key_valid[:, None, None, :]
        inv_sqrt_dh = 1.0 / math.sqrt(d // h)
        if self.lowp_scores:
            weights = masked_softmax_lowp(scores * torch.tensor(inv_sqrt_dh, dtype=cdt), mask)
        else:
            weights = masked_softmax(scores.float() * inv_sqrt_dh, mask).to(cdt)
        context = (weights @ v).transpose(1, 2).reshape(b, t, d)

        out = self.dropout(linear_in(self.w_o, context))
        h1 = self.norm1((queries + out).float()).to(cdt)
        ffn = self.dropout(F.leaky_relu(linear_in(self.ffn_1, h1), 0.01))
        ffn = self.dropout(linear_in(self.ffn_2, ffn))
        return self.norm2((h1 + ffn).float())
