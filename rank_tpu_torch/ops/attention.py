"""Target attention over behaviour sequences, DIN and DIEN forms, and the
softmaxes the zoo shares (port of ``rank_tpu/ops/attention.py``).

  * DIN's local-activation unit: cross features [q, k, q-k, q*k] ->
    MLP(4d->64->32->1) scores; mask by sequence length; either the scaled
    masked softmax (``use_softmax``) or the raw masked scores; weighted-sum
    pool over keys. Zero-length sequences give an all-zero pooled vector.
  * DIEN's bilinear attention: score_t = h_t . (W e_target), masked
    softmax; a zero-length row gets all-zero weights.
  * ``masked_softmax_lowp`` / ``softmax_lowp``: the low-precision storage
    contract of the BST block and the AutoInt layer. Tensors of the
    scores' shape stay in the scores' dtype (bf16); the exp argument and
    the normalising sum run in f32.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from .mlp import einsum, init_dense_, matmul, xavier_normal_

MASK_NEG = -(2.0**32) + 1.0  # reference padding value, din.py:74


def length_mask(lengths: torch.Tensor, max_len: int) -> torch.Tensor:
    """(B,) lengths -> (B, T) boolean validity mask."""
    t = torch.arange(max_len, dtype=lengths.dtype, device=lengths.device)[None, :]
    return t < lengths[:, None]


def masked_softmax(scores: torch.Tensor, mask: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Softmax that returns zeros where every position is masked (rather
    than the NaN of a softmax over all -inf)."""
    masked = torch.where(mask, scores, MASK_NEG)
    m = torch.amax(masked, dim=dim, keepdim=True)
    e = torch.exp(masked - m) * mask.to(scores.dtype)
    denom = torch.sum(e, dim=dim, keepdim=True)
    return e / torch.clamp_min(denom, 1e-12)


def masked_softmax_lowp(scores: torch.Tensor, mask: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """``masked_softmax`` with storage in the scores' dtype: the exp argument
    and the normalising sum in f32, everything of the scores' shape in
    their dtype. bf16 has f32's exponent range, so the MASK_NEG sentinel and
    the max subtraction are safe."""
    masked = torch.where(mask, scores, MASK_NEG)
    m = torch.amax(masked, dim=dim, keepdim=True)
    e = (torch.exp((masked - m).float()) * mask.float()).to(scores.dtype)
    denom = torch.sum(e.float(), dim=dim, keepdim=True)
    return e * torch.reciprocal(torch.clamp_min(denom, 1e-12)).to(scores.dtype)


def softmax_lowp(scores: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """The unmasked ``masked_softmax_lowp``, under the same contract (the
    AutoInt layer's)."""
    m = torch.amax(scores, dim=dim, keepdim=True)
    e = torch.exp((scores - m).float()).to(scores.dtype)
    denom = torch.sum(e.float(), dim=dim, keepdim=True)
    return e * torch.reciprocal(torch.clamp_min(denom, 1e-12)).to(scores.dtype)


class DINAttention(nn.Module):
    """DIN local-activation unit with a registered scoring MLP.

    The weights ``w1..b3`` are raw parameters in flax's (in, out) layout,
    so the kernel reads them as the JAX kernel does.

    backend:
      * ``'auto'``: the registered operator ``rank_tpu_torch::din_attention``:
        a hand-written CUDA kernel on CUDA tensors, at every shape the JAX
        module takes (``kernels/din_attention.py`` chooses the kernel by
        shape), and the plain version on CPU tensors;
      * ``'pallas'``: the same operator (the JAX package's name for its
        kernel backend); raises on CPU tensors;
      * ``'jnp'``: the plain torch version, on any device.
    Both kernel backends train through the operator's gradient, which
    recomputes through the plain version.
    """

    def __init__(
        self,
        dim: int,
        hidden_units: Sequence[int] = (64, 32),
        use_softmax: bool = False,
        backend: str = "auto",
        dense_init: str = "lecun",
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        if backend not in ("auto", "pallas", "jnp"):
            raise ValueError(f"unknown kernel backend {backend!r}")
        self.use_softmax = use_softmax
        self.backend = backend
        h1, h2 = hidden_units
        shapes = {"w1": (4 * dim, h1), "b1": (h1,), "w2": (h1, h2), "b2": (h2,),
                  "w3": (h2, 1), "b3": (1,)}
        for name, shape in shapes.items():
            setattr(self, name, nn.Parameter(torch.empty(shape)))
        init_dense_(self.w1, self.b1, 4 * dim, dense_init, generator)
        init_dense_(self.w2, self.b2, h1, dense_init, generator)
        init_dense_(self.w3, self.b3, h2, dense_init, generator)

    def forward(
        self,
        query: torch.Tensor,    # (B, D) target item embedding
        keys: torch.Tensor,     # (B, T, D) behaviour sequence embeddings
        lengths: torch.Tensor,  # (B,) valid lengths
    ) -> torch.Tensor:
        from .kernels import din_attention as kernels

        if self.backend == "pallas" and keys.device.type != "cuda":
            raise ValueError(f"the DIN attention kernel needs a CUDA device; keys are on "
                             f"{keys.device}")
        fn = kernels.din_attention_plain if self.backend == "jnp" else kernels.din_attention
        params = (self.w1, self.b1, self.w2, self.b2, self.w3, self.b3)
        return fn(query, keys, lengths, params, self.use_softmax)


class BilinearAttention(nn.Module):
    """DIEN's paper-form attention weights, score_t = h_t . (W e_target);
    ``w`` is (Dq, Dk) under flax's truncated xavier_normal."""

    def __init__(self, query_dim: int, key_dim: int, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.w = nn.Parameter(xavier_normal_(torch.empty(query_dim, key_dim), generator))

    def forward(
        self,
        query: torch.Tensor,    # (B, Dq)
        keys: torch.Tensor,     # (B, T, Dk)
        lengths: torch.Tensor,  # (B,)
    ) -> torch.Tensor:
        """(B, T) attention weights."""
        scores = einsum("btd,bd->bt", keys, matmul(query, self.w))
        return masked_softmax(scores, length_mask(lengths, keys.shape[1]))
