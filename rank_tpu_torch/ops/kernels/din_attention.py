"""Fused DIN attention: the hand-written CUDA kernels and their plain version.

Port of the Pallas TPU kernel ``rank_tpu/ops/pallas/din_attention.py``
(``din_attention_fused``). The kernels live in ``csrc/din_attention.cu``;
its header says what bounds them on an H100 and how their design answers
that.

  * ``din_attention_cuda``: launches a kernel; CUDA tensors only, f32
    inputs and int32 lengths, contiguous; raises on anything else. It
    takes every shape the JAX op takes (any D, T and hidden widths) and
    chooses the kernel by shape (``kernel_for``): ``din_attention_fwd``
    for D in ``TENSOR_CORE_DIMS`` and hidden widths ``TENSOR_CORE_HIDDEN``
    (D a template parameter), which counts its launches in
    ``din_attention_cuda.launches``; ``din_attention_generic_fwd`` for
    every other shape, which counts them in
    ``din_attention_cuda.generic_launches``. Both run the scoring MLP on
    the tensor cores in 3xTF32 (``mma.sync``); the generic kernel pads D
    to a multiple of 4 and the hidden widths to multiples of 8 with zeros
    as it stages the weights, and copies keys at any 4-byte alignment.
  * ``din_attention_plain``: the same function in plain torch ops (the
    JAX ``DINAttention`` 'jnp' math, with jnp's dtype promotion), the
    oracle the kernels are held against.
  * ``torch.ops.rank_tpu_torch.din_attention``: the registered operator.
    On CUDA tensors it casts the inputs to f32, launches
    ``din_attention_cuda`` and returns the result in the inputs' promoted
    dtype (bf16 under ``Predictor(weights_dtype='bfloat16')``, where the
    plain version would compute in bf16 as JAX does); on CPU tensors it is
    the plain version. Its fake implementation lets ``torch.export``
    trace it as one node, and its gradient recomputes through the plain
    version, as the JAX kernel's ``_bwd``
    (``rank_tpu/ops/pallas/din_attention.py:165``) does: there is no
    backward kernel. It is the one gradient route, which the models and
    the card checks take alike.
  * a FLOP formula for the operator (``register_flop_formula``), so that
    ``FlopCounterMode`` counts its products as it counts the plain
    version's, over every one of the B T keys; without it the operator
    counts 0.
  * ``din_attention``: the operator, on either device (``backend='auto'``,
    and ``'pallas'``, whose module refuses CPU tensors).
"""

from __future__ import annotations

import ctypes
import math
from typing import Sequence

import torch
from torch.utils.flop_counter import register_flop_formula

from . import _build
from ..attention import MASK_NEG, length_mask, masked_softmax
from ..mlp import cast_contiguous, einsum, matmul, promoted_dtype
from ...utils import tracing

# The instantiations of din_attention_fwd: D is a template parameter, and
# the hidden widths are those DINAttention is built with
# (rank_tpu/ops/attention.py). Every other shape takes the generic kernel,
# on the tensor cores too, at zero-padded widths.
TENSOR_CORE_DIMS = (8, 16, 32, 64)
TENSOR_CORE_HIDDEN = (64, 32)

_ARGTYPES = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
SIGNATURES = {"din_attention_fwd": _ARGTYPES, "din_attention_generic_fwd": _ARGTYPES}


def library() -> ctypes.CDLL:
    """Build (at first use) and load the kernels' shared library."""
    return _build.load("din_attention", SIGNATURES)


def din_attention_plain(
    query: torch.Tensor,
    keys: torch.Tensor,
    lengths: torch.Tensor,
    params: Sequence[torch.Tensor],
    use_softmax: bool,
) -> torch.Tensor:
    """(B, D), (B, T, D), (B,) -> (B, D); the JAX DINAttention 'jnp' math,
    in its order: mask, then divide by sqrt(d)."""
    w1, b1, w2, b2, w3, b3 = params
    _, t, d = keys.shape
    q = query[:, None, :].expand(-1, t, -1)
    cross = torch.cat([q, keys, q - keys, q * keys], dim=-1)  # (B, T, 4D)
    h = torch.relu(matmul(cross, w1) + b1)
    h = torch.relu(matmul(h, w2) + b2)
    scores = (matmul(h, w3) + b3)[..., 0]  # (B, T)
    mask = length_mask(lengths, t)
    if use_softmax:
        scores = torch.where(mask, scores, MASK_NEG) / math.sqrt(d)
        weights = masked_softmax(scores, mask)
    else:
        weights = torch.where(mask, scores, 0.0)
    return einsum("bt,btd->bd", weights, keys)


def check_shapes(query, keys, lengths, params) -> None:
    """Raise unless the shapes make q (B, D), keys (B, T, D), lengths (B,)
    and an MLP 4D -> H1 -> H2 -> 1."""
    w1, b1, w2, b2, w3, b3 = params
    if keys.dim() != 3 or w2.dim() != 2:
        raise ValueError(f"din_attention_cuda: keys {tuple(keys.shape)} and w2 "
                         f"{tuple(w2.shape)} need 3 and 2 dims")
    b, t, d = keys.shape
    h1, h2 = w2.shape
    named = {"query": query, "lengths": lengths, "w1": w1, "b1": b1, "b2": b2, "w3": w3, "b3": b3}
    shapes = {"query": (b, d), "lengths": (b,), "w1": (4 * d, h1), "b1": (h1,),
              "b2": (h2,), "w3": (h2, 1), "b3": (1,)}
    for name, shape in shapes.items():
        if tuple(named[name].shape) != shape:
            raise ValueError(
                f"din_attention_cuda: {name} has shape {tuple(named[name].shape)}, "
                f"needs {shape} for keys of shape {tuple(keys.shape)}"
            )


def kernel_for(d: int, h1: int, h2: int) -> str:
    """The kernel ``din_attention_cuda`` launches for D and hidden widths
    (H1, H2): ``din_attention_fwd`` at its instantiations, else
    ``din_attention_generic_fwd``, which takes every D, H1, H2 >= 1 (both
    on the tensor cores; "generic" means any shape)."""
    if d in TENSOR_CORE_DIMS and (h1, h2) == TENSOR_CORE_HIDDEN:
        return "din_attention_fwd"
    return "din_attention_generic_fwd"


def din_attention_cuda(
    query: torch.Tensor,
    keys: torch.Tensor,
    lengths: torch.Tensor,
    params: Sequence[torch.Tensor],
    use_softmax: bool,
) -> torch.Tensor:
    """Launch the kernel ``kernel_for`` names; raises unless every input is
    a contiguous CUDA tensor on one device with the kernels' dtypes and
    consistent shapes."""
    check_shapes(query, keys, lengths, params)
    w1, b1, w2, b2, w3, b3 = params
    _build.check_operands("din_attention_cuda", dict(
        query=query, keys=keys, lengths=lengths, w1=w1, b1=b1, w2=w2, b2=b2, w3=w3, b3=b3))
    b, t, d = keys.shape
    h1, h2 = w2.shape
    kernel = kernel_for(d, h1, h2)
    if kernel == "din_attention_fwd" and keys.data_ptr() % 16:
        raise ValueError("din_attention_cuda: keys must start on a 16-byte boundary")
    out = torch.empty((b, d), dtype=torch.float32, device=query.device)
    if b == 0:
        return out
    _build.launch(library(), kernel, query.device, (query, keys, lengths, *params, out),
                  (b, t, d, h1, h2, int(use_softmax)), B=b, T=t, D=d, H1=h1, H2=h2)
    if kernel == "din_attention_fwd":
        din_attention_cuda.launches += 1
    else:
        din_attention_cuda.generic_launches += 1
    return out


din_attention_cuda.launches = 0
din_attention_cuda.generic_launches = 0


def din_attention_vjp(query, keys, lengths, params, use_softmax, grad_out):
    """The gradients of query, keys and the six params, recomputed through
    the plain version (the JAX kernel's ``_bwd``)."""
    def fn(q, k, *p):
        return din_attention_plain(q, k, lengths, p, use_softmax)

    with tracing.span("din_attention.backward"):
        _, pullback = torch.func.vjp(fn, query, keys, *params)
        return pullback(grad_out)


# -- the registered operator --------------------------------------------------------


@torch.library.custom_op("rank_tpu_torch::din_attention", mutates_args=(), device_types="cpu")
def din_attention_op(query: torch.Tensor, keys: torch.Tensor, lengths: torch.Tensor,
                     w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor, b2: torch.Tensor,
                     w3: torch.Tensor, b3: torch.Tensor, use_softmax: bool) -> torch.Tensor:
    """On the CPU: the plain version, in the inputs' promoted dtype."""
    return din_attention_plain(query, keys, lengths, (w1, b1, w2, b2, w3, b3), use_softmax)


@din_attention_op.register_kernel("cuda")
def _din_attention_on_card(query, keys, lengths, w1, b1, w2, b2, w3, b3, use_softmax):
    """On the card: the inputs cast to f32, the kernel, the result cast back
    to the inputs' promoted dtype."""
    params = (w1, b1, w2, b2, w3, b3)
    dtype = promoted_dtype(query, keys, *params)
    f32 = lambda x: cast_contiguous(x, torch.float32)  # noqa: E731
    keys = f32(keys)
    if keys.data_ptr() % 16:  # a view that starts inside an allocation
        keys = keys.clone()
    out = din_attention_cuda(f32(query), keys, cast_contiguous(lengths, torch.int32),
                             tuple(map(f32, params)), use_softmax)
    return cast_contiguous(out, dtype)


@din_attention_op.register_fake
def _(query, keys, lengths, w1, b1, w2, b2, w3, b3, use_softmax):
    dtype = promoted_dtype(query, keys, w1, b1, w2, b2, w3, b3)
    return keys.new_empty((keys.shape[0], keys.shape[2]), dtype=dtype)


def _setup_context(ctx, inputs, output):
    *tensors, use_softmax = inputs
    ctx.use_softmax = use_softmax
    ctx.save_for_backward(*tensors)


def _backward(ctx, grad_out):
    query, keys, lengths, *params = ctx.saved_tensors
    gq, gk, *gp = din_attention_vjp(query, keys, lengths, params, ctx.use_softmax, grad_out)
    return (gq, gk, None, *gp, None)


din_attention_op.register_autograd(_backward, setup_context=_setup_context)


@register_flop_formula(torch.ops.rank_tpu_torch.din_attention)
def din_attention_flops(query_shape, keys_shape, lengths_shape, w1_shape, b1_shape, w2_shape,
                        *args, out_shape=None, **kwargs) -> int:
    """2 B T (4D H1 + H1 H2 + H2) for the scoring MLP and 2 B T D for the
    weighted sum: the products the plain version makes, every key counted
    (masked ones too)."""
    b, t, d = keys_shape
    h1, h2 = w2_shape
    return 2 * b * t * (4 * d * h1 + h1 * h2 + h2) + 2 * b * t * d


def din_attention(
    query: torch.Tensor,
    keys: torch.Tensor,
    lengths: torch.Tensor,
    params: Sequence[torch.Tensor],
    use_softmax: bool,
) -> torch.Tensor:
    """The registered operator: the kernel for CUDA tensors, the plain
    version for CPU tensors, with its gradient on both."""
    return din_attention_op(query, keys, lengths, *params, use_softmax)
