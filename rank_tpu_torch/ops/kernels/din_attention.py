"""Fused DIN attention: the hand-written CUDA kernel and its plain version.

Port of the Pallas TPU kernel ``rank_tpu/ops/pallas/din_attention.py``
(``din_attention_fused``). The kernel lives in ``csrc/din_attention.cu``;
its header says what bounds it on an H100 and how its design answers that.

  * ``din_attention_cuda``: launches the kernel; CUDA tensors only, f32
    inputs and int32 lengths, contiguous, D in ``KERNEL_DIMS`` and hidden
    widths ``KERNEL_HIDDEN``; raises on anything else.
    ``din_attention_cuda.launches`` counts its launches.
  * ``din_attention_plain``: the same function in plain torch ops (the
    JAX ``DINAttention`` 'jnp' math), the oracle the kernel is held against.
  * ``DINAttentionFn``: the ``torch.autograd.Function`` around a forward
    implementation (the kernel on the card). Its backward recomputes
    through the plain version, as the JAX kernel's ``_bwd``
    (``rank_tpu/ops/pallas/din_attention.py:165``) does: there is no
    backward kernel.
  * ``din_attention``: the kernel, through ``DINAttentionFn``, for CUDA
    tensors; the plain version for CPU tensors.
"""

from __future__ import annotations

import ctypes
import math
from typing import Sequence

import torch

from . import _build
from ..attention import MASK_NEG, length_mask, masked_softmax

# The kernel's instantiations: D is a template parameter, and the hidden
# widths are those DINAttention is built with (rank_tpu/ops/attention.py).
KERNEL_DIMS = (8, 16, 32, 64)
KERNEL_HIDDEN = (64, 32)

_lib = None


def library() -> ctypes.CDLL:
    """Build (at first use) and load the kernel's shared library."""
    global _lib
    if _lib is None:
        lib = _build.load("din_attention")
        lib.din_attention_fwd.argtypes = (
            [ctypes.c_void_p] * 10 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
        )
        lib.din_attention_fwd.restype = ctypes.c_int
        lib.din_attention_error_string.argtypes = [ctypes.c_int]
        lib.din_attention_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


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
    q = query[:, None, :].expand_as(keys)
    cross = torch.cat([q, keys, q - keys, q * keys], dim=-1)  # (B, T, 4D)
    h = torch.relu(cross @ w1 + b1)
    h = torch.relu(h @ w2 + b2)
    scores = (h @ w3 + b3)[..., 0]  # (B, T)
    mask = length_mask(lengths, t)
    if use_softmax:
        scores = torch.where(mask, scores, MASK_NEG) / math.sqrt(d)
        weights = masked_softmax(scores, mask)
    else:
        weights = torch.where(mask, scores, 0.0)
    return torch.einsum("bt,btd->bd", weights, keys)


def check_kernel_shapes(query, keys, lengths, params) -> None:
    """Raise unless the shapes match keys (B, T, D) with D in KERNEL_DIMS and
    hidden widths KERNEL_HIDDEN, the instantiations the kernel has."""
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
    if d not in KERNEL_DIMS or (h1, h2) != KERNEL_HIDDEN:
        raise ValueError(
            f"din_attention_cuda: D={d}, hidden widths ({h1}, {h2}); the kernel takes "
            f"D in {KERNEL_DIMS} and hidden widths {KERNEL_HIDDEN}"
        )


def din_attention_cuda(
    query: torch.Tensor,
    keys: torch.Tensor,
    lengths: torch.Tensor,
    params: Sequence[torch.Tensor],
    use_softmax: bool,
) -> torch.Tensor:
    """Launch the CUDA kernel; raises unless every input is a contiguous
    CUDA tensor on one device with the kernel's dtypes and shapes."""
    check_kernel_shapes(query, keys, lengths, params)
    w1, b1, w2, b2, w3, b3 = params
    named = {"query": query, "keys": keys, "lengths": lengths, "w1": w1, "b1": b1,
             "w2": w2, "b2": b2, "w3": w3, "b3": b3}
    for name, x in named.items():
        if x.device.type != "cuda" or x.device != query.device:
            raise ValueError(
                f"din_attention_cuda needs every input on one CUDA device; "
                f"{name} is on {x.device}, query on {query.device}"
            )
        want = torch.int32 if name == "lengths" else torch.float32
        if x.dtype != want:
            raise TypeError(f"din_attention_cuda: {name} is {x.dtype}, needs {want}")
        if not x.is_contiguous():
            raise ValueError(f"din_attention_cuda: {name} is not contiguous")
    if keys.data_ptr() % 16:
        raise ValueError("din_attention_cuda: keys must start on a 16-byte boundary")
    b, t, d = keys.shape
    h1, h2 = w2.shape
    out = torch.empty((b, d), dtype=torch.float32, device=query.device)
    if b == 0:
        return out
    lib = library()
    stream = torch.cuda.current_stream(query.device).cuda_stream
    err = lib.din_attention_fwd(
        query.data_ptr(), keys.data_ptr(), lengths.data_ptr(),
        w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), b2.data_ptr(),
        w3.data_ptr(), b3.data_ptr(), out.data_ptr(),
        b, t, d, h1, h2, int(use_softmax), query.device.index, stream,
    )
    if err != 0:
        raise RuntimeError(
            f"din_attention_fwd launch failed: "
            f"{lib.din_attention_error_string(err).decode()} (B={b}, T={t}, D={d}, "
            f"H1={h1}, H2={h2})"
        )
    din_attention_cuda.launches += 1
    return out


din_attention_cuda.launches = 0


class DINAttentionFn(torch.autograd.Function):
    """``forward_fn`` in the forward pass (``din_attention_cuda`` on the
    card); the backward pass recomputes ``din_attention_plain`` under
    autograd and returns the gradients of query, keys and the six params.
    ``lengths`` gets none. Taking ``forward_fn`` as an argument lets a CPU
    test run this backward with the plain forward."""

    @staticmethod
    def forward(ctx, forward_fn, use_softmax, query, keys, lengths, *params):
        ctx.use_softmax = use_softmax
        ctx.save_for_backward(query, keys, lengths, *params)
        return forward_fn(query, keys, lengths, params, use_softmax)

    @staticmethod
    def backward(ctx, grad_out):
        query, keys, lengths, *params = ctx.saved_tensors
        with torch.enable_grad():
            inputs = [x.detach().requires_grad_() for x in (query, keys, *params)]
            out = din_attention_plain(inputs[0], inputs[1], lengths, inputs[2:], ctx.use_softmax)
            grads = torch.autograd.grad(out, inputs, grad_out)
        return (None, None, grads[0], grads[1], None, *grads[2:])


def din_attention_cuda_fn(query, keys, lengths, params, use_softmax) -> torch.Tensor:
    """The kernel with its gradient: ``din_attention_cuda`` through
    ``DINAttentionFn``."""
    return DINAttentionFn.apply(din_attention_cuda, use_softmax, query, keys, lengths, *params)


def din_attention(
    query: torch.Tensor,
    keys: torch.Tensor,
    lengths: torch.Tensor,
    params: Sequence[torch.Tensor],
    use_softmax: bool,
) -> torch.Tensor:
    """The kernel, with its gradient, for CUDA tensors; the plain version
    for CPU tensors."""
    if keys.device.type == "cpu":
        return din_attention_plain(query, keys, lengths, params, use_softmax)
    return din_attention_cuda_fn(query, keys, lengths, params, use_softmax)
