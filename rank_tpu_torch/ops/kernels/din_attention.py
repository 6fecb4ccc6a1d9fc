"""Fused DIN attention: the hand-written CUDA kernels and their plain version.

Port of the Pallas TPU kernel ``rank_tpu/ops/pallas/din_attention.py``
(``din_attention_fused``). The kernels live in ``csrc/din_attention.cu``;
its header says what bounds them on an H100 and how their design answers
that.

  * ``din_attention_cuda``: launches a kernel; CUDA tensors only, f32
    inputs and int32 lengths, contiguous; raises on anything else. It
    takes every shape the JAX op takes (any D, T and hidden widths) and
    chooses the kernel by shape (``kernel_for``): the tensor-core kernel
    ``din_attention_fwd`` for D in ``TENSOR_CORE_DIMS`` and hidden widths
    ``TENSOR_CORE_HIDDEN``, which counts its launches in
    ``din_attention_cuda.launches``; the f32 CUDA-core kernel
    ``din_attention_generic_fwd`` for every other shape, which counts
    them in ``din_attention_cuda.generic_launches``.
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
    backward kernel.
  * ``DINAttentionFn``: the same gradient as a ``torch.autograd.Function``
    around any forward implementation (a CPU test runs it with the plain
    forward, ``chip_smoke.py`` with ``din_attention_cuda``).
  * ``din_attention``: the operator, on either device (``backend='auto'``);
    ``din_attention_cuda_fn`` the same, raising on CPU tensors
    (``backend='pallas'``).
"""

from __future__ import annotations

import ctypes
import math
from typing import Sequence

import torch

from . import _build
from ..attention import MASK_NEG, length_mask, masked_softmax
from ..mlp import cast_contiguous, einsum, matmul, promoted_dtype

# The tensor-core kernel's instantiations: D is a template parameter, and
# the hidden widths are those DINAttention is built with
# (rank_tpu/ops/attention.py). Every other shape takes the generic kernel.
TENSOR_CORE_DIMS = (8, 16, 32, 64)
TENSOR_CORE_HIDDEN = (64, 32)

_lib = None


def library() -> ctypes.CDLL:
    """Build (at first use) and load the kernels' shared library."""
    global _lib
    if _lib is None:
        lib = _build.load("din_attention")
        for fn in (lib.din_attention_fwd, lib.din_attention_generic_fwd):
            fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
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
    (H1, H2): the tensor-core kernel at its instantiations, else the
    generic one."""
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
    b, t, d = keys.shape
    h1, h2 = w2.shape
    kernel = kernel_for(d, h1, h2)
    if kernel == "din_attention_fwd" and keys.data_ptr() % 16:
        raise ValueError("din_attention_cuda: keys must start on a 16-byte boundary")
    out = torch.empty((b, d), dtype=torch.float32, device=query.device)
    if b == 0:
        return out
    lib = library()
    stream = torch.cuda.current_stream(query.device).cuda_stream
    err = getattr(lib, kernel)(
        query.data_ptr(), keys.data_ptr(), lengths.data_ptr(),
        w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), b2.data_ptr(),
        w3.data_ptr(), b3.data_ptr(), out.data_ptr(),
        b, t, d, h1, h2, int(use_softmax), query.device.index, stream,
    )
    if err != 0:
        raise RuntimeError(
            f"{kernel} launch failed: {lib.din_attention_error_string(err).decode()} "
            f"(B={b}, T={t}, D={d}, H1={h1}, H2={h2})"
        )
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

    _, pullback = torch.func.vjp(fn, query, keys, *params)
    return pullback(grad_out)


class DINAttentionFn(torch.autograd.Function):
    """``forward_fn`` in the forward pass; the backward pass is
    ``din_attention_vjp`` and returns the gradients of query, keys and the
    six params. ``lengths`` gets none. Taking ``forward_fn`` as an argument
    lets a CPU test run this backward with the plain forward."""

    @staticmethod
    def forward(ctx, forward_fn, use_softmax, query, keys, lengths, *params):
        ctx.use_softmax = use_softmax
        ctx.save_for_backward(query, keys, lengths, *params)
        return forward_fn(query, keys, lengths, params, use_softmax)

    @staticmethod
    def backward(ctx, grad_out):
        query, keys, lengths, *params = ctx.saved_tensors
        gq, gk, *gp = din_attention_vjp(query, keys, lengths, params, ctx.use_softmax, grad_out)
        return (None, None, gq, gk, None, *gp)


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


def din_attention_cuda_fn(query, keys, lengths, params, use_softmax) -> torch.Tensor:
    """The operator, for CUDA tensors only: raises on CPU tensors rather
    than running the plain version in the kernel's place."""
    if keys.device.type != "cuda":
        raise ValueError(f"the DIN attention kernel needs a CUDA device; keys are on {keys.device}")
    return din_attention(query, keys, lengths, params, use_softmax)
