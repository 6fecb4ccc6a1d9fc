"""Fused CIN layer: the hand-written CUDA kernel and its plain version.

Port of the Pallas TPU kernel ``rank_tpu/ops/pallas/cin.py``
(``cin_layer_fused_t``). One layer of xDeepFM's Compressed Interaction
Network in the transposed layout, with m = (b, d):

    (B, D, H), (B, D, F), w (O, H, F) -> (B, D, O)
    out[m, o] = sum_f x0[m, f] * sum_h xk[m, h] * w[o, h, f]

The kernel lives in ``csrc/cin.cu``; its header says what bounds it on an
H100 and how its design answers that.

  * ``cin_layer_cuda_t``: launches the kernel; contiguous f32 CUDA tensors
    only, any H, F, O >= 1; raises on anything else.
    ``cin_layer_cuda_t.launches`` counts its launches. It hands the kernel
    the weights as ``weight_operand`` lays them out: the GEMM's B operand
    with K ordered (f, h) and H padded to 8.
  * ``cin_layer_plain_t``: the same function in plain torch ops (the JAX
    ``_reference_t``, with jnp's dtype promotion), the oracle the kernel
    is held against.
  * ``torch.ops.rank_tpu_torch.cin_layer_t``: the registered operator. On
    CUDA tensors it casts the inputs to f32, launches ``cin_layer_cuda_t``
    and returns the result in the inputs' promoted dtype; on CPU tensors
    it is the plain version. Its fake implementation lets ``torch.export``
    trace it as one node, and its gradient recomputes through the plain
    version, as the JAX kernel's ``_bwd`` (``rank_tpu/ops/pallas/cin.py:149``)
    does: there is no backward kernel.
  * ``CINLayerFn``: the same gradient as a ``torch.autograd.Function``
    around any forward implementation (a CPU test runs it with the plain
    forward, ``chip_smoke.py`` with ``cin_layer_cuda_t``).
  * ``cin_layer_t``: the operator, on either device (``backend='auto'``);
    ``cin_layer_cuda_fn_t`` the same, raising on CPU tensors
    (``backend='pallas'``).
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from ..mlp import cast_contiguous, einsum, promoted_dtype

_lib = None


def library() -> ctypes.CDLL:
    """Build (at first use) and load the kernel's shared library."""
    global _lib
    if _lib is None:
        lib = _build.load("cin")
        lib.cin_layer_fwd.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        lib.cin_layer_fwd.restype = ctypes.c_int
        lib.cin_layer_error_string.argtypes = [ctypes.c_int]
        lib.cin_layer_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def cin_layer_plain_t(xk_t: torch.Tensor, x0_t: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(B, D, H), (B, D, F), (O, H, F) -> (B, D, O); the JAX ``_reference_t``
    math, which builds the (B, H, F, D) pair tensor."""
    z = einsum("bdh,bdf->bhfd", xk_t, x0_t)
    return einsum("bhfd,ohf->bdo", z, w)


def padded_h(h: int) -> int:
    """H rounded up to 8: a k-step of the kernel is 8 consecutive h under one f."""
    return -(-h // 8) * 8


def weight_operand(w: torch.Tensor) -> torch.Tensor:
    """(O, H, F) -> the kernel's B operand (F*Hp, Op): row f*Hp + h holds
    w[:, h, f], with K ordered (f, h); zero in the padding rows (h >= H) and
    columns (o >= O). Hp is H rounded up to 8, Op is O rounded up to 4 (rows
    of whole 16-byte copies)."""
    o, h, f = w.shape
    hp, op = padded_h(h), -(-o // 4) * 4
    wop = w.new_zeros((f, hp, op))
    wop[:, :h, :o] = w.permute(2, 1, 0)
    return wop.reshape(f * hp, op)


def check_shapes(xk_t: torch.Tensor, x0_t: torch.Tensor, w: torch.Tensor) -> None:
    """Raise unless the shapes make (B, D, H), (B, D, F), (O, H, F) with
    H, F, O >= 1."""
    for name, x in (("xk_t", xk_t), ("x0_t", x0_t), ("w", w)):
        if x.dim() != 3:
            raise ValueError(f"cin_layer_cuda_t: {name} has shape {tuple(x.shape)}, needs 3 dims")
    b, d, h = xk_t.shape
    f, o = x0_t.shape[2], w.shape[0]
    if tuple(x0_t.shape[:2]) != (b, d) or tuple(w.shape) != (o, h, f):
        raise ValueError(
            f"cin_layer_cuda_t: shapes xk_t {tuple(xk_t.shape)}, x0_t {tuple(x0_t.shape)}, "
            f"w {tuple(w.shape)} do not make (B, D, H), (B, D, F), (O, H, F)"
        )
    if min(h, f, o) < 1:
        raise ValueError(f"cin_layer_cuda_t: H={h}, F={f}, O={o}; each must be at least 1")


def cin_layer_cuda_t(xk_t: torch.Tensor, x0_t: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA kernel; raises unless every input is a contiguous f32
    CUDA tensor on one device with shapes the kernel takes."""
    check_shapes(xk_t, x0_t, w)
    named = {"xk_t": xk_t, "x0_t": x0_t, "w": w}
    for name, x in named.items():
        if x.device.type != "cuda" or x.device != xk_t.device:
            raise ValueError(
                f"cin_layer_cuda_t needs every input on one CUDA device; "
                f"{name} is on {x.device}, xk_t on {xk_t.device}"
            )
        if x.dtype != torch.float32:
            raise TypeError(f"cin_layer_cuda_t: {name} is {x.dtype}, needs torch.float32")
        if not x.is_contiguous():
            raise ValueError(f"cin_layer_cuda_t: {name} is not contiguous")
    b, d, h = xk_t.shape
    f = x0_t.shape[2]
    o = w.shape[0]
    out = torch.empty((b, d, o), dtype=torch.float32, device=xk_t.device)
    if b * d == 0:
        return out
    wop = weight_operand(w)
    lib = library()
    stream = torch.cuda.current_stream(xk_t.device).cuda_stream
    err = lib.cin_layer_fwd(
        xk_t.data_ptr(), x0_t.data_ptr(), wop.data_ptr(), out.data_ptr(),
        b * d, h, f, o, xk_t.device.index, stream,
    )
    if err != 0:
        raise RuntimeError(
            f"cin_layer_fwd launch failed: {lib.cin_layer_error_string(err).decode()} "
            f"(B={b}, D={d}, H={h}, F={f}, O={o})"
        )
    cin_layer_cuda_t.launches += 1
    return out


cin_layer_cuda_t.launches = 0


def cin_layer_vjp(xk_t, x0_t, w, grad_out):
    """The gradients of xk_t, x0_t and w, recomputed through the plain
    version (the JAX kernel's ``_bwd``)."""
    _, pullback = torch.func.vjp(cin_layer_plain_t, xk_t, x0_t, w)
    return pullback(grad_out)


class CINLayerFn(torch.autograd.Function):
    """``forward_fn`` in the forward pass; the backward pass is
    ``cin_layer_vjp``. Taking ``forward_fn`` as an argument lets a CPU
    test run this backward with the plain forward."""

    @staticmethod
    def forward(ctx, forward_fn, xk_t, x0_t, w):
        ctx.save_for_backward(xk_t, x0_t, w)
        return forward_fn(xk_t, x0_t, w)

    @staticmethod
    def backward(ctx, grad_out):
        return (None, *cin_layer_vjp(*ctx.saved_tensors, grad_out))


# -- the registered operator --------------------------------------------------------


@torch.library.custom_op("rank_tpu_torch::cin_layer_t", mutates_args=(), device_types="cpu")
def cin_layer_op(xk_t: torch.Tensor, x0_t: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """On the CPU: the plain version, in the inputs' promoted dtype."""
    return cin_layer_plain_t(xk_t, x0_t, w)


@cin_layer_op.register_kernel("cuda")
def _cin_layer_on_card(xk_t, x0_t, w):
    """On the card: the inputs cast to f32, the kernel, the result cast back
    to the inputs' promoted dtype."""
    out = cin_layer_cuda_t(*(cast_contiguous(x, torch.float32) for x in (xk_t, x0_t, w)))
    return cast_contiguous(out, promoted_dtype(xk_t, x0_t, w))


@cin_layer_op.register_fake
def _(xk_t, x0_t, w):
    return xk_t.new_empty((*xk_t.shape[:2], w.shape[0]), dtype=promoted_dtype(xk_t, x0_t, w))


def _setup_context(ctx, inputs, output):
    ctx.save_for_backward(*inputs)


def _backward(ctx, grad_out):
    return cin_layer_vjp(*ctx.saved_tensors, grad_out)


cin_layer_op.register_autograd(_backward, setup_context=_setup_context)


def cin_layer_t(xk_t: torch.Tensor, x0_t: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The registered operator: the kernel for CUDA tensors, the plain
    version for CPU tensors, with its gradient on both."""
    return cin_layer_op(xk_t, x0_t, w)


def cin_layer_cuda_fn_t(xk_t: torch.Tensor, x0_t: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The operator, for CUDA tensors only: raises on CPU tensors rather
    than running the plain version in the kernel's place."""
    if xk_t.device.type != "cuda":
        raise ValueError(f"the CIN kernel needs a CUDA device; xk_t is on {xk_t.device}")
    return cin_layer_t(xk_t, x0_t, w)
