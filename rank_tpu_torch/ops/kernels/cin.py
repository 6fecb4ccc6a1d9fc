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
  * ``cin_layer_bwd_cuda_t``: the gradient's kernels (``csrc/cin.cu``,
    ``cin_layer_bwd``): dxk, dx0 and dw from tiles of G.W kept on chip,
    without the pair tensor; the same input checks as the forward, with
    ``grad_out``. ``cin_layer_bwd_cuda_t.launches`` counts its calls. It
    hands the kernels the weights as ``weight_operand_bwd`` lays them out.
  * ``cin_layer_vjp``: the gradient on either device: the backward kernel
    on CUDA tensors (cast to f32, each gradient returned in its input's
    dtype), ``cin_layer_vjp_plain`` on CPU tensors: the recompute through
    the plain version that the JAX kernel's ``_bwd``
    (``rank_tpu/ops/pallas/cin.py:149``) makes, and the oracle the backward
    kernel is held against.
  * ``torch.ops.rank_tpu_torch.cin_layer_t``: the registered operator. On
    CUDA tensors it casts the inputs to f32, launches ``cin_layer_cuda_t``
    and returns the result in the inputs' promoted dtype; on CPU tensors
    it is the plain version. Its fake implementation lets ``torch.export``
    trace it as one node, and its gradient is ``cin_layer_vjp``: the one
    gradient route, which the models and the card checks take alike.
  * a FLOP formula for the operator (``register_flop_formula``), so that
    ``FlopCounterMode`` counts its 2 B D H F O product FLOPs, as many as
    it counts for the plain version; without it the operator counts 0.
  * ``cin_layer_t``: the operator, on either device (``backend='auto'``,
    and ``'pallas'``, whose module refuses CPU tensors).
"""

from __future__ import annotations

import ctypes

import torch
from torch.utils.flop_counter import register_flop_formula

from . import _build
from ..mlp import cast_contiguous, einsum, promoted_dtype
from ...utils import tracing

SIGNATURES = {
    "cin_layer_fwd": [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p],
    "cin_layer_bwd_splits": [ctypes.c_int] * 5,
    "cin_layer_bwd": [ctypes.c_void_p] * 8 + [ctypes.c_int] * 7 + [ctypes.c_void_p],
}


def library() -> ctypes.CDLL:
    """Build (at first use) and load the kernels' shared library."""
    return _build.load("cin", SIGNATURES)


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


def backward_h_chunk(h: int) -> int:
    """The h columns an h-chunk of the backward kernels holds: H padded to
    8, then to 16, 32 or 64; above 64, chunks of 64. ``cin_layer_bwd``
    refuses a layout of another width (``csrc/cin.cu``: ``bwd_h_chunk``)."""
    hp = padded_h(h)
    return next(c for c in (8, 16, 32, 64) if hp <= c or c == 64)


def weight_operand_bwd(w: torch.Tensor) -> torch.Tensor:
    """(O, H, F) -> the backward kernel's B operand (NHC, F, Op8, HSW):
    [c, f, o, j] holds w[o, c*HSW + j, f], zero in the padding (o >= O,
    h >= H). HSW is ``backward_h_chunk(H)``, NHC the h-chunks that cover
    H padded to 8, Op8 is O rounded up to 8 (a k-step of G.W is 8
    consecutive o)."""
    o, h, f = w.shape
    hsw = backward_h_chunk(h)
    nhc, op8 = -(-padded_h(h) // hsw), -(-o // 8) * 8
    wb = w.new_zeros((f, op8, nhc * hsw))
    wb[:, :o, :h] = w.permute(2, 0, 1)
    return wb.reshape(f, op8, nhc, hsw).permute(2, 0, 1, 3).contiguous()


def check_shapes(xk_t: torch.Tensor, x0_t: torch.Tensor, w: torch.Tensor,
                 who: str = "cin_layer_cuda_t") -> None:
    """Raise unless the shapes make (B, D, H), (B, D, F), (O, H, F) with
    H, F, O >= 1."""
    for name, x in (("xk_t", xk_t), ("x0_t", x0_t), ("w", w)):
        if x.dim() != 3:
            raise ValueError(f"{who}: {name} has shape {tuple(x.shape)}, needs 3 dims")
    b, d, h = xk_t.shape
    f, o = x0_t.shape[2], w.shape[0]
    if tuple(x0_t.shape[:2]) != (b, d) or tuple(w.shape) != (o, h, f):
        raise ValueError(
            f"{who}: shapes xk_t {tuple(xk_t.shape)}, x0_t {tuple(x0_t.shape)}, "
            f"w {tuple(w.shape)} do not make (B, D, H), (B, D, F), (O, H, F)"
        )
    if min(h, f, o) < 1:
        raise ValueError(f"{who}: H={h}, F={f}, O={o}; each must be at least 1")


def cin_layer_cuda_t(xk_t: torch.Tensor, x0_t: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA kernel; raises unless every input is a contiguous f32
    CUDA tensor on one device with shapes the kernel takes."""
    check_shapes(xk_t, x0_t, w)
    _build.check_operands("cin_layer_cuda_t", {"xk_t": xk_t, "x0_t": x0_t, "w": w})
    b, d, h = xk_t.shape
    f = x0_t.shape[2]
    o = w.shape[0]
    out = torch.empty((b, d, o), dtype=torch.float32, device=xk_t.device)
    if b * d == 0:
        return out
    _build.launch(library(), "cin_layer_fwd", xk_t.device, (xk_t, x0_t, weight_operand(w), out),
                  (b * d, h, f, o), B=b, D=d, H=h, F=f, O=o)
    cin_layer_cuda_t.launches += 1
    return out


cin_layer_cuda_t.launches = 0


def cin_layer_bwd_cuda_t(xk_t: torch.Tensor, x0_t: torch.Tensor, w: torch.Tensor,
                         grad_out: torch.Tensor):
    """Launch the backward kernels: (dxk_t, dx0_t, dw) for ``grad_out`` =
    dL/dout (B, D, O). Raises unless every input is a contiguous f32 CUDA
    tensor on one device with shapes the kernels take."""
    who = "cin_layer_bwd_cuda_t"
    check_shapes(xk_t, x0_t, w, who)
    b, d, h = xk_t.shape
    f, o = x0_t.shape[2], w.shape[0]
    if tuple(grad_out.shape) != (b, d, o):
        raise ValueError(f"{who}: grad_out has shape {tuple(grad_out.shape)}, needs {(b, d, o)}")
    _build.check_operands(who, {"xk_t": xk_t, "x0_t": x0_t, "w": w, "grad_out": grad_out})
    dxk, dx0 = torch.empty_like(xk_t), torch.empty_like(x0_t)
    if b * d == 0:
        return dxk, dx0, torch.zeros_like(w)
    dw = torch.empty_like(w)
    wb = weight_operand_bwd(w)
    lib = library()
    splits = lib.cin_layer_bwd_splits(b * d, h, f, o, xk_t.device.index)
    if splits < 1:
        raise RuntimeError(f"cin_layer_bwd_splits failed: {_build.error_string(lib, -splits)}")
    part = torch.empty((splits, o, h, f), dtype=torch.float32, device=xk_t.device)
    _build.launch(lib, "cin_layer_bwd", xk_t.device, (grad_out, xk_t, x0_t, wb, dxk, dx0, dw, part),
                  (splits, wb.shape[-1], b * d, h, f, o), B=b, D=d, H=h, F=f, O=o)
    cin_layer_bwd_cuda_t.launches += 1
    return dxk, dx0, dw


cin_layer_bwd_cuda_t.launches = 0


def cin_layer_vjp_plain(xk_t, x0_t, w, grad_out):
    """The gradients of xk_t, x0_t and w, recomputed through the plain
    version (the JAX kernel's ``_bwd``)."""
    _, pullback = torch.func.vjp(cin_layer_plain_t, xk_t, x0_t, w)
    return pullback(grad_out)


def cin_layer_vjp(xk_t, x0_t, w, grad_out):
    """The gradients of xk_t, x0_t and w: on CUDA tensors the backward
    kernels, on inputs cast to f32, with each gradient returned in its
    input's dtype; on CPU tensors ``cin_layer_vjp_plain``. Its span runs on
    whatever thread autograd runs the backward on."""
    with tracing.span("cin.backward"):
        if xk_t.device.type != "cuda":
            return cin_layer_vjp_plain(xk_t, x0_t, w, grad_out)
        inputs = (xk_t, x0_t, w)
        grads = cin_layer_bwd_cuda_t(*(cast_contiguous(x, torch.float32)
                                       for x in (*inputs, grad_out)))
        return tuple(cast_contiguous(gr, x.dtype) for gr, x in zip(grads, inputs))


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


@register_flop_formula(torch.ops.rank_tpu_torch.cin_layer_t)
def cin_layer_flops(xk_shape, x0_shape, w_shape, out_shape=None, **kwargs) -> int:
    """2 B D H F O: the products the plain version's contraction makes."""
    b, d, h = xk_shape
    o, _, f = w_shape
    return 2 * b * d * h * f * o


def cin_layer_t(xk_t: torch.Tensor, x0_t: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The registered operator: the kernel for CUDA tensors, the plain
    version for CPU tensors, with its gradient on both."""
    return cin_layer_op(xk_t, x0_t, w)
