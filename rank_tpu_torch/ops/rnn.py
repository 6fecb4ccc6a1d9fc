"""GRU / AGRU / AUGRU over behaviour sequences (port of ``rank_tpu/ops/rnn.py``):

  * GRU:   [u, r] = sigmoid([x, h] Wg + bg) (update first, then reset);
           c = tanh([x, r*h] Wc + bc); h' = (1-u)*h + u*c
  * AGRU:  h' = (1-a)*h + a*c     (the attention score a replaces u)
  * AUGRU: u' = a*u; h' = (1-u')*h + u'*c

A padded step (t >= length) carries the state through and outputs zeros,
so the final state is the state at step ``length - 1``. Parameters carry
the flax names: ``gates_kernel`` (d+h, 2h), ``gates_bias``,
``candidate_kernel`` (d+h, h), ``candidate_bias``; kernels under flax's
xavier_uniform. The ``unroll`` factor of the JAX module's ``lax.scan`` is
accepted and has no meaning here.

How a call runs, chosen by what it can see in its input
(``AttentionalGRU._recurrence``):

  * CPU tensors: ``_loop``, a Python loop over T of two ``addmm``, the
    gates and two ``where`` a step (the JAX module's ``lax.scan``);
  * CUDA tensors: ``gru_sequence``, the sequence kernels
    (``ops/kernels/csrc/gru_sequence.cu``), one launch a direction for all
    T steps, where the loop dispatched about 2,650 kernels a call, forward
    and backward, at DIEN's T = 50. They take H up to ``MAX_HIDDEN`` (512)
    and raise past it. They are registered operators, so a call traced by
    ``torch.export`` or ``torch.compile`` holds them too.

``gru_sequence`` computes x's share of the gates and the candidate for
all T steps in one product, P = x [W_xg | W_xc] + [b_g | b_c] ([x, h] W
= x W_x + h U is exact algebra), and hands the recurrence to the kernel;
``GRUSequence`` is its gradient, the backward kernel followed by the
weight and input gradients as products over all B*T rows. On CPU tensors
the same algorithm runs through the operators' plain versions, which the
tests hold against autograd of ``_loop``.

Each call opens the span ``rnn.<mode>`` (``utils/tracing.py``) around its
recurrence, one a call, and adds T to the class counter
``AttentionalGRU.steps``.

With ``graphed``, a training call on the card replays its recurrence,
forward and backward, from CUDA graphs (``utils/graphs.py``) inside its
span: the projection, the kernel and the gradient's products.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from ..utils import graphs, tracing
from .kernels import gru_sequence as _kernels  # noqa: F401  (registers the operators)
from .mlp import cast_contiguous, promote, promoted_dtype, xavier_uniform_

MODES = ("gru", "agru", "augru")


class AttentionalGRU(nn.Module):
    steps = 0  # timesteps run, over every call of every instance

    def __init__(
        self,
        input_dim: int,
        hidden_dim: int,
        mode: str = "gru",
        unroll: int = 1,
        generator: Optional[torch.Generator] = None,
        graphed: bool = False,
    ):
        super().__init__()
        if mode not in MODES:
            raise ValueError(f"unknown GRU mode {mode!r}; one of {MODES}")
        self.hidden_dim, self.mode, self.graphed = hidden_dim, mode, graphed
        width = input_dim + hidden_dim
        self.gates_kernel = nn.Parameter(xavier_uniform_(torch.empty(width, 2 * hidden_dim), generator))
        self.gates_bias = nn.Parameter(torch.zeros(2 * hidden_dim))
        self.candidate_kernel = nn.Parameter(xavier_uniform_(torch.empty(width, hidden_dim), generator))
        self.candidate_bias = nn.Parameter(torch.zeros(hidden_dim))

    def forward(
        self,
        inputs: torch.Tensor,                        # (B, T, D)
        lengths: torch.Tensor,                       # (B,)
        att_scores: Optional[torch.Tensor] = None,   # (B, T), for agru / augru
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Returns (outputs (B, T, H), final state (B, H))."""
        t = inputs.shape[1]
        if self.mode != "gru" and att_scores is None:
            raise ValueError(f"mode {self.mode!r} requires att_scores")
        AttentionalGRU.steps += t
        args = (inputs, lengths) if self.mode == "gru" else (inputs, lengths, att_scores)
        with tracing.span(f"rnn.{self.mode}"):
            if self.graphed and graphs.replayable(self, inputs):
                return graphs.call(self, AttentionalGRU._recurrence, *args)
            return self._recurrence(*args)

    def _recurrence(self, inputs: torch.Tensor, lengths: torch.Tensor,
                    att_scores: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
        """The sequence kernels on CUDA tensors, the loop on CPU tensors
        (the module's docstring)."""
        if inputs.is_cuda:
            return gru_sequence(self.mode, inputs, lengths, att_scores, self.gates_kernel,
                                self.gates_bias, self.candidate_kernel, self.candidate_bias)
        return self._loop(inputs, lengths, att_scores)

    def _loop(self, inputs: torch.Tensor, lengths: torch.Tensor,
              att_scores: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
        b, t, _ = inputs.shape
        valid = (torch.arange(t, device=lengths.device)[None, :] < lengths[:, None])[..., None]
        h = inputs.new_zeros(b, self.hidden_dim)
        outs = []
        for step in range(t):
            x = inputs[:, step]
            gates = torch.sigmoid(torch.addmm(*promote(
                self.gates_bias, torch.cat([x, h], -1), self.gates_kernel)))
            u, r = gates.split(self.hidden_dim, dim=-1)
            c = torch.tanh(torch.addmm(*promote(
                self.candidate_bias, torch.cat([x, r * h], -1), self.candidate_kernel)))
            if self.mode == "agru":
                u = att_scores[:, step, None]
            elif self.mode == "augru":
                u = att_scores[:, step, None] * u
            h_new = torch.where(valid[:, step], (1.0 - u) * h + u * c, h)
            outs.append(torch.where(valid[:, step], h_new, 0.0))
            h = h_new
        return torch.stack(outs, dim=1), h


def _project(x, gk, gb, ck, cb):
    """(P (B, T, 3H), W_x (D, 3H)): P = x [W_xg | W_xc] + [b_g | b_c], x's
    share of the gates' and the candidate's pre-activations at every step,
    in one product."""
    b, t, d = x.shape
    w_x = torch.cat([gk[:d], ck[:d]], dim=1)
    proj = torch.addmm(torch.cat([gb, cb]), x.reshape(b * t, d), w_x)
    return proj.view(b, t, -1), w_x


def _operands(mode, inputs, lengths, att, params):
    """The inputs as the recurrence computes them: f32 on the card (the
    kernels'), the promoted dtype on the CPU; lengths int32 on the card."""
    dtype = torch.float32 if inputs.is_cuda else promoted_dtype(inputs, *params)
    cast = lambda x: None if x is None else cast_contiguous(x, dtype)  # noqa: E731
    if inputs.is_cuda:
        lengths = cast_contiguous(lengths, torch.int32)
    return cast(inputs), lengths, cast(att if mode != "gru" else None), [cast(p) for p in params]


def _recur(x, lengths, att, gk, gb, ck, cb, mode, save):
    """The projection, then the forward operator: the kernel on CUDA
    tensors, its plain version on CPU tensors."""
    proj, w_x = _project(x, gk, gb, ck, cb)
    d = x.shape[2]
    outs, h_final, *saved = torch.ops.rank_tpu_torch.gru_seq_fwd(proj, lengths, att, gk[d:],
                                                                 ck[d:], mode, save)
    return outs, h_final, saved, w_x


_CHUNK = 512  # rows a partial weight-gradient product sums


def _weight_grad(a: torch.Tensor, g: torch.Tensor, out: torch.Tensor) -> None:
    """out = a^T g over all B*T rows of a (B, T, K) and g (B, T, N): products
    over chunks of 512 rows in one batched call, then their sum (a last
    product for a ragged tail). One product over all rows (51,200 in DIEN's
    cell) rounds about twice as far from f64 in f32 on the card, and a
    product a step (the loop's order, strided rows) runs a fifth slower."""
    k, n = a.shape[-1], g.shape[-1]
    a2, g2 = a.reshape(-1, k), g.reshape(-1, n)
    full = a2.shape[0] // _CHUNK * _CHUNK
    parts = torch.bmm(a2[:full].view(-1, _CHUNK, k).transpose(1, 2),
                      g2[:full].view(-1, _CHUNK, n))
    torch.sum(parts, dim=0, out=out)
    if full < a2.shape[0]:
        out.addmm_(a2[full:].t(), g2[full:])


class GRUSequence(torch.autograd.Function):
    """The recurrence as the sequence kernels compute it, with its written-out
    gradient: the backward operator (the kernel, or its plain version on the
    CPU) gives the pre-activation gradients dG (B, T, 3H) and d(att); then,
    over all B*T rows, dx = dG W_x^T, d[W_xg | W_xc] = x^T dG, dU_g =
    h_prev^T dG_g, dU_c = (r h_prev)^T dG_c and the biases' sums."""

    @staticmethod
    def forward(ctx, mode, inputs, lengths, att, gk, gb, ck, cb):
        ctx.set_materialize_grads(False)
        out_dtype = promoted_dtype(inputs, gk, gb, ck, cb)
        x, lengths, att, params = _operands(mode, inputs, lengths, att, (gk, gb, ck, cb))
        outs, h_final, saved, w_x = _recur(x, lengths, att, *params, mode, save=True)
        ctx.mode = mode
        ctx.dtypes = [None if t is None else t.dtype for t in (inputs, att, gk, gb, ck, cb)]
        ctx.save_for_backward(x, lengths, att, w_x, params[0], params[2], *saved)
        return outs.to(out_dtype), h_final.to(out_dtype)

    @staticmethod
    def backward(ctx, d_outs, d_h):
        x, lengths, att, w_x, gk, ck, gates, hprev, rh = ctx.saved_tensors
        mode = ctx.mode
        b, t, d = x.shape
        h = ck.shape[1]
        grad = lambda g: None if g is None else cast_contiguous(g, x.dtype)  # noqa: E731
        d_pre, d_att = torch.ops.rank_tpu_torch.gru_seq_bwd(
            gates, hprev, lengths, att, gk[d:], ck[d:], grad(d_outs), grad(d_h), mode)
        dg_g, dg_c = d_pre[..., :2 * h], d_pre[..., 2 * h:]
        need = ctx.needs_input_grad
        d_x = torch.mm(d_pre.view(b * t, 3 * h), w_x.t()).view(b, t, d) if need[1] else None
        d_gk = d_ck = d_gb = d_cb = None
        if need[4]:
            d_gk = torch.empty_like(gk)
            _weight_grad(x, dg_g, d_gk[:d])
            _weight_grad(hprev, dg_g, d_gk[d:])
        if need[6]:
            d_ck = torch.empty_like(ck)
            _weight_grad(x, dg_c, d_ck[:d])
            _weight_grad(rh, dg_c, d_ck[d:])
        if need[5]:
            d_gb = dg_g.sum((0, 1))
        if need[7]:
            d_cb = dg_c.sum((0, 1))
        grads = (d_x, d_att if need[3] else None, d_gk, d_gb, d_ck, d_cb)
        d_x, d_att, d_gk, d_gb, d_ck, d_cb = (
            None if g is None else g.to(dtype) for g, dtype in zip(grads, ctx.dtypes))
        return None, d_x, None, d_att, d_gk, d_gb, d_ck, d_cb


def gru_sequence(mode: str, inputs: torch.Tensor, lengths: torch.Tensor,
                 att: Optional[torch.Tensor], gates_kernel: torch.Tensor,
                 gates_bias: torch.Tensor, candidate_kernel: torch.Tensor,
                 candidate_bias: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(outputs (B, T, H), final state (B, H)) of ``AttentionalGRU`` by the
    sequence kernels on CUDA tensors, by their plain versions on CPU tensors;
    ``GRUSequence`` where a gradient is wanted, else a forward that saves
    nothing."""
    params = (gates_kernel, gates_bias, candidate_kernel, candidate_bias)
    if torch.is_grad_enabled() and any(
            p is not None and p.requires_grad for p in (inputs, att, *params)):
        return GRUSequence.apply(mode, inputs, lengths, att, *params)
    out_dtype = promoted_dtype(inputs, *params)
    x, lengths, att, params = _operands(mode, inputs, lengths, att, params)
    outs, h_final, _, _ = _recur(x, lengths, att, *params, mode, save=False)
    return outs.to(out_dtype), h_final.to(out_dtype)
