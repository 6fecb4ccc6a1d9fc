"""GRU / AGRU / AUGRU over behaviour sequences (port of ``rank_tpu/ops/rnn.py``):

  * GRU:   [u, r] = sigmoid([x, h] Wg + bg) (update first, then reset);
           c = tanh([x, r*h] Wc + bc); h' = (1-u)*h + u*c
  * AGRU:  h' = (1-a)*h + a*c     (the attention score a replaces u)
  * AUGRU: u' = a*u; h' = (1-u')*h + u'*c

A padded step (t >= length) carries the state through and outputs zeros,
so the final state is the state at step ``length - 1``. The recurrence is
a Python loop over T (the JAX module's ``lax.scan``); its ``unroll``
factor is accepted and has no meaning here. Parameters carry the flax
names: ``gates_kernel`` (d+h, 2h), ``gates_bias``, ``candidate_kernel``
(d+h, h), ``candidate_bias``; kernels under flax's xavier_uniform.

Each call opens the span ``rnn.<mode>`` (``utils/tracing.py``) around its
mask and loop, one a call, and adds T to the class counter
``AttentionalGRU.steps``.

With ``graphed``, a training call on the card replays the loop, forward
and backward, from CUDA graphs (``utils/graphs.py``) inside its span,
where the plain call dispatches about 2,700 kernels a call at DIEN's
T = 50 from Python.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from ..utils import graphs, tracing
from .mlp import promote, xavier_uniform_

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
                return graphs.call(self, AttentionalGRU._loop, *args)
            return self._loop(*args)

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
