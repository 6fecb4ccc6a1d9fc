"""DIEN's recurrences over a whole sequence: the hand-written CUDA kernels
and their plain versions.

The kernels (``csrc/gru_sequence.cu``; its header says what bounds them on
an H100 and how the design answers that) carry the recurrence of
``ops/rnn.py``'s GRU, AGRU and AUGRU over all T steps in one launch a
direction, from the input projection P = x W_x + b that the caller
computes for every step at once ((B, T, 3H): the update gate's, the reset
gate's and the candidate's columns). ``ops/rnn.py:GRUSequence`` puts them
together with that projection and the weight gradients. A length past T
counts as T.

  * ``gru_seq_cuda(proj, lengths, att, ug, uc, mode, save)``: the forward
    kernel; returns the outputs (B, T, H), zero at padded steps, the final
    state (B, H) and, with ``save``, what the backward reads: the gates
    u, r, c (B, T, 3H), the state before each step and r*h (each (B, T,
    H)), zero at padded steps. ``gru_seq_cuda.launches`` counts its
    launches.
  * ``gru_seq_bwd_cuda(gates, hprev, lengths, att, ug, uc, d_outs, d_h,
    mode)``: the backward kernel; returns the gradients of the gates' and
    the candidate's pre-activations (B, T, 3H) and, for agru and augru, of
    ``att`` (B, T). ``d_outs`` or ``d_h`` may be None (zero).
    ``gru_seq_bwd_cuda.launches`` counts its launches.
  * ``gru_seq_fwd_plain`` and ``gru_seq_bwd_plain``: the same functions in
    plain torch ops, step by step, in the inputs' dtype: the oracle the
    kernels are held against.
  * ``torch.ops.rank_tpu_torch.gru_seq_fwd`` and ``.gru_seq_bwd``: the
    registered operators, through which ``ops/rnn.py`` runs both
    directions: the kernels on CUDA tensors, the plain versions on CPU
    tensors. Their fake implementations let ``torch.export`` and
    ``torch.compile`` trace each as one node, so a program traced on the
    card launches the kernels; a tensor the call does not give (the saved
    buffers without ``save``, d(att) for gru) is empty. Each has a FLOP
    formula, 6 B T H^2 (the recurrent products of every step, as the loop's
    ``addmm`` count them), for ``FlopCounterMode``.

The kernels take contiguous f32 CUDA tensors (lengths int32), 1 <= H <=
``MAX_HIDDEN``, and raise on anything else, or when a launch is refused.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch
from torch.utils.flop_counter import register_flop_formula

from . import _build

MODES = {"gru": 0, "agru": 1, "augru": 2}
# U_g and U_c (3 H^2 floats) stay in a block's shared memory up to H = 128
# (196 KB, under the H100's 227 KB a block); wider, the kernels read them
# from global memory, with a thread a column of 2H threads a block, at most
# 1024
MAX_HIDDEN = 512

_ARGTYPES = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
SIGNATURES = {"gru_seq_fwd": _ARGTYPES, "gru_seq_bwd": _ARGTYPES}


def library() -> ctypes.CDLL:
    """Build (at first use) and load the kernels' shared library."""
    return _build.load("gru_sequence", SIGNATURES)


def _check(who: str, named: dict, h: int, mode: str) -> None:
    """Raise unless ``mode`` is known, 1 <= H <= MAX_HIDDEN and the tensors
    of ``named`` pass ``_build.check_operands``."""
    if mode not in MODES:
        raise ValueError(f"{who}: unknown mode {mode!r}; one of {tuple(MODES)}")
    if not 1 <= h <= MAX_HIDDEN:
        raise ValueError(f"{who}: H = {h}; the kernels take 1 <= H <= {MAX_HIDDEN}")
    _build.check_operands(who, named)


def _shapes(proj_or_gates: torch.Tensor, lengths, att, ug, uc, mode, who) -> Tuple[int, int, int]:
    if proj_or_gates.dim() != 3 or proj_or_gates.shape[2] % 3:
        raise ValueError(f"{who}: shape {tuple(proj_or_gates.shape)}, needs (B, T, 3H)")
    b, t, h3 = proj_or_gates.shape
    h = h3 // 3
    if tuple(lengths.shape) != (b,) or tuple(ug.shape) != (h, 2 * h) or tuple(uc.shape) != (h, h):
        raise ValueError(f"{who}: lengths {tuple(lengths.shape)}, ug {tuple(ug.shape)}, "
                         f"uc {tuple(uc.shape)} do not make (B,), (H, 2H), (H, H) with "
                         f"B = {b}, H = {h}")
    if (mode != "gru") != (att is not None) or (att is not None and tuple(att.shape) != (b, t)):
        raise ValueError(f"{who}: mode {mode!r} with att "
                         f"{None if att is None else tuple(att.shape)}; agru and augru take "
                         f"(B, T) = {(b, t)}, gru none")
    return b, t, h


def gru_seq_cuda(proj: torch.Tensor, lengths: torch.Tensor, att: Optional[torch.Tensor],
                 ug: torch.Tensor, uc: torch.Tensor, mode: str, save: bool):
    """Launch the forward kernel: (outputs, final state, saved), ``saved``
    = (gates, hprev, rh) with ``save``, else ()."""
    who = "gru_seq_cuda"
    b, t, h = _shapes(proj, lengths, att, ug, uc, mode, who)
    _check(who, {"proj": proj, "lengths": lengths, "att": att, "ug": ug, "uc": uc}, h, mode)
    outs = proj.new_empty((b, t, h))
    h_final = proj.new_zeros((b, h)) if b * t == 0 else proj.new_empty((b, h))
    saved = ((proj.new_empty((b, t, 3 * h)), proj.new_empty((b, t, h)), proj.new_empty((b, t, h)))
             if save else ())
    if b * t == 0:
        return outs, h_final, saved
    _build.launch(library(), "gru_seq_fwd", proj.device,
                  (proj, att, lengths, ug, uc, outs, h_final, *(saved or (None, None, None))),
                  (b, t, h, MODES[mode]), B=b, T=t, H=h, mode=mode)
    gru_seq_cuda.launches += 1
    return outs, h_final, saved


gru_seq_cuda.launches = 0


def gru_seq_bwd_cuda(gates: torch.Tensor, hprev: torch.Tensor, lengths: torch.Tensor,
                     att: Optional[torch.Tensor], ug: torch.Tensor, uc: torch.Tensor,
                     d_outs: Optional[torch.Tensor], d_h: Optional[torch.Tensor], mode: str):
    """Launch the backward kernel: (d_pre (B, T, 3H), d_att (B, T) or None
    for gru)."""
    who = "gru_seq_bwd_cuda"
    b, t, h = _shapes(gates, lengths, att, ug, uc, mode, who)
    for name, x, shape in (("hprev", hprev, (b, t, h)), ("d_outs", d_outs, (b, t, h)),
                           ("d_h", d_h, (b, h))):
        if x is not None and tuple(x.shape) != shape:
            raise ValueError(f"{who}: {name} has shape {tuple(x.shape)}, needs {shape}")
    _check(who, {"gates": gates, "hprev": hprev, "lengths": lengths, "att": att, "ug": ug,
                 "uc": uc, "d_outs": d_outs, "d_h": d_h}, h, mode)
    d_pre = gates.new_empty((b, t, 3 * h))
    d_att = None if mode == "gru" else gates.new_empty((b, t))
    if b * t == 0:
        return d_pre, d_att
    _build.launch(library(), "gru_seq_bwd", gates.device,
                  (gates, hprev, att, lengths, ug, uc, d_outs, d_h, d_pre, d_att),
                  (b, t, h, MODES[mode]), B=b, T=t, H=h, mode=mode)
    gru_seq_bwd_cuda.launches += 1
    return d_pre, d_att


gru_seq_bwd_cuda.launches = 0


def _update_gate(mode: str, u: torch.Tensor, a: Optional[torch.Tensor]) -> torch.Tensor:
    """z of h' = (1 - z) h + z c: u (gru), a_t (agru), a_t u (augru)."""
    return u if mode == "gru" else a if mode == "agru" else a * u


def gru_seq_fwd_plain(proj, lengths, att, ug, uc, mode: str, save: bool):
    """``gru_seq_cuda`` in plain torch ops, a step at a time."""
    b, t, h3 = proj.shape
    h = h3 // 3
    valid = torch.arange(t, device=proj.device)[None, :] < lengths[:, None]
    state = proj.new_zeros(b, h)
    outs, gates, hprev, rh = [], [], [], []
    for step in range(t):
        p, v = proj[:, step], valid[:, step, None]
        u, r = torch.sigmoid(p[:, :2 * h] + state @ ug).split(h, dim=-1)
        rh_t = r * state
        c = torch.tanh(p[:, 2 * h:] + rh_t @ uc)
        z = _update_gate(mode, u, None if att is None else att[:, step, None])
        new = (1.0 - z) * state + z * c
        outs.append(torch.where(v, new, 0.0))
        if save:
            gates.append(torch.where(v, torch.cat([u, r, c], dim=-1), 0.0))
            hprev.append(torch.where(v, state, 0.0))
            rh.append(torch.where(v, rh_t, 0.0))
        state = torch.where(v, new, state)
    stack = lambda xs, width: (torch.stack(xs, dim=1) if xs  # noqa: E731
                               else proj.new_zeros(b, 0, width))
    saved = (stack(gates, h3), stack(hprev, h), stack(rh, h)) if save else ()
    return stack(outs, h), state, saved


def gru_seq_bwd_plain(gates, hprev, lengths, att, ug, uc, d_outs, d_h, mode: str):
    """``gru_seq_bwd_cuda`` in plain torch ops, a step at a time, from the
    last step to the first."""
    b, t, h3 = gates.shape
    h = h3 // 3
    valid = torch.arange(t, device=gates.device)[None, :] < lengths[:, None]
    dh = gates.new_zeros(b, h) if d_h is None else d_h
    d_pre = gates.new_zeros(b, t, h3)
    d_att = None if mode == "gru" else gates.new_zeros(b, t)
    for step in reversed(range(t)):
        v = valid[:, step, None]
        u, r, c = gates[:, step].split(h, dim=-1)
        hp = hprev[:, step]
        a = None if att is None else att[:, step, None]
        dhn = dh if d_outs is None else dh + d_outs[:, step]
        z = _update_gate(mode, u, a)
        dz = dhn * (c - hp)
        dcp = dhn * z * (1.0 - c * c)
        if mode == "gru":
            dup = dz * u * (1.0 - u)
        elif mode == "augru":
            dup = dz * a * u * (1.0 - u)
            d_att[:, step] = torch.where(v, dz * u, 0.0).sum(-1)
        else:
            dup = torch.zeros_like(u)
            d_att[:, step] = torch.where(v, dz, 0.0).sum(-1)
        drh = dcp @ uc.t()
        drp = drh * hp * r * (1.0 - r)
        dg = torch.where(v, torch.cat([dup, drp, dcp], dim=-1), 0.0)
        d_pre[:, step] = dg
        dh = torch.where(v, dhn * (1.0 - z) + drh * r + dg[:, :2 * h] @ ug.t(), dh)
    return d_pre, d_att


# -- the registered operators -------------------------------------------------------


@torch.library.custom_op("rank_tpu_torch::gru_seq_fwd", mutates_args=(), device_types="cpu")
def gru_seq_fwd_op(proj: torch.Tensor, lengths: torch.Tensor, att: Optional[torch.Tensor],
                   ug: torch.Tensor, uc: torch.Tensor, mode: str,
                   save: bool) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor,
                                        torch.Tensor]:
    """On the CPU: the plain version. (outputs, final state, gates, hprev,
    rh); the last three empty without ``save``."""
    outs, h_final, saved = gru_seq_fwd_plain(proj, lengths, att, ug, uc, mode, save)
    return (outs, h_final, *(saved or _unsaved(proj)))


@gru_seq_fwd_op.register_kernel("cuda")
def _gru_seq_fwd_on_card(proj, lengths, att, ug, uc, mode, save):
    outs, h_final, saved = gru_seq_cuda(proj, lengths, att, ug, uc, mode, save)
    return (outs, h_final, *(saved or _unsaved(proj)))


def _unsaved(proj: torch.Tensor):
    return tuple(proj.new_empty(0) for _ in range(3))


@gru_seq_fwd_op.register_fake
def _(proj, lengths, att, ug, uc, mode, save):
    b, t, h = _shapes(proj, lengths, att, ug, uc, mode, "gru_seq_fwd")
    saved = ((proj.new_empty((b, t, 3 * h)), proj.new_empty((b, t, h)),
              proj.new_empty((b, t, h))) if save else _unsaved(proj))
    return (proj.new_empty((b, t, h)), proj.new_empty((b, h)), *saved)


@torch.library.custom_op("rank_tpu_torch::gru_seq_bwd", mutates_args=(), device_types="cpu")
def gru_seq_bwd_op(gates: torch.Tensor, hprev: torch.Tensor, lengths: torch.Tensor,
                   att: Optional[torch.Tensor], ug: torch.Tensor, uc: torch.Tensor,
                   d_outs: Optional[torch.Tensor], d_h: Optional[torch.Tensor],
                   mode: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """On the CPU: the plain version. (d_pre, d_att); d_att empty for gru."""
    d_pre, d_att = gru_seq_bwd_plain(gates, hprev, lengths, att, ug, uc, d_outs, d_h, mode)
    return d_pre, gates.new_empty(0) if d_att is None else d_att


@gru_seq_bwd_op.register_kernel("cuda")
def _gru_seq_bwd_on_card(gates, hprev, lengths, att, ug, uc, d_outs, d_h, mode):
    d_pre, d_att = gru_seq_bwd_cuda(gates, hprev, lengths, att, ug, uc, d_outs, d_h, mode)
    return d_pre, gates.new_empty(0) if d_att is None else d_att


@gru_seq_bwd_op.register_fake
def _(gates, hprev, lengths, att, ug, uc, d_outs, d_h, mode):
    b, t, h = _shapes(gates, lengths, att, ug, uc, mode, "gru_seq_bwd")
    return gates.new_empty((b, t, 3 * h)), gates.new_empty(0 if mode == "gru" else (b, t))


@register_flop_formula(torch.ops.rank_tpu_torch.gru_seq_fwd)
def gru_seq_fwd_flops(proj_shape, *args, out_shape=None, **kwargs) -> int:
    """6 B T H^2: h U_g and (r h) U_c at every step."""
    b, t, h3 = proj_shape
    return 2 * b * t * h3 * (h3 // 3)


@register_flop_formula(torch.ops.rank_tpu_torch.gru_seq_bwd)
def gru_seq_bwd_flops(gates_shape, *args, out_shape=None, **kwargs) -> int:
    """6 B T H^2: dc U_c^T and dg U_g^T at every step."""
    b, t, h3 = gates_shape
    return 2 * b * t * h3 * (h3 // 3)
