"""Multi-task gradient strategies: PCGrad and GradNorm (port of
``rank_tpu/train/mtl.py``).

Both need per-task gradients. Here they are a dict ``{parameter name: (T,
*shape) tensor}``: the trainer takes one forward pass and T backward
passes (``Trainer.train_step``), the counterpart of the JAX package's one
``jax.jacrev``. Everything downstream is cheap linear algebra:

* **PCGrad** (Yu et al., NeurIPS 2020) runs the surgery on the T x T Gram
  matrix of task-gradient dot products, tracking coefficients C with
  g_i^PC = sum_k C[i, k] g_k, and returns one weight a task for a single
  weighted sum of the gradients. Each task i projects against the other
  tasks' ORIGINAL gradients in a random order of its own.

  The orders are an explicit (T, T) integer input here: row i is task i's
  order. The JAX package draws them inside ``pcgrad_weights`` with
  ``jax.random.permutation(jax.random.fold_in(rng, i), T)``, which torch
  generators cannot reproduce, so the port draws them from a
  ``torch.Generator`` (``pcgrad_orders``) and the tests feed JAX's orders
  to both sides. With 2 tasks the order cannot matter.

* **GradNorm** (Chen et al., ICML 2018): learned task weights w with
  sum(w) = T, driven by L_grad = sum_i |G_i - mean(G) r_i^alpha| with
  G_i = w_i n_i and n_i = |grad_shared L_i|. G_i is linear in w_i, so the
  weight gradient is sign(G_i - target) n_i, with no second backward pass.
  The shared parameters are those that ``default_task_specific`` does not
  mark: the JAX rule, copied as it is (under PLE, the task-specific
  experts ``L{l}_t{ti}_e{k}`` and gates ``L{l}_gate_t{ti}`` count as
  shared, since only path parts starting ``tower_`` or ``gate_`` are
  task-specific). L_i(0) is captured at the first step.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, Mapping, Tuple

import torch

_EPS = 1e-12

Stacked = Mapping[str, torch.Tensor]


def gram_matrix(stacked: Stacked) -> torch.Tensor:
    """(T, T) dot products of the task gradients, over every parameter."""
    flats = (g.reshape(g.shape[0], -1).float() for g in stacked.values())
    return sum(flat @ flat.T for flat in flats)


def pcgrad_orders(num_tasks: int, generator: torch.Generator) -> torch.Tensor:
    """(T, T) int64 on the generator's device: row i is a random order of
    all tasks, for task i's projections."""
    return torch.stack([
        torch.randperm(num_tasks, generator=generator, device=generator.device)
        for _ in range(num_tasks)
    ])


def pcgrad_weights(gram: torch.Tensor, orders: torch.Tensor) -> torch.Tensor:
    """PCGrad surgery in coefficient space; ``orders`` (T, T) on the host.

    Returns w (T,) such that the combined gradient is sum_k w[k] g_k."""
    num_tasks = gram.shape[0]
    sq = torch.clamp_min(torch.diagonal(gram), _EPS)
    coeffs = torch.eye(num_tasks, dtype=torch.float32, device=gram.device)
    for i in range(num_tasks):
        # sequential projections: the dot product uses the CURRENT g_i^PC,
        # the projection target is the original g_j
        for j in orders[i].tolist():
            if j == i:
                continue
            dot = coeffs[i] @ gram[:, j]
            coeffs[i, j] -= torch.where(dot < 0.0, dot / sq[j], torch.zeros_like(dot))
    return coeffs.sum(dim=0)  # sum_i g_i^PC = sum_k (sum_i C[i, k]) g_k


def combine_stacked(stacked: Stacked, weights: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Collapse the leading task axis with per-task weights."""
    return {name: torch.tensordot(weights.to(g.dtype), g, dims=1)
            for name, g in stacked.items()}


def default_task_specific(path: Tuple[str, ...]) -> bool:
    """MMOE/PLE convention: towers, gates and uncertainty weights are
    per-task; everything else (embedding tables, experts) is shared."""
    return any(p.startswith(("tower_", "gate_")) or "task_log_var" in p for p in path)


def shared_param_mask(names: Iterable[str],
                      is_task_specific: Callable[[Tuple[str, ...]], bool]) -> Dict[str, bool]:
    """{dotted parameter name: True where the parameter is SHARED}."""
    return {name: not is_task_specific(tuple(name.split("."))) for name in names}


def shared_grad_squares(stacked: Stacked, shared_mask: Mapping[str, bool]) -> torch.Tensor:
    """|grad_shared L_i|^2 per task, over the shared parameters of ``stacked``."""
    first = next(iter(stacked.values()))
    total = torch.zeros(first.shape[0], device=first.device)
    for name, g in stacked.items():
        if shared_mask[name]:
            total = total + g.reshape(g.shape[0], -1).float().square().sum(dim=1)
    return total


def norms_from_squares(squares: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.clamp_min(squares, _EPS))


def shared_grad_norms(stacked: Stacked, shared_mask: Mapping[str, bool]) -> torch.Tensor:
    """n_i = |grad_shared L_i| per task, over the shared parameters."""
    return norms_from_squares(shared_grad_squares(stacked, shared_mask))


def gradnorm_init(num_tasks: int, device=None) -> Dict[str, torch.Tensor]:
    return {
        "w": torch.ones(num_tasks, device=device),
        "l0": torch.zeros(num_tasks, device=device),
        "initialized": torch.zeros((), dtype=torch.bool, device=device),
    }


def gradnorm_update(
    mtl_state: Mapping[str, torch.Tensor],
    task_losses: torch.Tensor,
    grad_norms: torch.Tensor,
    alpha: float,
    lr: float,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One GradNorm step. Returns (the weights to combine the gradients
    with, the new state). The combining weights are the CURRENT w
    (pre-update), as in the paper's alternating optimisation."""
    num_tasks = task_losses.shape[0]
    l0 = torch.where(mtl_state["initialized"], mtl_state["l0"], task_losses)
    w = mtl_state["w"]
    g = w * grad_norms  # G_i = |grad w_i L_i| = w_i n_i
    r = task_losses / torch.clamp_min(l0, _EPS)
    r_inv = r / torch.clamp_min(r.mean(), _EPS)
    target = g.mean() * r_inv**alpha
    grad_w = torch.sign(g - target) * grad_norms  # exact d|G_i - target|/dw_i
    w_new = torch.clamp_min(w - lr * grad_w, 1e-3)
    w_new = num_tasks * w_new / w_new.sum()  # renormalise: sum(w) = T
    return w, {"w": w_new, "l0": l0, "initialized": torch.ones_like(mtl_state["initialized"])}
