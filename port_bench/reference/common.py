"""Plain PyTorch pieces the frozen references share: BatchNorm (flax's train
mode: biased batch variance as E[x^2] - E[x]^2, clipped at 0), Dice,
dropout, the masked BCE, Adam, the precision scope, and the replay of
training steps and the scoring of rows. Nothing here imports the port.

A reference takes a state dict ``{name: tensor}`` in the port's naming,
made by the benchmark, and checks it against the names and shapes that the
configuration implies (``expect``) before it computes.
"""

from __future__ import annotations

import contextlib
import math
from typing import Callable, Dict, Iterator, List, Mapping, Optional, Tuple

import torch
import torch.nn.functional as F

BN_EPS = 1e-5


@contextlib.contextmanager
def precision(tf32: bool) -> Iterator[None]:
    """f32 products with TF32 off (the references), or TF32 on (the control:
    the reference computed in the next precision below the configuration's)."""
    before = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
              torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    torch.set_float32_matmul_precision("high" if tf32 else "highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = before[:2]
        torch.set_float32_matmul_precision(before[2])


def expect(state: Mapping[str, torch.Tensor], shapes: Mapping[str, Tuple[int, ...]]) -> None:
    """Raise unless ``state`` holds exactly these parameters, in these shapes."""
    got = {k: tuple(v.shape) for k, v in state.items() if k in shapes}
    missing = sorted(set(shapes) - set(got))
    wrong = {k: (got[k], shapes[k]) for k in got if got[k] != tuple(shapes[k])}
    if missing or wrong:
        raise ValueError(f"state does not fit the configuration: missing {missing}, "
                         f"shapes (got, want) {wrong}")


def linear(x: torch.Tensor, state: Mapping[str, torch.Tensor], name: str) -> torch.Tensor:
    return x @ state[f"{name}.weight"].t() + state[f"{name}.bias"]


def batch_norm(x: torch.Tensor, state: Mapping[str, torch.Tensor], name: str,
               train: bool, affine: bool = True) -> torch.Tensor:
    if train:
        mean = x.mean(0)
        var = torch.clamp_min((x * x).mean(0) - mean * mean, 0.0)
    else:
        mean, var = state[f"{name}.running_mean"], state[f"{name}.running_var"]
    y = (x - mean) / torch.sqrt(var + BN_EPS)
    return y * state[f"{name}.weight"] + state[f"{name}.bias"] if affine else y


def dice(x: torch.Tensor, state: Mapping[str, torch.Tensor], name: str, train: bool) -> torch.Tensor:
    """DIN's Dice: alpha * (1 - p) * x + p * x, p = sigmoid(BatchNorm(x))."""
    p = torch.sigmoid(batch_norm(x, state, f"{name}.BatchNorm_0", train, affine=False))
    return state[f"{name}.alpha"] * (1.0 - p) * x + p * x


def dropout(x: torch.Tensor, rate: float, train: bool) -> torch.Tensor:
    """Inverted dropout from torch's default generator: a replay that seeds it
    as the program's steps were seeded draws the same masks, call for call."""
    return F.dropout(x, rate, training=train) if rate > 0 else x


def masked_bce(logit: torch.Tensor, y: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    ll = F.binary_cross_entropy_with_logits(logit, y, reduction="none")
    return (ll * valid).sum() / torch.clamp_min(valid.sum(), 1.0)


Forward = Callable[[Mapping[str, torch.Tensor], Mapping[str, torch.Tensor], dict, bool],
                   torch.Tensor]


def replay(forward: Forward, state0: Mapping[str, torch.Tensor], names: List[str],
           batches: List[Dict[str, torch.Tensor]], config: dict, dropout_seed: int,
           moments: Optional[Mapping[str, Tuple[torch.Tensor, torch.Tensor]]] = None,
           steps_before: int = 0) -> dict:
    """Train ``names`` of ``state0`` with Adam over ``batches`` from the seeded
    dropout stream, from zero moments or from ``moments`` (``{name: (first,
    second)}``) after ``steps_before`` steps; returns each step's loss, each
    leaf's gradient norm at the first and each leaf's change after the last."""
    opt = config["optimizer"]
    lr, (b1, b2), eps = opt["learning_rate"], opt["betas"], opt["eps"]
    leaves = {n: state0[n].detach().clone().requires_grad_(True) for n in names}
    rest = {k: v for k, v in state0.items() if k not in leaves}
    if moments is None:
        m = {n: torch.zeros_like(p) for n, p in leaves.items()}
        v = {n: torch.zeros_like(p) for n, p in leaves.items()}
    else:
        m = {n: moments[n][0].detach().clone() for n in names}
        v = {n: moments[n][1].detach().clone() for n in names}
    torch.manual_seed(dropout_seed)
    losses, grad_norms = [], {}
    for t, batch in enumerate(batches, steps_before + 1):
        label = batch["labels"][:, config["schema"]["labels"].index(config["schema"]["label"])]
        loss = masked_bce(forward({**rest, **leaves}, batch, config, True), label, batch["_valid"])
        grads = torch.autograd.grad(loss, list(leaves.values()))
        losses.append(float(loss.detach()))
        if t == steps_before + 1:
            grad_norms = {n: float(g.norm()) for n, g in zip(leaves, grads)}
        with torch.no_grad():
            for (n, p), g in zip(leaves.items(), grads):
                m[n].mul_(b1).add_(g, alpha=1 - b1)
                v[n].mul_(b2).addcmul_(g, g, value=1 - b2)
                m_hat = m[n] / (1 - b1 ** t)
                v_hat = v[n] / (1 - b2 ** t)
                p.sub_(lr * m_hat / (torch.sqrt(v_hat) + eps))
    change = {n: float((leaves[n].detach() - state0[n]).norm()) for n in names}
    return {"losses": losses, "grad_norms": grad_norms, "change_norms": change}


@torch.no_grad()
def scores(forward: Forward, state: Mapping[str, torch.Tensor],
           batch: Mapping[str, torch.Tensor], config: dict) -> torch.Tensor:
    """Eval-mode probabilities of the rows of ``batch``."""
    return torch.sigmoid(forward(state, batch, config, False))


def masked_softmax(scores: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Softmax over the valid positions of each row; zeros for a row with
    none. Every intermediate stays finite, so the gradient does too."""
    safe = torch.where(mask, scores, torch.zeros_like(scores))
    top = torch.where(mask, safe, torch.full_like(safe, -math.inf)).amax(-1, keepdim=True)
    top = torch.where(torch.isfinite(top), top, torch.zeros_like(top)).detach()
    e = torch.exp(torch.where(mask, safe - top, torch.zeros_like(safe))) * mask
    return e / torch.clamp_min(e.sum(-1, keepdim=True), 1e-30)
