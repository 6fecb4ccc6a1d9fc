"""The numbers that decide ``correct``, each held to its limit.

Training: the program's steps against the reference's replay of them,
twice. In set-up the first ``checked_steps`` steps from the benchmark's
own initial state; after the window as many more steps, from the
program's state as the window left it (parameters, Adam's moments and
step count), so that whatever engages only once the program is warm is
checked too. For each:

  * ``loss_gap``: the relative gap between the program's and the
    reference's loss at the first step;
  * ``grad_gap``: over the leaves, the largest gap between the norm of the
    first step's gradient as the program's optimizer got it (read from
    Adam's first moment before and after the step) and the reference's norm
    of that leaf, as a share of the larger of that norm and the median
    leaf's;
  * ``dense_change_gap`` and ``table_change_gap``: the same gap for the
    norm of each leaf's change over the checked steps, its median over the
    dense leaves and over the embedding tables, each among the leaves whose
    reference gradient is at least a thousandth of the median leaf's: below
    that a leaf's gradient is nought to rounding (a bias before BatchNorm)
    and Adam moves it by round-off. The tables have a median of their own,
    so that an update that goes wrong in the tables alone shows.

The numbers after the window carry the prefix ``post_``.

The later steps' losses and the worst leaf's change are not compared:
Adam moves every element whose gradient is not zero by about its learning
rate, so elements whose gradient is rounding on both sides move apart by
that much, and from the second step on the loss and the smallest leaves
carry it. On the card they read from 0 to 150 times the first step's gaps
from seed to seed (PERF.md, section 2); the first step's loss and the
median leaf's change do not.

Serving: ``score_gap``, the largest gap between a served probability and
the reference's, over every row of every request of the window.
"""

from __future__ import annotations

import math
import statistics
from typing import Dict, Mapping

FLAT_GRADIENT = 1e-3  # of the median leaf's gradient norm


def leaf_gaps(got: Mapping[str, float], ref: Mapping[str, float], leaves) -> Dict[str, float]:
    """Each leaf's gap of norms, as a share of the larger of the reference's
    norm of that leaf and of the median leaf."""
    leaves = list(leaves)
    median = statistics.median(ref[n] for n in leaves)
    return {n: abs(got[n] - ref[n]) / max(ref[n], median, 1e-30) for n in leaves}


def moving_leaves(ref: Mapping[str, Mapping[str, float]]):
    grads = ref["grad_norms"]
    median = statistics.median(grads.values())
    return [n for n, g in grads.items() if g >= FLAT_GRADIENT * median]


def train_gaps(got: Mapping[str, Mapping], ref: Mapping[str, Mapping], tables,
               prefix: str = "") -> Dict[str, float]:
    """The numbers of one checked stretch; ``tables`` names the embedding
    tables among the leaves."""
    if set(got["grad_norms"]) != set(ref["grad_norms"]):
        raise ValueError("the program's leaves and the reference's differ")
    if len(got["losses"]) != len(ref["losses"]):
        raise ValueError("the program ran another number of checked steps")
    first, want = got["losses"][0], ref["losses"][0]
    moving = moving_leaves(ref)
    change = leaf_gaps(got["change_norms"], ref["change_norms"], moving)
    tables = set(tables)
    out = {
        "loss_gap": abs(first - want) / max(abs(want), 1e-30),
        "grad_gap": max(leaf_gaps(got["grad_norms"], ref["grad_norms"], ref["grad_norms"]).values()),
        "dense_change_gap": statistics.median(v for n, v in change.items() if n not in tables),
        "table_change_gap": statistics.median(v for n, v in change.items() if n in tables),
    }
    return {prefix + k: v for k, v in out.items()}


def verdict(values: Mapping[str, float], limits: Mapping[str, float]) -> Dict[str, dict]:
    """``{name: {"value", "limit"}}`` for every limit; a number that is
    missing or not finite reads as infinite."""
    out = {}
    for name, limit in limits.items():
        v = values.get(name, math.inf)
        out[name] = {"value": v if math.isfinite(v) else math.inf, "limit": limit}
    return out


def passed(checks: Mapping[str, Mapping[str, float]]) -> bool:
    return all(c["value"] <= c["limit"] for c in checks.values())
