"""DIN's work, counted from the configuration's shapes and the rows' history
lengths by the benchmark's own arithmetic (never by the program's FLOP
counters).

Products only: the multiply-adds of contractions, 2 FLOPs each. The
attention unit is counted over valid timesteps only, in the folded form
of ``chip_smoke.py:din_bound``: [q, k, q - k, q * k] W1 = q (W1q + W1d) +
k (W1k - W1d) + (q * k) W1p, so each row costs 2 E H1 once and each valid
timestep 4 E H1 for the first layer, 2 H1 H2 + 2 H2 for the others and 2 E
for the pool. The backward counts each contraction the gradient needs
once, with no recompute: a valid timestep's backward is the first layer's
two weight and two input gradients (8 E H1), the second layer's weight and
input gradients (4 H1 H2), the third layer's weight gradient (2 H2) and the
pool's weight gradient (2 E); the third layer's input gradient and the
pool's key gradient are scalings, no contractions. Each row adds the query
part's weight and input gradients (4 E H1). The tower's first layer needs
no gradient for the dense features' columns.
"""

from __future__ import annotations

from typing import List, Tuple

TOWER = ("userid", "device", "authorid", "bgm_song_id", "bgm_singer_id", "manual_tag_list")


def _dims(config: dict) -> Tuple[int, int, int]:
    s = config["schema"]
    (_, hist), _ = s["sequence"].items()
    h1, h2 = config["fixed_by_port"]["attention_units"]
    return s["categorical"][hist["table"]][1], h1, h2


def _tower(config: dict) -> List[int]:
    s = config["schema"]
    e, _, _ = _dims(config)
    width = s["dense"] + sum(s["categorical"][f][1] for f in TOWER) + 2 * e
    return [width, *config["model_config"]["hidden_units"], 1]


def attention_products(config: dict, rows: float, valid_steps: float) -> float:
    e, h1, h2 = _dims(config)
    return rows * 2 * e * h1 + valid_steps * (4 * e * h1 + 2 * h1 * h2 + 2 * h2 + 2 * e)


def forward_products(config: dict, stats: dict) -> float:
    """Product FLOPs of one example's forward pass at the mean history
    length ``stats['mean_history']``."""
    widths = _tower(config)
    tower = sum(2 * a * b for a, b in zip(widths, widths[1:]))
    return attention_products(config, 1, stats["mean_history"]) + tower


def train_products(config: dict, stats: dict) -> float:
    """Product FLOPs of one example's training step: forward and backward."""
    e, h1, h2 = _dims(config)
    dense = config["schema"]["dense"]
    steps = stats["mean_history"]
    attention_bwd = 4 * e * h1 + steps * (8 * e * h1 + 4 * h1 * h2 + 2 * h2 + 2 * e)
    widths = _tower(config)
    tower_bwd = sum(2 * a * b + 2 * (a - dense if i == 0 else a) * b
                    for i, (a, b) in enumerate(zip(widths, widths[1:])))
    return forward_products(config, stats) + attention_bwd + tower_bwd


def din_attention_calls(config: dict, unit: dict) -> List[Tuple[float, float]]:
    """(product FLOPs, bytes) of the one DIN attention operator call of a
    unit (a train step, a served request) of ``unit['rows']`` rows with
    ``unit['valid_steps']`` valid timesteps: the valid timesteps' products;
    q, the valid keys, the lengths and the weights read once, the output
    written once, in f32. A served request counts the rows requested, not
    the bucket's padding rows, whose work is waste."""
    e, h1, h2 = _dims(config)
    b, valid = unit["rows"], unit["valid_steps"]
    weights = 4 * e * h1 + h1 + h1 * h2 + 2 * h2 + 1
    return [(attention_products(config, b, valid), 4.0 * (2 * b * e + valid * e + b + weights))]


KERNELS = {"rank_tpu_torch::din_attention": din_attention_calls}
