"""DIEN's work, counted from the configuration's shapes and the rows' history
lengths by the benchmark's own arithmetic (never by the program's FLOP
counters).

Products only: the multiply-adds of contractions, 2 FLOPs each, over valid
timesteps only. A padded timestep, which the port computes and discards,
is waste and is not counted. With D the behaviour width and H the GRUs'
hidden width:

  * a GRU step (the extractor over e_t, D in; the AUGRU over h_t, H in):
    the gates [x, h] W_g, 2 (D_in + H) 2H, and the candidate [x, r h] W_c,
    2 (D_in + H) H: 6 H (D_in + H) a valid timestep; the AUGRU's a_t u and
    the gates' blends are scalings, no contractions;
  * the bilinear attention: W e_target, 2 D H a row, and h_t . (W e_target),
    2 H a valid timestep;
  * the tower: [dense, fields, e_target, h_final] through (200, 80) to 1.

The backward counts each contraction the gradient needs once, with no
recompute: a GRU step's weight and input gradients, twice its forward
(12 H (D_in + H)); the attention's W gradient and e_target's gradient
(4 D H a row), and the sum over t of ds_t h_t (2 H a valid timestep),
whose h_t gradient ds_t (W e_target) is a scaling; the tower's weight and
input gradients, the first layer's input gradient without the dense
features' columns.

DIEN launches neither hand-written kernel, so ``KERNELS`` is empty.
"""

from __future__ import annotations

from typing import List, Tuple

TOWER = ("userid", "device", "authorid", "bgm_song_id", "bgm_singer_id", "manual_tag_list")


def _dims(config: dict) -> Tuple[int, int]:
    """(D, H): the behaviour width and the GRUs' hidden width."""
    s = config["schema"]
    (_, hist), _ = s["sequence"].items()
    return s["categorical"][hist["table"]][1], config["model_config"]["gru_hidden_dim"]


def _tower(config: dict) -> List[int]:
    s = config["schema"]
    d, h = _dims(config)
    width = s["dense"] + sum(s["categorical"][f][1] for f in TOWER) + d + h
    return [width, *config["model_config"]["hidden_units"], 1]


def recurrence_products(config: dict, rows: float, valid_steps: float) -> float:
    """The forward products of both GRUs and the attention for ``rows`` rows
    with ``valid_steps`` valid timesteps in all."""
    d, h = _dims(config)
    per_step = 6 * h * (d + h) + 6 * h * (h + h) + 2 * h
    return rows * 2 * d * h + valid_steps * per_step


def forward_products(config: dict, stats: dict) -> float:
    """Product FLOPs of one example's forward pass at the mean history
    length ``stats['mean_history']``."""
    widths = _tower(config)
    tower = sum(2 * a * b for a, b in zip(widths, widths[1:]))
    return recurrence_products(config, 1, stats["mean_history"]) + tower


def train_products(config: dict, stats: dict) -> float:
    """Product FLOPs of one example's training step: forward and backward."""
    d, h = _dims(config)
    dense = config["schema"]["dense"]
    steps = stats["mean_history"]
    recurrence_bwd = 4 * d * h + steps * (12 * h * (d + h) + 12 * h * (h + h) + 2 * h)
    widths = _tower(config)
    tower_bwd = sum(2 * a * b + 2 * (a - dense if i == 0 else a) * b
                    for i, (a, b) in enumerate(zip(widths, widths[1:])))
    return forward_products(config, stats) + recurrence_bwd + tower_bwd


KERNELS: dict = {}
