"""xDeepFM's work, counted from the configuration's shapes by the
benchmark's own arithmetic (never by the program's FLOP counters).

Products only: the multiply-adds of contractions, 2 FLOPs each. The
backward counts each contraction the gradient needs once, with no
recompute: a weight's gradient, and an input's where the input depends on
a parameter (the dense features' columns need none).

CIN layer k on the rows m = (b, e): the least product count is the GEMM
over K = H_k F, 2 H_k F O_k a row (forming its operand, H_k F multiplies,
is no product). Its backward is two such GEMMs, the weight's gradient and
the operand's, Z' = G W; the inputs' gradients then reduce Z' against x_0
or x_k over one index, 1/O_k of a GEMM, and are not counted.
"""

from __future__ import annotations

from typing import List, Tuple

FIELDS = 7


def _cin(config: dict) -> Tuple[int, List[Tuple[int, int]], int]:
    """(E, [(H, O)] per layer, pooled width)."""
    mc = config["model_config"]
    e, sizes = mc["embedding_dim"], mc["cin_layer_sizes"]
    layers, pooled, h = [], 0, FIELDS
    for i, size in enumerate(sizes):
        layers.append((h, size))
        h = size if i == len(sizes) - 1 else size // 2
        pooled += h
    return e, layers, pooled


def _tower(config: dict) -> List[int]:
    e = config["model_config"]["embedding_dim"]
    return [config["schema"]["dense"] + FIELDS * e, *config["model_config"]["hidden_units"], 1]


def forward_products(config: dict, stats: dict) -> float:
    """Product FLOPs of one example's forward pass."""
    e, layers, pooled = _cin(config)
    cin = sum(2 * e * h * FIELDS * o for h, o in layers)
    widths = _tower(config)
    tower = sum(2 * a * b for a, b in zip(widths, widths[1:]))
    return cin + 2 * pooled + tower + 2 * config["schema"]["dense"]


def train_products(config: dict, stats: dict) -> float:
    """Product FLOPs of one example's training step: forward and backward."""
    e, layers, pooled = _cin(config)
    dense = config["schema"]["dense"]
    cin_bwd = sum(2 * 2 * e * h * FIELDS * o for h, o in layers)
    widths = _tower(config)
    tower_bwd = sum(2 * a * b + 2 * (a - dense if i == 0 else a) * b
                    for i, (a, b) in enumerate(zip(widths, widths[1:])))
    backward = cin_bwd + 2 * 2 * pooled + tower_bwd + 2 * dense
    return forward_products(config, stats) + backward


def cin_layer_calls(config: dict, unit: dict) -> List[Tuple[float, float]]:
    """(product FLOPs, bytes) of each CIN layer operator call of a unit of
    ``unit['rows']`` rows, in call order (layer 0 first) on (B, E, H_k),
    (B, E, F), (O_k, H_k, F): the GEMM's products; x_k, x_0 and w read once
    and the output written once, in f32."""
    e, layers, _ = _cin(config)
    m = unit["rows"] * e
    return [(2.0 * m * h * FIELDS * o, 4.0 * (m * (h + FIELDS + o) + o * h * FIELDS))
            for h, o in layers]


KERNELS = {"rank_tpu_torch::cin_layer_t": cin_layer_calls}
