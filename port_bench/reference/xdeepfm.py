"""Frozen plain-PyTorch reference of xDeepFM (Lian et al., KDD 2018,
arXiv:1803.05170) as the configuration states it, in f32.

logit = linear + CIN + DNN:

  * linear: a 1-wide weight per field's id, summed, plus a dense linear term;
  * CIN over the field embeddings x0 (B, F, E): layer k maps X^k (B, H_k, E)
    to Z (B, O_k, E) with Z[:, o] = sum_{h, f} W_k[o, h, f] X^k[:, h] * x0[:, f];
    every layer but the last gives its first O_k / 2 maps to the next layer
    and sum-pools the other half over E (split_half); the last pools all;
    the pooled maps go through a 1-wide output layer;
  * DNN: [dense features, flattened embeddings] -> Linear -> BatchNorm ->
    ReLU -> dropout per hidden layer -> a 1-wide output layer.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Tuple

import torch

from . import common

FIELDS = ("userid", "feedid", "device", "authorid", "bgm_song_id", "bgm_singer_id",
          "manual_tag_list")


def _widths(config: dict):
    mc = config["model_config"]
    sizes = list(mc["cin_layer_sizes"])
    hs, pooled, h = [], 0, len(FIELDS)
    for i, size in enumerate(sizes):
        hs.append(h)
        last = i == len(sizes) - 1
        h = size if last else size // 2
        pooled += h
    return mc["embedding_dim"], sizes, hs, pooled


def shapes(config: dict) -> Dict[str, Tuple[int, ...]]:
    e, sizes, hs, pooled = _widths(config)
    s = config["schema"]
    out = {}
    for f in FIELDS:
        rows = s["categorical"][f][0]
        out[f"emb_{f}.weight"] = (rows, e)
        out[f"linear_{f}.weight"] = (rows, 1)
    out["linear_dense.weight"], out["linear_dense.bias"] = (1, s["dense"]), (1,)
    for i, (size, h) in enumerate(zip(sizes, hs)):
        out[f"cin.w_{i}"] = (size, h, len(FIELDS))
    out["cin_output.weight"], out["cin_output.bias"] = (1, pooled), (1,)
    width = s["dense"] + len(FIELDS) * e
    for i, units in enumerate(config["model_config"]["hidden_units"]):
        out[f"dnn.Dense_{i}.weight"], out[f"dnn.Dense_{i}.bias"] = (units, width), (units,)
        out[f"dnn.BatchNorm_{i}.weight"] = out[f"dnn.BatchNorm_{i}.bias"] = (units,)
        width = units
    out["deep_output.weight"], out["deep_output.bias"] = (1, width), (1,)
    return out


def tables(config: dict) -> List[str]:
    """The embedding tables among the leaves, first-order ones included."""
    return [f"{kind}_{f}.weight" for f in FIELDS for kind in ("emb", "linear")]


def forward(state: Mapping[str, torch.Tensor], batch: Mapping[str, torch.Tensor],
            config: dict, train: bool) -> torch.Tensor:
    mc = config["model_config"]
    ids = {f: batch[f].long() for f in FIELDS}
    x0 = torch.stack([state[f"emb_{f}.weight"][ids[f]] for f in FIELDS], dim=1)  # (B, F, E)
    lin = sum(state[f"linear_{f}.weight"][ids[f]] for f in FIELDS)
    lin = lin + common.linear(batch["dense"], state, "linear_dense")

    _, sizes, _, _ = _widths(config)
    xk, pooled = x0, []
    for i, size in enumerate(sizes):
        z = xk[:, :, None, :] * x0[:, None, :, :]                     # (B, H, F, E)
        out = torch.einsum("bhfe,ohf->boe", z, state[f"cin.w_{i}"])    # (B, O, E)
        if i < len(sizes) - 1:
            xk, direct = out[:, : size // 2], out[:, size // 2:]
        else:
            direct = out
        pooled.append(direct.sum(-1))
    cin = common.linear(torch.cat(pooled, dim=-1), state, "cin_output")

    x = torch.cat([batch["dense"], x0.flatten(1)], dim=-1)
    for i, _ in enumerate(mc["hidden_units"]):
        x = common.linear(x, state, f"dnn.Dense_{i}")
        x = torch.relu(common.batch_norm(x, state, f"dnn.BatchNorm_{i}", train))
        x = common.dropout(x, mc["dropout_rate"], train)
    deep = common.linear(x, state, "deep_output")
    return (lin + cin + deep).reshape(-1)
