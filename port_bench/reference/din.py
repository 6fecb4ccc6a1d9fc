"""Frozen plain-PyTorch reference of DIN (Zhou et al., KDD 2018,
arXiv:1706.06978) as the configuration states it, in f32.

  * the tower fields' embeddings (the tag field as the mean of its valid
    tags' embeddings), the target feed's embedding q, and the history's
    embeddings k_t, which share the feed table;
  * the local activation unit: score_t = MLP([q, k_t, q - k_t, q * k_t]) with
    ReLU hidden layers (``attention_units``) and a 1-wide output; the
    weights are a softmax of score_t / sqrt(E) over the valid timesteps
    (``use_softmax``) or the raw scores with the others zeroed; the pooled
    history is sum_t w_t k_t, zero for an empty history;
  * the tower: [dense, fields, q, pooled] -> Linear -> Dice -> BatchNorm ->
    dropout per hidden layer -> a 1-wide output layer.
"""

from __future__ import annotations

import math
from typing import Dict, List, Mapping, Tuple

import torch

from . import common

TOWER = ("userid", "device", "authorid", "bgm_song_id", "bgm_singer_id", "manual_tag_list")


def _hist(config: dict):
    (name, spec), (tags, tspec) = config["schema"]["sequence"].items()
    return name, spec["table"], tags, tspec["table"]


def shapes(config: dict) -> Dict[str, Tuple[int, ...]]:
    s, mc = config["schema"], config["model_config"]
    out = {f"tables.table_{f}.weight": tuple(rd) for f, rd in s["categorical"].items()}
    e = s["categorical"][_hist(config)[1]][1]
    h1, h2 = config["fixed_by_port"]["attention_units"]
    out.update({"attention.w1": (4 * e, h1), "attention.b1": (h1,), "attention.w2": (h1, h2),
                "attention.b2": (h2,), "attention.w3": (h2, 1), "attention.b3": (1,)})
    width = s["dense"] + sum(s["categorical"][f][1] for f in TOWER) + 2 * e
    for i, units in enumerate(mc["hidden_units"]):
        out[f"fcn.Dense_{i}.weight"], out[f"fcn.Dense_{i}.bias"] = (units, width), (units,)
        out[f"fcn.Dice_{i}.alpha"] = (units,)
        out[f"fcn.BatchNorm_{i}.weight"] = out[f"fcn.BatchNorm_{i}.bias"] = (units,)
        width = units
    out["output.weight"], out["output.bias"] = (1, width), (1,)
    return out


def tables(config: dict) -> List[str]:
    """The embedding tables among the leaves."""
    return [f"tables.table_{f}.weight" for f in config["schema"]["categorical"]]


def attention(q: torch.Tensor, k: torch.Tensor, lengths: torch.Tensor,
              state: Mapping[str, torch.Tensor], use_softmax: bool) -> torch.Tensor:
    t = k.shape[1]
    qe = q[:, None, :].expand_as(k)
    x = torch.cat([qe, k, qe - k, qe * k], dim=-1)
    x = torch.relu(x @ state["attention.w1"] + state["attention.b1"])
    x = torch.relu(x @ state["attention.w2"] + state["attention.b2"])
    score = (x @ state["attention.w3"] + state["attention.b3"])[..., 0]  # (B, T)
    mask = torch.arange(t, device=k.device)[None, :] < lengths[:, None]
    if use_softmax:
        w = common.masked_softmax(score / math.sqrt(k.shape[-1]), mask)
    else:
        w = torch.where(mask, score, torch.zeros_like(score))
    return torch.einsum("bt,bte->be", w, k)


def forward(state: Mapping[str, torch.Tensor], batch: Mapping[str, torch.Tensor],
            config: dict, train: bool) -> torch.Tensor:
    mc = config["model_config"]
    hist, hist_table, tags, tag_table = _hist(config)

    def table(name):
        return state[f"tables.table_{name}.weight"]

    fields = []
    for f in TOWER:
        if f == tag_table and mc["multihot_tags"]:
            seq = batch[tags].long()
            mask = (seq > 0)[..., None].to(torch.float32)
            fields.append((table(f)[seq] * mask).sum(1) / torch.clamp_min(mask.sum(1), 1.0))
        else:
            fields.append(table(f)[batch[f].long()])
    q = table(hist_table)[batch["feedid"].long()]
    k = table(hist_table)[batch[hist].long()]
    pooled = attention(q, k, batch[hist + "_length"].long(), state, mc["use_softmax"])
    x = torch.cat([batch["dense"]] + fields + [q, pooled], dim=-1)
    for i, _ in enumerate(mc["hidden_units"]):
        x = common.linear(x, state, f"fcn.Dense_{i}")
        x = common.dice(x, state, f"fcn.Dice_{i}", train)
        x = common.batch_norm(x, state, f"fcn.BatchNorm_{i}", train)
        x = common.dropout(x, mc["dropout_rate"], train)
    return common.linear(x, state, "output").reshape(-1)
