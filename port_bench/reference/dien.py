"""Frozen plain-PyTorch reference of DIEN (Zhou et al., AAAI 2019,
arXiv:1809.03672) as the configuration states it, in f32.

  * the tower fields' embeddings (the tag field as the mean of its valid
    tags' embeddings), the target feed's embedding e_target, and the
    behaviour embeddings e_t, which share the feed table;
  * the interest extractor, a GRU over e_t (paper section 4.2), each
    product written as W x + U h:
        u = sigmoid(W_u e_t + U_u h + b_u),  r = sigmoid(W_r e_t + U_r h + b_r)
        c = tanh(W_c e_t + U_c (r * h) + b_c)
        h' = (1 - u) * h + u * c
    a padded step (t >= length) carries h and outputs zeros;
  * the attention (paper eq. 3), bilinear: a_t = softmax over the valid t of
    h_t . (W e_target), zeros for an empty history;
  * the interest evolving layer, an AUGRU over h_t (paper section 4.3): the
    same cell with the update gate scaled, u' = a_t * u, h' = (1 - u') * h +
    u' * c; its state at step length - 1 enters the tower;
  * the tower: [dense, fields, e_target, h_final] -> Linear -> Dice ->
    BatchNorm -> dropout per hidden layer -> a 1-wide output layer.

Departures from the paper, each as the configuration's ``assumed`` list
gives it: no auxiliary next-item loss (``use_aux_loss`` false; the paper
adds it with alpha = 1); the candidate takes U (r * h), as TF's GRUCell,
where the paper writes r * (U h); BatchNorm after each Dice, where the
authors' code normalises the tower's input once; a 1-wide logit and a
history of 50.

Its callers compute it inside ``common.precision(False)``: f32 products with
TF32 off (the control, ``precision(True)``, is the same in TF32).

The kernels are stored as the port's state holds them: ``gates_kernel``
(D + H, 2H), the update gate's columns first, and ``candidate_kernel``
(D + H, H), each split here into the rows that take e_t and those that take h.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Optional, Tuple

import torch

from . import common

TOWER = ("userid", "device", "authorid", "bgm_song_id", "bgm_singer_id", "manual_tag_list")
RNNS = ("interest_extractor", "interest_evolution")


def _hist(config: dict):
    (name, spec), (tags, tspec) = config["schema"]["sequence"].items()
    return name, spec["table"], tags, tspec["table"]


def _widths(config: dict) -> Tuple[int, int]:
    """(D, H): the behaviour width and the GRUs' hidden width."""
    d = config["schema"]["categorical"][_hist(config)[1]][1]
    return d, config["model_config"]["gru_hidden_dim"]


def shapes(config: dict) -> Dict[str, Tuple[int, ...]]:
    s, mc = config["schema"], config["model_config"]
    out = {f"tables.table_{f}.weight": tuple(rd) for f, rd in s["categorical"].items()}
    d, h = _widths(config)
    for name, d_in in zip(RNNS, (d, h)):
        out[f"{name}.gates_kernel"], out[f"{name}.gates_bias"] = (d_in + h, 2 * h), (2 * h,)
        out[f"{name}.candidate_kernel"], out[f"{name}.candidate_bias"] = (d_in + h, h), (h,)
    out["attention.w"] = (d, h)
    width = s["dense"] + sum(s["categorical"][f][1] for f in TOWER) + d + h
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


def gru(x: torch.Tensor, lengths: torch.Tensor, state: Mapping[str, torch.Tensor], name: str,
        att: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The GRU ``name`` over x (B, T, D_in); with ``att`` (B, T) the AUGRU.
    Returns the outputs (B, T, H), zero at padded steps, and the final state."""
    b, t, d_in = x.shape
    wg, bg = state[f"{name}.gates_kernel"], state[f"{name}.gates_bias"]
    wc, bc = state[f"{name}.candidate_kernel"], state[f"{name}.candidate_bias"]
    hidden = bc.shape[0]
    w_u, w_r = wg[:d_in, :hidden], wg[:d_in, hidden:]
    u_u, u_r = wg[d_in:, :hidden], wg[d_in:, hidden:]
    b_u, b_r = bg[:hidden], bg[hidden:]
    w_c, u_c = wc[:d_in], wc[d_in:]
    h = torch.zeros(b, hidden, dtype=x.dtype, device=x.device)
    outs = []
    for step in range(t):
        e = x[:, step]
        u = torch.sigmoid(e @ w_u + h @ u_u + b_u)
        r = torch.sigmoid(e @ w_r + h @ u_r + b_r)
        c = torch.tanh(e @ w_c + (r * h) @ u_c + bc)
        if att is not None:
            u = att[:, step, None] * u
        valid = (step < lengths)[:, None]
        h = torch.where(valid, (1.0 - u) * h + u * c, h)
        outs.append(torch.where(valid, h, torch.zeros_like(h)))
    return torch.stack(outs, dim=1), h


def attention(target: torch.Tensor, keys: torch.Tensor, lengths: torch.Tensor,
              state: Mapping[str, torch.Tensor]) -> torch.Tensor:
    """a_t = softmax over the valid t of h_t . (W e_target), (B, T)."""
    scores = torch.einsum("bth,bh->bt", keys, target @ state["attention.w"])
    mask = torch.arange(keys.shape[1], device=keys.device)[None, :] < lengths[:, None]
    return common.masked_softmax(scores, mask)


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
    target = table(hist_table)[batch["feedid"].long()]
    behaviours = table(hist_table)[batch[hist].long()]
    lengths = batch[hist + "_length"].long()
    interests, _ = gru(behaviours, lengths, state, RNNS[0])
    att = attention(target, interests, lengths, state)
    _, final = gru(interests, lengths, state, RNNS[1], att)
    x = torch.cat([batch["dense"]] + fields + [target, final], dim=-1)
    for i, _ in enumerate(mc["hidden_units"]):
        x = common.linear(x, state, f"fcn.Dense_{i}")
        x = common.dice(x, state, f"fcn.Dice_{i}", train)
        x = common.batch_norm(x, state, f"fcn.BatchNorm_{i}", train)
        x = common.dropout(x, mc["dropout_rate"], train)
    return common.linear(x, state, "output").reshape(-1)
