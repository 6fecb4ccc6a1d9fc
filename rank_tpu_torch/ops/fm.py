"""Factorization-machine interactions (port of ``rank_tpu/ops/fm.py``):
FM first and second order, bi-interaction pooling, FLEN's FwBI, the
pairwise products, FwFM and FFM.

Every op takes a stacked field-embedding tensor (B, F, D) and runs without
a Python loop over pairs: the pair indices are static numpy (this module's
own copy of ``pair_indices``), so each op is a fixed gather feeding one
reduction.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch


def pair_indices(num_fields: int) -> Tuple[np.ndarray, np.ndarray]:
    """Static upper-triangle (i<j) field pair indices."""
    iu, ju = np.triu_indices(num_fields, k=1)
    return iu.astype(np.int32), ju.astype(np.int32)


@functools.lru_cache(maxsize=None)
def pair_index_tensors(num_fields: int, device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    """``pair_indices`` as index tensors on ``device``, made once per
    (field count, device): a step then gathers without a host-to-device
    copy. Nothing writes to them. They are made outside inference mode
    even when a ``Predictor`` asks first, so that a later train step in the
    same process may save them for backward."""
    i, j = pair_indices(num_fields)
    with torch.inference_mode(False):
        return (torch.as_tensor(i, dtype=torch.long, device=device),
                torch.as_tensor(j, dtype=torch.long, device=device))


def fm_first_order(weights: torch.Tensor) -> torch.Tensor:
    """Sum of per-field scalar weights. weights: (B, F) or (B, F, 1) -> (B, 1)."""
    if weights.ndim == 3:
        weights = weights[..., 0]
    return weights.sum(dim=-1, keepdim=True)


def fm_second_order(emb: torch.Tensor, keepdims: bool = True) -> torch.Tensor:
    """Classic FM identity: 0.5 * ((sum_f v)^2 - sum_f v^2), summed over D.
    emb: (B, F, D) -> (B, 1), or (B,) without ``keepdims``."""
    return fm_second_order_vector(emb).sum(dim=-1, keepdim=keepdims)


def fm_second_order_vector(emb: torch.Tensor) -> torch.Tensor:
    """Bi-interaction pooling (NFM form), kept as a vector: (B, F, D) -> (B, D)."""
    return 0.5 * (emb.sum(dim=1).square() - emb.square().sum(dim=1))


def flen_field_wise_bi_interaction(
    emb: torch.Tensor,
    group_slices: Tuple[Tuple[int, int], ...],
    r_intra: torch.Tensor,
    r_inter: torch.Tensor,
) -> torch.Tensor:
    """FLEN's FwBI vector h_MF + h_FM (Feng et al. 2020, section 3.2).

    emb: (B, F, D) with each field group a contiguous [start, stop) slice.
    h_MF sums the r_inter-weighted products of the M group-sum embeddings
    over group pairs; h_FM sums the r_intra-weighted bi-interaction pooling
    within each group. Returns (B, D).
    """
    group_sums = torch.stack([emb[:, a:b, :].sum(dim=1) for a, b in group_slices], dim=1)
    i, j = pair_index_tensors(len(group_slices), emb.device)
    h_mf = (group_sums[:, i, :] * group_sums[:, j, :] * r_inter[None, :, None]).sum(dim=1)
    h_fm = sum(r_intra[m] * fm_second_order_vector(emb[:, a:b, :])
               for m, (a, b) in enumerate(group_slices))
    return h_mf + h_fm


def pairwise_hadamard(emb: torch.Tensor) -> torch.Tensor:
    """All F*(F-1)/2 elementwise pair products, (B, F, D) -> (B, P, D):
    AFM's interaction tensor."""
    i, j = pair_index_tensors(emb.shape[1], emb.device)
    return emb[:, i, :] * emb[:, j, :]


def pairwise_dot(emb: torch.Tensor) -> torch.Tensor:
    """All pair inner products, (B, F, D) -> (B, P)."""
    return pairwise_hadamard(emb).sum(dim=-1)


def fwfm_interaction(emb: torch.Tensor, field_weights: torch.Tensor) -> torch.Tensor:
    """Field-weighted FM pair term sum_p r_p * <v_i, v_j>: emb (B, F, D),
    field_weights (P,) -> (B, 1)."""
    return (pairwise_dot(emb) * field_weights[None, :]).sum(dim=-1, keepdim=True)


def ffm_interaction(field_aware_emb: torch.Tensor) -> torch.Tensor:
    """Field-aware FM pair term: (B, F, F, D), where [:, i, j] is field i's
    embedding for interacting with field j -> (B, 1), the sum over pairs
    of <v_{i,f_j}, v_{j,f_i}>."""
    i, j = pair_index_tensors(field_aware_emb.shape[1], field_aware_emb.device)
    vi = field_aware_emb[:, i, j, :]  # (B, P, D)
    vj = field_aware_emb[:, j, i, :]
    return (vi * vj).sum(dim=(1, 2))[:, None]
