"""On-device metrics: exact AUC and streaming accumulators (port of
``rank_tpu/train/metrics.py``).

Metric state lives on the device with the model; the host reads it once
an epoch. ``exact_auc`` is the rank-sum (Mann-Whitney) AUC with average
ranks for ties, as ``sklearn.roc_auc_score`` computes it; the bucketed
streaming AUC keeps constant memory across steps.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

NUM_BUCKETS = 16384


def exact_auc(
    scores: torch.Tensor, labels: torch.Tensor, valid: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """Exact ROC AUC via average ranks; ``valid`` is an optional (N,) 0/1
    mask of padded rows. Rank sums are taken in float64 (the JAX version
    sums in float32, exact only while they stay below 2**24)."""
    n = scores.shape[0]
    if valid is None:
        valid = torch.ones(n, device=scores.device)
    valid = valid.to(torch.float64)
    labels = labels.to(torch.float64) * valid
    # invalid rows sort below every valid one: they take ranks but add
    # nothing to the positives' rank sum or to the counts
    s = torch.where(valid > 0, scores, torch.finfo(scores.dtype).min)
    sorted_s, order = torch.sort(s)
    _, group_id, counts = torch.unique_consecutive(sorted_s, return_inverse=True, return_counts=True)
    ranks_in_order = torch.arange(1, n + 1, dtype=torch.float64, device=scores.device)
    group_sum = torch.zeros(counts.shape[0], dtype=torch.float64, device=scores.device)
    group_sum.index_add_(0, group_id, ranks_in_order)
    avg_ranks_sorted = (group_sum / counts.to(torch.float64))[group_id]
    ranks = torch.empty_like(avg_ranks_sorted).scatter_(0, order, avg_ranks_sorted)

    n_pos = labels.sum()
    n_valid = valid.sum()
    n_neg = n_valid - n_pos
    pos_rank_sum = (ranks * labels).sum() - (n - n_valid) * n_pos
    auc = (pos_rank_sum - n_pos * (n_pos + 1) / 2.0) / torch.clamp_min(n_pos * n_neg, 1.0)
    return torch.where((n_pos > 0) & (n_neg > 0), auc, torch.full_like(auc, 0.5))


def auc_state_init(num_buckets: int = NUM_BUCKETS, device=None) -> Dict[str, torch.Tensor]:
    return {
        "pos": torch.zeros(num_buckets, device=device),
        "neg": torch.zeros(num_buckets, device=device),
    }


def auc_state_update_(
    state: Dict[str, torch.Tensor],
    probs: torch.Tensor,
    labels: torch.Tensor,
    valid: Optional[torch.Tensor] = None,
) -> Dict[str, torch.Tensor]:
    """Add a batch to the per-class probability histograms, in place
    (``index_add_``); probs in [0, 1]. Returns ``state``."""
    nb = state["pos"].shape[0]
    if valid is None:
        valid = torch.ones_like(probs)
    valid = valid.to(torch.float32)
    b = torch.clamp((probs * nb).to(torch.int32), 0, nb - 1)
    labels = labels.to(torch.float32)
    state["pos"].index_add_(0, b, labels * valid)
    state["neg"].index_add_(0, b, (1.0 - labels) * valid)
    return state


def auc_state_result(state: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Trapezoidal AUC from the class histograms (ties within a bucket get
    half credit)."""
    pos, neg = state["pos"], state["neg"]
    total_pos = torch.clamp_min(pos.sum(), 1e-12)
    total_neg = torch.clamp_min(neg.sum(), 1e-12)
    p = pos.flip(0)
    nneg = neg.flip(0)
    neg_lower = total_neg - torch.cumsum(nneg, 0)
    return torch.sum(p * (neg_lower + 0.5 * nneg)) / (total_pos * total_neg)


def binary_accuracy(
    probs: torch.Tensor, labels: torch.Tensor, valid: Optional[torch.Tensor] = None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(num_correct, num_valid) for round(prob) == label accuracy."""
    if valid is None:
        valid = torch.ones_like(probs)
    valid = valid.to(torch.float32)
    correct = (torch.round(probs) == labels).to(torch.float32) * valid
    return correct.sum(), valid.sum()
