"""Synthetic WeChat-shaped dataset (copy of ``rank_tpu/data/synthetic.py``;
the same seed gives byte-identical arrays, which the tests check).

The raw competition CSVs are not distributed with the reference snapshot
(``dataset/README.md:6``), so tests and benchmarks run on a synthetic
dataset with the exact batch layout of the real one: 16 log1p dense
features, 7 categorical ids, a length-50 behaviour sequence, a tag
sequence, and 7 binary labels.

Labels are generated from latent user/item factors so that models can
actually learn (sanity AUC > 0.5), which the unit tests assert.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from ..features import FeatureSchema, WECHAT_SCHEMA


def make_synthetic_dataset(
    schema: FeatureSchema = WECHAT_SCHEMA,
    num_rows: int = 8192,
    seed: int = 0,
    latent_dim: int = 8,
) -> Dict[str, np.ndarray]:
    """Return a dict-of-arrays dataset matching the loader's batch layout.

    Keys:
      dense              (N, num_dense) f32
      <cat name>         (N,)           i32   per categorical feature
      <seq name>         (N, max_len)   i32   per sequence feature
      <seq name>_length  (N,)           i32
      labels             (N, 7)         f32
    """
    rng = np.random.default_rng(seed)
    out: Dict[str, np.ndarray] = {}

    n_users = schema.categorical_feature("userid").vocab_size
    n_feeds = schema.categorical_feature("feedid").vocab_size

    # Latent factors drive both labels and dense "engagement count" features.
    user_f = rng.normal(size=(n_users, latent_dim)).astype(np.float32)
    feed_f = rng.normal(size=(n_feeds, latent_dim)).astype(np.float32)
    label_w = rng.normal(size=(latent_dim, len(schema.labels))).astype(np.float32)

    users = rng.integers(1, n_users, size=num_rows).astype(np.int32)
    feeds = rng.integers(1, n_feeds, size=num_rows).astype(np.int32)

    affinity = np.einsum("nd,nd->n", user_f[users], feed_f[feeds])  # (N,)
    task_logit = (user_f[users] + feed_f[feeds]) @ label_w  # (N, L)
    task_logit = task_logit / np.sqrt(2 * latent_dim) + affinity[:, None] * 0.5

    # Heavily imbalanced positives, like read_comment in the real data.
    bias = np.linspace(-2.5, -3.5, len(schema.labels)).astype(np.float32)
    prob = 1.0 / (1.0 + np.exp(-(task_logit + bias)))
    labels = (rng.random(size=prob.shape) < prob).astype(np.float32)
    out["labels"] = labels

    # Dense features: log1p of count-like draws correlated with affinity.
    rate = np.exp(0.6 * affinity[:, None] + rng.normal(scale=0.3, size=(num_rows, schema.num_dense)))
    counts = rng.poisson(rate).astype(np.float32)
    out["dense"] = np.log1p(counts).astype(np.float32)

    for f in schema.categorical:
        if f.name == "userid":
            out[f.name] = users
        elif f.name == "feedid":
            out[f.name] = feeds
        else:
            # 10% OOV (id 0), like real rows whose token misses the vocab.
            ids = rng.integers(0, f.vocab_size, size=num_rows).astype(np.int32)
            oov = rng.random(num_rows) < 0.1
            out[f.name] = np.where(oov, 0, ids).astype(np.int32)

    for f in schema.sequence:
        lengths = rng.integers(0, f.max_len + 1, size=num_rows).astype(np.int32)
        seq = rng.integers(1, f.vocab_size, size=(num_rows, f.max_len)).astype(np.int32)
        mask = np.arange(f.max_len)[None, :] < lengths[:, None]
        out[f.name] = np.where(mask, seq, 0).astype(np.int32)
        out[f.length_name] = lengths

    return out
