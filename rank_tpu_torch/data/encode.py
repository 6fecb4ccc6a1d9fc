"""DataFrame -> fixed-schema arrays: the vocab-driven encoding step
(the port's copy of ``rank_tpu/data/encode.py``; the tests hold the two
to the same arrays).

Replaces the original repo's seven per-model ``WechatDataset`` variants
with one vectorised encoder:

  * categorical tokens map through the vocabulary files; the original
    repo maps token at file line i to index i *and* OOV to index 0 —
    colliding with the first vocabulary token while leaving the +1 row
    unused (deepfm.py:40,62-64 vs deepfm.py:80-86). Here row 0 is a
    dedicated OOV row and token i maps to i+1, which is what the +1-sized
    tables were for.
  * sequences pad to the schema's fixed max_len with explicit lengths.
  * the original scalar ``manual_tag_list`` lookup hits OOV for nearly
    every row (it looks up the whole comma-joined string; afm.py:133);
    here the first tag is used for the scalar feature and the full tag
    list becomes the ``manual_tag_seq`` sequence feature.
  * labels -> (N, 7) float32 in schema order.

pandas is not imported here: ``encode_dataframe`` takes a DataFrame the
caller made, and ``load_npz`` and the vocabulary readers need numpy only.
"""

from __future__ import annotations

import os
from typing import Dict, Mapping, Optional

import numpy as np

from .. import native
from ..features import (
    FeatureSchema,
    load_vocabulary,
    vocab_index,
)


def load_vocab_indices(schema: FeatureSchema, vocab_dir: str) -> Dict[str, Dict[str, int]]:
    """feature name -> {token: row} (row 0 reserved for OOV)."""
    out = {}
    for f in list(schema.categorical) + list(schema.sequence):
        tokens = load_vocabulary(os.path.join(vocab_dir, f.vocab_file))
        out[f.name] = vocab_index(tokens)
    return out


def _native_vocab(index: Mapping[str, int]):
    """Native mirror of a ``vocab_index`` dict (insertion order == row-1),
    or None when the C++ library is unavailable/disabled or a token would
    desynchronise the newline protocol."""
    if not native.available():
        return None
    tokens = list(index.keys())
    if any("\n" in t for t in tokens):
        return None
    return native.Vocab(tokens)


def _encode_tokens(series, index: Mapping[str, int], nvocab=None) -> np.ndarray:
    """Vectorised token -> id with OOV/missing -> 0."""
    if nvocab is not None:
        try:
            return nvocab.encode_tokens(list(series))
        except ValueError:  # newline inside a value: fall back
            pass
    return np.asarray(
        [index.get(tok, 0) if isinstance(tok, str) else 0 for tok in series],
        np.int32,
    )


def _seq_to_str(item) -> str:
    if isinstance(item, str):
        return item
    if isinstance(item, (list, np.ndarray)) and len(item):
        toks = list(item)
        if any(not isinstance(t, str) or not t or "," in t for t in toks):
            raise ValueError("list row not representable as comma-joined str")
        return ",".join(toks)
    return ""


def _encode_seq(series, index: Mapping[str, int], max_len: int, nvocab=None):
    if nvocab is not None:
        try:
            return nvocab.encode_seq([_seq_to_str(i) for i in series], max_len)
        except ValueError:  # desync or unrepresentable row: numpy fallback
            pass
    n = len(series)
    ids = np.zeros((n, max_len), np.int32)
    lengths = np.zeros((n,), np.int32)
    for r, item in enumerate(series):
        if isinstance(item, str) and item:
            toks = item.split(",")
        elif isinstance(item, (list, np.ndarray)):
            toks = list(item)
        else:
            continue
        toks = toks[-max_len:]  # keep the most recent, DataGenerator.py:274
        lengths[r] = len(toks)
        for c, tok in enumerate(toks):
            ids[r, c] = index.get(tok, 0)
    return ids, lengths


def encode_dataframe(
    df,
    schema: FeatureSchema,
    vocab_dir: str,
    vocab_indices: Optional[Dict[str, Dict[str, int]]] = None,
) -> Dict[str, np.ndarray]:
    """pandas DataFrame (ETL output parquet) -> loader-ready arrays."""
    if vocab_indices is None:
        vocab_indices = load_vocab_indices(schema, vocab_dir)
    nvocabs = {name: _native_vocab(idx) for name, idx in vocab_indices.items()}
    out: Dict[str, np.ndarray] = {}

    dense_cols = []
    for f in schema.dense:
        col = (
            df[f.name].fillna(0.0).to_numpy(np.float32)
            if f.name in df.columns
            else np.zeros(len(df), np.float32)
        )
        dense_cols.append(col)
    out["dense"] = np.stack(dense_cols, axis=1)

    tag_series = (
        df["manual_tag_list"] if "manual_tag_list" in df.columns else [""] * len(df)
    )
    for f in schema.categorical:
        if f.name == "manual_tag_list":
            first = [
                (s.split(",")[0] if isinstance(s, str) and s else None)
                for s in tag_series
            ]
            out[f.name] = _encode_tokens(first, vocab_indices[f.name], nvocabs[f.name])
        else:
            series = df[f.name] if f.name in df.columns else [None] * len(df)
            out[f.name] = _encode_tokens(series, vocab_indices[f.name], nvocabs[f.name])

    for f in schema.sequence:
        source = "manual_tag_list" if f.name == "manual_tag_seq" else f.name
        series = df[source] if source in df.columns else [""] * len(df)
        ids, lengths = _encode_seq(
            series, vocab_indices[f.name], f.max_len, nvocabs[f.name]
        )
        out[f.name] = ids
        out[f.length_name] = lengths

    labels = []
    for name in schema.labels:
        labels.append(
            df[name].fillna(0).to_numpy(np.float32)
            if name in df.columns
            else np.zeros(len(df), np.float32)
        )
    out["labels"] = np.stack(labels, axis=1)
    return out


def save_npz(path: str, data: Dict[str, np.ndarray]) -> None:
    np.savez_compressed(path, **data)


def load_npz(path: str) -> Dict[str, np.ndarray]:
    with np.load(path) as z:
        return {k: z[k] for k in z.files}
