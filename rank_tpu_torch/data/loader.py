"""In-memory array dataset and batch iterator (port of ``rank_tpu/data/loader.py``).

The dataset is a dict of numpy arrays with one row per example; a batch is
a dict of row slices of it. The same seed gives the same batches, the same
``_valid`` padding and the same ``num_batches`` as the JAX loader (the tests
check byte identity). Rows are gathered with ``native.take_rows`` (a
threaded memcpy; numpy's fancy index where the host library is missing),
as the JAX loader does.

``drop_remainder=False`` pads the final short batch by repeating row 0 and
reports the true rows in the ``_valid`` mask, so every row is covered while
every step keeps one static shape. ``num_batches`` pads the epoch with
fully invalid batches up to an agreed count (processes with unequal shards
must run the same number of collective steps).
"""

from __future__ import annotations

from typing import Dict, Iterator, Optional

import numpy as np

from .. import native

Batch = Dict[str, np.ndarray]


def num_rows(data: Batch) -> int:
    return next(iter(data.values())).shape[0]


def shard_for_process(data: Batch, process_index: int, process_count: int) -> Batch:
    """Keep this process's strided shard of the rows."""
    if process_count <= 1:
        return data
    return {k: v[process_index::process_count] for k, v in data.items()}


class ArrayLoader:
    """Batched iteration over a dict-of-arrays dataset.

    BatchNorm computes its train-mode statistics over the repeated padding
    rows of the one short batch an epoch, as the JAX loader's notes say
    (``docs/REPRODUCING.md`` §4.7).
    """

    def __init__(
        self,
        data: Batch,
        batch_size: int,
        shuffle: bool = False,
        seed: int = 42,
        drop_remainder: bool = True,
        num_batches: Optional[int] = None,
    ):
        self.data = data
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_remainder = drop_remainder
        self._rng = np.random.default_rng(seed)
        self.n = num_rows(data)
        if num_batches is not None:
            if drop_remainder:
                raise ValueError("num_batches requires drop_remainder=False")
            if num_batches < -(-self.n // batch_size):
                raise ValueError(
                    f"num_batches={num_batches} cannot cover "
                    f"{self.n} rows at batch_size={batch_size}"
                )
        self.num_batches = num_batches

    def __len__(self) -> int:
        if self.num_batches is not None:
            return self.num_batches
        if self.drop_remainder:
            return self.n // self.batch_size
        return -(-self.n // self.batch_size)

    def __iter__(self) -> Iterator[Batch]:
        order = np.arange(self.n)
        if self.shuffle:
            self._rng.shuffle(order)
        bs = self.batch_size
        num_full = self.n // bs
        take = native.take_rows
        emitted = 0
        for i in range(num_full):
            idx = order[i * bs : (i + 1) * bs]
            batch = {k: take(v, idx) for k, v in self.data.items()}
            batch["_valid"] = np.ones((bs,), np.float32)
            emitted += 1
            yield batch
        rem = self.n - num_full * bs
        if rem and not self.drop_remainder:
            idx = np.concatenate([order[num_full * bs :], np.zeros(bs - rem, np.int64)])
            batch = {k: take(v, idx) for k, v in self.data.items()}
            valid = np.zeros((bs,), np.float32)
            valid[:rem] = 1.0
            batch["_valid"] = valid
            emitted += 1
            yield batch
        while self.num_batches is not None and emitted < self.num_batches:
            idx = np.zeros(bs, np.int64)
            batch = {k: take(v, idx) for k, v in self.data.items()}
            batch["_valid"] = np.zeros((bs,), np.float32)
            emitted += 1
            yield batch


def split_train_test(data: Batch, test_fraction: float = 0.15, seed: int = 0):
    """Deterministic row split (the synthetic-data stand-in for the
    reference's date-based train/test split)."""
    n = num_rows(data)
    rng = np.random.default_rng(seed)
    order = rng.permutation(n)
    cut = int(n * (1.0 - test_fraction))
    tr, te = order[:cut], order[cut:]
    return ({k: v[tr] for k, v in data.items()}, {k: v[te] for k, v in data.items()})
