"""Device-resident epochs (port of the semantics of ``rank_tpu/train/staged.py``).

Each split is staged on the device once, as one tensor per column, padded
to whole batches with a ``_valid`` mask (``_pad_rows``). Each training epoch
draws one uniform permutation of the padded rows from a ``torch.Generator``
seeded with ``seed + epoch``, gathers every column once in that order, and
each step takes a contiguous slice: a view, with no copy and no host
transfer. Eval walks the staged split in order.

The JAX runner's TPU layout (one packed int32 matrix, the block-interleave
map for sharded steps, several steps unrolled into one dispatch) answers
the TPU's gather rate and dispatch cost and is not carried over; the
``'local'`` per-shard shuffle waits for the multi-device port (ROADMAP A13).
"""

from __future__ import annotations

from typing import Dict, Iterator, Optional

import numpy as np
import torch

from ..data.loader import num_rows


def _pad_rows(data: Dict[str, np.ndarray], batch_size: int, steps: Optional[int] = None):
    """Pad to ``steps`` batches (default: just enough) by repeating row 0,
    and add ``_valid``; returns (padded data, steps)."""
    n = num_rows(data)
    if steps is None:
        steps = -(-n // batch_size)
    padded_n = steps * batch_size
    out = {}
    for k, v in data.items():
        if padded_n != n:
            v = np.concatenate([v, np.repeat(v[:1], padded_n - n, axis=0)], axis=0)
        out[k] = v
    valid = np.zeros((padded_n,), np.float32)
    valid[:n] = 1.0
    out["_valid"] = valid
    return out, steps


class StagedRunner:
    """Drives device-resident train and eval epochs for one ``Trainer``."""

    def __init__(self, trainer, train_data, eval_data, batch_size: int):
        self.trainer = trainer
        self.batch_size = batch_size
        self.train_staged, self.train_steps = self._stage(train_data)
        self.eval_staged, self.eval_steps = self._stage(eval_data)

    def _stage(self, data):
        padded, steps = _pad_rows(data, self.batch_size)
        return self.trainer.to_device(padded), steps

    def _slices(self, staged: Dict[str, torch.Tensor], steps: int) -> Iterator[Dict[str, torch.Tensor]]:
        bs = self.batch_size
        for i in range(steps):
            yield {k: v[i * bs : (i + 1) * bs] for k, v in staged.items()}

    def shuffled(self, epoch: int, seed: int) -> Dict[str, torch.Tensor]:
        """The staged training split in this epoch's order."""
        device = self.trainer.device
        generator = torch.Generator(device=device).manual_seed(seed + epoch)
        n = self.train_steps * self.batch_size
        perm = torch.randperm(n, generator=generator, device=device)
        return {k: v.index_select(0, perm) for k, v in self.train_staged.items()}

    def train_epoch(self, state, epoch: int, seed: int = 42):
        batches = self._slices(self.shuffled(epoch, seed), self.train_steps)
        return self.trainer.train_epoch(state, batches, epoch)

    def evaluate(self, state, epoch: int = 1):
        return self.trainer.evaluate(state, self._slices(self.eval_staged, self.eval_steps), epoch)
