"""Device-resident epochs (port of the semantics of ``rank_tpu/train/staged.py``).

Each split is staged on the device once, as one tensor per column, padded
to whole batches with a ``_valid`` mask (``_pad_rows``). On a mesh each
rank stages only its data shard's rows (``cli.py`` shards by data index,
so table peers stage the same rows), and every rank pads to the step
count all agree on (``_agreed_steps``: an all-reduce MAX). Each step takes
a contiguous slice of the epoch's order: a view, with no copy and no host
transfer. Eval walks each rank's staged split in order; ``Trainer.evaluate``
gathers the data ranks' steps.

Epoch shuffles (``shuffle_mode``; a bad mode raises ``ValueError`` as
``staged.py:175-176`` does):

  * ``'global'`` (the default; the reference DataLoader's semantics): one
    uniform permutation over all global rows, drawn alike on every rank
    from a ``torch.Generator`` seeded ``seed + epoch`` on the device. Each
    step's global batch is split into d contiguous blocks, data rank i
    taking block i (the JAX layout, ``_interleave_index``). The rows move
    between data ranks by one ``all_to_all`` an epoch, packed into one
    int32 matrix (float32 columns bitcast, as ``pack_columns`` does).
  * ``'local'``: a one-time stride interleave of the global staged order at
    the first epoch, so that shard i holds global rows i, i+d, i+2d, ...
    (one exchange a run, where JAX's is one gather a run), then each epoch
    a permutation of each shard's own rows with **no** collective: shard i
    takes the i-th of d permutations drawn from the generator seeded
    ``seed + epoch``. Rows never move between shards across epochs, the
    per-worker shuffle of distributed loaders.

With one data rank both modes draw the same permutation and move nothing.
``step_memory_analysis`` measures what one train step holds on the card
(``staged.py:368``). The JAX runner's TPU layout (several steps unrolled
into one dispatch) answers the TPU's dispatch cost and is not carried over.
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from ..data.loader import num_rows
from ..parallel.mesh import DATA_AXIS, Mesh
from ..utils import tracing

SHUFFLE_MODES = ("global", "local")


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


def _agreed_steps(n_local: int, batch_size: int, mesh: Optional[Mesh] = None) -> int:
    """The step count every rank agrees on: the most any rank needs."""
    steps = -(-n_local // batch_size)
    if mesh is None or mesh.world_size == 1:
        return steps
    agreed = torch.tensor([steps], dtype=torch.int64, device=mesh.device)
    return int(mesh.all_reduce_(agreed, None, op="max").item())


def _pack(columns: Dict[str, torch.Tensor]) -> Tuple[torch.Tensor, List[Tuple[str, int, torch.dtype, torch.Size]]]:
    """Every column as int32 words side by side in one (N, W) matrix (a
    bitcast, lossless); returns it and the layout ``_unpack`` takes."""
    n = next(iter(columns.values())).shape[0]
    words, layout = [], []
    for k, v in columns.items():
        flat = v.reshape(n, -1)
        if flat.element_size() % 4:
            raise TypeError(f"column {k!r} of {v.dtype} does not pack into 32-bit words")
        flat = flat.contiguous().view(torch.int32)
        words.append(flat)
        layout.append((k, flat.shape[1], v.dtype, v.shape[1:]))
    return torch.cat(words, dim=1), layout


def _unpack(packed: torch.Tensor, layout) -> Dict[str, torch.Tensor]:
    out, start = {}, 0
    for k, width, dtype, trailing in layout:
        col = packed[:, start:start + width].contiguous().view(dtype)
        out[k] = col.reshape((packed.shape[0],) + tuple(trailing))
        start += width
    return out


class StagedRunner:
    """Drives device-resident train and eval epochs for one ``Trainer``;
    ``batch_size`` is each rank's rows a step."""

    def __init__(self, trainer, train_data, eval_data, batch_size: int,
                 shuffle_mode: str = "global"):
        if shuffle_mode not in SHUFFLE_MODES:
            raise ValueError(f"shuffle_mode {shuffle_mode!r}: global|local")
        self.shuffle_mode = shuffle_mode
        self.trainer = trainer
        self.mesh = trainer.mesh
        self.batch_size = batch_size
        self.train_staged, self.train_steps = self._stage(train_data)
        self.eval_staged, self.eval_steps = self._stage(eval_data)
        self._interleaved = False

    def _stage(self, data):
        steps = _agreed_steps(num_rows(data), self.batch_size, self.mesh)
        padded, steps = _pad_rows(data, self.batch_size, steps)
        return self.trainer.to_device(padded), steps

    def _slices(self, staged: Dict[str, torch.Tensor], steps: int) -> Iterator[Dict[str, torch.Tensor]]:
        bs = self.batch_size
        for i in range(steps):
            yield {k: v[i * bs : (i + 1) * bs] for k, v in staged.items()}

    def _exchange(self, staged: Dict[str, torch.Tensor], wanted: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Data rank i's new rows: ``wanted[i]`` (d, n_local) names, for
        every data rank, the global staged rows (rank-major) it takes, in
        order. One ``all_to_all`` over the data group moves them."""
        d, n_local = wanted.shape
        me = self.mesh.data_index
        send = []
        for dest in range(d):
            rows = wanted[dest]
            send.append(rows[rows // n_local == me] % n_local)
        send_idx = torch.cat(send)
        in_splits = [int(x.numel()) for x in send]
        mine = wanted[me]
        source = mine // n_local
        out_splits = [int(x) for x in torch.bincount(source, minlength=d).tolist()]
        packed, layout = _pack(staged)
        recv = self.mesh.all_to_all(packed.index_select(0, send_idx), DATA_AXIS,
                                    out_splits=out_splits, in_splits=in_splits)
        # rows arrive grouped by source rank, in ``mine``'s order within each
        order = torch.sort(source, stable=True).indices
        placed = torch.empty_like(recv)
        placed[order] = recv
        return _unpack(placed, layout)

    def _stride_interleave(self) -> None:
        """Once a run ('local'): shard i takes global rows i, i+d, i+2d, ..."""
        d = self.mesh.shape[DATA_AXIS]
        n_local = self.train_steps * self.batch_size
        device = self.trainer.device
        j = torch.arange(n_local, device=device)
        wanted = torch.stack([j * d + i for i in range(d)])
        self.train_staged = self._exchange(self.train_staged, wanted)
        self._interleaved = True

    def shuffled(self, epoch: int, seed: int) -> Dict[str, torch.Tensor]:
        """This rank's staged training rows in this epoch's order."""
        with tracing.span("staged.shuffle"):
            device = self.trainer.device
            d = self.mesh.shape[DATA_AXIS]
            n_local = self.train_steps * self.batch_size
            generator = torch.Generator(device=device).manual_seed(seed + epoch)
            if self.shuffle_mode == "local":
                if d > 1 and not self._interleaved:
                    self._stride_interleave()
                perms = [torch.randperm(n_local, generator=generator, device=device)
                         for _ in range(d)]
                perm = perms[self.mesh.data_index]
                return {k: v.index_select(0, perm) for k, v in self.train_staged.items()}
            perm = torch.randperm(n_local * d, generator=generator, device=device)
            if d == 1:
                return {k: v.index_select(0, perm) for k, v in self.train_staged.items()}
            # step s's global batch perm[s*gbs:(s+1)*gbs] in d blocks, block i
            # for data rank i
            wanted = perm.view(self.train_steps, d, self.batch_size).transpose(0, 1).reshape(d, -1)
            return self._exchange(self.train_staged, wanted)

    def step_memory_analysis(self, state) -> Optional[Dict[str, float]]:
        """What one train step on the first staged batch holds on the card,
        GiB (2**30 bytes): ``argument_gb`` allocated at its entry (the
        state, the staged splits, fresh meters), ``temp_gb`` its peak over
        that, ``output_gb`` what it leaves allocated beyond that (Adam's
        moments and the gradients after a first step). Measured around a
        real step, which ``Trainer.restoring`` then undoes, in the caching
        allocator's requested bytes (``torch.cuda.memory_stats``'
        ``requested_bytes.all.current`` and ``.peak``, whose peak it
        resets): what the tensors asked for. ``memory_allocated`` counts
        the blocks that hold them, and a block taken from the cache may
        be larger than its tensor, by as much as the allocator's history
        left: a step that frees and reallocates its gradients then reads
        as leaving less than it found. None on a CPU trainer: the JAX
        runner's contract for a backend without a memory analysis."""
        device = self.trainer.device
        if device.type != "cuda":
            return None

        def requested(which: str) -> int:
            return torch.cuda.memory_stats(device)[f"requested_bytes.all.{which}"]

        batch = next(self._slices(self.train_staged, 1))
        with self.trainer.restoring(state):
            meters = self.trainer.meters_init()
            torch.cuda.synchronize(device)
            entry = requested("current")
            torch.cuda.reset_peak_memory_stats(device)
            self.trainer.train_step(state, meters, batch)
            torch.cuda.synchronize(device)
            peak, left = requested("peak"), requested("current")
        return {"argument_gb": entry / 2**30, "output_gb": (left - entry) / 2**30,
                "temp_gb": (peak - entry) / 2**30}

    def train_epoch(self, state, epoch: int, seed: int = 42):
        batches = self._slices(self.shuffled(epoch, seed), self.train_steps)
        return self.trainer.train_epoch(state, batches, epoch)

    def evaluate(self, state, epoch: int = 1):
        return self.trainer.evaluate(state, self._slices(self.eval_staged, self.eval_steps), epoch)
