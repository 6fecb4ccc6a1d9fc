"""Per-op buffer-traffic attribution of a train step (port of
``rank_tpu/utils/hlo_bytes.py``).

The JAX module walks the compiled step's entry HLO and counts each fusion
boundary's materialised buffers. Eager PyTorch has no HLO and fuses
nothing: every aten op reads its operands from memory and writes its
output back. So each dispatched op plays the role of one fusion boundary,
and ``recording`` (a ``TorchDispatchMode``) counts, per op:

  * an ordinary op: its output and its tensor operands, a tensor list
    per tensor (the foreach ops of ``torch.optim.Adam`` on the card);
  * an in-place op (or an ``out=`` variant): what it reads and the
    tensors it writes, the mutated operand counted as a read and a write;
  * views and allocations that write nothing (``view``, ``t``,
    ``transpose``, ``permute``, ``expand``, ``slice``, ``select``,
    ``squeeze``, ``detach``, ``_unsafe_view``, ``empty``, ...): free;
    ``zeros_like`` and its kin: the output only;
  * an embedding gather (``embedding``, ``index_select``, ``gather``,
    ``index``): twice the output (the touched rows read, the output
    written) and the index bytes, not the whole table;
  * ``embedding_dense_backward``: the ordinary rule, so the whole
    table-sized gradient it writes, which eager PyTorch really moves (the
    JAX module's 3 x updates for a scatter does not hold here);
  * the two hand-written kernels' operators: the ordinary rule, each input
    read once and the output written once. Their casts and weight layout
    run inside the operator and are not seen.

A tensor's bytes are its distinct elements' (a stride-0 dimension of an
``expand`` counts once). Ops outside aten (the profiler's ranges) hold no
tensors and count nothing.

Each row names the op, its module scope (``ModuleTracker``: the deepest
module running, e.g. ``DIN.attention``) and its phase: ``backward`` when
the autograd engine runs it, ``optimizer`` inside ``Optimizer.step``,
else ``forward``. ``bucket`` groups rows under the JAX module's labels
where they apply.
"""

from __future__ import annotations

import collections
import contextlib
from typing import Iterator, List, Tuple

import torch
from torch.optim.optimizer import (register_optimizer_step_post_hook,
                                   register_optimizer_step_pre_hook)
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.module_tracker import ModuleTracker

Row = Tuple[int, str, str, str]  # bytes, op (e.g. 'aten.mm'), module scope, phase

_FREE = {"aten._unsafe_view", "aten.lift_fresh", "aten.empty", "aten.empty_like",
         "aten.empty_strided", "aten.new_empty", "aten.new_empty_strided"}
# factories that read their operand's shape only
_WRITE_ONLY = {"aten.zeros_like", "aten.ones_like", "aten.full_like"}
_GATHER = {"aten.embedding", "aten.index_select", "aten.gather", "aten.index"}
_MATMUL = {"aten.mm", "aten.addmm", "aten.bmm", "aten.baddbmm", "aten.mv", "aten.addmv",
           "aten.dot"}
_SCATTER = {"aten.embedding_dense_backward", "aten.index_add", "aten.index_add_",
            "aten.index_put", "aten.index_put_", "aten._index_put_impl_", "aten.scatter_add",
            "aten.scatter_add_"}


def tensor_bytes(t: torch.Tensor) -> int:
    """The bytes of ``t``'s distinct elements: a stride-0 dimension counts once."""
    n = t.element_size()
    for size, stride in zip(t.shape, t.stride()):
        if stride != 0:
            n *= size
    return n if t.numel() else 0


def _tensors(tree) -> List[torch.Tensor]:
    return [x for x in tree_flatten(tree)[0] if isinstance(x, torch.Tensor)]


def op_traffic(func, args, kwargs, out) -> int:
    """The bytes one dispatched op moves under the rules of the module docstring."""
    name = str(func.overloadpacket)
    if func.is_view or name in _FREE:
        return 0
    written = sum(map(tensor_bytes, _tensors(out)))
    if name in _GATHER:
        indices = [x for x in _tensors((args[1:], kwargs)) if not x.is_floating_point()]
        return 2 * written + sum(map(tensor_bytes, indices))
    if name in _WRITE_ONLY:
        return written
    schema = func._schema
    if schema.is_mutable:
        named = dict(zip((a.name for a in schema.arguments), args))
        named.update(kwargs)
        written = sum(map(tensor_bytes, _tensors(
            [named[a.name] for a in schema.arguments
             if a.alias_info is not None and a.alias_info.is_write and a.name in named])))
    return written + sum(map(tensor_bytes, _tensors((args, kwargs))))


class _Recorder(TorchDispatchMode):
    def __init__(self, rows: List[Row], tracker: ModuleTracker):
        super().__init__()
        self.rows, self.tracker = rows, tracker
        self.in_optimizer = False

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        nbytes = op_traffic(func, args, kwargs, out)
        if nbytes:
            if self.in_optimizer:
                phase = "optimizer"
            elif torch._C._current_graph_task_id() != -1:
                phase = "backward"
            else:
                phase = "forward"
            scope = max(self.tracker.parents, key=lambda p: p.count("."))
            self.rows.append((nbytes, str(func.overloadpacket), scope, phase))
        return out


@contextlib.contextmanager
def recording() -> Iterator[List[Row]]:
    """Record a row for every op dispatched inside the block that moves
    bytes; yields the list the rows go into."""
    rows: List[Row] = []
    tracker = ModuleTracker()
    recorder = _Recorder(rows, tracker)

    def enter(*_):
        recorder.in_optimizer = True

    def leave(*_):
        recorder.in_optimizer = False

    pre = register_optimizer_step_pre_hook(enter)
    post = register_optimizer_step_post_hook(leave)
    try:
        with tracker, recorder:
            yield rows
    finally:
        pre.remove()
        post.remove()


def attribute_bytes(fn, *args, **kwargs) -> List[Row]:
    """The rows of one call ``fn(*args, **kwargs)``."""
    with recording() as rows:
        fn(*args, **kwargs)
    return rows


def step_rows(trainer, state, batch) -> List[Row]:
    """The rows of one train step of ``trainer`` on the device batch
    ``batch``, run on ``state`` and put back afterwards
    (``Trainer.restoring``), with fresh meters."""
    with trainer.restoring(state):
        return attribute_bytes(trainer.train_step, state, trainer.meters_init(), batch)


def real_step_bytes(trainer, state, batch) -> int:
    """The total buffer traffic of one train step (``step_rows``)."""
    return sum(r[0] for r in step_rows(trainer, state, batch))


def bucket(op: str, scope: str, phase: str) -> str:
    """The JAX module's label for a row where one applies, else the last
    module of its scope and the op."""
    if phase == "optimizer":
        return "optimizer_update"
    if op in _MATMUL:
        return "matmul_bwd" if phase == "backward" else "matmul_fwd"
    if op in _GATHER:
        return "embedding_gather"
    if op in _SCATTER:
        return "embedding_scatter_grad"
    lowered = scope.lower()
    if "attention" in lowered:
        return "attention"
    if "transformer" in lowered:
        return "transformer"
    return f"{scope.rsplit('.', 1)[-1]}/{op.rsplit('.', 1)[-1]}"[:60]


def grouped(rows: List[Row], top: int = 14):
    """The ``top`` buckets by bytes: [(label, bytes), ...]."""
    g = collections.Counter()
    for nbytes, op, scope, phase in rows:
        g[bucket(op, scope, phase)] += nbytes
    return g.most_common(top)
