"""Training calls replayed as CUDA graphs (``ModelConfig.cuda_graphs``).

``call(owner, fn, *args, modules=...)`` returns ``fn(owner, *args)``,
where ``fn`` reads the parameters of ``modules`` (``owner`` by default)
and no other. The first call
of a key captures ``fn``'s forward and its backward with
``torch.cuda.make_graphed_callables``; every later call copies ``args``
into the graph's inputs and launches one graph a direction, where the
plain call dispatches each of its kernels from Python. The key is
``fn``, the shapes, dtypes and ``requires_grad`` of ``args``, their device
and the float32 matmul precision; ``fn``'s graphs are dropped when those
parameters move to other storage. A parameter that ``fn`` does not read
must stay out of ``modules``: a capture's backward would then meet that
parameter's gradient accumulator from the live step, made on another
stream, and fail. The graphs hold the kernels the plain
call launches, so the numbers are the plain call's. The capture's warm-up
calls update ``owner``'s buffers (BatchNorm's running statistics), so
they are restored after it; in the replays the graph updates them.

``replayable(module, x)`` says where a graph may stand in: a training
call with gradients on the card, outside autocast, another capture and a
process group (whose collectives a graph would freeze). ``fn`` draws no
random numbers: the capture's warm-up would move the generator.
"""

from __future__ import annotations

import weakref
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch
from torch import nn

# owner -> {fn: (its parameters' storage, {key: graphed call})}
_GRAPHS: "weakref.WeakKeyDictionary[nn.Module, Dict[Callable, Tuple[tuple, Dict[tuple, nn.Module]]]]" = (
    weakref.WeakKeyDictionary())


def replayable(module: nn.Module, x: torch.Tensor) -> bool:
    return (x.is_cuda and module.training and torch.is_grad_enabled()
            and not torch.is_autocast_enabled("cuda")
            and not torch.cuda.is_current_stream_capturing()
            and not (torch.distributed.is_available() and torch.distributed.is_initialized()))


class _Call(nn.Module):
    """``fn(owner, *args)`` as a module holding ``params`` and a weak
    reference to ``owner``, so that ``_GRAPHS`` keeps no owner alive."""

    def __init__(self, owner: nn.Module, fn: Callable, params: List[nn.Parameter]):
        super().__init__()
        self.fn, self.owner = fn, weakref.ref(owner)
        for i, p in enumerate(params):
            self.register_parameter(f"p{i}", p)

    def forward(self, *args):
        return self.fn(self.owner(), *args)


def call(owner: nn.Module, fn: Callable, *args: torch.Tensor,
         modules: Optional[Sequence[nn.Module]] = None):
    params = [p for m in (modules or (owner,)) for p in m.parameters()]
    storage = tuple(p.data_ptr() for p in params)
    calls = _GRAPHS.setdefault(owner, {})
    held, graphs = calls.get(fn, (None, {}))
    if held != storage:  # moved or replaced parameters: older graphs read freed memory
        graphs = {}
        calls[fn] = (storage, graphs)
    key = (tuple((a.shape, a.dtype, a.requires_grad) for a in args), args[0].device,
           torch.get_float32_matmul_precision())
    if key not in graphs:
        sample = tuple(a.detach().clone().requires_grad_(a.requires_grad) for a in args)
        buffers = [b.detach().clone() for b in owner.buffers()]
        graphs[key] = torch.cuda.make_graphed_callables(_Call(owner, fn, params), sample,
                                                        allow_unused_input=True)
        with torch.no_grad():
            for b, kept in zip(owner.buffers(), buffers):
                b.copy_(kept)
    return graphs[key](*args)
