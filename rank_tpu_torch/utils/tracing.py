"""Named spans of the port's stages, recorded in ``torch.profiler``'s trace.

``span(name)`` opens ``torch.profiler.record_function("rank_tpu_torch." +
name)`` while a profiler records, so the span lands in the same
trace as the CUDA kernels and the runtime calls that launch them, on the
same clock. Otherwise it returns one shared null context: a span then costs
one read of a module flag, where an unconditional ``record_function`` costs
microseconds.

The flag is ``torch.autograd.profiler._is_profiler_enabled``, which a
running profiler sets for the whole process. The C++ ``_profiler_enabled()`` is
per thread, and a backward that autograd runs on its device thread could
miss it.

Spans open around the steps of the train step and of ``Predictor``, around
the kernels' backward, and inside one ``nn.Module.forward``: the GRU's
(``ops/rnn.py``), which opens ``rnn.gru`` or ``rnn.augru`` once a call
around its loop over T, since the recurrence runs only inside a forward.
That is safe because the flag is read when the span opens: without a
profiler the span is the shared null context, so a ``torch.export``
program or a CUDA-graph capture made without one holds no profiler op
(``tests/test_torch_dien_spans.py``). Open no span inside a step of a
loop, where it would cost its microseconds a timestep under a profiler.
"""

from __future__ import annotations

import contextlib

import torch
from torch.autograd import profiler as _autograd_profiler

PREFIX = "rank_tpu_torch."
_NULL = contextlib.nullcontext()


def span(name: str):
    """A context that records ``PREFIX + name`` while a profiler records."""
    if _autograd_profiler._is_profiler_enabled:
        return torch.profiler.record_function(PREFIX + name)
    return _NULL
