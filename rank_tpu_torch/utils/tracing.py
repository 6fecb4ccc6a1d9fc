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
miss it. No span opens inside an ``nn.Module.forward``, where it would
enter ``torch.export`` programs and CUDA-graph captures.
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
