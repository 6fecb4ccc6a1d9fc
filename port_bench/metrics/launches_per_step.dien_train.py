"""Runtime calls a DIEN step, on any thread inside the port's
``trainer.step`` spans, whose correlation id reaches a kernel, copy or
memset of the traced slice (layer: the Trainer)."""

from port_bench.program_spans import launches_per_step as read  # noqa: F401
