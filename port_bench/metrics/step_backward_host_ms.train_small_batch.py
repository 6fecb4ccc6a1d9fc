"""Host milliseconds a step in the port's ``trainer.backward`` span: zeroing
the gradients, the backward pass, their sums over ranks and clipping, mean
over the traced slice's steps (layer: the Trainer)."""

from port_bench.program_spans import step_backward_host_ms as read  # noqa: F401
