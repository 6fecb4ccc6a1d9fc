"""Host milliseconds a step in the port's ``trainer.forward`` span: the model's
forward and the loss, mean over the traced slice's steps (layer: the Trainer)."""

from port_bench.program_spans import step_forward_host_ms as read  # noqa: F401
