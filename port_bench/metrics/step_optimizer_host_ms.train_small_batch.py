"""Host milliseconds a step in the port's ``trainer.optimizer`` span: Adam's
step, mean over the traced slice's steps (layer: the Trainer)."""

from port_bench.program_spans import step_optimizer_host_ms as read  # noqa: F401
