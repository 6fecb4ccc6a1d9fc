"""Host milliseconds a DIEN train step: the mean of the benchmark's spans
around every ``Trainer.train_step`` call of the window (layer: the
Trainer)."""

from port_bench.readers import step_host_ms as read  # noqa: F401
