"""Host milliseconds a call of ``Trainer.train_step``: the mean of the
benchmark's spans around every call in the window (layer: the Trainer)."""

from port_bench.readers import step_host_ms as read  # noqa: F401
