"""Device milliseconds a step launched inside the port's ``cin.backward``
spans, B2's recompute backward, by correlation id on the span's own thread
(layer: kernel B2)."""

from port_bench.program_spans import b2_backward_device_ms as read  # noqa: F401
