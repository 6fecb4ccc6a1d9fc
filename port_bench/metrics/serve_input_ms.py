"""Host milliseconds a request in the port's ``predictor.pad`` and
``predictor.h2d`` spans: padding every column on the host and copying it to
the device, median over the traced slice's requests (layer: serving)."""

from port_bench.program_spans import serve_input_ms as read  # noqa: F401
