"""Host milliseconds a request in the port's ``predictor.d2h`` span: copying
each head to the host, which waits for the device, median over the traced
slice's requests (layer: serving)."""

from port_bench.program_spans import serve_output_ms as read  # noqa: F401
