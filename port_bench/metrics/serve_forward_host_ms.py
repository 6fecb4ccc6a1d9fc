"""Host milliseconds a request in the port's ``predictor.forward`` span: the
forward's dispatch and the heads, median over the traced slice's requests
(layer: serving)."""

from port_bench.program_spans import serve_forward_host_ms as read  # noqa: F401
