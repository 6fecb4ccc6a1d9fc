"""Device copies a request: ``gpu_memcpy`` events launched inside the port's
``predictor.call`` span, median over the traced slice's requests (layer:
serving)."""

from port_bench.program_spans import serve_copies_per_request as read  # noqa: F401
