"""Median host milliseconds from a call of ``Predictor`` to its return, over
every request of the window: the service time, without the queue's wait
(layer: serving)."""

from port_bench.readers import serve_service_ms as read  # noqa: F401
