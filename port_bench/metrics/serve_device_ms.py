"""Device milliseconds a request: the union of kernels, copies and memsets
in the profiled slice over the requests it served (layer: models and ops on
the device, serving)."""

from port_bench.readers import device_ms_per_unit as read  # noqa: F401
