"""Device milliseconds a DIEN train step: the union of kernels, copies and
memsets in the profiled slice over its steps (layer: models, embedding and
ops on the device)."""

from port_bench.readers import device_ms_per_unit as read  # noqa: F401
