"""Share of the profiled slice of DIEN's training window in which the device
ran no kernel, copy or memset, % (layer: the device)."""

from port_bench.readers import device_idle_pct as read  # noqa: F401
