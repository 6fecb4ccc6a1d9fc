"""Kernel B1's share of its roofline in serving, %: the least time of the
work of every launch of the DIN attention operator in the profiled slice
(``work/din.py``) over the device time of the kernels launched inside
the operator's forward calls."""

from port_bench.readers import b1_roofline_pct as read  # noqa: F401
