"""Kernel B2's share of its roofline in training, %: the least time of the
work of every launch of the CIN layer operator in the profiled slice
(``work/xdeepfm.py``) over the device time of the kernels launched inside
the operator's forward calls."""

from port_bench.readers import b2_roofline_pct as read  # noqa: F401
