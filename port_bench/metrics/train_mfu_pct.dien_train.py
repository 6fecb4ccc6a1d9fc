"""The whole DIEN train step's share of the card's f32-accurate product
peak, %: product FLOPs per example (``work/dien.py``) times the window's
examples a second, over ``peaks.PRODUCT_FLOPS``."""

from port_bench.readers import train_mfu_pct as read  # noqa: F401
