"""The whole serving forward's share of the card's f32-accurate product
peak, %: the product FLOPs of the rows requested (not the padding), from
``work/<model>.py``, over the summed service time of the window's requests
times ``peaks.PRODUCT_FLOPS``."""

from port_bench.readers import serve_mfu_pct as read  # noqa: F401
