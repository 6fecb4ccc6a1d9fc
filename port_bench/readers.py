"""The readers that per-layer metrics share. A metric's own file
(``metrics/<metric>.py``) names its reader here, so that a cell whose
metrics carry other names reads them with the same code. Each takes the
traced run's record and returns the number, or None where the record
holds nothing to read."""

from __future__ import annotations

import statistics
from typing import Optional

from .peaks import PRODUCT_FLOPS
from .trace import roofline_pct


def device_idle_pct(record) -> Optional[float]:
    """Share of the profiled slice in which the device ran no kernel, copy
    or memset, %."""
    trace = record["trace"]
    if trace is None or trace.busy_us <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_us / trace.window_us)


def device_ms_per_unit(record) -> Optional[float]:
    """The union of kernels, copies and memsets in the profiled slice over
    the units (train steps, requests) it holds, ms."""
    trace, units = record["trace"], record["units"]
    if trace is None or not units or trace.busy_us <= 0:
        return None
    return trace.busy_us / len(units) * 1e-3


def b1_roofline_pct(record) -> Optional[float]:
    return roofline_pct(record, "rank_tpu_torch::din_attention")


def b2_roofline_pct(record) -> Optional[float]:
    return roofline_pct(record, "rank_tpu_torch::cin_layer_t")


def step_host_ms(record) -> Optional[float]:
    """The mean of the benchmark's spans around every ``Trainer.train_step``
    call of the window, ms."""
    times = record["spans"].get("train_step")
    return statistics.fmean(times) * 1e3 if times else None


def train_mfu_pct(record) -> Optional[float]:
    """Product FLOPs per example (``work/<model>.py``) times the window's
    examples a second, over ``peaks.PRODUCT_FLOPS``, %."""
    w = record["window"]
    if not w["examples"]:
        return None
    return 100.0 * record["products_per_example"] * w["examples"] / w["seconds"] / PRODUCT_FLOPS


def serve_service_ms(record) -> Optional[float]:
    """The median host time from a call of ``Predictor`` to its return, over
    every request of the window, ms."""
    times = record["spans"].get("service")
    return statistics.median(times) * 1e3 if times else None


def serve_mfu_pct(record) -> Optional[float]:
    """The product FLOPs of the rows requested (not the padding) over the
    summed service time of the window's requests times
    ``peaks.PRODUCT_FLOPS``, %."""
    w = record["window"]
    if not w["service_seconds"]:
        return None
    return 100.0 * w["requested_products"] / (w["service_seconds"] * PRODUCT_FLOPS)
