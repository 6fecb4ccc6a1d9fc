"""Measurement tools: the step roofline (``roofline.py``), the per-op
buffer-traffic attribution (``op_bytes.py``) and the spans of the port's
stages in a profiler's trace (``tracing.py``)."""
