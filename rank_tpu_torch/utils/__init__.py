"""Measurement tools: the step roofline (``roofline.py``) and the per-op
buffer-traffic attribution (``op_bytes.py``)."""
