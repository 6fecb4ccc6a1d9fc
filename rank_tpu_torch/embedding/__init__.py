"""Per-field embedding tables."""
