"""Data producers (numpy only)."""
