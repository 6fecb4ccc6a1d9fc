"""Interaction ops; hand-written CUDA kernels live under ``ops.kernels``."""
