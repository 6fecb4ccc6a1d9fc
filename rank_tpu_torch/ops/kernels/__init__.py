"""Hand-written Hopper kernels, each beside its plain torch version."""
