"""Peaks of one NVIDIA H100 SXM (80 GB HBM3), from NVIDIA's data sheet:
dense rates at the full 700 W power limit.

Every share of a peak in this benchmark is taken against ``PRODUCT_FLOPS``:
the TF32 tensor-core rate over the three TF32 products that 3xTF32 makes
of each f32-accurate product. It is the fastest rate at which the card
computes products to f32 accuracy, so no implementation held to the
configurations' f32 can read over 100%. Bytes are bounded by the HBM rate.
"""

TF32_FLOPS = 495e12
PRODUCT_FLOPS = TF32_FLOPS / 3
HBM_BYTES_PER_S = 3.35e12


def least_seconds(flops: float, nbytes: float) -> float:
    """The least time the card could take for this work: the larger of the
    products at ``PRODUCT_FLOPS`` and the bytes at ``HBM_BYTES_PER_S``."""
    return max(flops / PRODUCT_FLOPS, nbytes / HBM_BYTES_PER_S)
