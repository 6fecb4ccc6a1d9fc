"""Roofline and MFU accounting of train steps on the H100 (port of
``rank_tpu/utils/roofline.py``).

Converts a measured examples/s into achieved FLOP/s and HBM bytes/s against
the card's peaks, so that a claim of "at the hardware's ceiling" is a
checkable number:

  * ``step_costs`` counts one train step: its FLOPs with
    ``torch.utils.flop_counter.FlopCounterMode`` and its bytes with
    ``utils/op_bytes.py``. The FLOPs are the products' (mm, addmm, bmm,
    baddbmm and the formulas registered beside the two hand-written
    kernels' operators, ``ops/kernels/{din_attention,cin}.py``):
    elementwise work (activations, the loss, Adam's update) is not counted.
    XLA's count, behind the JAX function, includes it, so the port's
    count is lower by that work (for DCN, Adam's ~19 FLOPs a parameter;
    ``scripts/mfu_roofline.py:dcn_hand_count``).
  * ``roofline`` gives the MFU, the HBM share, what bounds the step and
    the examples/s at the roofline's ceiling.

Peaks: NVIDIA's data sheet of the H100 SXM, dense rates, at the card's full
700 W. A card set to a lower power limit reaches less; state its limit
beside every share. The compute peak is the one of the products'
arithmetic under ``matmul_precision`` (``peak_flops``): f32 outside the
tensor cores by default and under ``float32`` and ``highest``, TF32 under
``bfloat16``, which ``Trainer`` maps to torch's ``'medium'``: on the card
cuBLAS then runs f32 products in TF32 (``chip_smoke.py``'s
``matmul_precision_error`` line measures it). The two hand-written kernels
run 3xTF32 under every setting; their products are f32-accurate and are
counted at the same peak as the rest.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch.utils.flop_counter import FlopCounterMode

from . import op_bytes

H100_PEAK_F32_FLOPS = 67e12  # f32 FLOP/s outside the tensor cores
H100_PEAK_TF32_FLOPS = 495e12  # TF32 FLOP/s on the tensor cores
H100_PEAK_BF16_FLOPS = 989e12  # bf16 FLOP/s on the tensor cores
H100_PEAK_HBM = 3.35e12  # HBM3 bytes/s
H100_HBM_BYTES = 80e9

# the arithmetic of an f32 product under each TrainConfig.matmul_precision
PRODUCT_ARITHMETIC = {None: "float32", "float32": "float32", "highest": "float32",
                      "bfloat16": "tf32"}


def peak_flops(matmul_precision: Optional[str] = None) -> float:
    """The compute peak of the products under ``matmul_precision``."""
    if matmul_precision not in PRODUCT_ARITHMETIC:
        raise ValueError(f"matmul_precision {matmul_precision!r}: one of "
                         f"{sorted(k for k in PRODUCT_ARITHMETIC if k)} or None")
    arithmetic = PRODUCT_ARITHMETIC[matmul_precision]
    return H100_PEAK_TF32_FLOPS if arithmetic == "tf32" else H100_PEAK_F32_FLOPS


def step_costs(trainer, state, batch) -> Optional[Dict[str, float]]:
    """FLOPs and bytes of one train step of ``trainer`` on the device batch
    ``batch``: the products' FLOPs (see the module docstring) and the
    materialised buffer traffic of ``op_bytes``. The step runs on
    ``state`` on the trainer's device, with fresh meters, and
    ``Trainer.restoring`` puts the model, the optimizer, the step and the
    random generators back afterwards. None where no product was counted,
    as the JAX function returns None for no FLOPs."""
    with trainer.restoring(state):
        meters = trainer.meters_init()
        with FlopCounterMode(display=False) as counter, op_bytes.recording() as rows:
            trainer.train_step(state, meters, batch)
    flops = counter.get_total_flops()
    if flops <= 0:
        return None
    return {"flops": float(flops), "bytes": float(sum(r[0] for r in rows))}


def roofline(
    flops_per_example: float,
    bytes_per_example: float,
    examples_per_s: float,
    matmul_precision: Optional[str] = None,
) -> Dict[str, float]:
    """Achieved rates against the H100's peaks and the roofline's ceiling
    (the JAX function's keys; ``bound`` is ``"hbm"`` or ``"compute"``, and
    ``peak_tflops`` names the compute peak divided by)."""
    peak = peak_flops(matmul_precision)
    ach_flops = flops_per_example * examples_per_s
    ach_bw = bytes_per_example * examples_per_s
    # the ceiling: the examples/s at which the binding resource saturates
    # (no overlap slack assumed)
    t_flops = flops_per_example / peak
    t_bw = bytes_per_example / H100_PEAK_HBM
    ceiling = 1.0 / max(t_flops, t_bw) if max(t_flops, t_bw) > 0 else 0.0
    return {
        "flops_per_example": round(flops_per_example, 1),
        "bytes_per_example": round(bytes_per_example, 1),
        "achieved_tflops": round(ach_flops / 1e12, 3),
        "achieved_hbm_gbs": round(ach_bw / 1e9, 1),
        "mfu_pct": round(100 * ach_flops / peak, 2),
        "hbm_bw_pct": round(100 * ach_bw / H100_PEAK_HBM, 1),
        "bound": "hbm" if t_bw >= t_flops else "compute",
        "roofline_ceiling_ex_s": round(ceiling),
        "pct_of_roofline": round(100 * examples_per_s / ceiling, 1) if ceiling else None,
        "peak_tflops": peak / 1e12,
    }
