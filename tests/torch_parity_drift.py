"""Measure how far two free-running training trajectories part: rank_tpu's
and the port's from the same weights on the same batches, against the
port's and the port's own from its weights nudged by a relative 1e-6
(about 8 float32 ulps, a rounding-level change). The evidence for checking
``test_torch_parity_steps.py::test_long_training_matches_jax_step_by_step`` step
by step rather than on free-running trajectories. Not collected by
pytest; run from the repository root, naming the models (pnn, widedeep
and mmoe when none is named):

    PYTHONPATH=$PWD:$PYTHONPATH JAX_PLATFORMS=cpu python tests/torch_parity_drift.py [model ...]

It prints one JSON line a model: the worst relative gap of the step loss
over steps 1-5, 6-20 and 21-50 for each pair, and the mean step loss of
each run. The small calibrated log (scale 0.005, seed 0) is written under
a temporary directory; the configs are the test's (the matrix's, full
width, dropout 0, ``LONG_BATCH`` rows a step).
"""

import dataclasses
import json
import os
import sys
import tempfile

import jax
import numpy as np
import torch

jax.config.update("jax_platforms", "cpu")
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import test_torch_parity_steps as tp  # noqa: E402
from rank_tpu.features import WECHAT_SCHEMA as JAX_WECHAT_SCHEMA  # noqa: E402
from rank_tpu.models import ModelConfig as JaxModelConfig  # noqa: E402
from rank_tpu.train import TrainConfig as JaxTrainConfig  # noqa: E402
from rank_tpu.train import Trainer as JaxTrainer  # noqa: E402
from rank_tpu_torch import WECHAT_SCHEMA, parity  # noqa: E402
from rank_tpu_torch.data.loader import ArrayLoader  # noqa: E402
from rank_tpu_torch.interop import state_dict_from_flax  # noqa: E402
from rank_tpu_torch.models.base import jax_fields  # noqa: E402
from rank_tpu_torch.train import Trainer  # noqa: E402

WEIGHTINGS = {"mmoe": "sum"}
WINDOWS = ((0, 5), (5, 20), (20, tp.LONG_STEPS))


def step_losses(trainer, state, batches) -> np.ndarray:
    meters, out = trainer.meters_init(), []
    for batch in batches:
        trainer.train_step(state, meters, trainer.to_device(batch))
        out.append(float(meters["loss"]))
    return np.diff(out, prepend=0.0)


def drift(model: str, small_log) -> dict:
    if model in WEIGHTINGS:
        model_cfg, train_cfg = parity.mtl_config(model, WEIGHTINGS[model], 42, tp.LONG_BATCH)
    else:
        model_cfg, train_cfg = parity.calib_config(model, 42, tp.LONG_BATCH)
    model_cfg = model_cfg.replace(dropout_rate=0.0)
    batches = list(ArrayLoader(small_log.train, tp.LONG_BATCH, shuffle=True,
                               seed=5))[:tp.LONG_STEPS]

    jtrainer = JaxTrainer(JAX_WECHAT_SCHEMA, JaxModelConfig(**jax_fields(model_cfg)),
                          JaxTrainConfig(**dataclasses.asdict(train_cfg)))
    jstate = jtrainer.init_state(batches[0])
    host = jax.device_get(jstate)
    variables = {"params": host["params"], **host["extra"]}
    jstep = jtrainer._get_compiled("train")
    jmeters, jlosses = jtrainer.meters_init(), []
    for batch in batches:
        jstate, jmeters = jstep(jstate, jmeters, jtrainer._host_to_device(batch))
        jlosses.append(float(jmeters["loss"]))
    jlosses = np.diff(jlosses, prepend=0.0)

    def port_run(nudge: bool) -> np.ndarray:
        trainer = Trainer(WECHAT_SCHEMA, model_cfg, train_cfg, device="cpu")
        state = trainer.init_state()
        weights = state_dict_from_flax(state["model"], variables)
        if nudge:
            gen = torch.Generator().manual_seed(1)
            for value in weights.values():
                if value.is_floating_point():
                    value.mul_(1 + 1e-6 * torch.randn(value.shape, generator=gen))
        state["model"].load_state_dict(weights)
        return step_losses(trainer, state, batches)

    port, nudged = port_run(False), port_run(True)

    def worst(a, b):
        rel = np.abs(a - b) / np.abs(b)
        return [float(rel[lo:hi].max()) for lo, hi in WINDOWS]

    return {"model": model, "steps": tp.LONG_STEPS, "batch": tp.LONG_BATCH,
            "windows": [f"{lo + 1}-{hi}" for lo, hi in WINDOWS],
            "port_vs_jax": worst(port, jlosses), "port_vs_nudged_port": worst(nudged, port),
            "mean_loss": {"jax": float(jlosses.mean()), "port": float(port.mean()),
                          "nudged_port": float(nudged.mean())}}


def main(models) -> None:
    with tempfile.TemporaryDirectory() as tmp:
        small_log = parity.calibrated_data(tp.SMALL_SCALE, tmp)
        for model in models or ("pnn", "widedeep", "mmoe"):
            print(json.dumps(drift(model, small_log)), flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
