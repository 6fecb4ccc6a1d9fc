"""Whole staged runs of the port held against rank_tpu's from the same start
(``ROADMAP.md`` C4): dcn on the small calibrated log and mmoe under
``sum`` on a small synthetic log, 2 epochs at full width and the matrices'
configs (neither runs dropout, whose masks each framework draws its own),
rank_tpu on one device as its protocol runs on the CPU, the port starting
from rank_tpu's initial state
(``torch_jax_carry.load_jax_state``) on rank_tpu's epoch order
(``torch_jax_carry.JaxOrderRunner``). What the 50-step carried-state test
cannot see, a whole run exercises: the padded rows ``shuffled()`` spreads
through each epoch, BatchNorm statistics accumulated over every step and
read in eval mode (neither model has BatchNorm under these configs),
Adam's moments carried from epoch to epoch, and the exact AUC of the eval
pass.

The bars are ``FACTOR`` times the largest gap measured between the two
runs at seeds 42, 43 and 44 (``MEASURED``, float32 on the CPU). A
parameter's gap is the relative norm of its difference, |a − b| / |b|,
the worst over the tensors: Adam normalises each element's gradient, so
an element whose gradient is rounding noise in both runs moves by up to
the learning rate a step either way, and an elementwise bar would be as
wide as that. Free-running trajectories part at the rounding level step by
step (``python tests/torch_parity_drift.py``), so the gaps grow over a run:
the port's dcn run parts from itself started from weights nudged by a
relative 1e-6 as far as from rank_tpu's (parameters 0.0019 against 0.0021
at seed 42). The BatchNorm towers are no case for such a bar: pnn,
widedeep and fibinet at dropout 0 part from their nudged selves by 14–18%
of a tensor's norm in these 2 epochs, as far as pnn from rank_tpu.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from rank_tpu.features import WECHAT_SCHEMA as JAX_WECHAT_SCHEMA
from rank_tpu.models import ModelConfig as JaxModelConfig
from rank_tpu.parallel.mesh import make_mesh
from rank_tpu.train import TrainConfig as JaxTrainConfig
from rank_tpu.train import Trainer as JaxTrainer
from rank_tpu.train.staged import StagedRunner as JaxStagedRunner
from rank_tpu.train.staged import unpack_columns
from rank_tpu_torch import WECHAT_SCHEMA, parity
from rank_tpu_torch.data.loader import num_rows
from rank_tpu_torch.interop import state_dict_from_flax
from rank_tpu_torch.models.base import jax_fields
from rank_tpu_torch.train import Trainer
from torch_jax_carry import JaxOrderRunner, load_jax_state

SMALL_SCALE = 0.005
MTL_ROWS = 12_000
EPOCHS = 2
SEED = 42
CASES = ("dcn", "mmoe")
# the largest gaps measured between the two runs at seeds 42-44 (see the
# module's doc): {case: (eval AUC of any head, eval loss, parameter
# (relative norm), BatchNorm statistic (absolute; None: the model has none))}
MEASURED = {
    "dcn": (1.06e-4, 4.49e-6, 2.39e-3, None),
    "mmoe": (1.86e-4, 1.84e-4, 2.42e-2, None),
}
FACTOR = 4.0


@pytest.fixture(scope="module")
def logs(tmp_path_factory):
    return {"dcn": parity.calibrated_data(SMALL_SCALE, str(tmp_path_factory.mktemp("calibrated"))),
            "mmoe": parity.mtl_data(MTL_ROWS)}


def configs(case):
    if case == "mmoe":
        return parity.mtl_config("mmoe", "sum", SEED)
    return parity.calib_config(case, SEED)


def whole_runs(case, data):
    """rank_tpu's run and the port's from its initial state on its order;
    returns both final states' tensors under the port's names, both evals
    and, for epoch 1, whether every batch of the two orders was equal."""
    model_cfg, train_cfg = configs(case)
    bs = train_cfg.batch_size
    jtrainer = JaxTrainer(JAX_WECHAT_SCHEMA, JaxModelConfig(**jax_fields(model_cfg)),
                          JaxTrainConfig(**dataclasses.asdict(train_cfg)), mesh=make_mesh(1))
    jrunner = JaxStagedRunner(jtrainer, data.train, data.eval, bs)
    jstate = jrunner.init_state()
    host0 = jax.device_get(jstate)

    trainer = Trainer(WECHAT_SCHEMA, model_cfg, train_cfg, device="cpu")
    runner = JaxOrderRunner(trainer, data.train, data.eval, bs)
    state = trainer.init_state()
    load_jax_state(trainer, state, host0)

    # epoch 1's batches: rank_tpu's shuffled matrix, step by step, against
    # the port's rows in the carried order
    jrunner._build()
    shuffled3 = jrunner._shuffle_fn(jrunner.train_staged, SEED + 1)
    mine = runner.shuffled(1, SEED)
    bpd = bs // shuffled3.shape[0]
    same_order = True
    for i in range(runner.train_steps):
        rows = np.asarray(shuffled3[:, i * bpd:(i + 1) * bpd]).reshape(bs, -1)
        theirs = jax.device_get(unpack_columns(rows, jrunner.train_specs))
        same_order &= all(np.array_equal(theirs[k], mine[k][i * bs:(i + 1) * bs].numpy())
                          for k in theirs)

    for epoch in range(1, EPOCHS + 1):
        jstate, _ = jrunner.train_epoch(jstate, epoch, SEED)
        state, _ = runner.train_epoch(state, epoch, SEED)
    jev, ev = jrunner.evaluate(jstate, EPOCHS), runner.evaluate(state, EPOCHS)
    host = jax.device_get(jstate)
    want = state_dict_from_flax(state["model"], {"params": host["params"], **host["extra"]})
    return want, state, jev, ev, same_order


def gaps(want, state, jev, ev):
    """(eval AUC, eval loss, parameter, BatchNorm statistic) gaps; the
    last is None for a model without BatchNorm."""
    params = dict(state["model"].named_parameters())
    pgap, bgap = 0.0, None
    for key, value in state["model"].state_dict().items():
        if key.endswith("num_batches_tracked"):
            continue
        a, b = value.detach().numpy().astype(np.float64), want[key].numpy().astype(np.float64)
        if key in params:
            pgap = max(pgap, float(np.linalg.norm(a - b) / np.linalg.norm(b)))
        else:
            bgap = max(bgap or 0.0, float(np.max(np.abs(a - b))))
    aucs = [abs(ev["task_aucs"][k] - jev["task_aucs"][k]) for k in jev["task_aucs"]]
    return max(aucs), abs(ev["loss"] - jev["loss"]), pgap, bgap


@pytest.mark.parametrize("case", CASES)
def test_whole_run_matches_jax_from_its_start_on_its_order(case, logs):
    """2 staged epochs of rank_tpu and of the port, the port from
    rank_tpu's initial state on rank_tpu's epoch order: the order carried
    is rank_tpu's batch for batch, the padded rows are in it, and the eval
    AUC of every head, the eval loss, every parameter and every BatchNorm
    statistic end within ``FACTOR`` times the measured gap."""
    data = logs[case]
    bs = configs(case)[1].batch_size
    assert num_rows(data.train) % bs, "the train split must leave padded rows"
    want, state, jev, ev, same_order = whole_runs(case, data)
    assert same_order
    assert state["step"] == EPOCHS * -(-num_rows(data.train) // bs)
    got = gaps(want, state, jev, ev)
    for name, gap, measured in zip(("eval AUC", "eval loss", "parameter", "BatchNorm"),
                                   got, MEASURED[case]):
        if measured is None:
            assert gap is None, f"{case} has {name} statistics"
            continue
        assert gap <= FACTOR * measured, f"{case}: {name} gap {gap:.3g} past {FACTOR} x {measured:.3g}"
    assert torch.isfinite(torch.tensor(ev["loss"]))
