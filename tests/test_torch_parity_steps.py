"""The flag procedure's long check (``ROADMAP.md`` C4): rank_tpu's
``Trainer`` and the port's over ``LONG_STEPS`` Adam steps of the quality
matrices' configs at full width, JAX's state carried into the port before
every step (``test_long_training_matches_jax_step_by_step``). Kept apart
from ``test_torch_parity.py``: it is the heavier file's half.
"""

import dataclasses

import jax
import numpy as np
import pytest

from rank_tpu.features import WECHAT_SCHEMA as JAX_WECHAT_SCHEMA
from rank_tpu.models import ModelConfig as JaxModelConfig
from rank_tpu.train import TrainConfig as JaxTrainConfig
from rank_tpu.train import Trainer as JaxTrainer
from rank_tpu_torch import WECHAT_SCHEMA, parity
from rank_tpu_torch.data.loader import ArrayLoader
from rank_tpu_torch.interop import state_dict_from_flax
from rank_tpu_torch.models.base import jax_fields
from rank_tpu_torch.train import Trainer
from torch_jax_carry import load_jax_state

SMALL_SCALE = 0.005


LONG_STEPS = 50
LONG_BATCH = 256
LR = parity.TrainConfig().learning_rate


@pytest.fixture(scope="module")
def small_log(tmp_path_factory):
    return parity.calibrated_data(SMALL_SCALE, str(tmp_path_factory.mktemp("calibrated")))


def adam_response_bar(p, g, mu, nu, count, gtol):
    """Elementwise bar on a parameter after one Adam step (optax's and
    torch's formula, lr * m_hat / (sqrt(v_hat) + eps)) whose gradient may
    differ by ``gtol``: rtol 1e-4 / atol 1e-5 on the parameter, plus the
    update's first-order response to the gradient's error through m_hat
    and v_hat. Where sqrt(v_hat) is near eps (gradients at the rounding
    level all along) the response is large: the update there is Adam's
    normalisation of rounding noise, in both frameworks."""
    b1, b2, eps = 0.9, 0.999, 1e-8
    c1, c2 = (1 - b1) / (1 - b1 ** count), (1 - b2) / (1 - b2 ** count)
    m_hat, s = mu / (1 - b1 ** count), np.sqrt(nu / (1 - b2 ** count))
    through_m = c1 / (s + eps)
    with np.errstate(divide="ignore", invalid="ignore"):
        through_v = np.where(s > 0, np.abs(m_hat) * c2 * np.abs(g) / (s * (s + eps) ** 2), 0.0)
    return 1e-5 + 1e-4 * np.abs(p) + LR * gtol * (through_m + through_v)


@pytest.mark.parametrize("model,weighting", [("pnn", None), ("widedeep", None),
                                             ("mmoe", "sum")])
def test_long_training_matches_jax_step_by_step(model, weighting, small_log):
    """rank_tpu's ``Trainer`` takes
    ``LONG_STEPS`` Adam steps on batches of the small log under the
    matrix's config at full width and dropout 0. Before each step its
    state (parameters, BatchNorm statistics, Adam's moments and count) is
    carried into the port, which takes the same step on the same batch.
    At every step the loss (rtol 1e-4), every gradient and every BatchNorm
    statistic after the step (rtol 1e-4 / atol 1e-5) must equal JAX's, and
    every parameter after the step must lie within ``adam_response_bar``
    of JAX's. Step by step, because two free-running trajectories part at
    the rounding level within a few Adam steps: the port's from JAX's as
    far as the port's from itself with its weights nudged by 1e-6
    (``python tests/torch_parity_drift.py``)."""
    if weighting is None:
        model_cfg, train_cfg = parity.calib_config(model, 42, LONG_BATCH)
    else:
        model_cfg, train_cfg = parity.mtl_config(model, weighting, 42, LONG_BATCH)
    model_cfg = model_cfg.replace(dropout_rate=0.0)
    batches = list(ArrayLoader(small_log.train, LONG_BATCH, shuffle=True, seed=5))[:LONG_STEPS]
    assert len(batches) == LONG_STEPS

    jtrainer = JaxTrainer(JAX_WECHAT_SCHEMA, JaxModelConfig(**jax_fields(model_cfg)),
                          JaxTrainConfig(**dataclasses.asdict(train_cfg)))
    jstate = jtrainer.init_state(batches[0])
    jstep = jtrainer._get_compiled("train")
    jgrad = jax.jit(lambda params, extra, batch, rng: jax.value_and_grad(
        jtrainer.loss_fn, has_aux=True)(params, extra, batch, rng, True))
    trainer = Trainer(WECHAT_SCHEMA, model_cfg, train_cfg, device="cpu")
    state = trainer.init_state()
    model_ = state["model"]
    tol = dict(rtol=1e-4, atol=1e-5)
    for k, batch in enumerate(batches):
        load_jax_state(trainer, state, jax.device_get(jstate))
        meters = trainer.meters_init()
        trainer.train_step(state, meters, trainer.to_device(batch))
        jbatch = jtrainer._host_to_device(batch)
        (jloss, _), jgrads = jgrad(jstate["params"], jstate["extra"], jbatch,
                                   jax.random.split(jstate["rng"])[0])
        jstate, _ = jstep(jstate, jtrainer.meters_init(), jbatch)
        np.testing.assert_allclose(float(meters["loss"]), float(jloss), rtol=1e-4,
                                   err_msg=f"loss at step {k + 1}")
        host = jax.device_get(jstate)
        extra = host["extra"]
        want = state_dict_from_flax(model_, {"params": host["params"], **extra})
        want_grads = state_dict_from_flax(model_, {"params": jax.device_get(jgrads), **extra})
        adam = host["opt_state"][0]
        mu = state_dict_from_flax(model_, {"params": adam.mu, **extra})
        nu = state_dict_from_flax(model_, {"params": adam.nu, **extra})
        params = dict(model_.named_parameters())
        for key, value in model_.state_dict().items():
            if key.endswith("num_batches_tracked"):
                continue
            if key not in params:  # BatchNorm statistics
                np.testing.assert_allclose(value.numpy(), want[key].numpy(), **tol,
                                           err_msg=f"{key} after step {k + 1}")
                continue
            g = want_grads[key].numpy()
            np.testing.assert_allclose(params[key].grad.numpy(), g, **tol,
                                       err_msg=f"gradient of {key} at step {k + 1}")
            bar = adam_response_bar(want[key].numpy(), g, mu[key].numpy(), nu[key].numpy(),
                                    int(adam.count), 1e-5 + 1e-4 * np.abs(g))
            gap = np.abs(value.numpy() - want[key].numpy())
            assert (gap <= bar).all(), (f"{key} after step {k + 1}: {int((gap > bar).sum())} "
                                        f"elements past the bar, worst gap {gap.max():.3g}")
    assert state["step"] == LONG_STEPS and int(jax.device_get(jstate["step"])) == LONG_STEPS
