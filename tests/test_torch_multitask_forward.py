"""The port's multi-task models (ESMM, MMOE, PLE; under sum and uncertainty
weighting) held against the JAX package on the CPU, forward and served.

  * forward: the same weights (the JAX package's variables, carried over by
    ``interop.state_dict_from_flax`` with random non-trivial biases and
    uncertainty weights) and the same numpy inputs made from a seed, at the
    tiny schema and at full ``WECHAT_SCHEMA`` width; logits to 1e-4,
    probabilities to 1e-5 (the bars of ``tests/test_forward_parity.py``);
  * ``Predictor`` heads against the JAX ``Predictor(variables=...)``.

``tests/test_torch_multitask.py`` holds the rest of the multi-task slice and
imports ``TINY``, ``TOL`` and ``_jax_model_and_variables`` from here.
"""

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rank_tpu.features import WECHAT_SCHEMA as JAX_WECHAT
from rank_tpu.features import tiny_schema as jax_tiny_schema
from rank_tpu.models import build_model as jax_build_model
from rank_tpu.models import default_config as jax_default_config
from rank_tpu.serve import Predictor as JaxPredictor
from rank_tpu_torch import WECHAT_SCHEMA, Predictor, build_model, default_config, tiny_schema
from rank_tpu_torch.data.synthetic import make_synthetic_dataset
from rank_tpu_torch.interop import state_dict_from_flax
from test_torch_zoo_forward import _randomize, _sigmoid

LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)
TOL = dict(rtol=1e-5, atol=1e-5)  # probabilities, and the mtl functions
# narrow experts and towers for the tiny schema; every structure stays
TINY = dict(expert_units=(16, 8), tower_units=(8,))
MODELS = {
    "mmoe": {},
    "ple1": dict(num_levels=1),
    "ple2": dict(num_levels=2),
    "ple3": dict(num_levels=3),
    "esmm": {},
}


def _jax_model_and_variables(name, overrides, jax_schema, data, seed=0):
    jax_model = jax_build_model(jax_schema, jax_default_config(name, **overrides))
    rngs = {"params": jax.random.PRNGKey(seed), "dropout": jax.random.PRNGKey(1)}
    batch = {k: jnp.asarray(v[:2]) for k, v in data.items()}
    variables = nn.meta.unbox(jax.jit(lambda r, b: jax_model.init(r, b, train=False))(rngs, batch))
    rng = np.random.default_rng(seed)
    variables = _randomize(jax.tree_util.tree_map(np.asarray, dict(variables)), rng)
    params = variables["params"]
    for key in params:  # non-zero uncertainty weights, so each does work
        if key.startswith("task_log_var_"):
            params[key] = np.asarray(rng.normal(0.0, 0.5), np.float32)
    return jax_model, variables


def _schemas(width):
    return (jax_tiny_schema(), tiny_schema()) if width == "tiny" else (JAX_WECHAT, WECHAT_SCHEMA)


def _overrides(key, width, weighting):
    name = key[:3] if key.startswith("ple") else key
    return name, {**(TINY if width == "tiny" else {}), **MODELS[key], "task_weighting": weighting}


# -- forward --------------------------------------------------------------------


@pytest.mark.parametrize("weighting", ["sum", "uncertainty"])
@pytest.mark.parametrize("width", ["tiny", "full"])
@pytest.mark.parametrize("key", sorted(MODELS))
def test_forward_matches_jax(key, width, weighting):
    name, overrides = _overrides(key, width, weighting)
    jax_schema, schema = _schemas(width)
    rows = 32
    data = make_synthetic_dataset(schema, num_rows=rows, seed=0)
    jax_model, variables = _jax_model_and_variables(name, overrides, jax_schema, data)
    want = jax.jit(lambda v, b: jax_model.apply(v, b, train=False))(
        variables, {k: jnp.asarray(v) for k, v in data.items()})

    model = build_model(schema, default_config(name, **overrides), device="cpu")
    state_dict = state_dict_from_flax(model, variables)  # raises unless every key maps
    model.load_state_dict(state_dict)
    with torch.no_grad():
        got = model.eval()({k: torch.from_numpy(v) for k, v in data.items()})
    assert float(got["aux_loss"]) == float(want["aux_loss"]) == 0.0
    if name == "esmm":
        assert sorted(got["probs"]) == ["ctcvr", "ctr"] and "logits" not in got
        for head in ("ctr", "ctcvr"):
            np.testing.assert_allclose(got["probs"][head].numpy(), np.asarray(want["probs"][head]),
                                       **TOL, err_msg=head)
        return
    tasks = default_config(name).tasks
    assert list(got["logits"]) == list(tasks)
    for task in tasks:
        logit, want_logit = got["logits"][task].numpy(), np.asarray(want["logits"][task])
        assert logit.shape == (rows,) and logit.dtype == np.float32
        np.testing.assert_allclose(logit, want_logit, **LOGIT_TOL, err_msg=task)
        np.testing.assert_allclose(_sigmoid(logit), _sigmoid(want_logit), **TOL)
    # the uncertainty weights: scalar parameters on the model root, mapped by
    # interop's rule for any other parameter
    log_var_keys = sorted(k for k in state_dict if k.startswith("task_log_var_"))
    assert log_var_keys == (sorted(f"task_log_var_{t}" for t in tasks)
                            if weighting == "uncertainty" else [])
    assert sorted(got["task_log_vars"]) == sorted(want["task_log_vars"])
    for task, s in got["task_log_vars"].items():
        assert s.shape == () and float(s.detach()) == float(want["task_log_vars"][task]) != 0.0


# -- serving ----------------------------------------------------------------------


@pytest.mark.parametrize("key", ["mmoe", "ple2", "esmm"])
def test_predictor_heads_match_jax(key):
    """Requests of 1 and 300 rows (buckets 256 and 512): every head."""
    name, overrides = _overrides(key, "tiny", "sum")
    data = make_synthetic_dataset(tiny_schema(), num_rows=300, seed=4)
    _, variables = _jax_model_and_variables(name, overrides, jax_tiny_schema(), data, seed=4)
    jax_pred = JaxPredictor(jax_tiny_schema(), jax_default_config(name, **overrides),
                            variables=variables)
    cfg = default_config(name, **overrides)
    state_dict = state_dict_from_flax(build_model(tiny_schema(), cfg, device="cpu"), variables)
    pred = Predictor(tiny_schema(), cfg, state_dict=state_dict, device="cpu")
    heads = ["ctcvr", "ctr"] if name == "esmm" else sorted(cfg.tasks)
    for n in (1, 300):
        request = {k: v[:n] for k, v in data.items() if k != "labels"}
        got, want = pred(request), jax_pred(request)
        assert sorted(got) == sorted(want) == heads
        for head in heads:
            assert got[head].shape == (n,) and got[head].dtype == np.float32
            np.testing.assert_allclose(got[head], want[head], **TOL, err_msg=head)
