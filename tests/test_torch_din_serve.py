"""The port's DIN serving slice (rank_tpu_torch) held against the JAX package.

Both sides get the same weights (the JAX package's variables, carried over
by ``interop.state_dict_from_flax``, with random non-trivial BatchNorm
statistics and Dice alphas) and the same synthetic requests. The JAX side
runs its Pallas DIN-attention kernel in interpret mode. Probabilities must
agree to 1e-5 and logits to 1e-4 (the bar of tests/test_forward_parity.py).
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rank_tpu.data.synthetic import make_synthetic_dataset as jax_synthetic
from rank_tpu.features import WECHAT_SCHEMA as JAX_WECHAT
from rank_tpu.features import tiny_schema as jax_tiny_schema
from rank_tpu.models import build_model as jax_build_model
from rank_tpu.models import default_config as jax_default_config
from rank_tpu.ops.mlp import MLPTower as JaxMLPTower
from rank_tpu.ops.pallas import din_attention as pk
from rank_tpu.serve import Predictor as JaxPredictor
from rank_tpu_torch import WECHAT_SCHEMA, Predictor, build_model, default_config, tiny_schema
from rank_tpu_torch.data.synthetic import make_synthetic_dataset
from rank_tpu_torch.embedding.collection import table_specs
from rank_tpu_torch.interop import state_dict_from_flax
from rank_tpu_torch.ops.mlp import MLPTower

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True)
def interpret_mode(monkeypatch):
    monkeypatch.setattr(pk, "_INTERPRET", True)


def _randomize_stats(tree, rng):
    """Random non-trivial BatchNorm statistics and scales, Dice alphas and
    biases, so eval-mode BatchNorm and Dice do real work on both sides."""
    out = {}
    for key, value in tree.items():
        if isinstance(value, dict):
            out[key] = _randomize_stats(value, rng)
            continue
        value = np.asarray(value)
        if key == "var":
            value = rng.uniform(0.5, 2.0, value.shape)
        elif key == "scale":
            value = rng.normal(1.0, 0.5, value.shape)
        elif key in ("mean", "alpha", "bias", "b1", "b2", "b3"):
            value = rng.normal(0.0, 0.5, value.shape)
        out[key] = np.asarray(value, np.float32)
    return out


def _jax_variables(jax_model, data, seed=0):
    batch = {k: jnp.asarray(v[:2]) for k, v in data.items()}
    rngs = {"params": jax.random.PRNGKey(seed), "dropout": jax.random.PRNGKey(1)}
    # one jitted init: eager init compiles every small op on its own
    variables = nn.meta.unbox(jax.jit(lambda r, b: jax_model.init(r, b, train=False))(rngs, batch))
    variables = jax.tree_util.tree_map(np.asarray, dict(variables))
    return _randomize_stats(variables, np.random.default_rng(seed))


def _serve_both(jax_schema, schema, overrides, rows, min_bucket, seed=0):
    data = make_synthetic_dataset(schema, num_rows=max(rows), seed=seed)
    # init traces the jnp attention (the same parameters, a cheaper trace)
    jax_model = jax_build_model(jax_schema, jax_default_config("din", **overrides))
    variables = _jax_variables(jax_model, data, seed)
    jax_cfg = jax_default_config("din", kernel_backend="pallas", **overrides)
    jax_pred = JaxPredictor(jax_schema, jax_cfg, variables=variables, min_bucket=min_bucket)

    cfg = default_config("din", **overrides)
    model = build_model(schema, cfg, device="cpu")
    state_dict = state_dict_from_flax(model, variables)
    pred = Predictor(schema, cfg, state_dict=state_dict, min_bucket=min_bucket, device="cpu")
    for n in rows:
        request = {k: v[:n] for k, v in data.items() if k != "labels"}
        want = jax_pred(request)["score"]
        got = pred(request)["score"]
        assert got.shape == (n,) and got.dtype == np.float32
        assert np.all(np.isfinite(got)) and np.all((got > 0) & (got < 1))
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    return jax_model, variables, pred, data


def test_tiny_predictor_matches_jax_predictor():
    """Requests of 1 and 300 rows: buckets 256 and 512."""
    overrides = dict(hidden_units=(32, 16))
    jax_model, variables, pred, data = _serve_both(
        jax_tiny_schema(), tiny_schema(), overrides, rows=(1, 300), min_bucket=256
    )
    # logits too, at the forward-parity bar
    batch = {k: v[:64] for k, v in data.items()}
    want = jax.jit(jax_model.apply)(
        variables, {k: jnp.asarray(v) for k, v in batch.items()}
    )["logits"]
    with torch.inference_mode():
        got = pred.model({k: torch.from_numpy(v) for k, v in batch.items()})["logits"]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)


def test_full_width_predictor_matches_jax_predictor():
    """WECHAT_SCHEMA at full width: tower 82 -> 512 -> 256 -> 128, T=50."""
    _serve_both(JAX_WECHAT, WECHAT_SCHEMA, {}, rows=(16,), min_bucket=16)


@pytest.mark.parametrize("order", ["bn_act", "act_bn"])
@pytest.mark.parametrize("activation", ["relu", "dice", "prelu", "leakyrelu"])
def test_mlp_tower_matches_jax(activation, order):
    rng = np.random.default_rng(3)
    x = rng.normal(size=(9, 12)).astype(np.float32)
    jtower = JaxMLPTower((8, 4), activation=activation, order=order)
    variables = nn.meta.unbox(jtower.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    variables = _randomize_stats(jax.tree_util.tree_map(np.asarray, dict(variables)), rng)
    want = np.asarray(jtower.apply(variables, jnp.asarray(x)))

    tower = MLPTower(12, (8, 4), activation=activation, order=order)
    tower.load_state_dict(state_dict_from_flax(tower, variables))
    tower.eval()
    with torch.no_grad():
        got = tower(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("which", ["tiny", "wechat"])
def test_synthetic_is_byte_identical(which):
    if which == "tiny":
        want = jax_synthetic(jax_tiny_schema(), num_rows=50, seed=7)
        got = make_synthetic_dataset(tiny_schema(), num_rows=50, seed=7)
    else:
        want = jax_synthetic(JAX_WECHAT, num_rows=20, seed=3)
        got = make_synthetic_dataset(WECHAT_SCHEMA, num_rows=20, seed=3)
    assert sorted(got) == sorted(want)
    for key in want:
        assert got[key].dtype == want[key].dtype, key
        assert got[key].tobytes() == want[key].tobytes(), key


def test_schema_and_tables_match_jax():
    from rank_tpu.embedding.collection import table_specs as jax_table_specs

    for jax_schema, schema in ((JAX_WECHAT, WECHAT_SCHEMA), (jax_tiny_schema(), tiny_schema())):
        assert repr(schema) == repr(jax_schema)
        assert table_specs(schema) == jax_table_specs(jax_schema)
    assert set(table_specs(WECHAT_SCHEMA)) == {
        "userid", "feedid", "device", "authorid", "bgm_song_id", "bgm_singer_id",
        "manual_tag_list",
    }


def test_config_defaults_match_jax():
    from rank_tpu.models.registry import DEFAULT_CONFIGS as JAX_DEFAULTS
    from rank_tpu_torch.models.registry import DEFAULT_CONFIGS

    assert sorted(DEFAULT_CONFIGS) == sorted(JAX_DEFAULTS)
    for name, cfg in JAX_DEFAULTS.items():
        assert repr(DEFAULT_CONFIGS[name]) == repr(cfg), name


def test_interop_raises_on_missing_and_leftover_keys():
    schema = tiny_schema()
    model = build_model(schema, default_config("din", hidden_units=(8,)), device="cpu")
    jax_model = jax_build_model(jax_tiny_schema(), jax_default_config("din", hidden_units=(8,)))
    variables = _jax_variables(jax_model, make_synthetic_dataset(schema, num_rows=2))
    state_dict_from_flax(model, variables)  # complete: no error

    missing = {**variables, "params": {k: v for k, v in variables["params"].items() if k != "output"}}
    with pytest.raises(KeyError, match="output"):
        state_dict_from_flax(model, missing)
    extra = {**variables, "params": {**variables["params"], "stray": {"kernel": np.zeros(2)}}}
    with pytest.raises(KeyError, match="stray"):
        state_dict_from_flax(model, extra)


def test_entry_points_raise_without_cuda(monkeypatch):
    """With no CUDA device, the default device raises: no silent CPU run."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    schema, cfg = tiny_schema(), default_config("din", hidden_units=(8,))
    with pytest.raises(RuntimeError, match="CUDA"):
        build_model(schema, cfg)
    state_dict = build_model(schema, cfg, device="cpu").state_dict()
    with pytest.raises(RuntimeError, match="CUDA"):
        Predictor(schema, cfg, state_dict=state_dict)


def test_unported_model_and_model_dir_raise(tmp_path):
    """A model asked for with a path not ported yet (the table-sharded
    ``psum`` embedding lookup) raises; ``model_dir`` serves the saved best
    model (it raised before the checkpoint port) and a directory without
    one raises."""
    from rank_tpu_torch.train import CheckpointManager

    with pytest.raises(NotImplementedError, match="not ported"):
        build_model(tiny_schema(), default_config("din", embedding_mode="psum"), device="cpu")
    schema, cfg = tiny_schema(), default_config("din", hidden_units=(8,))
    model = build_model(schema, cfg, device="cpu", generator=torch.Generator().manual_seed(3))
    CheckpointManager(str(tmp_path / "ckpt")).save_best({"model": model})
    request = {k: v for k, v in make_synthetic_dataset(schema, num_rows=5).items() if k != "labels"}
    got = Predictor(schema, cfg, model_dir=str(tmp_path / "ckpt"), device="cpu")(request)
    want = Predictor(schema, cfg, state_dict=model.state_dict(), device="cpu")(request)
    np.testing.assert_array_equal(got["score"], want["score"])
    with pytest.raises(FileNotFoundError, match="best_model"):
        Predictor(schema, cfg, model_dir=str(tmp_path / "empty"), device="cpu")
    assert not (tmp_path / "empty").exists()


def _imported_modules(path: Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_imports_nothing_of_jax():
    files = sorted((ROOT / "rank_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 10
    names = {str(p.relative_to(ROOT)) for p in files}
    assert {"rank_tpu_torch/native/__init__.py", "rank_tpu_torch/data/calibrated.py",
            "rank_tpu_torch/data/etl.py"} <= names
    for path in files:
        for module in _imported_modules(path):
            top = module.split(".")[0]
            assert top not in ("jax", "flax", "rank_tpu"), f"{path} imports {module}"

    code = (
        "import sys; before = set(sys.modules); "
        "import rank_tpu_torch, rank_tpu_torch.interop, rank_tpu_torch.ops.kernels.din_attention, "
        "rank_tpu_torch.cli, rank_tpu_torch.train.loop, rank_tpu_torch.ops.kernels.cin, "
        "rank_tpu_torch.ops.cross, rank_tpu_torch.ops.fm, rank_tpu_torch.ops.product, "
        "rank_tpu_torch.ops.senet, rank_tpu_torch.ops.autoint, rank_tpu_torch.ops.transformer, "
        "rank_tpu_torch.ops.rnn, rank_tpu_torch.models.fm_family, "
        "rank_tpu_torch.models.cross_family, rank_tpu_torch.models.sequence, "
        "rank_tpu_torch.models.multitask, rank_tpu_torch.train.mtl, rank_tpu_torch.serve, "
        "rank_tpu_torch.ops.kernels, rank_tpu_torch.native, rank_tpu_torch.data.encode, "
        "rank_tpu_torch.data.etl, rank_tpu_torch.data.calibrated, rank_tpu_torch.data.douban; "
        "new = {m.split('.')[0] for m in set(sys.modules) - before}; "
        "assert not new & {'jax', 'flax', 'rank_tpu'}, new"
    )
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(filter(None, [str(ROOT), env.get("PYTHONPATH")]))
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
