"""The port's table-sharded, data-parallel Trainer held against JAX's on a
mesh: the counterparts of ``tests/test_sharding.py:42-250``.

The port runs 4 gloo ranks on the CPU, a (2 x 2) mesh (d = 2 data ranks,
t = 2 table shards; ``tests/torch_ranks.py``, spawned once for the
module); JAX runs the same cases on 4 of conftest's virtual CPU devices
(``make_mesh(num_devices=4, table_parallelism=2)``). Both start from the
JAX init (carried over in the checkpoint normal form) and take the same
three global batches of ``tiny_schema(vocab=65)``, whose odd vocab is
padded to 66: DCN, DIN (Dice and BatchNorm on the global batch) under
each embedding mode, DCN with global-norm clipping, MMOE under GradNorm
and DCN over a padded last batch whose data shards hold unequal valid
counts. Losses over the 3 steps agree to rtol 2e-4 / atol 2e-5 (JAX's own
bar, sharded against replicated); parameters after 3 Adam steps to rtol
1e-4 / atol 1e-5, the port's bar, but DIN's ``attention.b3``, whose
gradient is rounding noise that Adam turns into steps of +-lr (see
``test_torch_train.check_train_step_parity``). DCN also runs on one rank
(t = 1), and the checkpoint normal form restores into ``Predictor``, a
t = 2 resume and a t = 1 run.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

import torch_ranks
from rank_tpu.data.loader import ArrayLoader as JaxArrayLoader
from rank_tpu.features import tiny_schema as jax_tiny_schema
from rank_tpu.models import default_config as jax_default_config
from rank_tpu.parallel.mesh import make_mesh as jax_make_mesh
from rank_tpu.train import TrainConfig as JaxTrainConfig
from rank_tpu.train import Trainer as JaxTrainer
from rank_tpu_torch import Predictor, build_model, default_config, tiny_schema
from rank_tpu_torch.cli import _restore_normal_form
from rank_tpu_torch.data.synthetic import make_synthetic_dataset
from rank_tpu_torch.interop import state_dict_from_flax
from rank_tpu_torch.parallel import Mesh, make_mesh
from rank_tpu_torch.train import CheckpointManager, TrainConfig, Trainer

LOSS_TOL = dict(rtol=2e-4, atol=2e-5)
PARAM_TOL = dict(rtol=1e-4, atol=1e-5)
LR = 0.005
WORLD, T = 4, 2
VOCAB, HIST, BS = 65, 8, 64
DCN = dict(hidden_units=(16, 8), num_cross_layers=2)
DIN = dict(hidden_units=(16, 8), dropout_rate=0.0)
CASES = {
    "dcn": ("dcn", DCN, {}, 192),
    "din_gspmd": ("din", {**DIN, "embedding_mode": "gspmd"}, {}, 192),
    "din_psum": ("din", {**DIN, "embedding_mode": "psum"}, {}, 192),
    "din_alltoall": ("din", {**DIN, "embedding_mode": "alltoall"}, {}, 192),
    "dcn_clip": ("dcn", DCN, {"gradient_clip_norm": 0.05}, 192),
    "mmoe_gradnorm": ("mmoe", dict(expert_units=(16, 8), tower_units=(8,),
                                   task_weighting="gradnorm"), {}, 192),
    # 170 rows: the last batch holds 42 valid rows, 32 on data rank 0, 10 on 1
    "dcn_padded": ("dcn", DCN, {}, 170),
}
NOISE = {"attention.b3": 3 * LR}


def _batches(rows):
    data = make_synthetic_dataset(tiny_schema(vocab=VOCAB, hist_len=HIST), num_rows=rows, seed=2)
    return list(JaxArrayLoader(data, BS, drop_remainder=False))


def _normal_form(model_cfg, variables):
    """flax variables of padded tables -> the port's normal-form state dict
    (tables sliced back to the caller-schema vocab)."""
    schema = tiny_schema(vocab=VOCAB, hist_len=HIST)
    padded, _ = schema.padded_for_table_sharding(T, min_rows=16)
    sd = state_dict_from_flax(build_model(padded, model_cfg, device="cpu"), variables)
    ref = build_model(schema, model_cfg, device="cpu").state_dict()
    return {k: v[: ref[k].shape[0]].numpy() if v.dim() else v.numpy() for k, v in sd.items()}


def _variables(state):
    state = jax.device_get(state)
    return {"params": state["params"], **state["extra"]}


def _jax_case(name):
    model, overrides, train, rows = CASES[name]
    batches = _batches(rows)
    trainer = JaxTrainer(
        jax_tiny_schema(vocab=VOCAB, hist_len=HIST), jax_default_config(model, **overrides),
        JaxTrainConfig(batch_size=BS, log_every=0, table_parallelism=T, min_rows_to_shard=16,
                       learning_rate=LR, **train),
        mesh=jax_make_mesh(num_devices=WORLD, table_parallelism=T),
    )
    state = trainer.init_state(batches[0])
    cfg = default_config(model, **overrides)
    init = _normal_form(cfg, _variables(state))
    step = trainer._get_compiled("train")
    losses = []
    for batch in batches:
        meters = trainer.meters_init()
        state, meters = step(state, meters, trainer._host_to_device(batch))
        losses.append(float(meters["loss"]))
    result = {"losses": losses, "model": _normal_form(cfg, _variables(state)),
              "decisions": trainer.shard_decisions, "table_padding": trainer.table_padding,
              "sharded_table_names": trainer.sharded_table_names}
    if "mtl" in state:
        result["mtl"] = jax.device_get(state["mtl"])
    case = dict(model=model, overrides=overrides, train=dict(learning_rate=LR, **train),
                vocab=VOCAB, hist_len=HIST, batch_size=BS, batches=batches, init=init)
    return case, result


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    workdir = tmp_path_factory.mktemp("sharding")
    cases, jax_results = {}, {}
    for name in CASES:
        cases[name], jax_results[name] = _jax_case(name)
    torch_ranks.save(workdir, "cases.pkl", {"table_parallelism": T, "cases": cases})
    torch_ranks.spawn(torch_ranks.trainer_rank, WORLD, workdir)
    port = torch_ranks.load(workdir, "trainer_results.pkl")
    return workdir, cases, jax_results, port


def _assert_params(got, want, err):
    assert set(got) == set(want)
    for key, value in want.items():
        if key.endswith("num_batches_tracked"):
            continue
        tol = dict(rtol=0, atol=NOISE[key]) if key in NOISE else PARAM_TOL
        np.testing.assert_allclose(got[key], value, **tol, err_msg=f"{key} {err}")


@pytest.mark.parametrize("name", list(CASES))
def test_losses_match_jax(runs, name):
    _, _, jax_results, port = runs
    np.testing.assert_allclose(port["cases"][name]["losses"], jax_results[name]["losses"],
                               **LOSS_TOL)


@pytest.mark.parametrize("name", list(CASES))
def test_params_after_3_steps_match_jax(runs, name):
    _, _, jax_results, port = runs
    _assert_params(port["cases"][name]["model"], jax_results[name]["model"], name)


def _one_rank(case):
    """The case on one rank (t = 1), from the same weights and batches."""
    trainer = torch_ranks._trainer(case, make_mesh(device="cpu"))
    return torch_ranks.train_case(trainer, case, trainer.mesh)


@pytest.mark.parametrize("name", ["dcn", "din_psum"])
def test_table_sharded_matches_one_rank(runs, name):
    _, cases, _, port = runs
    want, _ = _one_rank(cases[name])
    got = port["cases"][name]
    np.testing.assert_allclose(got["losses"], want["losses"], **LOSS_TOL)
    _assert_params(got["model"], want["model"], "t=2 against t=1")


@pytest.mark.parametrize("name", ["dcn", "din_alltoall", "mmoe_gradnorm"])
def test_shard_decisions_match_jax(runs, name):
    _, _, jax_results, port = runs
    got, want = port["cases"][name], jax_results[name]
    assert got["decisions"] == want["decisions"]
    assert got["sharded_table_names"] == tuple(want["sharded_table_names"])
    assert any("table_device" in r and "(3, 2)" in r for r in got["decisions"]["replicated"])
    assert all("table_device" not in r for r in got["decisions"]["sharded"])


def test_odd_vocab_padded_to_table_multiple(runs):
    _, _, jax_results, port = runs
    got = port["cases"]["dcn"]
    assert got["table_padding"] == jax_results["dcn"]["table_padding"]
    assert got["table_padding"]["userid"] == (65, 66)
    assert any("['table_userid']['embedding'](66, 16)" in r for r in got["decisions"]["sharded"])
    # the normal form holds the caller's 65 rows
    assert got["model"]["tables.table_userid.weight"].shape == (65, 16)


def test_gradnorm_state_matches_jax(runs):
    _, _, jax_results, port = runs
    got, want = port["cases"]["mmoe_gradnorm"]["mtl"], jax_results["mmoe_gradnorm"]["mtl"]
    for key in ("w", "l0"):
        np.testing.assert_allclose(got[key], np.asarray(want[key]), **PARAM_TOL)
    np.testing.assert_allclose(got["w"].sum(), 3.0, rtol=1e-6)


def test_padded_batch_splits_unequal_valid_counts(runs):
    _, cases, _, _ = runs
    last = cases["dcn_padded"]["batches"][-1]["_valid"]
    assert (last[:32].sum(), last[32:].sum()) == (32, 10)


def test_clipping_bites(runs):
    """At a 0.05 norm the clipped run trains away from the unclipped one."""
    _, _, jax_results, port = runs
    assert not np.allclose(port["cases"]["dcn_clip"]["losses"][1:],
                           port["cases"]["dcn"]["losses"][1:], **LOSS_TOL)


def test_checkpoint_on_disk_is_the_normal_form(runs):
    workdir, _, _, port = runs
    mgr = CheckpointManager(str(workdir / "normal"))
    assert mgr.has_best() and mgr.latest_epoch() == 1
    best = mgr.load_best_state_dict("cpu")
    assert best["tables.table_userid.weight"].shape == (65, 16)
    payload = mgr.load_epoch(1, "cpu")
    rows = {tuple(m["exp_avg"].shape) for m in payload["optimizer"]["state"].values()}
    assert (65, 16) in rows and not any(r[0] == 66 for r in rows)
    assert len(payload["rng_by_data_index"]) == 2
    np.testing.assert_array_equal(best["tables.table_userid.weight"].numpy(),
                                  port["cases"]["dcn"]["model"]["tables.table_userid.weight"])


def test_predictor_serves_the_normal_form(runs):
    workdir, cases, _, port = runs
    case = cases["dcn"]
    schema, cfg = tiny_schema(vocab=VOCAB, hist_len=HIST), default_config("dcn", **DCN)
    request = {k: v for k, v in case["batches"][0].items() if k not in ("labels", "_valid")}
    got = Predictor(schema, cfg, model_dir=str(workdir / "normal"), device="cpu")(request)
    state_dict = {k: torch.from_numpy(v) for k, v in port["cases"]["dcn"]["model"].items()}
    want = Predictor(schema, cfg, state_dict=state_dict, device="cpu")(request)
    assert got["score"].shape == (BS,) and np.isfinite(got["score"]).all()
    np.testing.assert_array_equal(got["score"], want["score"])


def test_same_parallelism_resume_restores(runs):
    _, _, _, port = runs
    restored = port["restored"]["epoch"]
    assert restored["max_diff"] == 0.0 and restored["step"] == 3
    assert restored["printed"] == ""
    assert np.isfinite(restored["next_loss"])


def test_one_rank_run_restores_a_sharded_checkpoint(runs):
    workdir, cases, _, port = runs
    case = cases["dcn"]
    trainer = torch_ranks._trainer(case, make_mesh(device="cpu"))
    assert not trainer.table_padding
    state = trainer.init_state()
    mgr = CheckpointManager(str(workdir / "normal"))
    state = _restore_normal_form(trainer, state, "checkpoint_epoch_1",
                                 lambda: mgr.load_epoch(1, "cpu"))
    assert state["step"] == 3
    got = trainer.depad_state(state)["model"]
    for key, value in port["cases"]["dcn"]["model"].items():
        np.testing.assert_array_equal(got[key].numpy(), value, err_msg=key)
    meters = trainer.meters_init()
    trainer.train_step(state, meters, trainer.to_device(case["batches"][0]))
    assert np.isfinite(float(meters["loss"]))


def test_legacy_padded_checkpoint_names_the_format_change(runs):
    """A checkpoint whose tables hold the mesh's padded rows is not the
    normal form: the restore says so, retries it as padded, and restores
    it under the same table parallelism (``rank_tpu/cli.py:197-220``)."""
    workdir, _, _, port = runs
    legacy = port["restored"]["legacy"]
    assert "padded template" in legacy["printed"] and "normal form" in legacy["printed"]
    assert legacy["max_diff"] == 0.0
    best = CheckpointManager(str(workdir / "legacy")).load_best_state_dict("cpu")
    assert best["tables.table_userid.weight"].shape == (66, 16)


def _fake_mesh(t):
    """A mesh's shape, for the checks a Trainer makes before any collective."""
    return Mesh(world_size=t, shape={"data": 1, "table": t})


def test_padded_feature_suffix_collision_raises():
    schema = tiny_schema(vocab=VOCAB)
    userid = schema.categorical_feature("userid")
    extra = dataclasses.replace(userid, name="x_userid", vocab_size=66)
    schema = dataclasses.replace(schema, categorical=schema.categorical + (extra,))
    with pytest.raises(ValueError, match="suffix"):
        Trainer(schema, default_config("dcn"), TrainConfig(min_rows_to_shard=16), device="cpu",
                mesh=_fake_mesh(2))


def test_table_parallelism_needs_the_ranks():
    """Without a process group the world is one rank: t = 2 does not divide
    it, as JAX's ``make_mesh`` refuses too many table shards."""
    with pytest.raises(ValueError, match="not divisible by table_parallelism=2"):
        make_mesh(table_parallelism=2, device="cpu")
    with pytest.raises(ValueError, match="not divisible by table_parallelism=2"):
        Trainer(tiny_schema(), default_config("dcn"), TrainConfig(table_parallelism=2),
                device="cpu")
    with pytest.raises(ValueError, match="one process per device"):
        make_mesh(num_devices=4, device="cpu")
