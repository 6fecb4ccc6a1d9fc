"""The port's multi-task slice (ESMM, MMOE, PLE; uncertainty, GradNorm and
PCGrad weighting) held against the JAX package on the CPU; the forward
and the ``Predictor`` heads are in ``tests/test_torch_multitask_forward.py``.

  * ``train/mtl.py`` against ``rank_tpu/train/mtl.py`` function by
    function. PCGrad's task orders come from JAX's PRNG there, which torch
    cannot reproduce: the port takes them as an input, and the test feeds it
    the orders JAX draws;
  * train-step parity (``test_torch_train.check_train_step_parity``): loss
    and every gradient at step 1, every parameter after 3 Adam steps, at
    rtol 1e-4 / atol 1e-5, and GradNorm's state after every step. PCGrad
    runs with 2 tasks there, where the order cannot matter;
  * the CLI on ``--device=cpu``: ESMM's export, GradNorm's resume, and the
    gradient strategies refused for models that cannot take them.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rank_tpu.features import tiny_schema as jax_tiny_schema
from rank_tpu.train import mtl as jmtl
from rank_tpu_torch import WECHAT_SCHEMA, Predictor, build_model, default_config, tiny_schema
from rank_tpu_torch.cli import main
from rank_tpu_torch.data.loader import split_train_test
from rank_tpu_torch.data.synthetic import make_synthetic_dataset
from rank_tpu_torch.interop import state_dict_from_flax
from rank_tpu_torch.train import CheckpointManager, TrainConfig, Trainer
from rank_tpu_torch.train import mtl
from test_torch_multitask_forward import TINY, TOL, _jax_model_and_variables
from test_torch_train import check_train_step_parity


def test_ple_levels_and_fan_in():
    """No shared gate at the last level; experts after level 0 read the
    ``expert_units[-1]``-wide mixtures."""
    cfg = default_config("ple", num_levels=3, **TINY)
    model = build_model(tiny_schema(), cfg, device="cpu")
    gates = sorted(n for n, _ in model.named_children() if "gate_shared" in n)
    assert gates == ["L0_gate_shared", "L1_gate_shared"]
    assert model.L1_t0_e0.Dense_0.in_features == model.L2_shared_e1.Dense_0.in_features == 8
    assert model.L0_t0_e0.Dense_0.in_features == model.input_width


# -- train/mtl.py -----------------------------------------------------------------


def _stacked(num_tasks, seed, conflicts=True):
    """Per-task gradients over three parameters, as numpy (T, *shape).
    With ``conflicts``, every pair of tasks has a negative dot product:
    the rows are the vertices of a regular simplex centred at 0 (pairwise
    dot -1/T), turned by a random rotation, plus a little noise."""
    rng = np.random.default_rng(seed)
    shapes = {"a": (4, 3), "b.weight": (5,), "c.bias": (2, 2, 2)}
    size = sum(int(np.prod(s)) for s in shapes.values())
    flat = rng.normal(size=(num_tasks, size))
    if conflicts:
        simplex = np.eye(num_tasks) - 1.0 / num_tasks
        rotation, _ = np.linalg.qr(rng.normal(size=(size, size)))
        flat = simplex @ rotation[:num_tasks] * 3.0 + 0.01 * flat
        gram = flat @ flat.T
        assert np.all(gram[~np.eye(num_tasks, dtype=bool)] < 0)
    out, start = {}, 0
    for name, shape in shapes.items():
        n = int(np.prod(shape))
        out[name] = flat[:, start:start + n].reshape((num_tasks,) + shape).astype(np.float32)
        start += n
    return out


def _torch(tree):
    return {k: torch.from_numpy(v) for k, v in tree.items()}


def _jax(tree):
    return {k: jnp.asarray(v) for k, v in tree.items()}


def test_gram_matrix_and_combine_match_jax():
    stacked = _stacked(3, seed=0, conflicts=False)
    np.testing.assert_allclose(mtl.gram_matrix(_torch(stacked)).numpy(),
                               np.asarray(jmtl.gram_matrix(_jax(stacked))), **TOL)
    weights = np.asarray([0.5, -1.25, 2.0], np.float32)
    got = mtl.combine_stacked(_torch(stacked), torch.from_numpy(weights))
    want = jmtl.combine_stacked(_jax(stacked), jnp.asarray(weights))
    assert list(got) == list(stacked)
    for key in stacked:
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), **TOL)


def _jax_orders(key, num_tasks):
    """The orders ``rank_tpu.train.mtl.pcgrad_weights`` draws from ``key``."""
    return np.stack([np.asarray(jax.random.permutation(jax.random.fold_in(key, i), num_tasks))
                     for i in range(num_tasks)])


@pytest.mark.parametrize("num_tasks", [2, 3, 4])
def test_pcgrad_weights_match_jax(num_tasks):
    """Every pair of tasks conflicts, so every projection fires; given the
    orders JAX draws, the port gives JAX's weights. For T >= 3 the orders
    matter: reversing them changes the weights."""
    stacked = _stacked(num_tasks, seed=num_tasks)
    gram = np.array(jmtl.gram_matrix(_jax(stacked)))
    key = jax.random.PRNGKey(7 + num_tasks)
    want = np.asarray(jmtl.pcgrad_weights(jnp.asarray(gram), key))
    orders = torch.from_numpy(_jax_orders(key, num_tasks))
    got = mtl.pcgrad_weights(torch.from_numpy(gram), orders).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert not np.allclose(want, np.ones(num_tasks))  # the surgery did work
    reversed_w = mtl.pcgrad_weights(torch.from_numpy(gram), orders.flip(1)).numpy()
    assert np.allclose(reversed_w, got) == (num_tasks == 2)


def test_pcgrad_orders_are_seeded_permutations():
    draw = lambda seed: mtl.pcgrad_orders(4, torch.Generator().manual_seed(seed))
    orders = draw(44)
    assert orders.shape == (4, 4) and orders.dtype == torch.int64
    for row in orders:
        assert sorted(row.tolist()) == [0, 1, 2, 3]
    assert torch.equal(orders, draw(44))
    generator = torch.Generator().manual_seed(44)
    mtl.pcgrad_orders(4, generator)
    assert not torch.equal(mtl.pcgrad_orders(4, generator), orders)  # a new draw each step


def test_shared_grad_norms_match_jax():
    stacked = _stacked(3, seed=5, conflicts=False)
    mask = {"a": True, "b.weight": False, "c.bias": True}
    got = mtl.shared_grad_norms(_torch(stacked), mask).numpy()
    want = np.asarray(jmtl.shared_grad_norms(_jax(stacked), mask))
    np.testing.assert_allclose(got, want, **TOL)


def test_gradnorm_update_matches_jax_over_three_calls():
    """The combining weights are the pre-update ones; ``l0`` is the first
    call's losses, kept after; the weights stay summed to T."""
    rng = np.random.default_rng(6)
    state, jstate = mtl.gradnorm_init(3), jmtl.gradnorm_init(3)
    first_losses = None
    for call in range(3):
        losses = rng.uniform(0.2, 1.0, 3).astype(np.float32)
        norms = rng.uniform(0.1, 5.0, 3).astype(np.float32)
        first_losses = losses if first_losses is None else first_losses
        w, state = mtl.gradnorm_update(state, torch.from_numpy(losses), torch.from_numpy(norms),
                                       1.5, 0.025)
        jw, jstate = jmtl.gradnorm_update(jstate, jnp.asarray(losses), jnp.asarray(norms),
                                          1.5, 0.025)
        np.testing.assert_allclose(w.numpy(), np.asarray(jw), **TOL, err_msg=f"call {call}")
        for key in ("w", "l0"):
            np.testing.assert_allclose(state[key].numpy(), np.asarray(jstate[key]), **TOL,
                                       err_msg=f"{key}, call {call}")
        assert bool(state["initialized"]) and bool(jstate["initialized"])
        np.testing.assert_array_equal(state["l0"].numpy(), first_losses)
        assert float(state["w"].sum()) == pytest.approx(3.0, rel=1e-6)
    assert not np.allclose(state["w"].numpy(), 1.0)


@pytest.mark.parametrize("name, overrides", [
    ("mmoe", dict(task_weighting="uncertainty")),
    ("ple", dict(num_levels=2)),
])
def test_shared_param_mask_matches_jax(name, overrides):
    """The port's mask on its dotted parameter names against the JAX mask on
    the flax tree of the same model. The JAX mask is carried over as values
    (1 shared, 0 task-specific) by ``state_dict_from_flax``, which pairs
    the names. Under PLE the task-specific experts and gates count as
    shared: the JAX rule marks only parts starting ``tower_``/``gate_``."""
    overrides = {**TINY, **overrides}
    data = make_synthetic_dataset(tiny_schema(), num_rows=2, seed=0)
    _, variables = _jax_model_and_variables(name, overrides, jax_tiny_schema(), data)
    jax_mask = jmtl.shared_param_mask(variables["params"], jmtl.default_task_specific)
    as_values = jax.tree_util.tree_map(
        lambda keep, p: np.full(np.shape(p), float(keep), np.float32),
        jax_mask, variables["params"])
    model = build_model(tiny_schema(), default_config(name, **overrides), device="cpu")
    want = state_dict_from_flax(model, {"params": as_values})
    got = mtl.shared_param_mask((n for n, _ in model.named_parameters()),
                                mtl.default_task_specific)
    assert len(got) == len(want)
    for key, shared in got.items():
        assert torch.all(want[key] == float(shared)), key
    assert not got["tower_like.Dense_0.weight"] and got["tables.table_feedid.weight"]
    if name == "mmoe":
        assert not got["gate_like.weight"] and not got["task_log_var_like"]
        assert got["expert_0.Dense_0.weight"]
    else:
        assert got["L0_t1_e0.Dense_0.weight"] and got["L0_gate_t1.weight"]


# -- training ---------------------------------------------------------------------


TRAIN_CASES = {
    "mmoe-sum": ("mmoe", {}),
    "mmoe-uncertainty": ("mmoe", dict(task_weighting="uncertainty")),
    "mmoe-gradnorm": ("mmoe", dict(task_weighting="gradnorm")),
    "mmoe-pcgrad-2tasks": ("mmoe", dict(task_weighting="pcgrad", tasks=("read_comment", "like"))),
    "ple-sum": ("ple", {}),
    "esmm-sum": ("esmm", {}),
}


@pytest.mark.parametrize("case", sorted(TRAIN_CASES))
def test_multitask_train_step_parity(case):
    """No BatchNorm and no dropout in these models: every parameter at the
    plain bar. Under uncertainty the ``task_log_var_*`` scalars train and
    are compared too; under gradnorm, ``w`` and ``l0`` after every step."""
    name, overrides = TRAIN_CASES[case]
    got, state = check_train_step_parity(name, {**TINY, **overrides}, {})
    weighting = overrides.get("task_weighting", "sum")
    log_vars = [k for k in got if k.startswith("task_log_var_")]
    assert len(log_vars) == (3 if weighting == "uncertainty" else 0)
    for key in log_vars:
        assert float(got[key]) != 0.0  # trained through Adam
    assert ("mtl" in state) == (weighting == "gradnorm")
    assert ("pcgrad_generator" in state) == (weighting == "pcgrad")


def test_trainer_refuses_gradient_strategies_without_logit_heads():
    """As the JAX trainer: pcgrad and gradnorm need mmoe or ple."""
    for name, weighting in (("esmm", "pcgrad"), ("esmm", "gradnorm"), ("xdeepfm", "gradnorm")):
        with pytest.raises(ValueError, match="mmoe/ple"):
            Trainer(tiny_schema(), default_config(name, task_weighting=weighting), device="cpu")


# -- the CLI on the CPU -----------------------------------------------------------


def _cli(tmp_path, *extra):
    return main(["--synthetic=1500", "--batch_size=256", "--device=cpu",
                 f"--model_dir={tmp_path}/m", f"--output_dir={tmp_path}/o", *extra])


def test_cli_esmm_exports_the_ctr_head(tmp_path, capsys):
    """ESMM at full schema width: both heads' AUCs in the history, and
    ``predictions.csv`` holds the ``ctr`` head against the first task's
    labels, under ``--label``'s name, as the JAX CLI writes it."""
    assert _cli(tmp_path, "--model=esmm", "--label=like") == 0
    history = [json.loads(line) for line in open(tmp_path / "o" / "metrics_history.jsonl")]
    assert sorted(history[0]["eval_task_aucs"]) == ["ctcvr", "ctr"]
    assert history[0]["eval_auc"] == history[0]["eval_task_aucs"]["ctr"]
    assert open(tmp_path / "o" / "predictions.csv").readline().strip() == "like,probability"
    rows = np.loadtxt(tmp_path / "o" / "predictions.csv", delimiter=",", skiprows=1)
    _, eval_data = split_train_test(make_synthetic_dataset(WECHAT_SCHEMA, num_rows=1500), 0.15)
    col = WECHAT_SCHEMA.labels.index(default_config("esmm").tasks[0])
    np.testing.assert_array_equal(rows[:, 0], eval_data["labels"][:, col])
    pred = Predictor(WECHAT_SCHEMA, default_config("esmm"), model_dir=str(tmp_path / "m"),
                     device="cpu")
    np.testing.assert_allclose(pred(eval_data)["ctr"], rows[:, 1], rtol=1e-5, atol=1e-5)
    assert "task AUCs: {'ctr'" in capsys.readouterr().out


def test_cli_gradnorm_resumes_its_weights(tmp_path, capsys):
    """mmoe with 2 tasks under gradnorm, a checkpoint each epoch, then a
    resume: the restored GradNorm state is the saved one, which has moved
    from w = 1 and still sums to T."""
    args = ["--model=mmoe", "--tasks=read_comment,like", "--task_weighting=gradnorm",
            "--save_checkpoints_steps=1"]
    assert _cli(tmp_path, *args) == 0
    mgr = CheckpointManager(str(tmp_path / "m"))
    saved = torch.load(tmp_path / "m" / "checkpoint_epoch_1", weights_only=True)["mtl"]
    assert float(saved["w"].sum()) == pytest.approx(2.0, rel=1e-5)
    assert not torch.allclose(saved["w"], torch.ones(2)) and bool(saved["initialized"])

    cfg = default_config("mmoe", tasks=("read_comment", "like"), task_weighting="gradnorm")
    trainer = Trainer(WECHAT_SCHEMA, cfg, TrainConfig(), device="cpu")
    state, epoch = mgr.restore_epoch(trainer.init_state(), 1)
    assert epoch == 1
    for key in ("w", "l0", "initialized"):
        assert torch.equal(state["mtl"][key], saved[key]), key

    assert _cli(tmp_path, *args, "--resume=true", "--num_epochs=2") == 0
    assert "resumed from checkpoint_epoch_1" in capsys.readouterr().out
    resumed = torch.load(tmp_path / "m" / "checkpoint_epoch_2", weights_only=True)["mtl"]
    torch.testing.assert_close(resumed["l0"], saved["l0"], rtol=0, atol=0)  # l0 kept
    assert not torch.equal(resumed["w"], saved["w"])


def test_cli_pcgrad_resumes_its_generator(tmp_path):
    """ple with 3 tasks under pcgrad: the checkpoint carries the task
    orders' generator, and a resume restores it."""
    args = ["--model=ple", "--task_weighting=pcgrad", "--save_checkpoints_steps=1"]
    assert _cli(tmp_path, *args) == 0
    payload = torch.load(tmp_path / "m" / "checkpoint_epoch_1", weights_only=True)
    history = [json.loads(line) for line in open(tmp_path / "o" / "metrics_history.jsonl")]
    assert sorted(history[0]["eval_task_aucs"]) == sorted(default_config("ple").tasks)
    assert all(np.isfinite(history[0][k]) for k in ("train_loss", "eval_loss"))
    trainer = Trainer(WECHAT_SCHEMA, default_config("ple", task_weighting="pcgrad"),
                      device="cpu")
    state = trainer.init_state()
    fresh = state["pcgrad_generator"].get_state()
    state, _ = CheckpointManager(str(tmp_path / "m")).restore_epoch(state, 1)
    restored = state["pcgrad_generator"].get_state()
    assert torch.equal(restored, payload["pcgrad_generator"]) and not torch.equal(restored, fresh)


@pytest.mark.parametrize("model, weighting", [("esmm", "pcgrad"), ("xdeepfm", "gradnorm")])
def test_cli_refuses_gradient_strategies(tmp_path, model, weighting):
    with pytest.raises(ValueError, match="mmoe/ple"):
        _cli(tmp_path, f"--model={model}", f"--task_weighting={weighting}")
    assert not os.path.exists(tmp_path / "m")


def test_multitask_entry_points_raise_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    schema = tiny_schema()
    for name in ("esmm", "mmoe", "ple"):
        cfg = default_config(name, **TINY)
        with pytest.raises(RuntimeError, match="CUDA"):
            build_model(schema, cfg)
        with pytest.raises(RuntimeError, match="CUDA"):
            Trainer(schema, cfg)
        state_dict = build_model(schema, cfg, device="cpu").state_dict()
        with pytest.raises(RuntimeError, match="CUDA"):
            Predictor(schema, cfg, state_dict=state_dict)
