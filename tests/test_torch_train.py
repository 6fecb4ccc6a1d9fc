"""The port's training slice (rank_tpu_torch) held against the JAX package.

  * loader, staging and split: the same seed gives byte-identical batches;
  * metrics: exact AUC (ties, ``_valid``), streaming AUC and accuracy;
  * BatchNorm in train mode and global-norm clipping against flax/optax;
  * train-step parity for xdeepfm and din at dropout 0: the first step's
    loss and gradients, then parameters and BatchNorm running statistics
    after 3 Adam steps, from the same carried-over weights and batches
    (``check_train_step_parity``, which the zoo and multi-task files use
    too, under every task weighting);
  * the CLI on ``--device=cpu``: a tiny run end to end, resume, the
    best-model reload, ``Predictor(model_dir=...)``, and the error paths.

Tolerances: losses and gradients rtol 1e-4 / atol 1e-5 (float32 sums in
another order); parameters after 3 steps the same, except as stated in
``test_train_step_parity``.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from rank_tpu.cli import build_parser as jax_build_parser
from rank_tpu.data.loader import ArrayLoader as JaxArrayLoader
from rank_tpu.data.loader import split_train_test as jax_split
from rank_tpu.features import tiny_schema as jax_tiny_schema
from rank_tpu.models import default_config as jax_default_config
from rank_tpu.train import TrainConfig as JaxTrainConfig
from rank_tpu.train import Trainer as JaxTrainer
from rank_tpu.train import metrics as JM
from rank_tpu.train import mtl as jmtl
from rank_tpu.train.staged import _pad_rows as jax_pad_rows
from rank_tpu_torch import WECHAT_SCHEMA, Predictor, default_config, tiny_schema
from rank_tpu_torch.cli import build_parser, main, model_config_from_args
from rank_tpu_torch.data.loader import ArrayLoader, shard_for_process, split_train_test
from rank_tpu_torch.data.synthetic import make_synthetic_dataset
from rank_tpu_torch.interop import state_dict_from_flax
from rank_tpu_torch.ops.activations import BatchNorm
from rank_tpu_torch.train import TrainConfig, Trainer
from rank_tpu_torch.train import metrics as M
from rank_tpu_torch.train.loop import clip_by_global_norm_
from rank_tpu_torch.train.staged import StagedRunner, _pad_rows

TOL = dict(rtol=1e-4, atol=1e-5)


def _same_batches(got, want):
    got, want = list(got), list(want)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for k in w:
            assert g[k].dtype == w[k].dtype and g[k].tobytes() == w[k].tobytes(), k


@pytest.mark.parametrize("kwargs", [
    dict(),
    dict(shuffle=True, seed=3, drop_remainder=False),
    dict(shuffle=True, seed=5, drop_remainder=False, num_batches=6),
])
def test_loader_batches_are_byte_identical(kwargs):
    data = make_synthetic_dataset(tiny_schema(), num_rows=83, seed=2)
    _same_batches(ArrayLoader(data, 16, **kwargs), JaxArrayLoader(data, 16, **kwargs))
    assert len(ArrayLoader(data, 16, **kwargs)) == len(JaxArrayLoader(data, 16, **kwargs))


def test_split_pad_and_shard_match_jax():
    data = make_synthetic_dataset(tiny_schema(), num_rows=101, seed=4)
    for got, want in zip(split_train_test(data, 0.15), jax_split(data, 0.15)):
        _same_batches([got], [want])
    got, steps = _pad_rows(data, 32)
    want, want_steps = jax_pad_rows(data, 32)
    assert steps == want_steps == 4
    _same_batches([got], [want])
    shard = shard_for_process(data, 1, 3)
    assert shard["dense"].tobytes() == data["dense"][1::3].tobytes()
    with pytest.raises(ValueError, match="num_batches"):
        ArrayLoader(data, 16, num_batches=2, drop_remainder=False)


def test_staged_epochs_cover_every_row_once():
    schema = tiny_schema()
    data = make_synthetic_dataset(schema, num_rows=150, seed=1)
    trainer = Trainer(schema, default_config("xdeepfm"), TrainConfig(batch_size=64), device="cpu")
    runner = StagedRunner(trainer, data, data, 64)
    assert runner.train_steps == runner.eval_steps == 3
    orders = []
    for epoch in (1, 2, 1):
        shuffled = runner.shuffled(epoch, seed=42)
        assert float(shuffled["_valid"].sum()) == 150
        rows = shuffled["dense"][shuffled["_valid"] > 0]
        np.testing.assert_array_equal(np.sort(rows.numpy(), axis=0),
                                      np.sort(data["dense"], axis=0))
        orders.append(shuffled["userid"])
    assert torch.equal(orders[0], orders[2]) and not torch.equal(orders[0], orders[1])
    batches = list(runner._slices(runner.eval_staged, runner.eval_steps))
    assert [b["_valid"].sum().item() for b in batches] == [64, 64, 22]
    assert batches[0]["dense"].data_ptr() == runner.eval_staged["dense"].data_ptr()


def _auc_inputs(seed=0, n=500):
    rng = np.random.default_rng(seed)
    scores = np.round(rng.random(n), 2).astype(np.float32)  # many ties
    labels = (rng.random(n) < 0.3).astype(np.float32)
    valid = (rng.random(n) < 0.8).astype(np.float32)
    return scores, labels, valid


@pytest.mark.parametrize("with_valid", [False, True])
def test_exact_auc_matches_jax(with_valid):
    scores, labels, valid = _auc_inputs()
    args = (scores, labels, valid) if with_valid else (scores, labels)
    want = float(jax.jit(JM.exact_auc)(*map(jnp.asarray, args)))
    got = float(M.exact_auc(*map(torch.from_numpy, args)))
    assert abs(got - want) < 1e-6
    from sklearn.metrics import roc_auc_score

    keep = valid > 0 if with_valid else slice(None)
    assert abs(got - roc_auc_score(labels[keep], scores[keep])) < 1e-9
    one_class = M.exact_auc(torch.ones(4), torch.zeros(4))
    assert float(one_class) == 0.5


def test_streaming_auc_and_accuracy_match_jax():
    state, jstate = M.auc_state_init(), JM.auc_state_init()
    for seed in (1, 2):
        scores, labels, valid = _auc_inputs(seed)
        M.auc_state_update_(state, *map(torch.from_numpy, (scores, labels, valid)))
        jstate = JM.auc_state_update(jstate, *map(jnp.asarray, (scores, labels, valid)))
    np.testing.assert_array_equal(state["pos"].numpy(), np.asarray(jstate["pos"]))
    np.testing.assert_array_equal(state["neg"].numpy(), np.asarray(jstate["neg"]))
    assert abs(float(M.auc_state_result(state)) - float(JM.auc_state_result(jstate))) < 1e-6
    got = M.binary_accuracy(*map(torch.from_numpy, (scores, labels, valid)))
    want = JM.binary_accuracy(*map(jnp.asarray, (scores, labels, valid)))
    assert [float(x) for x in got] == [float(x) for x in want]


@pytest.mark.parametrize("affine", [True, False])
def test_batch_norm_trains_as_flax(affine):
    """Train mode: batch statistics with the biased variance, and running
    statistics updated with decay 0.99; eval mode: the running statistics."""
    import flax.linen as nn

    rng = np.random.default_rng(7)
    xs = [(rng.normal(size=(33, 5)) * 3 + 1).astype(np.float32) for _ in range(2)]
    jbn = nn.BatchNorm(use_running_average=False, momentum=0.99, epsilon=1e-5,
                       use_bias=affine, use_scale=affine)
    variables = jbn.init(jax.random.PRNGKey(0), jnp.asarray(xs[0]))
    if affine:
        variables = {"params": {"scale": jnp.asarray(rng.normal(1, 0.5, 5), jnp.float32),
                                "bias": jnp.asarray(rng.normal(0, 0.5, 5), jnp.float32)},
                     "batch_stats": variables["batch_stats"]}
    bn = BatchNorm(5, affine=affine)
    bn.load_state_dict(state_dict_from_flax(bn, variables))
    bn.train()
    for x in xs:
        want, mutated = jbn.apply(variables, jnp.asarray(x), mutable=["batch_stats"])
        variables = {**variables, **mutated}
        got = bn(torch.from_numpy(x))
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    stats = variables["batch_stats"]
    np.testing.assert_allclose(bn.running_mean.numpy(), np.asarray(stats["mean"]), **TOL)
    np.testing.assert_allclose(bn.running_var.numpy(), np.asarray(stats["var"]), **TOL)
    assert int(bn.num_batches_tracked) == 2
    bn.eval()
    want = nn.BatchNorm(use_running_average=True, epsilon=1e-5, use_bias=affine,
                        use_scale=affine).apply(variables, jnp.asarray(xs[0]))
    np.testing.assert_allclose(bn(torch.from_numpy(xs[0])).detach().numpy(),
                               np.asarray(want), **TOL)


@pytest.mark.parametrize("max_norm", [0.5, 100.0])
def test_clip_by_global_norm_matches_optax(max_norm):
    rng = np.random.default_rng(8)
    grads = [rng.normal(size=s).astype(np.float32) for s in ((3, 4), (5,), (2, 2, 2))]
    want, _ = optax.clip_by_global_norm(max_norm).update([jnp.asarray(g) for g in grads], None)
    got = [torch.from_numpy(g.copy()) for g in grads]
    clip_by_global_norm_(got, max_norm)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=1e-7)


# -- train-step parity --------------------------------------------------------

PARITY_BS = 64  # divisible by the JAX tests' 8-device CPU mesh
PARITY_OVERRIDES = {
    "xdeepfm": dict(hidden_units=(32, 16), embedding_dim=8, cin_layer_sizes=(8, 8),
                    dropout_rate=0.0),
    "din": dict(hidden_units=(32, 16), dropout_rate=0.0),
}


def _variables(state):
    state = jax.device_get(state)
    return {"params": state["params"], **state["extra"]}


def bn_fed_bias_noise(tower: str, layers: int, lr: float, steps: int = 3) -> dict:
    """The 3-step atol of the Dense biases that feed a BatchNorm in
    ``tower`` (bn_act order), and of those BatchNorms' running means: see
    ``check_train_step_parity``."""
    noise = {f"{tower}.Dense_{i}.bias": steps * lr for i in range(layers)}
    noise.update({f"{tower}.BatchNorm_{i}.running_mean": steps * lr * 0.01
                  for i in range(layers)})
    return noise


def jax_first_step(jtrainer, jstate, jbatch):
    """The JAX trainer's loss and gradient at its first step, as its train
    step computes them: ``value_and_grad`` of the loss, or under pcgrad and
    gradnorm the per-task ``jacrev`` combined by ``rank_tpu.train.mtl``
    with the step's key and the GradNorm state."""
    rng = jax.random.split(jstate["rng"])[0]
    mode = jtrainer.mtl_mode

    def first(params, extra, mtl_state, batch, rng):
        if mode is None:
            (loss, _), grads = jax.value_and_grad(jtrainer.loss_fn, has_aux=True)(
                params, extra, batch, rng, True)
            return loss, grads
        stacked, (losses, _, _) = jax.jacrev(jtrainer.task_losses_fn, has_aux=True)(
            params, extra, batch, rng, True)
        if mode == "pcgrad":
            weights, loss = jmtl.pcgrad_weights(jmtl.gram_matrix(stacked), rng), jnp.sum(losses)
        else:
            mask = jmtl.shared_param_mask(params, jmtl.default_task_specific)
            cfg = jtrainer.model_cfg
            weights, _ = jmtl.gradnorm_update(mtl_state, losses,
                                              jmtl.shared_grad_norms(stacked, mask),
                                              cfg.gradnorm_alpha, cfg.gradnorm_lr)
            loss = jnp.sum(weights * losses)
        return loss, jmtl.combine_stacked(stacked, weights)

    loss, grads = jax.jit(first)(jstate["params"], jstate["extra"], jstate.get("mtl"), jbatch, rng)
    return float(loss), jax.device_get(grads)


def check_train_step_parity(name: str, overrides: dict, noise: dict, lr: float = 0.005,
                            schemas=None, data=None, batch_size: int = PARITY_BS):
    """One JAX trainer and one port trainer from the same weights (the JAX
    init, carried over) and the same three batches: by default of the tiny
    schema's synthetic rows, else the first three ``batch_size`` batches of
    ``data`` under ``schemas`` (the port's schema, JAX's). Step 1: loss and every
    gradient. After 3 Adam steps: every parameter and BatchNorm running
    statistic. Under gradnorm, GradNorm's weights and initial losses after
    every step.

    Hazard: a Dense bias that feeds a BatchNorm (a bn_act tower) has a
    gradient that is zero up to rounding, and Adam turns that noise into
    steps of +-lr, whose signs differ between the frameworks. So those
    biases are compared at atol = steps * lr, and the running means of the
    BatchNorms they feed, which take (1 - decay) of each batch mean, at
    atol = steps * lr * (1 - decay) (``bn_fed_bias_noise``). ``noise`` maps
    each such key to its atol."""
    schema, jax_schema = schemas or (tiny_schema(), jax_tiny_schema())
    if data is None:
        data = make_synthetic_dataset(schema, num_rows=3 * batch_size, seed=11)
    batches = list(ArrayLoader(data, batch_size))[:3]

    jtrainer = JaxTrainer(jax_schema, jax_default_config(name, **overrides),
                          JaxTrainConfig(batch_size=batch_size, learning_rate=lr, log_every=0))
    jstate = jtrainer.init_state(batches[0])
    variables0 = _variables(jstate)
    jbatches = [jtrainer._host_to_device(b) for b in batches]
    jloss, jgrads = jax_first_step(jtrainer, jstate, jbatches[0])
    step = jtrainer._get_compiled("train")
    jmeters = jtrainer.meters_init()
    jmtl_states = []
    for b in jbatches:
        jstate, jmeters = step(jstate, jmeters, b)
        jmtl_states.append(jax.device_get(jstate.get("mtl")))

    trainer = Trainer(schema, default_config(name, **overrides),
                      TrainConfig(batch_size=batch_size, learning_rate=lr, log_every=0),
                      device="cpu")
    state = trainer.init_state()
    model = state["model"]
    model.load_state_dict(state_dict_from_flax(model, variables0))
    meters = trainer.meters_init()

    def take_step(i):
        trainer.train_step(state, meters, trainer.to_device(batches[i]))
        if jmtl_states[i] is not None:
            for key in ("w", "l0"):
                np.testing.assert_allclose(state["mtl"][key].numpy(), jmtl_states[i][key], **TOL,
                                           err_msg=f"GradNorm {key} after step {i + 1}")

    take_step(0)
    np.testing.assert_allclose(float(meters["loss"]), jloss, **TOL)
    want_grads = state_dict_from_flax(model, {**variables0, "params": jgrads})
    params = dict(model.named_parameters())
    assert len(params) > 10
    for key, p in params.items():
        np.testing.assert_allclose(p.grad.numpy(), want_grads[key].numpy(), **TOL,
                                   err_msg=f"gradient of {key}")

    for i in range(1, len(batches)):
        take_step(i)
    assert state["step"] == 3
    np.testing.assert_allclose(float(meters["loss"]), float(jmeters["loss"]), **TOL)
    want = state_dict_from_flax(model, _variables(jstate))
    got = model.state_dict()
    assert set(noise) <= set(got)
    for key, value in got.items():
        if key.endswith("num_batches_tracked"):
            assert int(value) == 3
            continue
        tol = dict(rtol=0, atol=noise[key]) if key in noise else TOL
        np.testing.assert_allclose(value.numpy(), want[key].numpy(), **tol,
                                   err_msg=f"{key} after 3 steps")
    return got, state


@pytest.mark.parametrize("name", ["xdeepfm", "din"])
def test_train_step_parity(name):
    """``check_train_step_parity`` for xdeepfm and din at dropout 0.
    xDeepFM's tower is bn_act. DIN's attention bias ``b3`` shifts every
    valid score alike, which the softmax cancels: its gradient is rounding
    noise too, and it is compared at atol = steps * lr."""
    lr = 0.005
    noise = bn_fed_bias_noise("dnn", 2, lr) if name == "xdeepfm" else {"attention.b3": 3 * lr}
    got, _ = check_train_step_parity(name, PARITY_OVERRIDES[name], noise, lr)
    assert any("running_var" in k for k in got)


# -- the CLI on the CPU ---------------------------------------------------------

def _cli(tmp_path, *extra):
    return main(["--synthetic=1500", "--batch_size=256", "--device=cpu",
                 "--hidden_units=32,16", f"--model_dir={tmp_path}/m",
                 f"--output_dir={tmp_path}/o", *extra])


def test_cli_trains_resumes_reloads_best_and_serves(tmp_path, capsys):
    """xDeepFM at full schema width (tower cut to 32-16): epoch 1, then a
    resume for epoch 2. The exported predictions are the best model's, and
    ``Predictor(model_dir=...)`` serves the same scores."""
    assert _cli(tmp_path, "--model=xdeepfm", "--save_checkpoints_steps=1") == 0
    assert _cli(tmp_path, "--model=xdeepfm", "--save_checkpoints_steps=1", "--resume=true",
                "--num_epochs=2") == 0
    out = capsys.readouterr().out
    assert "resumed from checkpoint_epoch_1" in out
    assert sorted(os.listdir(tmp_path / "m")) == [
        "best_model", "checkpoint_epoch_1", "checkpoint_epoch_1_metrics.json",
        "checkpoint_epoch_2", "checkpoint_epoch_2_metrics.json"]
    history = [json.loads(line) for line in open(tmp_path / "o" / "metrics_history.jsonl")]
    assert [h["epoch"] for h in history] == [1, 2]
    assert all(np.isfinite(h["train_loss"]) and 0 <= h["eval_auc"] <= 1 for h in history)
    best = max(h["eval_auc"] for h in history)
    metrics = json.load(open(tmp_path / "m" / "checkpoint_epoch_2_metrics.json"))
    assert metrics["best_auc"] == pytest.approx(best)
    assert f"Eval AUC: {best:.4f}\nPredictions saved" in out  # the best model reloaded

    rows = np.loadtxt(tmp_path / "o" / "predictions.csv", delimiter=",", skiprows=1)
    _, eval_data = split_train_test(make_synthetic_dataset(WECHAT_SCHEMA, num_rows=1500), 0.15)
    col = WECHAT_SCHEMA.labels.index("read_comment")
    np.testing.assert_array_equal(rows[:, 0], eval_data["labels"][:, col])
    cfg = default_config("xdeepfm", hidden_units=(32, 16))
    pred = Predictor(WECHAT_SCHEMA, cfg, model_dir=str(tmp_path / "m"), device="cpu")
    np.testing.assert_allclose(pred(eval_data)["score"], rows[:, 1], rtol=1e-5, atol=1e-5)


def test_cli_streams_din(tmp_path):
    assert _cli(tmp_path, "--model=din", "--device_resident=false") == 0
    assert os.path.exists(tmp_path / "o" / "predictions.csv")
    assert os.path.exists(tmp_path / "m" / "best_model")


def test_cli_error_paths(tmp_path):
    with pytest.raises(SystemExit, match="available"):
        main(["--model=nosuch", "--synthetic=10"])
    assert main(["--model=din"]) == 2
    assert main(["--model=din", "--train_data=a.parquet"]) == 2


@pytest.mark.parametrize("extra", [
    ["--model=din", "--table_parallelism=2"],
    ["--model=din", "--embedding_mode=psum"],
    ["--model=din", "--staged_shuffle=local"],
    ["--model=din", "--profile_dir=trace"],
    ["--model=din", "--matmul_precision=highest"],
])
def test_cli_unported_flags_raise(extra):
    with pytest.raises(NotImplementedError, match="not ported"):
        main(["--synthetic=10", "--device=cpu", *extra])


def test_cli_parser_matches_jax():
    """Every flag of the JAX CLI, with its default; the port adds --device."""
    def flags(parser):
        return {a.dest: a.default for a in parser._actions if a.dest != "help"}

    got, want = flags(build_parser()), flags(jax_build_parser())
    assert got.pop("device") == "cuda"
    assert got == want
    argv = ["--model=din", "--hidden_units=64,32", "--activation=prelu", "--use_softmax=false",
            "--dropout_rate=0.2", "--embedding_init=normal_small"]
    from rank_tpu.cli import model_config_from_args as jax_model_config

    got_cfg = model_config_from_args(build_parser().parse_args(argv))
    want_cfg = jax_model_config(jax_build_parser().parse_args(argv))
    assert dataclasses.asdict(got_cfg) == dataclasses.asdict(want_cfg)


def test_training_entry_points_raise_without_cuda(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        Trainer(tiny_schema(), default_config("xdeepfm"))
    with pytest.raises(RuntimeError, match="CUDA"):
        main(["--model=xdeepfm", "--synthetic=10", f"--model_dir={tmp_path}/m",
              f"--output_dir={tmp_path}/o"])
    # a multi-task model builds on the CPU when asked to; pcgrad needs one
    # with a logit head a task, as in the JAX trainer
    trainer = Trainer(tiny_schema(), default_config("mmoe"), device="cpu")
    assert sorted(trainer.init_state()["model"](
        trainer.to_device(make_synthetic_dataset(tiny_schema(), num_rows=4)))["logits"]) == sorted(
        default_config("mmoe").tasks)
    with pytest.raises(ValueError, match="pcgrad"):
        Trainer(tiny_schema(), default_config("xdeepfm", task_weighting="pcgrad"), device="cpu")
