"""The port's CLI and staged epochs on several ranks (gloo, CPU).

  * ``rank_tpu_torch.cli.main`` on 2 ranks at d = 2 (staged and streaming)
    and at t = 2. The data shards are unequal (417 and 416 training rows,
    14 and 13 steps of 32), so ``_agreed_steps`` must give both ranks the
    same step count; both ranks report the same eval AUC (they gather the
    same predictions); rank 0 alone writes ``metrics_history.jsonl``, the
    predictions and the checkpoints; the best model, in the normal form,
    serves through a one-rank ``Predictor``. At t = 2 (one data rank) the
    run trains what the one-rank CLI trains, as the card's ``sharded``
    phase holds. Parity with JAX is ``test_torch_sharding.py``'s: the
    port's staged shuffle draws its order from torch.
  * ``StagedRunner``'s shuffles on 2 data ranks: ``'global'`` moves each
    step's rows as the permutation drawn alike on every rank says, with one
    ``all_to_all`` an epoch; ``'local'`` interleaves once by stride (shard
    i holds rows i, i+2, ...), then permutes each shard's own rows with no
    collective (counted by wrapping ``torch.distributed``); one epoch
    trains every valid row once.
"""

import json
import os

import numpy as np
import pytest
import torch

import torch_ranks
from rank_tpu_torch import WECHAT_SCHEMA, Predictor, default_config, tiny_schema
from rank_tpu_torch.cli import main
from rank_tpu_torch.data.loader import shard_for_process, split_train_test
from rank_tpu_torch.data.synthetic import make_synthetic_dataset
from rank_tpu_torch.train import TrainConfig, Trainer
from rank_tpu_torch.train.staged import StagedRunner

ROWS, BATCH, EPOCHS = 980, 64, 2  # 833 training rows: shards of 417 and 416
RUNS = {
    "d2": ["--table_parallelism=1"],
    "d2_streaming": ["--table_parallelism=1", "--device_resident=false"],
    "d2_local": ["--table_parallelism=1", "--staged_shuffle=local"],
    "t2": ["--table_parallelism=2", "--embedding_mode=psum"],
}


def _argv(workdir, extra):
    return ["--model=dcn", f"--synthetic={ROWS}", f"--batch_size={BATCH}", "--device=cpu",
            "--hidden_units=16,8", f"--num_epochs={EPOCHS}", "--save_checkpoints_steps=1",
            f"--model_dir={workdir}/m", f"--output_dir={workdir}/o", *extra]


@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory):
    out = {}
    for name, extra in RUNS.items():
        workdir = tmp_path_factory.mktemp(name)
        torch_ranks.spawn(torch_ranks.cli_rank, 2, workdir, _argv(workdir, extra))
        ranks = [json.load(open(workdir / f"cli_{r}.json")) for r in range(2)]
        out[name] = (workdir, ranks)
    return out


def _eval_aucs(stdout):
    return [line.split("Eval AUC: ")[1].split(",")[0] for line in stdout.splitlines()
            if "Eval AUC" in line]


def test_unequal_shards_need_agreed_steps():
    train, _ = split_train_test(make_synthetic_dataset(WECHAT_SCHEMA, num_rows=ROWS), 0.15)
    sizes = [len(shard_for_process(train, i, 2)["labels"]) for i in range(2)]
    assert sizes == [417, 416]
    assert [-(-n // (BATCH // 2)) for n in sizes] == [14, 13]


@pytest.mark.parametrize("name", list(RUNS))
def test_ranks_agree_on_eval_auc(cli_runs, name):
    _, ranks = cli_runs[name]
    assert [r["rc"] for r in ranks] == [0, 0]
    aucs = [_eval_aucs(r["stdout"]) for r in ranks]
    assert len(aucs[0]) == EPOCHS + 1  # each epoch and the best model's
    assert aucs[0] == aucs[1]


@pytest.mark.parametrize("name", list(RUNS))
def test_rank_zero_alone_writes(cli_runs, name):
    workdir, ranks = cli_runs[name]
    history = [json.loads(line) for line in open(workdir / "o" / "metrics_history.jsonl")]
    assert [h["epoch"] for h in history] == list(range(1, EPOCHS + 1))
    assert sorted(os.listdir(workdir / "m")) == [
        "best_model", "checkpoint_epoch_1", "checkpoint_epoch_1_metrics.json",
        "checkpoint_epoch_2", "checkpoint_epoch_2_metrics.json"]
    assert "Predictions saved" in ranks[0]["stdout"]
    assert "Predictions saved" not in ranks[1]["stdout"]


def _eval_rows_in_gathered_order(d):
    """The eval rows in the order the ranks' gather gives them: step-major,
    data rank 0's rows of a step before rank 1's, padding dropped."""
    _, eval_data = split_train_test(make_synthetic_dataset(WECHAT_SCHEMA, num_rows=ROWS), 0.15)
    if d == 1:
        return eval_data
    shards = [shard_for_process(eval_data, i, d) for i in range(d)]
    bs = BATCH // d
    steps = max(-(-len(s["labels"]) // bs) for s in shards)
    index = []
    for s in range(steps):
        for i, shard in enumerate(shards):
            rows = np.arange(s * bs, min((s + 1) * bs, len(shard["labels"])))
            index.extend(rows * d + i)  # shard_for_process is strided
    return {k: v[np.asarray(index)] for k, v in eval_data.items()}


@pytest.mark.parametrize("name", list(RUNS))
def test_best_model_serves_through_one_rank(cli_runs, name):
    workdir, _ = cli_runs[name]
    d = 1 if name == "t2" else 2
    rows = np.loadtxt(workdir / "o" / "predictions.csv", delimiter=",", skiprows=1)
    eval_rows = _eval_rows_in_gathered_order(d)
    col = WECHAT_SCHEMA.labels.index("read_comment")
    np.testing.assert_array_equal(rows[:, 0], eval_rows["labels"][:, col])
    pred = Predictor(WECHAT_SCHEMA, default_config("dcn", hidden_units=(16, 8)),
                     model_dir=str(workdir / "m"), device="cpu")
    np.testing.assert_allclose(pred(eval_rows)["score"], rows[:, 1], rtol=1e-5, atol=1e-5)


def test_table_sharded_cli_trains_what_one_rank_trains(cli_runs, tmp_path):
    """t = 2 on one data rank against the one-rank CLI, same seed: the
    losses of every epoch to rtol 2e-4 and the eval AUC to 1e-4."""
    workdir, _ = cli_runs["t2"]
    assert main(_argv(tmp_path, ["--table_parallelism=1"])) == 0
    got = [json.loads(line) for line in open(workdir / "o" / "metrics_history.jsonl")]
    want = [json.loads(line) for line in open(tmp_path / "o" / "metrics_history.jsonl")]
    np.testing.assert_allclose([h["train_loss"] for h in got], [h["train_loss"] for h in want],
                               rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose([h["eval_auc"] for h in got], [h["eval_auc"] for h in want],
                               rtol=0, atol=1e-4)


# -- staged shuffles --------------------------------------------------------------

STAGED_ROWS, STAGED_BATCH = 150, 32  # shards of 75 rows, 5 steps of 16, 5 padding rows


@pytest.fixture(scope="module")
def staged(tmp_path_factory):
    workdir = tmp_path_factory.mktemp("staged")
    data = make_synthetic_dataset(tiny_schema(), num_rows=STAGED_ROWS, seed=3)
    data["rowid"] = np.arange(STAGED_ROWS, dtype=np.int32)
    torch_ranks.save(workdir, "staged_inputs.pkl", {"data": data, "batch_size": STAGED_BATCH})
    torch_ranks.spawn(torch_ranks.staged_rank, 2, workdir)
    return [torch_ranks.load(workdir, f"staged_{r}.pkl") for r in range(2)]


def _global_order(ranks, mode):
    """The global staged order: rank 0's staged rows, then rank 1's."""
    return np.concatenate([r[mode]["staged"] for r in ranks])


def test_local_shuffle_interleaves_by_stride(staged):
    order = _global_order(staged, "local")
    for i, r in enumerate(staged):
        np.testing.assert_array_equal(r["local"]["interleaved"], order[i::2])


@pytest.mark.parametrize("epoch", [1, 2, 3])
def test_local_shuffle_keeps_each_shards_rows(staged, epoch):
    for r in staged:
        got = r["local"]["epochs"][epoch]["rowid"]
        np.testing.assert_array_equal(np.sort(got), np.sort(r["local"]["interleaved"]))
        assert not np.array_equal(got, r["local"]["interleaved"])  # permuted
    orders = [staged[0]["local"]["epochs"][e]["rowid"] for e in (1, 2, 3)]
    assert not np.array_equal(orders[0], orders[1]) and not np.array_equal(orders[1], orders[2])


def test_local_shuffle_calls_no_collective(staged):
    for r in staged:
        calls = r["local"]["calls"]
        assert calls[1] == {"all_to_all_single": 1}  # the one-time interleave
        assert calls[2] == {} and calls[3] == {}


@pytest.mark.parametrize("epoch", [1, 2, 3])
def test_global_shuffle_follows_the_drawn_permutation(staged, epoch):
    order = _global_order(staged, "global")
    steps, bs = staged[0]["global"]["steps"], STAGED_BATCH // 2
    generator = torch.Generator().manual_seed(42 + epoch)
    perm = torch.randperm(len(order), generator=generator).numpy()
    for i, r in enumerate(staged):
        want = order[perm.reshape(steps, 2, bs)[:, i, :].reshape(-1)]
        np.testing.assert_array_equal(r["global"]["epochs"][epoch]["rowid"], want)
        assert r["global"]["calls"][epoch] == {"all_to_all_single": 1}


@pytest.mark.parametrize("mode", ["global", "local"])
def test_one_epoch_trains_every_valid_row_once(staged, mode):
    for epoch in (1, 2, 3):
        rows = np.concatenate([r[mode]["epochs"][epoch]["rowid"][r[mode]["epochs"][epoch]["valid"] > 0]
                               for r in staged])
        np.testing.assert_array_equal(np.sort(rows), np.arange(STAGED_ROWS))
    assert [r[mode]["trained_count"] for r in staged] == [STAGED_ROWS, STAGED_ROWS]


def test_bad_shuffle_mode_raises():
    schema = tiny_schema()
    data = make_synthetic_dataset(schema, num_rows=40, seed=1)
    trainer = Trainer(schema, default_config("dcn"), TrainConfig(batch_size=16), device="cpu")
    with pytest.raises(ValueError, match="global|local"):
        StagedRunner(trainer, data, data, 16, shuffle_mode="per_host")
