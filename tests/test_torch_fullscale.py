"""The port's full-scale runner (``rank_tpu_torch.fullscale``) held against
rank_tpu's ``scripts/fullscale_rehearsal.py``:

  * every model's configs equal those the script's ``run_one`` builds (its
    ``Trainer`` is replaced by one that records its arguments; so is the
    port's), and the parser has the script's flags and defaults, plus
    ``--device``;
  * a CPU ``run_one`` of xDeepFM and DIN at full width on a few thousand
    synthetic rows: the record has every key of rank_tpu's record,
    ``predictions.csv`` holds the eval's primary head over every eval row,
    and the saved best model served by ``Predictor`` reproduces it;
  * ``main`` writes the JSON and its table, and a record meets rank_tpu's
    AUCs only on rank_tpu's protocol;
  * exact AUC at the full eval size (609,036 rows with ties): the port's in
    float64 against a numpy rank-sum, rank_tpu's (float32 rank sums, which
    pass 2**24 here) at a wider bar.
"""

import csv
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rank_tpu.train as jax_train
from rank_tpu.models import MODEL_CLASSES as JAX_MODEL_CLASSES
from rank_tpu.train.metrics import exact_auc as jax_exact_auc
from rank_tpu_torch import WECHAT_SCHEMA, Predictor, default_config, fullscale
from rank_tpu_torch.data.synthetic import make_synthetic_dataset
from rank_tpu_torch.models import MODEL_CLASSES
from rank_tpu_torch.train.metrics import exact_auc
from rank_tpu_torch.train.staged import StagedRunner
from test_torch_parity import (Built, _argparse_defaults, assert_same_fields, load_script,
                               recording_trainer, vocab_sizes)

# the end-to-end runs: two train steps and a padded eval step at batch 1024
E2E_TRAIN_ROWS, E2E_EVAL_ROWS, E2E_BATCH = 2048, 700, 1024
SERVE_TOL = 1e-6
# the full eval split, padded to whole batches of 1024 as StagedRunner pads it
EVAL_ROWS, PADDED_ROWS = 609_036, 595 * 1024
PORT_AUC_TOL = 1e-12
# rank_tpu sums ranks in float32; here its gap is about 4e-7
JAX_AUC_TOL = 1e-5


@pytest.fixture(scope="module")
def script():
    return load_script("fullscale_rehearsal")


@pytest.mark.parametrize("model", sorted(MODEL_CLASSES))
def test_run_one_configs_match_jax_script(script, model, monkeypatch, tmp_path):
    monkeypatch.setattr(jax_train, "Trainer", recording_trainer)
    with pytest.raises(Built) as jax_built:
        script.run_one(model, {}, {}, 2, 1024, str(tmp_path), dense_init="torch")
    monkeypatch.setattr(fullscale, "Trainer", recording_trainer)
    with pytest.raises(Built) as port_built:
        fullscale.run_one(model, {}, {}, 2, 1024, str(tmp_path), dense_init="torch",
                          device="cpu")
    got, want = port_built.value, jax_built.value
    assert_same_fields(got, want)
    assert got.model_cfg.dense_init == "torch" and got.train_cfg.batch_size == 1024
    assert vocab_sizes(got.schema) == vocab_sizes(want.schema)
    assert got.kwargs == {"device": "cpu"} and want.kwargs == {}


def test_parser_matches_jax_script(script):
    jax_defaults = _argparse_defaults(script)
    port = {a.dest: a for a in fullscale.build_parser()._actions if a.dest != "help"}
    assert set(port) == set(jax_defaults) | {"device"}
    # the port's own: its record's file (rank_tpu's is never overwritten)
    # and its output root under the temporary directory (TMPDIR)
    own = {"json_out": "RESULTS_fullscale_H100.json",
           "out": os.path.join(fullscale.tempfile.gettempdir(), "fullscale"),
           "device": "cuda"}
    assert jax_defaults["json_out"] == fullscale.RANK_TPU_RECORD
    assert jax_defaults["out"] == "/tmp/fullscale"
    for dest, action in port.items():
        assert action.default == own.get(dest, jax_defaults.get(dest)), dest
    assert port["dense_init"].choices == ("lecun", "torch")
    assert (fullscale.TRAIN_ROWS, fullscale.EVAL_ROWS) == (script.TRAIN_ROWS, script.EVAL_ROWS)
    # --models all
    assert sorted(MODEL_CLASSES) == sorted(JAX_MODEL_CLASSES) and len(MODEL_CLASSES) == 18


def _rank_tpu_keys():
    """Every key rank_tpu's records hold (``note`` is a remark on one run)."""
    return set().union(*(r for r in fullscale.rank_tpu_record().values())) - {"note"}


@pytest.fixture(scope="module")
def e2e_data():
    data = make_synthetic_dataset(WECHAT_SCHEMA, num_rows=E2E_TRAIN_ROWS + E2E_EVAL_ROWS, seed=0)
    return ({k: v[:E2E_TRAIN_ROWS] for k, v in data.items()},
            {k: v[E2E_TRAIN_ROWS:] for k, v in data.items()})


@pytest.mark.parametrize("model", ["xdeepfm", "din"])
def test_run_one_end_to_end_on_cpu(model, e2e_data, monkeypatch, tmp_path):
    train_d, eval_d = e2e_data
    evals = []
    evaluate = StagedRunner.evaluate

    def recorded(self, state, epoch=1):
        evals.append(evaluate(self, state, epoch))
        return evals[-1]

    monkeypatch.setattr(StagedRunner, "evaluate", recorded)
    rec = fullscale.run_one(model, train_d, eval_d, 1, E2E_BATCH, str(tmp_path),
                            E2E_TRAIN_ROWS, E2E_EVAL_ROWS, dense_init="torch", device="cpu")
    assert _rank_tpu_keys() - {"calibrated_scale"} <= set(rec)
    assert rec["trained_rows_per_epoch"] == E2E_TRAIN_ROWS
    assert rec["predictions_rows"] == E2E_EVAL_ROWS
    assert rec["peak_hbm_gb"] is None and rec["resident_hbm_gb"] is None
    assert rec["step_temp_gb"] is None and rec["hbm_probe"].startswith("none")
    assert rec["card"] is None and rec["device"] == "cpu"
    assert rec["eval_aucs"] == [rec["eval_auc"]] == [rec["best_auc"]]
    staged_bytes = sum(v.nbytes for v in eval_d.values()) + 4 * E2E_EVAL_ROWS
    assert rec["staged_eval_gb"] * 2**30 == pytest.approx(staged_bytes * 1024 / E2E_EVAL_ROWS)

    (ev,) = evals
    primary = "read_comment"
    assert rec["eval_auc"] == ev["auc"] == ev["task_aucs"][primary]
    with open(tmp_path / model / "out" / "predictions.csv") as f:
        rows = list(csv.reader(f))
    assert rows[0] == ["read_comment", "probability"] and len(rows) == E2E_EVAL_ROWS + 1
    table = np.asarray(rows[1:], np.float32)
    valid = ev["valid"] > 0
    assert valid.sum() == E2E_EVAL_ROWS
    np.testing.assert_array_equal(table[:, 1], ev["predictions"][primary][valid])
    np.testing.assert_array_equal(
        table[:, 0], eval_d["labels"][:, WECHAT_SCHEMA.labels.index(primary)])

    cfg = default_config(model, dense_init="torch")
    served = Predictor(WECHAT_SCHEMA, cfg, model_dir=str(tmp_path / model / "model"),
                       device="cpu")({k: v for k, v in eval_d.items() if k != "labels"})
    np.testing.assert_allclose(served["score"], table[:, 1], rtol=0, atol=SERVE_TOL)


def test_main_writes_records_and_table(tmp_path):
    json_out = tmp_path / "fs.json"
    results = fullscale.main(["--models", "dcn,widedeep", "--train_rows", "1024", "--eval_rows",
                              "300", "--device", "cpu", "--out", str(tmp_path / "out"),
                              "--json_out", str(json_out)])
    assert [r["model"] for r in results] == ["dcn", "widedeep"]
    assert json.loads(json_out.read_text()) == json.loads(json.dumps(results))
    for r in results:
        assert r["t_data"] >= 0 and r["predictions_rows"] == 300
        assert not r["protocol"] and r["rank_tpu_best_auc"] is None and r["flagged"] is None
    table = (tmp_path / "fs.md").read_text().splitlines()
    body = [line for line in table if line.startswith("| ") and not line.startswith("| Model")]
    assert [line.split(" | ")[0] for line in body] == ["| dcn", "| widedeep"]


def test_compare_with_rank_tpu_on_protocol_only():
    record = fullscale.rank_tpu_record()
    assert set(record) == set(MODEL_CLASSES)
    for r in record.values():
        assert {k: r[k] for k in ("calibrated_scale", "epochs", "batch", "dense_init")} == \
            fullscale.PROTOCOL
    base = {"model": "dcn", **fullscale.PROTOCOL}
    jax_best = record["dcn"]["best_auc"]
    for best, flagged in ((jax_best + 0.0099, False), (jax_best - 0.0101, True),
                          (jax_best + 0.0101, True)):
        rec = fullscale.compare_with_rank_tpu({**base, "eval_auc": best, "best_auc": best}, record)
        assert rec["protocol"] and rec["rank_tpu_best_auc"] == jax_best
        assert rec["rank_tpu_eval_auc"] == record["dcn"]["eval_auc"]
        assert rec["delta_best_auc"] == pytest.approx(best - jax_best)
        assert rec["flagged"] is flagged
    for off in ({"epochs": 1}, {"calibrated_scale": 0.05}, {"dense_init": "lecun"}, {"batch": 512}):
        rec = fullscale.compare_with_rank_tpu({**base, **off, "eval_auc": 0.8, "best_auc": 0.8},
                                              record)
        assert not rec["protocol"] and rec["rank_tpu_best_auc"] is None and rec["flagged"] is None


def rank_sum_auc(scores: np.ndarray, labels: np.ndarray) -> float:
    """Mann-Whitney AUC with average ranks for ties, in float64."""
    order = np.argsort(scores, kind="stable")
    _, first, counts = np.unique(scores[order], return_index=True, return_counts=True)
    ranks = np.empty(len(scores))
    ranks[order] = np.repeat(first + (counts + 1) / 2.0, counts)
    n_pos = labels.sum(dtype=np.float64)
    n_neg = len(labels) - n_pos
    return float((ranks[labels > 0].sum() - n_pos * (n_pos + 1) / 2) / (n_pos * n_neg))


@pytest.fixture(scope="module")
def full_eval():
    """609,036 scores with ties (three decimals) and labels at the log's
    read_comment rate, padded to whole batches by repeating row 0."""
    rng = np.random.default_rng(11)
    labels = (rng.random(EVAL_ROWS) < 0.035).astype(np.float32)
    scores = np.round(rng.random(EVAL_ROWS) * 0.6 + 0.25 * labels, 3).astype(np.float32)
    pad = PADDED_ROWS - EVAL_ROWS
    valid = np.concatenate([np.ones(EVAL_ROWS, np.float32), np.zeros(pad, np.float32)])
    padded = [np.concatenate([x, np.repeat(x[:1], pad)]) for x in (scores, labels)]
    want = rank_sum_auc(scores.astype(np.float64), labels)
    # the positives' rank sum passes 2**24 many times over
    assert labels.sum() * EVAL_ROWS / 2 > 2**24 * 100
    return (*padded, valid, want)


@pytest.mark.parametrize("side", ["port", "rank_tpu"])
def test_exact_auc_at_full_eval_size(full_eval, side):
    scores, labels, valid, want = full_eval
    if side == "port":
        got = float(exact_auc(torch.from_numpy(scores), torch.from_numpy(labels),
                              torch.from_numpy(valid)))
        assert abs(got - want) <= PORT_AUC_TOL
    else:
        got = float(jax_exact_auc(jnp.asarray(scores), jnp.asarray(labels), jnp.asarray(valid)))
        assert abs(got - want) <= JAX_AUC_TOL
    print(f"{side}: exact AUC {got!r} against the float64 rank sum {want!r}: "
          f"gap {abs(got - want):.3e}")

