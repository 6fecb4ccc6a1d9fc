"""The port's training-quality runner (``rank_tpu_torch.parity``) held
against rank_tpu's runners and table writers:

  * the protocol lists and every run's configs equal those that
    ``scripts/parity_check.py:train_ours`` and
    ``scripts/mtl_quality.py:run_one`` build (each script's ``Trainer`` is
    replaced by one that records its arguments; so is the port's);
  * the eval readout: on a small calibrated log, from weights carried over
    from the JAX ``Trainer``'s state, the port runner's ``auc`` and every
    ``task_aucs`` value equal rank_tpu's ``StagedRunner.evaluate`` to 1e-5
    (the Pallas kernels in interpret mode, as ``tests/test_pallas.py`` runs
    them on the CPU);
  * the records: every field, and ``rank_tpu`` null off the protocol;
  * the table: its rank_tpu column is what ``scripts/parity_table.py`` and
    ``scripts/mtl_quality.py --render`` write from the same records, and
    the flag rule |Δ| > 2·SE fires on either side.

The flag procedure's long check is ``test_torch_parity_steps.py``.
"""

import ast
import dataclasses
import importlib.util
import json
import re
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest

import rank_tpu.train as jax_train
from rank_tpu.features import WECHAT_SCHEMA as JAX_WECHAT_SCHEMA
from rank_tpu.models import ModelConfig as JaxModelConfig
from rank_tpu.ops.pallas import cin as ck
from rank_tpu.ops.pallas import din_attention as pk
from rank_tpu.train import TrainConfig as JaxTrainConfig
from rank_tpu.train import Trainer as JaxTrainer
from rank_tpu.train.staged import StagedRunner as JaxStagedRunner
from rank_tpu_torch import WECHAT_SCHEMA, ModelConfig, parity
from rank_tpu_torch.interop import state_dict_from_flax
from rank_tpu_torch.models.base import jax_fields
from rank_tpu_torch.train import TrainConfig, Trainer

ROOT = Path(__file__).resolve().parent.parent
# fields of the port's configs that rank_tpu's lack (none: the port's
# ModelConfig and TrainConfig are rank_tpu's, field for field)
PORT_ONLY_FIELDS = {"ModelConfig": {"cuda_graphs"}, "TrainConfig": set()}
READOUT_SCALE = 0.005
READOUT_TOL = 1e-5


def load_script(name: str):
    """A JAX runner script as a module: at top level it imports only numpy
    and the standard library."""
    spec = importlib.util.spec_from_file_location(f"jax_{name}", ROOT / "scripts" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


class Built(Exception):
    """Raised by a recording ``Trainer`` once it has its arguments."""

    def __init__(self, schema, model_cfg, train_cfg, **kwargs):
        super().__init__()
        self.schema, self.model_cfg, self.train_cfg, self.kwargs = (
            schema, model_cfg, train_cfg, kwargs)


def recording_trainer(*args, **kwargs):
    raise Built(*args, **kwargs)


def jax_built(monkeypatch, run):
    monkeypatch.setattr(jax_train, "Trainer", recording_trainer)
    with pytest.raises(Built) as built:
        run()
    return built.value


def port_built(monkeypatch, run):
    monkeypatch.setattr(parity, "Trainer", recording_trainer)
    with pytest.raises(Built) as built:
        run()
    return built.value


def assert_same_fields(got, want):
    for port_cls, jax_cls in ((ModelConfig, JaxModelConfig), (TrainConfig, JaxTrainConfig)):
        port_fields = {f.name for f in dataclasses.fields(port_cls)}
        jax_fields = {f.name for f in dataclasses.fields(jax_cls)}
        assert port_fields - jax_fields == PORT_ONLY_FIELDS[port_cls.__name__]
    for g, w in ((got.model_cfg, want.model_cfg), (got.train_cfg, want.train_cfg)):
        g, w = dataclasses.asdict(g), dataclasses.asdict(w)
        shared = sorted(set(g) & set(w))
        assert len(shared) > 10
        assert {k: g[k] for k in shared} == {k: w[k] for k in shared}


def vocab_sizes(schema):
    return {f.name: (f.vocab_size, f.emb_dim) for f in schema.categorical}


def test_protocol_lists_match_jax_scripts():
    check, mtl = load_script("parity_check"), load_script("mtl_quality")
    assert parity.MODELS == check.MODELS and len(parity.MODELS) == 18
    assert parity.SCALAR_TAG_MODELS == check.SCALAR_TAG_MODELS
    assert parity.MULTI_TASK == check.MULTI_TASK
    assert parity.MTL_MODELS == mtl.MODELS and parity.WEIGHTINGS == mtl.WEIGHTINGS
    defaults = _argparse_defaults(mtl)
    assert defaults["seeds"] == ",".join(map(str, parity.SEEDS))
    assert defaults["epochs"] == parity.EPOCHS and defaults["batch"] == parity.BATCH_SIZE
    assert defaults["rows"] == parity.MTL_ROWS
    assert defaults["models"].split(",") == list(parity.MTL_MODELS)
    assert defaults["weightings"].split(",") == list(parity.WEIGHTINGS)
    # PARITY_CALIB_r05.md's protocol: the calibrated log at 0.05, 3 epochs,
    # batch 1024, every model and seed recorded
    assert {(m, s) for m, s in parity.jax_records("calib")} == {
        (m, s) for m in parity.MODELS for s in parity.SEEDS}
    assert {(m, w, s) for m, w, s in parity.jax_records("mtl")} == {
        (m, w, s) for m in parity.MTL_MODELS for w in parity.WEIGHTINGS for s in parity.SEEDS}


def _argparse_defaults(module) -> dict:
    """{dest: default} of every ``add_argument`` call with a default in a
    loaded script's source, each default evaluated in the script's names."""
    defaults = {}
    for node in ast.walk(ast.parse(Path(module.__file__).read_text())):
        if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                and node.func.attr == "add_argument"):
            for kw in node.keywords:
                if kw.arg == "default":
                    expr = compile(ast.Expression(kw.value), module.__file__, "eval")
                    defaults[node.args[0].value.lstrip("-")] = eval(expr, vars(module))
    return defaults


@pytest.mark.parametrize("model", parity.MODELS)
def test_calib_config_matches_jax(model, monkeypatch):
    check = load_script("parity_check")
    want = jax_built(monkeypatch, lambda: check.train_ours(
        model, None, None, parity.EPOCHS, parity.BATCH_SIZE, seed=43, dense_init="torch"))
    data = parity.Dataset("calib", parity.CALIB_SCALE, {}, {})
    got = port_built(monkeypatch, lambda: parity.run_calibrated(model, 43, data, device="cpu"))
    assert_same_fields(got, want)
    assert got.model_cfg == parity.calib_config(model, 43)[0]
    assert got.model_cfg.dense_init == "torch"
    assert got.model_cfg.multihot_tags == (model not in check.SCALAR_TAG_MODELS)
    assert got.train_cfg.seed == 43 and got.train_cfg.batch_size == 1024
    assert got.schema is WECHAT_SCHEMA and want.schema is JAX_WECHAT_SCHEMA
    assert vocab_sizes(got.schema) == vocab_sizes(want.schema)
    assert got.kwargs == {"device": "cpu"}


@pytest.mark.parametrize("model,weighting", [(m, w) for m in parity.MTL_MODELS
                                             for w in parity.WEIGHTINGS])
def test_mtl_config_matches_jax(model, weighting, monkeypatch):
    mtl = load_script("mtl_quality")
    want = jax_built(monkeypatch, lambda: mtl.run_one(
        model, weighting, 44, None, None, parity.EPOCHS, parity.BATCH_SIZE))
    data = parity.Dataset("mtl", parity.MTL_ROWS, {}, {})
    got = port_built(monkeypatch,
                     lambda: parity.run_mtl(model, weighting, 44, data, device="cpu"))
    assert_same_fields(got, want)
    assert got.model_cfg.task_weighting == weighting and not got.model_cfg.multihot_tags
    assert got.model_cfg.dense_init == "lecun"  # run_one keeps the default family
    assert got.train_cfg.seed == 44
    assert vocab_sizes(got.schema) == vocab_sizes(want.schema)


@pytest.fixture(scope="module")
def small_log(tmp_path_factory):
    return parity.calibrated_data(READOUT_SCALE, str(tmp_path_factory.mktemp("calibrated")))


def few_rows(data, size, train_rows: int = 1024, eval_rows: int = 2048):
    """The first rows of ``data`` under the size label ``size``: one train
    step an epoch at batch 1024, so that a run of the protocol's length
    stays cheap on the CPU."""
    return parity.Dataset(data.matrix, size, {k: v[:train_rows] for k, v in data.train.items()},
                          {k: v[:eval_rows] for k, v in data.eval.items()})


@pytest.fixture
def interpret_pallas(monkeypatch):
    monkeypatch.setattr(pk, "_INTERPRET", True)
    monkeypatch.setattr(ck, "_INTERPRET", True)


@pytest.mark.parametrize("model", ["xdeepfm", "din", "mmoe", "esmm"])
def test_eval_readout_matches_jax(model, small_log, interpret_pallas):
    model_cfg, train_cfg = parity.calib_config(model, 42)
    jtrainer = JaxTrainer(JAX_WECHAT_SCHEMA, JaxModelConfig(**jax_fields(model_cfg)),
                          JaxTrainConfig(**dataclasses.asdict(train_cfg)))
    jrunner = JaxStagedRunner(jtrainer, small_log.train, small_log.eval, train_cfg.batch_size)
    jstate = jrunner.init_state()
    want = jrunner.evaluate(jstate, 1)

    trainer = Trainer(WECHAT_SCHEMA, model_cfg, train_cfg, device="cpu")
    state = trainer.init_state()
    host = jax.device_get(jstate)
    state["model"].load_state_dict(state_dict_from_flax(
        state["model"], {"params": host["params"], **host["extra"]}))
    got = parity.train_and_evaluate(trainer, small_log, 0, state)

    assert len(small_log.eval["labels"]) > 2 * train_cfg.batch_size  # several eval steps
    assert sorted(got["task_aucs"]) == sorted(want["task_aucs"])
    assert len(got["task_aucs"]) == {"mmoe": 3, "esmm": 2}.get(model, 1)
    for head, auc in want["task_aucs"].items():
        assert abs(got["task_aucs"][head] - auc) < READOUT_TOL, head
    assert abs(got["auc"] - want["auc"]) < READOUT_TOL
    primary = "ctr" if model == "esmm" else "read_comment"
    assert got["auc"] == got["task_aucs"][primary]
    assert 0.0 < got["auc"] < 1.0 and got["auc"] != 0.5


RECORD_FIELDS = {"matrix", "model", "seed", "epochs", "batch_size", "protocol", "device", "port",
                 "task_aucs", "rank_tpu", "rank_tpu_task_aucs", "t_port_s", "card", "torch",
                 "matmul_precision"}


def test_runner_writes_records(small_log, tmp_path):
    out = tmp_path / "runs.jsonl"
    off = parity.run_calibrated("widedeep", 42, few_rows(small_log, READOUT_SCALE), epochs=1,
                                device="cpu", json_out=str(out))
    mtl_rows = parity.mtl_data(3000)
    mtl_run = parity.run_mtl("mmoe", "uncertainty", 43, mtl_rows, epochs=1, batch_size=512,
                             device="cpu", json_out=str(tmp_path / "mtl.jsonl"))
    # the size label, the epochs and the batch decide whether a run kept
    # the protocol: here a small log labelled with the protocol's scale
    labelled = few_rows(small_log, parity.CALIB_SCALE)
    on = parity.run_calibrated("widedeep", 44, labelled, device="cpu", json_out=str(out))

    lines = parity.read_records(str(out))
    assert lines == [off, on] and parity.read_records(str(tmp_path / "mtl.jsonl")) == [mtl_run]
    for r in lines + [mtl_run]:
        assert RECORD_FIELDS <= set(r), RECORD_FIELDS - set(r)
        assert r["device"] == "cpu" and r["card"] is None
        assert r["torch"] == parity.torch.__version__
        assert set(r["matmul_precision"]) == {"float32_matmul_precision", "allow_tf32"}
        assert 0.0 < r["port"] < 1.0 and r["t_port_s"] > 0
    assert off["scale"] == READOUT_SCALE and off["epochs"] == 1
    assert not off["protocol"] and off["rank_tpu"] is None and off["rank_tpu_task_aucs"] is None
    assert off["task_aucs"] == {"read_comment": off["port"]}
    assert mtl_run["weighting"] == "uncertainty" and mtl_run["rows"] == 3000
    assert not mtl_run["protocol"] and mtl_run["rank_tpu"] is None
    assert mtl_run["port"] == mtl_run["task_aucs"]["read_comment"]
    assert sorted(mtl_run["task_aucs"]) == ["click_avatar", "like", "read_comment"]
    assert on["protocol"] and on["epochs"] == 3 and on["batch_size"] == 1024
    assert on["rank_tpu"] == parity.jax_records("calib")[("widedeep", 44)]["auc"]
    jax_line = [json.loads(line) for line in open(ROOT / "PARITY_CALIB_r05.jsonl")
                if '"widedeep"' in line and '"seed": 44' in line]
    assert on["rank_tpu"] == jax_line[-1]["ours"]

    summary = parity.write_table(str(out), str(tmp_path / "runs.md"))
    assert summary["cells"] == 1 and summary["flagged"] in ([], ["widedeep"])
    assert "| widedeep | 1 |" in (tmp_path / "runs.md").read_text()  # the protocol run only
    assert parity.write_table(str(tmp_path / "mtl.jsonl"))["cells"] == 0
    with pytest.raises(ValueError, match="calibrated log"):
        parity.run_calibrated("dcn", 42, mtl_rows, device="cpu")
    with pytest.raises(ValueError, match="unknown model"):
        parity.run_calibrated("nosuch", 42, small_log, device="cpu")


def _md_rows(path: Path):
    """{first cell: [cells]} of a markdown table's rows."""
    rows = {}
    for line in path.read_text().splitlines():
        if line.startswith("| ") and not line.startswith("|---"):
            cells = [c.strip() for c in line.strip("|").split("|")]
            rows[cells[0]] = cells
    return rows


def _protocol_records(matrix: str):
    """Made-up port records, one a record of rank_tpu's, on the protocol."""
    m = parity.MATRICES[matrix]
    out = []
    for key, rec in parity.jax_records(matrix).items():
        cell = dict(zip(("model", "weighting") if matrix == "mtl" else ("model",), key[:-1]))
        out.append({"matrix": matrix, **cell, "seed": key[-1], m.size_key: m.protocol_size,
                    "protocol": True, "port": rec["auc"] + 0.001,
                    "task_aucs": rec["task_aucs"] or {}, "t_port_s": 1.0, "card": "card",
                    "torch": "torch", "matmul_precision": {}})
    return out


def test_table_jax_column_matches_parity_table(tmp_path):
    want_md = tmp_path / "parity_table.md"
    subprocess.run([sys.executable, str(ROOT / "scripts" / "parity_table.py"), "--jsonl",
                    str(ROOT / "PARITY_CALIB_r05.jsonl"), "--out", str(want_md), "--calibrated"],
                   check=True, capture_output=True, timeout=120)
    want = {re.sub(r" \(\d+ seeds\)$", "", k): v[1] for k, v in _md_rows(want_md).items()
            if k.endswith("seeds)")}
    got_md = tmp_path / "port.md"
    got_md.write_text(parity.render_table(_protocol_records("calib"), "calib", "port.jsonl"))
    rows = _md_rows(got_md)
    got = {m: rows[m][4] for m in parity.MODELS}
    assert len(want) == 18 and got == want
    assert all(rows[m][5] == "-0.00100" or rows[m][5] == "+0.00100" for m in parity.MODELS)


def test_mtl_table_jax_column_matches_mtl_quality_render(tmp_path):
    want_md = tmp_path / "mtl_quality.md"
    subprocess.run([sys.executable, str(ROOT / "scripts" / "mtl_quality.py"), "--render",
                    "--json_out", str(ROOT / "MTL_QUALITY_r03.jsonl"), "--md_out", str(want_md)],
                   check=True, capture_output=True, timeout=120)
    want = {}
    for line in want_md.read_text().splitlines():
        cells = [c.strip() for c in line.strip("|").split("|")]
        if len(cells) > 3 and cells[1].endswith("seeds)"):
            want[(cells[0], cells[1].split(" ")[0])] = cells[2]  # read_comment
    rows = parity.table_rows(_protocol_records("mtl"), "mtl")
    assert len(rows) == 8 and len(want) == 8
    for row in rows:
        mean, sd = np.mean(row["rank_tpu"]), np.std(row["rank_tpu"], ddof=1)
        assert f"{mean:.4f} ± {sd:.4f}" == want[row["cell"]], row["cell"]


def test_table_against_another_rank_tpu_file(tmp_path):
    """``--rank_tpu_jsonl``: the port's runs against another file of
    rank_tpu's runner (its format), in the cells that file has."""
    other = {("dcn", 42): 0.9, ("dcn", 43): 0.91, ("dcn", 44): 0.905, ("pnn", 42): 0.897,
             ("pnn", 45): 0.896}
    path = tmp_path / "PARITY_CALIB_JAX_CPU.jsonl"
    path.write_text("".join(json.dumps({"model": m, "seed": seed, "dense_init": "torch",
                                        "ours": auc, "torch": 0.5}) + "\n"
                            for (m, seed), auc in other.items()))
    records = _protocol_records("calib")
    port = tmp_path / "port.jsonl"
    port.write_text("".join(json.dumps(r) + "\n" for r in records))
    assert parity.main(["table", "--json_out", str(port), "--md_out", str(tmp_path / "t.md"),
                        "--rank_tpu_jsonl", str(path)]) == 0
    rows = parity.table_rows(records, "calib", str(path))
    assert [row["cell"] for row in rows] == [("dcn",), ("pnn",)]
    assert rows[0]["rank_tpu"] == [0.9, 0.91, 0.905] and rows[1]["rank_tpu"] == [0.897, 0.896]
    table = (tmp_path / "t.md").read_text()
    assert "`PARITY_CALIB_JAX_CPU.jsonl`" in table and "--rank_tpu_jsonl" in table
    md = _md_rows(tmp_path / "t.md")
    assert md["dcn"][4] == parity.mean_std([0.9, 0.91, 0.905]) and "widedeep" not in md


def test_flag_rule_is_two_sided():
    jax_side = [0.900, 0.905, 0.910]
    spread = [-0.005, 0.0, 0.005]
    se = np.sqrt(2 * np.var(spread, ddof=1) / 3)
    for shift, flagged in ((2.01 * se, True), (-2.01 * se, True), (1.99 * se, False),
                           (-1.99 * se, False), (0.0, False)):
        port = [x + shift for x in jax_side]
        got = parity.compare(port, jax_side)
        assert got["flagged"] is flagged, (shift, got)
        assert got["delta"] == pytest.approx(shift, abs=1e-12)
        assert got["se"] == pytest.approx(se, rel=1e-12)
    assert parity.compare([0.9], jax_side)["flagged"] is None  # one run: no SE
    records = []
    for model, k in (("dcn", 2.5), ("din", -2.5), ("bst", 0.5)):
        want = [parity.jax_records("calib")[(model, seed)]["auc"] for seed in parity.SEEDS]
        shift = k * np.sqrt(2 * np.var(want, ddof=1) / 3)  # k SE: equal spreads on both sides
        records += [{"matrix": "calib", "model": model, "seed": seed, "protocol": True,
                     "port": x + shift, "task_aucs": {}, "t_port_s": 1.0}
                    for seed, x in zip(parity.SEEDS, want)]
    rows = {row["cell"][0]: row for row in parity.table_rows(records, "calib")}
    assert rows["dcn"]["flagged"] and rows["din"]["flagged"] and not rows["bst"]["flagged"]
    assert rows["dcn"]["delta"] > 0 > rows["din"]["delta"]


def test_cli_runs_the_flagged_cells_again(small_log, tmp_path, monkeypatch):
    """``--flagged_seeds``: after the runs, each cell the table flags gets
    those seeds too, appended to the same file, and the table is written
    again. The small log is labelled with the protocol's scale, and the
    record is made up far above what the port reaches on it, so the cell
    is flagged."""
    labelled = few_rows(small_log, parity.CALIB_SCALE)
    monkeypatch.setattr(parity, "calibrated_data", lambda scale, cache_dir: labelled)
    record = {("widedeep", seed): {"auc": 0.999 - 1e-4 * i, "task_aucs": None}
              for i, seed in enumerate(parity.SEEDS)}
    monkeypatch.setattr(parity, "jax_records", lambda matrix, path=None: record)
    out = tmp_path / "calib.jsonl"
    assert parity.main(["calib", "--models", "widedeep", "--seeds", "42,43", "--device", "cpu",
                        "--json_out", str(out), "--flagged_seeds", "45"]) == 0
    lines = parity.read_records(str(out))
    assert [r["seed"] for r in lines] == [42, 43, 45]
    assert [r["rank_tpu"] is None for r in lines] == [False, False, True]  # no record of 45
    table = (tmp_path / "calib.md").read_text()
    assert "| widedeep | 3 |" in table and "**flag**" in table
