"""The training-quality matrices, the port's half (the port's counterpart
of ``scripts/parity_check.py:train_ours``, ``scripts/mtl_quality.py:run_one``
and the table writer ``scripts/parity_table.py``).

Two matrices, each run under rank_tpu's protocol as its JAX runner builds
it, each held against rank_tpu's recorded eval AUCs (data files at the
repository root, read as JSON, never imported):

  * ``calib``: the 18 models on the calibrated log at scale 0.05 (seed 0:
    166,115 train and 30,452 eval rows), 3 epochs, batch 1024, Adam 5e-3,
    ``dense_init='torch'``, the scalar tag lookup for
    ``SCALAR_TAG_MODELS``, on ``WECHAT_SCHEMA`` (``parity_check.py:261-264``
    discards the vocabulary-sized schema). rank_tpu's record:
    ``PARITY_CALIB_r05.jsonl``, field ``ours``.
  * ``mtl``: MMOE and PLE under each task weighting on 200,000 synthetic
    rows (seed 0, 15% held out by ``split_train_test``), 3 epochs, batch
    1024, the default dense init, scalar tags. rank_tpu's record:
    ``MTL_QUALITY_r03.jsonl``, field ``task_aucs``.

A run trains with ``Trainer`` and ``StagedRunner`` (``train_epoch(state,
e, seed)`` for e = 1..3, then ``evaluate``) and appends one JSON line: the
model, seed (and weighting), ``port`` (the primary head's eval AUC: ESMM's
``ctr``, else the first task, as ``rank_tpu/train/staged.py:469-482``
picks it) and ``task_aucs``; ``rank_tpu``, the record for the same model,
weighting and seed, only when the run kept the whole protocol (else null:
a smaller run is never compared with the record); ``t_port_s``; the card
(``nvidia-smi`` name and power limit), the torch version and the float32
matmul precision.

The table compares, per model or cell, the port's protocol runs with
rank_tpu's record: mean ± std (ddof 1) of each, Δ = the difference of the
means, SE = sqrt(s_p²/n_p + s_j²/n_j). A row is flagged when |Δ| > 2·SE,
on either side: what is tested is that the two packages agree, so a port
that is better beyond the noise is flagged too.

    python -m rank_tpu_torch.parity calib --models all --seeds 42,43,44
    python -m rank_tpu_torch.parity mtl --models all --weightings all --seeds 42,43,44
    python -m rank_tpu_torch.parity table --json_out PARITY_PORT_CALIB_H100.jsonl
    python -m rank_tpu_torch.parity table --json_out PARITY_PORT_CALIB_H100.jsonl \
        --rank_tpu_jsonl PARITY_CALIB_JAX_CPU.jsonl --md_out PARITY_PORT_VS_JAX_CPU.md

The last holds the same runs against another file of rank_tpu's runner in
the record's format (there: its protocol run on the CPU, in f32), in the
cells that file has.

Runs go to the card (``--device cuda``, the default); ``--device cpu`` runs
the same code on the CPU, as the tests do.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .data.calibrated import make_calibrated_dataset
from .data.loader import split_train_test
from .data.synthetic import make_synthetic_dataset
from .features import WECHAT_SCHEMA
from .models import ModelConfig, default_config
from .train import TrainConfig, Trainer
from .train.staged import StagedRunner

ROOT = Path(__file__).resolve().parent.parent

# scripts/parity_check.py:54-68
MODELS = (
    "dcn", "bst", "din", "dien", "deepcrossing", "afm", "xdeepfm",
    "mmoe", "ple", "deepfm",
    "fwfm", "ffm", "pnn", "widedeep", "fibinet", "autoint", "flen", "esmm",
)
MULTI_TASK = ("mmoe", "ple")
SCALAR_TAG_MODELS = (
    "din", "mmoe", "deepcrossing", "ple", "dien", "widedeep", "esmm",
    "dcn", "bst",
)
# scripts/mtl_quality.py:29-31 and its argparse defaults (:122-129)
MTL_MODELS = ("mmoe", "ple")
WEIGHTINGS = ("sum", "uncertainty", "gradnorm", "pcgrad")
SEEDS = (42, 43, 44)
EPOCHS = 3
BATCH_SIZE = 1024
CALIB_SCALE = 0.05
MTL_ROWS = 200_000
MTL_TEST_FRACTION = 0.15


@dataclasses.dataclass(frozen=True)
class Matrix:
    """One matrix: the file of rank_tpu's record, the port's default output
    file, the name of its data size in a record and the protocol's size."""

    jax_jsonl: str
    json_out: str
    size_key: str
    protocol_size: float
    title: str


MATRICES = {
    "calib": Matrix("PARITY_CALIB_r05.jsonl", "PARITY_PORT_CALIB_H100.jsonl", "scale",
                    CALIB_SCALE, "the 18 models on the calibrated log"),
    "mtl": Matrix("MTL_QUALITY_r03.jsonl", "MTL_QUALITY_PORT_H100.jsonl", "rows", MTL_ROWS,
                  "MMOE and PLE under each task weighting"),
}


@dataclasses.dataclass
class Dataset:
    """A matrix's train and eval splits and the size they were made at: the
    calibrated log's scale, or the synthetic rows."""

    matrix: str
    size: float
    train: Dict[str, np.ndarray]
    eval: Dict[str, np.ndarray]


def calibrated_data(scale: float = CALIB_SCALE, cache_dir: Optional[str] = None) -> Dataset:
    """The calibrated log at ``scale`` (its default seed 0) through the ETL;
    the vocabulary-sized schema it returns is not used."""
    train, test, _ = make_calibrated_dataset(scale=scale, cache_dir=cache_dir)
    return Dataset("calib", scale, train, test)


def mtl_data(rows: int = MTL_ROWS) -> Dataset:
    data = make_synthetic_dataset(WECHAT_SCHEMA, num_rows=rows, seed=0)
    train, test = split_train_test(data, MTL_TEST_FRACTION)
    return Dataset("mtl", rows, train, test)


def calib_config(model: str, seed: int,
                 batch_size: int = BATCH_SIZE) -> Tuple[ModelConfig, TrainConfig]:
    """The calibrated matrix's configs, as ``train_ours`` builds them."""
    cfg = default_config(model, dense_init="torch")
    if model in SCALAR_TAG_MODELS:
        cfg = cfg.replace(multihot_tags=False)
    return cfg, TrainConfig(batch_size=batch_size, log_every=0, seed=seed)


def mtl_config(model: str, weighting: str, seed: int,
               batch_size: int = BATCH_SIZE) -> Tuple[ModelConfig, TrainConfig]:
    """The task-weighting matrix's configs, as ``run_one`` builds them."""
    cfg = default_config(model).replace(task_weighting=weighting, multihot_tags=False)
    return cfg, TrainConfig(batch_size=batch_size, log_every=0, seed=seed)


def train_and_evaluate(trainer: Trainer, data: Dataset, epochs: int, state=None) -> Dict:
    """``epochs`` staged epochs from ``state`` (the trainer's fresh state
    when None), then one eval pass; the primary head's AUC and every
    head's."""
    runner = StagedRunner(trainer, data.train, data.eval, trainer.cfg.batch_size)
    if state is None:
        state = trainer.init_state()
    for epoch in range(1, epochs + 1):
        state, _ = runner.train_epoch(state, epoch, trainer.cfg.seed)
    stats = runner.evaluate(state, epochs)
    return {"auc": stats["auc"], "task_aucs": stats["task_aucs"]}


def jax_records(matrix: str, path: Optional[str] = None) -> Dict[Tuple, Dict]:
    """rank_tpu's record of ``matrix``: {(model, seed) or (model, weighting,
    seed): {"auc": primary head's eval AUC, "task_aucs": dict or None}}.
    The latest line of a key wins, as ``scripts/parity_table.py`` reads it.
    ``path``: another file of rank_tpu's runner in the same format (default:
    the matrix's record)."""
    out = {}
    with open(path or ROOT / MATRICES[matrix].jax_jsonl) as f:
        for line in f:
            if not line.strip():
                continue
            r = json.loads(line)
            if matrix == "calib":
                out[(r["model"], r.get("seed", 42))] = {"auc": r["ours"], "task_aucs": None}
            else:
                primary = default_config(r["model"]).tasks[0]
                out[(r["model"], r["weighting"], r["seed"])] = {
                    "auc": r["task_aucs"][primary], "task_aucs": r["task_aucs"]}
    return out


def card_line() -> str:
    """The card's name and power limit, as ``nvidia-smi`` prints them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def matmul_precision() -> Dict:
    """The float32 matmul setting the run trained under."""
    return {"float32_matmul_precision": torch.get_float32_matmul_precision(),
            "allow_tf32": torch.backends.cuda.matmul.allow_tf32}


def _run(key: Dict, model_cfg: ModelConfig, train_cfg: TrainConfig, data: Dataset,
         epochs: int, device, json_out: Optional[str]) -> Dict:
    matrix = MATRICES[data.matrix]
    t0 = time.perf_counter()
    trainer = Trainer(WECHAT_SCHEMA, model_cfg, train_cfg, device=device)
    result = train_and_evaluate(trainer, data, epochs)
    seconds = time.perf_counter() - t0
    protocol = (data.size == matrix.protocol_size and epochs == EPOCHS
                and train_cfg.batch_size == BATCH_SIZE)
    record_key = (*key.values(), train_cfg.seed)
    jax = jax_records(data.matrix).get(record_key) if protocol else None
    record = {
        "matrix": data.matrix, **key, "seed": train_cfg.seed,
        matrix.size_key: data.size, "epochs": epochs, "batch_size": train_cfg.batch_size,
        "protocol": protocol, "device": str(trainer.device),
        "port": result["auc"], "task_aucs": result["task_aucs"],
        "rank_tpu": None if jax is None else jax["auc"],
        "rank_tpu_task_aucs": None if jax is None else jax["task_aucs"],
        "t_port_s": seconds,
        "card": card_line() if trainer.device.type == "cuda" else None,
        "torch": torch.__version__,
        "matmul_precision": matmul_precision(),
    }
    if json_out:
        with open(json_out, "a") as f:
            f.write(json.dumps(record) + "\n")
    print(json.dumps(record), flush=True)
    return record


def run_calibrated(model: str, seed: int, data: Optional[Dataset] = None, epochs: int = EPOCHS,
                   batch_size: int = BATCH_SIZE, device="cuda",
                   json_out: Optional[str] = None) -> Dict:
    """One run of the calibrated matrix (``data``: ``calibrated_data()``
    when None); returns its record, appended to ``json_out`` when given."""
    if model not in MODELS:
        raise ValueError(f"unknown model {model!r}; the matrix has {MODELS}")
    data = data if data is not None else calibrated_data()
    if data.matrix != "calib":
        raise ValueError(f"run_calibrated takes the calibrated log, got {data.matrix!r} data")
    model_cfg, train_cfg = calib_config(model, seed, batch_size)
    return _run({"model": model}, model_cfg, train_cfg, data, epochs, device, json_out)


def run_mtl(model: str, weighting: str, seed: int, data: Optional[Dataset] = None,
            epochs: int = EPOCHS, batch_size: int = BATCH_SIZE, device="cuda",
            json_out: Optional[str] = None) -> Dict:
    """One run of the task-weighting matrix (``data``: ``mtl_data()`` when
    None); returns its record, appended to ``json_out`` when given."""
    if model not in MTL_MODELS or weighting not in WEIGHTINGS:
        raise ValueError(f"({model!r}, {weighting!r}): the matrix has {MTL_MODELS} x {WEIGHTINGS}")
    data = data if data is not None else mtl_data()
    if data.matrix != "mtl":
        raise ValueError(f"run_mtl takes the synthetic rows, got {data.matrix!r} data")
    model_cfg, train_cfg = mtl_config(model, weighting, seed, batch_size)
    return _run({"model": model, "weighting": weighting}, model_cfg, train_cfg, data, epochs,
                device, json_out)


# -- the table -----------------------------------------------------------------


def compare(port: Sequence[float], jax: Sequence[float]) -> Dict:
    """Δ of the means, its standard error and the two-sided flag
    |Δ| > 2·SE; SE and the flag are None while either side has fewer
    than two runs."""
    p, j = np.asarray(port, np.float64), np.asarray(jax, np.float64)
    delta = float(p.mean() - j.mean())
    if len(p) < 2 or len(j) < 2:
        return {"delta": delta, "se": None, "flagged": None}
    se = math.sqrt(p.var(ddof=1) / len(p) + j.var(ddof=1) / len(j))
    return {"delta": delta, "se": se, "flagged": bool(abs(delta) > 2 * se)}


def mean_std(values: Sequence[float]) -> str:
    v = np.asarray(values, np.float64)
    sd = v.std(ddof=1) if len(v) > 1 else 0.0
    return f"{v.mean():.5f} ± {sd:.5f}"


def read_records(path: str) -> List[Dict]:
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def _cell_keys(matrix: str) -> Tuple[str, ...]:
    return ("model",) if matrix == "calib" else ("model", "weighting")


def _order(matrix: str) -> List[Tuple]:
    if matrix == "calib":
        return [(m,) for m in sorted(MODELS)]
    return [(m, w) for m in MTL_MODELS for w in WEIGHTINGS]


def table_rows(records: Iterable[Dict], matrix: str,
               rank_tpu_jsonl: Optional[str] = None) -> List[Dict]:
    """One row a cell that has protocol runs and a record: the port's runs
    (protocol, not superseded) against rank_tpu's record of every seed
    (or ``rank_tpu_jsonl``'s, another file of rank_tpu's runner)."""
    keys = _cell_keys(matrix)
    port: Dict[Tuple, List[Dict]] = {}
    for r in records:
        if r["matrix"] == matrix and r["protocol"] and not r.get("superseded"):
            port.setdefault(tuple(r[k] for k in keys), []).append(r)
    jax: Dict[Tuple, List[Dict]] = {}
    for key, rec in jax_records(matrix, rank_tpu_jsonl).items():
        jax.setdefault(key[:-1], []).append(rec)
    rows = []
    for cell in _order(matrix):
        runs = port.get(cell)
        if not runs or cell not in jax:
            continue
        p = [r["port"] for r in runs]
        j = [r["auc"] for r in jax[cell]]
        rows.append({"cell": cell, "port": p, "rank_tpu": j, "seeds": [r["seed"] for r in runs],
                     "task_aucs": [r["task_aucs"] for r in runs],
                     "rank_tpu_task_aucs": [r["task_aucs"] for r in jax[cell]],
                     "t_port_s": [r["t_port_s"] for r in runs], **compare(p, j)})
    return rows


NOTES = """
Known differences the matrix cannot separate:
- a seed draws other initial weights, dropout masks and shuffles in the
  two frameworks (torch generators against JAX keys), so seed 42 of one
  side is not seed 42 of the other: only the distributions compare;
- PCGrad's 3-task orders come from a `torch.Generator` seeded seed + 2
  (ROADMAP.md "Decisions in force"), not from JAX's key;
- rank_tpu's records `PARITY_CALIB_r05.jsonl` and `MTL_QUALITY_r03.jsonl`
  were taken on a TPU, at rank_tpu's default matmul precision there (the
  `*_JAX_CPU.jsonl` files on the CPU, in f32); the port's runs compute
  f32 products at the precision each line records, and its DIN
  attention and CIN kernels in 3xTF32.

A flagged cell gets three more port seeds (45, 46, 47, `--flagged_seeds`);
if it stays flagged, a CPU test trains both packages from the same
weights on the same batches for 50 steps
(`tests/test_torch_parity_steps.py::test_long_training_matches_jax_step_by_step`).
What that finds is recorded in ROADMAP.md's list C.

With nothing different, |Δ| > 2·SE fires with P = 0.12–0.18 at 3 runs a
side (Welch's t, 2–4 degrees of freedom), so 3–5 of the 26 cells of the
two matrices flag by chance. ROADMAP.md's C4, the leans of these tables,
is closed with no fault found at 20 seeds: whole runs of both packages on
the CPU, with the initial draw, the epoch order and the arithmetic split
apart, and the port's runs on the card at the same seeds
(`C4_ARMS_CPU.md`, `tests/torch_c4_arms.py`). Its sub-item C4a, widedeep
at full scale, is open.
"""


def render_table(records: List[Dict], matrix: str, source: str,
                 rank_tpu_jsonl: Optional[str] = None) -> str:
    m = MATRICES[matrix]
    rows = table_rows(records, matrix, rank_tpu_jsonl)
    jax_file = m.jax_jsonl if rank_tpu_jsonl is None else os.path.basename(rank_tpu_jsonl)
    again = "" if rank_tpu_jsonl is None else f" --rank_tpu_jsonl {jax_file}"
    label = "Model" if matrix == "calib" else "Model | Weighting"
    lines = [
        f"# Training quality, port against rank_tpu: {m.title}\n\n",
        f"Port: `rank_tpu_torch.parity` ({source}, one line a run); rank_tpu:\n"
        f"`{jax_file}`. Each cell's eval AUC (the primary head) over its\n"
        "seeds, mean ± std (ddof 1); Δ = port mean − rank_tpu mean, SE =\n"
        "sqrt(s_p²/n_p + s_j²/n_j); **flag** where |Δ| > 2·SE, either sign.\n"
        "Regenerate with `python -m rank_tpu_torch.parity table --json_out "
        f"{source}{again}`.\n\n",
        f"| {label} | port n | port AUC | rank_tpu n | rank_tpu AUC | Δ | SE | Δ/SE | flag | port s/run |\n",
        "|---|" + ("---|" if matrix == "mtl" else "") + "---|" * 9 + "\n",
    ]
    for row in rows:
        se = row["se"]
        ratio = "—" if se is None else f"{row['delta'] / se:+.2f}"
        lines.append(
            f"| {' | '.join(row['cell'])} | {len(row['port'])} | {mean_std(row['port'])} | "
            f"{len(row['rank_tpu'])} | {mean_std(row['rank_tpu'])} | {row['delta']:+.5f} | "
            f"{'—' if se is None else f'{se:.5f}'} | {ratio} | "
            f"{'**flag**' if row['flagged'] else ''} | {np.mean(row['t_port_s']):.1f} |\n")
    if matrix == "mtl":
        tasks = default_config("mmoe").tasks
        lines += ["\nEvery task's eval AUC, port mean / rank_tpu mean (Δ):\n\n",
                  "| Model | Weighting | " + " | ".join(tasks) + " |\n",
                  "|---|---|" + "---|" * len(tasks) + "\n"]
        for row in rows:
            cells = []
            for t in tasks:
                p = np.mean([a[t] for a in row["task_aucs"]])
                j = np.mean([a[t] for a in row["rank_tpu_task_aucs"]])
                cells.append(f"{p:.5f} / {j:.5f} ({p - j:+.5f})")
            lines.append(f"| {' | '.join(row['cell'])} | " + " | ".join(cells) + " |\n")
    deltas = [row["delta"] for row in rows]
    flagged = [" ".join(row["cell"]) for row in rows if row["flagged"]]
    if deltas:
        lines.append(
            f"\nGrand mean Δ over {len(deltas)} cells: {np.mean(deltas):+.5f} "
            f"({sum(d > 0 for d in deltas)} positive, range {min(deltas):+.5f} to "
            f"{max(deltas):+.5f}). Flagged: {', '.join(flagged) or 'none'}.\n")
    port_runs = [r for r in records if r["matrix"] == matrix and r["protocol"]]
    cards = sorted({str(r["card"]) for r in port_runs})
    versions = sorted({r["torch"] for r in port_runs})
    precisions = sorted({json.dumps(r["matmul_precision"], sort_keys=True) for r in port_runs})
    superseded = sum(1 for r in records if r["matrix"] == matrix and r.get("superseded"))
    if port_runs:
        lines.append(
            f"\nPort runs: {len(port_runs)} on the protocol ({superseded} superseded, kept "
            f"in the file), on {', '.join(cards)}; torch {', '.join(versions)}; matmul "
            f"precision {', '.join(precisions)}. The s/run column is the port's: train and "
            "eval, after the data is made.\n")
    lines.append(NOTES)
    return "".join(lines)


def write_table(json_out: str, md_out: Optional[str] = None,
                rank_tpu_jsonl: Optional[str] = None) -> Dict:
    """Regenerate the markdown table of ``json_out`` (its matrix read from
    the lines) against rank_tpu's record, or ``rank_tpu_jsonl``; returns a
    summary: the flagged cells and the grand mean Δ."""
    records = read_records(json_out)
    matrices = {r["matrix"] for r in records}
    if len(matrices) != 1:
        raise ValueError(f"{json_out} holds records of {sorted(matrices)}: one matrix a file")
    (matrix,) = matrices
    md_out = md_out or os.path.splitext(json_out)[0] + ".md"
    with open(md_out, "w") as f:
        f.write(render_table(records, matrix, os.path.basename(json_out), rank_tpu_jsonl))
    rows = table_rows(records, matrix, rank_tpu_jsonl)
    summary = {"matrix": matrix, "md_out": md_out, "cells": len(rows),
               "grand_mean_delta": float(np.mean([r["delta"] for r in rows])) if rows else None,
               "flagged": [" ".join(r["cell"]) for r in rows if r["flagged"]]}
    print(json.dumps(summary), flush=True)
    return summary


# -- the CLI -------------------------------------------------------------------


def _names(value: str, allowed: Sequence[str]) -> List[str]:
    names = list(allowed) if value == "all" else value.split(",")
    unknown = [n for n in names if n not in allowed]
    if unknown:
        raise SystemExit(f"unknown {unknown}; choose from {list(allowed)} or 'all'")
    return names


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m rank_tpu_torch.parity",
                                 description=__doc__.split("\n\n")[0])
    sub = ap.add_subparsers(dest="command", required=True)
    for name in ("calib", "mtl"):
        p = sub.add_parser(name, help=f"run {MATRICES[name].title}")
        p.add_argument("--models", default="all")
        p.add_argument("--seeds", default=",".join(map(str, SEEDS)))
        p.add_argument("--epochs", type=int, default=EPOCHS)
        p.add_argument("--batch_size", type=int, default=BATCH_SIZE)
        p.add_argument("--device", default="cuda")
        p.add_argument("--json_out", default=MATRICES[name].json_out)
        p.add_argument("--md_out", default=None,
                       help="the table regenerated after the runs (default: beside --json_out)")
        p.add_argument("--flagged_seeds", default="",
                       help="seeds run next for every cell the table then flags, appended "
                            "to the same file (the flag procedure's first step: 45,46,47)")
        if name == "calib":
            p.add_argument("--scale", type=float, default=CALIB_SCALE)
            p.add_argument("--cache_dir", default=None,
                           help="the calibrated log's cache (default: under TMPDIR)")
        else:
            p.add_argument("--weightings", default="all")
            p.add_argument("--rows", type=int, default=MTL_ROWS)
    p = sub.add_parser("table", help="regenerate a matrix's markdown table from its JSONL")
    p.add_argument("--json_out", default=MATRICES["calib"].json_out)
    p.add_argument("--md_out", default=None)
    p.add_argument("--rank_tpu_jsonl", default=None,
                   help="hold the port against this file of rank_tpu's runner (the same "
                        "format as the matrix's record) instead of the record")
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.command == "table":
        write_table(args.json_out, args.md_out, args.rank_tpu_jsonl)
        return 0
    common = dict(epochs=args.epochs, batch_size=args.batch_size, device=args.device,
                  json_out=args.json_out)
    if args.command == "calib":
        cells = [(m,) for m in _names(args.models, MODELS)]
        data = calibrated_data(args.scale, args.cache_dir)
        run = lambda cell, seed: run_calibrated(*cell, seed, data, **common)  # noqa: E731
    else:
        cells = [(m, w) for m in _names(args.models, MTL_MODELS)
                 for w in _names(args.weightings, WEIGHTINGS)]
        data = mtl_data(args.rows)
        run = lambda cell, seed: run_mtl(*cell, seed, data, **common)  # noqa: E731
    for cell in cells:
        for seed in (int(s) for s in args.seeds.split(",")):
            run(cell, seed)
    write_table(args.json_out, args.md_out)
    if args.flagged_seeds:
        rows = table_rows(read_records(args.json_out), args.command)
        for cell in (row["cell"] for row in rows if row["flagged"]):
            for seed in (int(s) for s in args.flagged_seeds.split(",")):
                run(cell, seed)
        write_table(args.json_out, args.md_out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
