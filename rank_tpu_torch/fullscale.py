"""The full-scale rehearsal, the port's half (the port's counterpart of
``scripts/fullscale_rehearsal.py``).

Trains any subset of the 18-model zoo at the reference's data scale
(3,322,313 train / 609,037 eval rows; the calibrated log at scale 1.0
reproduces the reference's day-8-13 / day-14 split, 3,322,312 / 609,036)
on ``WECHAT_SCHEMA``, batch 1024, through ``Trainer`` and
``StagedRunner`` (both splits resident on the card): each epoch trains,
evaluates over the whole eval split (exact AUC) and saves the best
checkpoint on improvement; then the primary head's ``predictions.csv``
is written over every eval row.

A record keeps the JAX script's keys with the port's own numbers:
staging and init seconds, each epoch's seconds and examples/s, the eval,
save and export seconds, eval and best AUC, the staged splits' sizes (the
staged tensors' own bytes: the columns keep their dtypes), the train
step's temporaries (``step_memory_analysis``) and the card's peak memory,
measured: ``torch.cuda.reset_peak_memory_stats`` before staging,
``max_memory_allocated`` after the export. It adds the data build's
seconds, the card (``nvidia-smi`` name and power limit), the torch version,
the float32 matmul precision, and rank_tpu's eval and best AUC for the
same model from ``RESULTS_fullscale_r05.json`` (read as data; its times and
memory figures are a TPU's and are not copied) with the differences,
when the run keeps that record's protocol (the calibrated log at scale
1.0, 2 epochs, batch 1024, ``dense_init='torch'``); else null. A model
whose best AUC is more than ``FLAG_AUC`` from rank_tpu's is flagged.

Every region is timed between two points where the host has waited for
the card. Between models the runner and the state are freed and the
allocator's cache emptied, so that each model's peak is its own.

    python -m rank_tpu_torch.fullscale --models all --epochs 2 --calibrated 1.0 \\
        --dense_init torch --json_out RESULTS_fullscale_H100.json

writes the JSON after every model and the table beside it
(``RESULTS_fullscale_H100.md``). Runs go to the card (``--device cuda``,
the default); ``--device cpu`` runs the same code on the CPU.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import tempfile
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from .data.calibrated import make_calibrated_dataset
from .data.synthetic import make_synthetic_dataset
from .features import WECHAT_SCHEMA
from .models import MODEL_CLASSES, default_config
from .models.registry import resolve_device
from .parity import ROOT, card_line, matmul_precision
from .train import TrainConfig, Trainer
from .train.checkpoint import CheckpointManager, export_predictions
from .train.staged import StagedRunner

TRAIN_ROWS = 3_322_313  # the reference's dataset README: rows of days 1-13
EVAL_ROWS = 609_037
# rank_tpu's record and the protocol it was taken under
RANK_TPU_RECORD = "RESULTS_fullscale_r05.json"
PROTOCOL = {"calibrated_scale": 1.0, "epochs": 2, "batch": 1024, "dense_init": "torch"}
FLAG_AUC = 0.01
GIB = 2**30


def _now(device: torch.device) -> float:
    """The host clock once the card has finished what was queued."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return time.perf_counter()


def _allocated_gb(device: torch.device) -> Optional[float]:
    return torch.cuda.memory_allocated(device) / GIB if device.type == "cuda" else None


def _staged_gb(staged: Dict[str, torch.Tensor]) -> float:
    return sum(t.numel() * t.element_size() for t in staged.values()) / GIB


def rank_tpu_record() -> Dict[str, Dict]:
    """rank_tpu's full-scale record: {model: its record}."""
    with open(ROOT / RANK_TPU_RECORD) as f:
        return {r["model"]: r for r in json.load(f)}


def run_one(model_name, train_d, eval_d, epochs, batch, out_root,
            train_rows=TRAIN_ROWS, eval_rows=EVAL_ROWS, dense_init="lecun",
            device="cuda") -> Dict:
    """One model: stage and init, ``epochs`` times train / evaluate / save
    the best, then export the primary head's predictions; returns the
    record (see the module's docstring)."""
    cfg = default_config(model_name, dense_init=dense_init)
    trainer = Trainer(WECHAT_SCHEMA, cfg, TrainConfig(batch_size=batch, log_every=0),
                      device=device)
    dev = trainer.device
    rec = {"model": model_name, "train_rows": train_rows, "eval_rows": eval_rows,
           "batch": batch, "epochs": epochs, "dense_init": dense_init, "device": str(dev)}

    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = _now(dev)
    runner = StagedRunner(trainer, train_d, eval_d, batch)
    state = trainer.init_state()
    rec["t_stage_and_init"] = _now(dev) - t0
    resident = [_allocated_gb(dev)]
    rec["staged_train_gb"] = _staged_gb(runner.train_staged)
    rec["staged_eval_gb"] = _staged_gb(runner.eval_staged)

    model_dir = os.path.join(out_root, model_name, "model")
    output_dir = os.path.join(out_root, model_name, "out")
    mgr = CheckpointManager(model_dir)

    best_auc, epoch_secs, eps, eval_aucs = 0.0, [], [], []
    for e in range(1, epochs + 1):
        t0 = _now(dev)
        state, tr_stats = runner.train_epoch(state, e, 42)
        epoch_secs.append(_now(dev) - t0)
        eps.append(tr_stats["examples_per_s"])
        resident.append(_allocated_gb(dev))
        t0 = _now(dev)
        ev = runner.evaluate(state, e)
        rec["t_eval"] = _now(dev) - t0
        eval_aucs.append(ev["auc"])
        if ev["auc"] > best_auc:
            best_auc = ev["auc"]
            t0 = _now(dev)
            mgr.save_best(trainer.depad_state(state))
            rec["t_save_best"] = _now(dev) - t0
    rec["epoch_secs"] = epoch_secs
    rec["train_examples_per_s"] = eps
    rec["trained_rows_per_epoch"] = int(tr_stats["count"])
    rec["eval_aucs"] = eval_aucs
    rec["eval_auc"] = ev["auc"]
    rec["task_aucs"] = ev["task_aucs"]
    rec["best_auc"] = best_auc

    # the primary head over every valid eval row (the reference's tail,
    # deepfm.py:273-293)
    primary = trainer.primary_head(ev["predictions"])
    mask = ev["valid"] > 0
    label_col = trainer.label_cols.get(primary, trainer.label_cols[cfg.tasks[0]])
    t0 = time.perf_counter()
    path = export_predictions(output_dir, ev["labels"][mask, label_col],
                              ev["predictions"][primary][mask])
    rec["t_export"] = time.perf_counter() - t0
    with open(path) as f:
        rec["predictions_rows"] = sum(1 for _ in f) - 1
    assert rec["predictions_rows"] == eval_rows, rec["predictions_rows"]

    resident.append(_allocated_gb(dev))
    if dev.type == "cuda":
        rec["peak_hbm_gb"] = torch.cuda.max_memory_allocated(dev) / GIB
        rec["resident_hbm_gb"] = max(resident)
        rec["hbm_probe"] = "max_memory_allocated"
    else:
        rec["peak_hbm_gb"] = rec["resident_hbm_gb"] = None
        rec["hbm_probe"] = "none: a CPU run has no device memory to probe"
    # measured after the peak was read: it resets the peak statistics
    ma = runner.step_memory_analysis(state)
    rec["step_temp_gb"] = None if ma is None else ma["temp_gb"]

    rec["card"] = card_line() if dev.type == "cuda" else None
    rec["torch"] = torch.__version__
    rec["matmul_precision"] = matmul_precision()

    del runner, state, trainer
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return rec


def compare_with_rank_tpu(rec: Dict, record: Dict[str, Dict]) -> Dict:
    """Add rank_tpu's eval and best AUC for the same model, the
    differences and the flag, when ``rec`` kept rank_tpu's protocol; else
    null, for a smaller or other run is never compared with the record."""
    protocol = all(rec.get(k) == v for k, v in PROTOCOL.items())
    jax = record.get(rec["model"]) if protocol else None
    rec["protocol"] = protocol
    rec["rank_tpu_eval_auc"] = None if jax is None else jax["eval_auc"]
    rec["rank_tpu_best_auc"] = None if jax is None else jax["best_auc"]
    rec["delta_eval_auc"] = None if jax is None else rec["eval_auc"] - jax["eval_auc"]
    rec["delta_best_auc"] = None if jax is None else rec["best_auc"] - jax["best_auc"]
    rec["flagged"] = None if jax is None else abs(rec["delta_best_auc"]) > FLAG_AUC
    return rec


def _fmt(x, spec: str) -> str:
    return "—" if x is None else format(x, spec)


def render(records: List[Dict]) -> str:
    """The table: one row a model, the port's numbers beside rank_tpu's AUCs."""
    cards = sorted({r["card"] for r in records if r.get("card")})
    lines = [
        "# Full-scale rehearsal on the H100",
        "",
        "The calibrated log at the reference's scale, every model at `default_config`,",
        "`WECHAT_SCHEMA`, through `Trainer` and `StagedRunner`: written by",
        "`python -m rank_tpu_torch.fullscale` (`RESULTS_fullscale_H100.json`).",
        f"Card: {', '.join(cards) or 'none (CPU)'}; torch "
        f"{', '.join(sorted({r['torch'] for r in records}))}. rank_tpu's AUCs are",
        f"`{RANK_TPU_RECORD}`'s (a TPU v5e; its times are not comparable and not shown).",
        f"Δ = port − rank_tpu; flagged: |Δ best| > {FLAG_AUC}. One run a side: not a parity claim.",
        "Epoch seconds and examples/s per epoch; peak: `max_memory_allocated`, GiB.",
        "",
        "| Model | Rows (train / eval) | Epochs | Port eval | Port best | rank_tpu eval | "
        "rank_tpu best | Δ best | Flag | Epoch s | Examples/s | Stage s | Eval s | Export s "
        "| Staged GiB | Peak GiB |",
        "|---|---|---|---|---|---|---|---|---|---|---|---|---|---|---|---|",
    ]
    for r in records:
        flag = {None: "—", True: "**flagged**", False: ""}[r.get("flagged")]
        lines.append(
            f"| {r['model']} | {r['trained_rows_per_epoch']:,} / {r['predictions_rows']:,} "
            f"| {r['epochs']} | {r['eval_auc']:.5f} | {r['best_auc']:.5f} "
            f"| {_fmt(r.get('rank_tpu_eval_auc'), '.5f')} | {_fmt(r.get('rank_tpu_best_auc'), '.5f')} "
            f"| {_fmt(r.get('delta_best_auc'), '+.5f')} | {flag} "
            f"| {' / '.join(f'{s:.1f}' for s in r['epoch_secs'])} "
            f"| {' / '.join(f'{x:,.0f}' for x in r['train_examples_per_s'])} "
            f"| {r['t_stage_and_init']:.1f} | {r['t_eval']:.2f} | {r['t_export']:.2f} "
            f"| {r['staged_train_gb'] + r['staged_eval_gb']:.2f} "
            f"| {_fmt(r['peak_hbm_gb'], '.2f')} |")
    return "\n".join(lines) + "\n"


def build_parser() -> argparse.ArgumentParser:
    """The JAX script's flags and defaults, and ``--device``. Two defaults
    are the port's own: ``--json_out`` (rank_tpu's record is never
    overwritten) and ``--out`` (under the temporary directory, ``TMPDIR``)."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--models", default="dcn,bst,din,mmoe",
                    help="comma list, or 'all' for the full 18-model zoo")
    ap.add_argument("--epochs", type=int, default=1)
    ap.add_argument("--batch", type=int, default=1024)
    ap.add_argument("--out", default=os.path.join(tempfile.gettempdir(), "fullscale"))
    ap.add_argument("--train_rows", type=int, default=TRAIN_ROWS)
    ap.add_argument("--eval_rows", type=int, default=EVAL_ROWS)
    ap.add_argument("--calibrated", type=float, default=0.0,
                    help="use the calibrated log at this scale instead of the latent-factor "
                    "sampler; 1.0 reproduces the reference's per-day row counts (the row "
                    "counts then come from the day-8-13/14 split; --train_rows/--eval_rows "
                    "are ignored)")
    ap.add_argument("--dense_init", default="lecun", choices=("lecun", "torch"))
    ap.add_argument("--json_out", default="RESULTS_fullscale_H100.json")
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    return ap


def load_data(args) -> Dict[str, Dict[str, np.ndarray]]:
    """The train and eval splits ``args`` names; sets ``args.train_rows``
    and ``args.eval_rows`` to the calibrated log's when it is used."""
    if args.calibrated:
        train_d, eval_d, _ = make_calibrated_dataset(scale=args.calibrated)
        args.train_rows = len(train_d["labels"])
        args.eval_rows = len(eval_d["labels"])
        return {"train": train_d, "eval": eval_d}
    data = make_synthetic_dataset(WECHAT_SCHEMA, num_rows=args.train_rows + args.eval_rows,
                                  seed=0)
    return {"train": {k: v[:args.train_rows] for k, v in data.items()},
            "eval": {k: v[args.train_rows:] for k, v in data.items()}}


def main(argv=None) -> List[Dict]:
    args = build_parser().parse_args(argv)
    resolve_device(args.device)  # no card: raise before the data is built
    t0 = time.perf_counter()
    data = load_data(args)
    t_data = time.perf_counter() - t0
    print(f"data ready: {args.train_rows:,} train / {args.eval_rows:,} eval rows in "
          f"{t_data:.1f}s (calibrated={args.calibrated})", flush=True)

    models = sorted(MODEL_CLASSES) if args.models == "all" else args.models.split(",")
    record = rank_tpu_record()
    md_out = os.path.splitext(args.json_out)[0] + ".md"
    results = []
    for m in models:
        print(f"=== {m} ===", flush=True)
        rec = run_one(m, data["train"], data["eval"], args.epochs, args.batch, args.out,
                      args.train_rows, args.eval_rows, args.dense_init, args.device)
        if args.calibrated:
            rec["calibrated_scale"] = args.calibrated
        rec["t_data"] = t_data
        results.append(compare_with_rank_tpu(rec, record))
        print(json.dumps(rec), flush=True)
        with open(args.json_out, "w") as f:
            json.dump(results, f, indent=1)
        with open(md_out, "w") as f:
            f.write(render(results))
    print(f"wrote {args.json_out} and {md_out}")
    return results


if __name__ == "__main__":
    main()
