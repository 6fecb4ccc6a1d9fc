"""Single config-driven training CLI (port of ``rank_tpu/cli.py``).

    python -m rank_tpu_torch.cli --model=dcn --synthetic=100000 --num_epochs=2

The parser is the JAX CLI's, flag for flag and default for default, plus
``--device`` (default ``cuda``; ``--device=cpu`` runs the plain versions of
the kernels on the CPU). ``main`` trains, evaluates each epoch, saves the
best model on eval AUC and periodic checkpoints, resumes, reloads the best
model and writes ``predictions.csv`` and ``metrics_history.jsonl``.

Data: ``--synthetic=N`` rows. Every flag whose path is not ported yet raises
``NotImplementedError`` naming its ``ROADMAP.md`` item, rather than being
ignored: ``--train_data``/``--eval_data`` (parquet or npz; A12),
``--synthetic_calibrated`` (A12), ``--init_from_reference`` (A11),
``--table_parallelism`` > 1, an ``--embedding_mode`` other than ``gspmd``
and ``--staged_shuffle=local`` (A13), ``--profile_dir`` and
``--matmul_precision`` (A14).

Every model of the JAX registry runs, the multi-task ESMM, MMOE and PLE
with every ``--task_weighting`` (sum, uncertainty, gradnorm, pcgrad;
the last two for mmoe and ple only). Their eval prints each head's AUC;
``predictions.csv`` holds the primary head (the first task's, or ESMM's
``ctr``) against the first task's label, under the name ``--label``, as
the JAX CLI writes it.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from .data.loader import ArrayLoader, num_rows, split_train_test
from .data.synthetic import make_synthetic_dataset
from .features import WECHAT_SCHEMA
from .models import DEFAULT_CONFIGS, default_config
from .train import CheckpointManager, TrainConfig, Trainer, export_predictions
from .train.staged import StagedRunner


def _str2bool(v: str) -> bool:
    return str(v).lower() in ("1", "true", "yes", "y")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="CTR rank-model zoo on PyTorch/CUDA")
    p.add_argument("--model", type=str, required=True,
                   help="a zoo model: afm, autoint, bst, dcn, deepcrossing, deepfm, dien, "
                   "din, esmm, ffm, fibinet, flen, fwfm, mmoe, ple, pnn, widedeep, xdeepfm")
    # data
    p.add_argument("--train_data", type=str, default=None)
    p.add_argument("--eval_data", type=str, default=None)
    p.add_argument("--vocabulary_dir", type=str, default=None)
    p.add_argument("--synthetic", type=int, default=0,
                   help="train on N synthetic rows instead of real data")
    p.add_argument("--synthetic_calibrated", type=float, default=0.0,
                   help="the EDA-calibrated synthetic log at this scale (not ported yet)")
    # reference-named training flags
    p.add_argument("--model_dir", type=str, default="./model_dir")
    p.add_argument("--output_dir", type=str, default="./output_dir")
    p.add_argument("--num_epochs", type=int, default=1)
    p.add_argument("--batch_size", type=int, default=1024)
    p.add_argument("--learning_rate", type=float, default=0.005)
    p.add_argument("--save_checkpoints_steps", type=int, default=1000)
    p.add_argument("--resume", type=_str2bool, default=False)
    p.add_argument("--init_from_reference", type=str, default=None,
                   help="warm-start from a reference best_model.pth (not ported yet)")
    # model hyperparameters (union; reference names)
    p.add_argument("--hidden_units", type=str, default=None)
    p.add_argument("--embedding_dim", type=int, default=None)
    p.add_argument("--dropout_rate", type=float, default=None)
    p.add_argument("--batch_norm", type=_str2bool, default=None)
    p.add_argument("--activation", type=str, default=None)
    p.add_argument("--use_softmax", type=_str2bool, default=None)
    p.add_argument("--l2_lambda", type=float, default=None)
    p.add_argument("--mini_batch_aware_regularization", type=_str2bool, default=None)
    p.add_argument("--num_cross_layer", type=int, default=None)
    p.add_argument("--cross_frozen_random", type=_str2bool, default=None)
    p.add_argument("--residual_internal_dim", type=int, default=None)
    p.add_argument("--residual_network_num", type=int, default=None)
    p.add_argument("--attention_factor", type=int, default=None)
    p.add_argument("--nhead", type=int, default=None)
    p.add_argument("--num_transformer_blocks", type=int, default=None)
    p.add_argument("--attn_impl", type=str, default=None, choices=("vpu", "vpu2", "einsum"))
    p.add_argument("--pooling_method", type=str, default=None)
    p.add_argument("--tasks", type=str, default=None, help="comma list for multi-task models")
    p.add_argument("--task_weighting", type=str, default=None,
                   choices=("sum", "uncertainty", "gradnorm", "pcgrad"))
    p.add_argument("--gradnorm_alpha", type=float, default=None)
    p.add_argument("--gradnorm_lr", type=float, default=None)
    p.add_argument("--autoint_layers", type=int, default=None)
    p.add_argument("--autoint_heads", type=int, default=None)
    p.add_argument("--autoint_att_dim", type=int, default=None)
    # parallelism / performance
    p.add_argument("--table_parallelism", type=int, default=1)
    p.add_argument("--embedding_mode", type=str, default=None,
                   choices=("gspmd", "psum", "alltoall"))
    p.add_argument("--label", type=str, default="read_comment")
    p.add_argument("--profile_dir", type=str, default=None)
    p.add_argument("--gradient_clip_norm", type=float, default=0.0)
    p.add_argument("--matmul_precision", type=str, default=None,
                   choices=("bfloat16", "float32", "highest"))
    p.add_argument("--multihot_tags", type=_str2bool, default=None)
    p.add_argument("--dense_init", type=str, default=None, choices=("lecun", "torch"))
    p.add_argument("--embedding_init", type=str, default=None,
                   choices=("normal", "normal_small", "truncated_normal", "xavier_uniform"))
    p.add_argument("--device_resident", type=_str2bool, default=True,
                   help="stage each split on the device once and slice every "
                   "step from it (train/staged.py); false streams numpy batches")
    p.add_argument("--staged_shuffle", choices=("global", "local"), default="global",
                   help="epoch shuffle on the staged path: one uniform "
                   "permutation over all rows ('local' is not ported yet)")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device; 'cpu' runs the kernels' plain versions")
    return p


_CFG_MAP = {
    "hidden_units": lambda v: tuple(int(x) for x in v.split(",")),
    "embedding_dim": int,
    "dropout_rate": float,
    "batch_norm": bool,
    "activation": str,
    "use_softmax": bool,
    "l2_lambda": float,
    "mini_batch_aware_regularization": bool,
    "attention_factor": int,
    "num_transformer_blocks": int,
    "attn_impl": str,
    "pooling_method": str,
    "residual_internal_dim": int,
    "multihot_tags": bool,
    "tasks": lambda v: tuple(v.split(",")),
    "task_weighting": str,
    "gradnorm_alpha": float,
    "gradnorm_lr": float,
    "autoint_layers": int,
    "autoint_heads": int,
    "autoint_att_dim": int,
    "embedding_mode": str,
    "dense_init": str,
    "embedding_init": str,
    "cross_frozen_random": bool,
}


def model_config_from_args(args):
    if args.model not in DEFAULT_CONFIGS:
        raise SystemExit(f"unknown model {args.model!r}; available: {sorted(DEFAULT_CONFIGS)}")
    overrides = {}
    for k, conv in _CFG_MAP.items():
        v = getattr(args, k, None)
        if v is not None:
            overrides[k] = conv(v) if not isinstance(v, (bool, int, float, tuple)) else v
    if args.num_cross_layer is not None:
        overrides["num_cross_layers"] = args.num_cross_layer
    if args.residual_network_num is not None:
        overrides["num_residual_units"] = args.residual_network_num
    if args.nhead is not None:
        overrides["num_heads"] = args.nhead
    return default_config(args.model, **overrides)


def _refuse_unported(args) -> None:
    """Raise for every asked-for path the port does not have yet."""
    unported = [
        (args.train_data or args.eval_data,
         "--train_data/--eval_data (parquet and npz loading; ROADMAP A12)"),
        (args.synthetic_calibrated, "--synthetic_calibrated (ROADMAP A12)"),
        (args.init_from_reference, "--init_from_reference (ROADMAP A11)"),
        (args.table_parallelism > 1, "--table_parallelism > 1 (ROADMAP A13)"),
        (args.embedding_mode not in (None, "gspmd"),
         f"--embedding_mode={args.embedding_mode} (ROADMAP A13)"),
        (args.staged_shuffle == "local", "--staged_shuffle=local (ROADMAP A13)"),
        (args.profile_dir, "--profile_dir (ROADMAP A14)"),
        (args.matmul_precision, "--matmul_precision (ROADMAP A14)"),
    ]
    for asked, what in unported:
        if asked:
            raise NotImplementedError(f"{what} is not ported to rank_tpu_torch yet")


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if not (args.synthetic or args.synthetic_calibrated) and not (
        args.train_data and args.eval_data and args.vocabulary_dir
    ):
        print("need --train_data/--eval_data/--vocabulary_dir or --synthetic=N", file=sys.stderr)
        return 2
    model_cfg = model_config_from_args(args)
    _refuse_unported(args)

    schema = WECHAT_SCHEMA
    data = make_synthetic_dataset(schema, num_rows=args.synthetic)
    train_data, eval_data = split_train_test(data, test_fraction=0.15)

    train_cfg = TrainConfig(
        model_dir=args.model_dir,
        output_dir=args.output_dir,
        num_epochs=args.num_epochs,
        batch_size=args.batch_size,
        learning_rate=args.learning_rate,
        save_checkpoints_steps=args.save_checkpoints_steps,
        label=args.label,
        gradient_clip_norm=args.gradient_clip_norm,
    )
    trainer = Trainer(schema, model_cfg, train_cfg, device=args.device)
    bs = train_cfg.batch_size
    runner = StagedRunner(trainer, train_data, eval_data, bs) if args.device_resident else None
    state = trainer.init_state()
    mgr = CheckpointManager(args.model_dir)

    start_epoch = 1
    best_auc = 0.0
    if args.resume and mgr.latest_epoch() is not None:
        epoch = mgr.latest_epoch()
        state, _ = mgr.restore_epoch(state, epoch)
        start_epoch = epoch + 1
        best_auc = mgr.epoch_metrics(epoch).get("best_auc", 0.0)
        print(f"resumed from checkpoint_epoch_{epoch} (best_auc={best_auc:.4f})")

    # streaming loaders keep the remainder batch (padded, with _valid)
    train_batches = -(-num_rows(train_data) // bs)
    eval_batches = -(-num_rows(eval_data) // bs)

    def run_eval(epoch):
        if runner is not None:
            return runner.evaluate(state, epoch)
        loader = ArrayLoader(eval_data, bs, drop_remainder=False, num_batches=eval_batches)
        return trainer.evaluate(state, loader, epoch)

    os.makedirs(args.output_dir, exist_ok=True)
    history_path = os.path.join(args.output_dir, "metrics_history.jsonl")

    for epoch in range(start_epoch, args.num_epochs + 1):
        if runner is not None:
            state, train_stats = runner.train_epoch(state, epoch, train_cfg.seed)
        else:
            loader = ArrayLoader(
                train_data, bs, shuffle=True, seed=train_cfg.seed + epoch,
                drop_remainder=False, num_batches=train_batches,
            )
            state, train_stats = trainer.train_epoch(state, loader, epoch)
        stats = run_eval(epoch)
        with open(history_path, "a") as f:
            f.write(json.dumps({
                "epoch": epoch,
                "train_loss": train_stats["loss"],
                "train_auc": train_stats["auc"],
                "train_examples_per_s": train_stats["examples_per_s"],
                "eval_loss": stats["loss"],
                "eval_auc": stats["auc"],
                "eval_task_aucs": stats["task_aucs"],
            }) + "\n")
        if stats["auc"] > best_auc:
            best_auc = stats["auc"]
            mgr.save_best(state)
            print(f"Model saved at epoch {epoch} with best AUC: {best_auc:.4f}")
        if epoch % args.save_checkpoints_steps == 0:
            mgr.save_epoch(state, epoch, {"eval_auc": stats["auc"], "best_auc": best_auc})

    # reload the best model, export its predictions
    if mgr.has_best():
        state = mgr.restore_best(state)
    stats = run_eval(args.num_epochs)
    primary = trainer.primary_head(stats["predictions"])
    # ESMM's primary head "ctr" predicts the first task's label
    label_col = (trainer.label_cols[primary] if primary in trainer.label_cols
                 else trainer.label_cols[model_cfg.tasks[0]])
    mask = stats["valid"] > 0
    path = export_predictions(
        args.output_dir,
        stats["labels"][mask, label_col],
        stats["predictions"][primary][mask],
        label_name=args.label,
    )
    print(f"Predictions saved to {path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
