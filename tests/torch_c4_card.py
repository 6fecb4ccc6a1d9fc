"""C4's card arms: the port alone on the card.

``--protocol calib`` splits the arm by kernel: the port under the
calibrated protocol (``parity.calib_config`` on ``parity.calibrated_data
(0.05)``, 3 epochs), with the model's ``kernel_backend`` set, so that a
model whose hand kernels run on its path (B1 for DIN, B2 for xDeepFM) is
trained once through them (``auto``) and once through their plain
versions (``jnp``) at the same seeds. Both runs of a seed draw the same
initial weights, epoch orders and dropout masks from the same generators,
so their difference is the kernels' arithmetic. Imports only the port; not
collected by pytest. On a machine with a CUDA card:

    python tests/torch_c4_card.py --models din --seeds 42-61 \\
        --kernel_backends auto,jnp --json_out C4_ARMS_H100_kernels.jsonl

One JSON line a run, in ``rank_tpu_torch.parity``'s record format plus
``kernel_backend``; ``tests/torch_c4_arms.py table`` reads them as the arms
``P_card_auto`` and ``P_card_jnp``.

``--protocol fullscale`` runs ``tests/torch_c4_arms.py``'s full-scale
protocol (``fullscale.run_one``'s config, ``default_config(m,
dense_init='torch')``, batch 1024, 2 epochs on the calibrated log at scale
1.0, the shuffle seeded with the run's seed, the best eval AUC of the
epochs), the log built once a call:

    python tests/torch_c4_card.py --protocol fullscale --models widedeep \\
        --seeds 42-61 --json_out C4_ARMS_H100_fullscale.jsonl

``table`` reads those lines as the arm ``P_card`` of the ``fullscale``
protocol.
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from rank_tpu_torch import WECHAT_SCHEMA, parity  # noqa: E402
from rank_tpu_torch.models import default_config  # noqa: E402
from rank_tpu_torch.train import TrainConfig, Trainer  # noqa: E402
from rank_tpu_torch.train.staged import StagedRunner  # noqa: E402

FULLSCALE = 1.0
FULLSCALE_EPOCHS = 2


def run(model: str, seed: int, backend: str, data, device: str) -> dict:
    model_cfg, train_cfg = parity.calib_config(model, seed)
    model_cfg = model_cfg.replace(kernel_backend=backend)
    t0 = time.perf_counter()
    trainer = Trainer(WECHAT_SCHEMA, model_cfg, train_cfg, device=device)
    result = parity.train_and_evaluate(trainer, data, parity.EPOCHS)
    return {
        "matrix": "calib", "model": model, "seed": seed, "scale": data.size,
        "epochs": parity.EPOCHS, "batch_size": train_cfg.batch_size,
        "protocol": data.size == parity.CALIB_SCALE,
        "kernel_backend": backend, "device": str(trainer.device),
        "port": result["auc"], "task_aucs": result["task_aucs"],
        "t_port_s": time.perf_counter() - t0,
        "card": parity.card_line() if trainer.device.type == "cuda" else None,
        "torch": torch.__version__, "matmul_precision": parity.matmul_precision(),
    }


def run_fullscale(model: str, seed: int, data, device: str) -> dict:
    """One run of the full-scale protocol: the best eval AUC over the
    epochs, each epoch's eval recorded."""
    model_cfg = default_config(model, dense_init="torch")
    train_cfg = TrainConfig(batch_size=parity.BATCH_SIZE, log_every=0, seed=seed)
    t0 = time.perf_counter()
    trainer = Trainer(WECHAT_SCHEMA, model_cfg, train_cfg, device=device)
    runner = StagedRunner(trainer, data.train, data.eval, parity.BATCH_SIZE)
    state = trainer.init_state()
    evals = []
    for epoch in range(1, FULLSCALE_EPOCHS + 1):
        state, _ = runner.train_epoch(state, epoch, seed)
        ev = runner.evaluate(state, epoch)
        evals.append({"epoch": epoch, "auc": float(ev["auc"]), "loss": float(ev["loss"])})
    return {
        "matrix": "fullscale", "model": model, "seed": seed, "scale": data.size,
        "epochs": FULLSCALE_EPOCHS, "batch_size": parity.BATCH_SIZE,
        "protocol": data.size == FULLSCALE, "device": str(trainer.device),
        "port": max(e["auc"] for e in evals), "evals": evals, "task_aucs": ev["task_aucs"],
        "t_port_s": time.perf_counter() - t0,
        "card": parity.card_line() if trainer.device.type == "cuda" else None,
        "torch": torch.__version__, "matmul_precision": parity.matmul_precision(),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--protocol", choices=("calib", "fullscale"), default="calib")
    ap.add_argument("--models", default="din")
    ap.add_argument("--seeds", default="42-61")
    ap.add_argument("--kernel_backends", default="auto,jnp")
    ap.add_argument("--json_out", default="C4_ARMS_H100_kernels.jsonl")
    ap.add_argument("--cache_dir", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    lo, _, hi = args.seeds.partition("-")
    seeds = range(int(lo), int(hi or lo) + 1)
    fullscale = args.protocol == "fullscale"
    data = parity.calibrated_data(FULLSCALE if fullscale else parity.CALIB_SCALE, args.cache_dir)
    for model in args.models.split(","):
        for seed in seeds:
            if fullscale:
                recs = [run_fullscale(model, seed, data, args.device)]
            else:
                recs = [run(model, seed, backend, data, args.device)
                        for backend in args.kernel_backends.split(",")]
            for rec in recs:
                with open(args.json_out, "a") as f:
                    f.write(json.dumps(rec) + "\n")
                print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
