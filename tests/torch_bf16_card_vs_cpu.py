"""Measure how far the card's bf16 Predictor lies from the CPU's, the
evidence for ``chip_smoke.py``'s ``BF16_CARD_VS_CPU_ATOL`` check and its
reference (``card_arithmetic_on_cpu``). Imports only the port; not
collected by pytest. On a machine with a CUDA card, from the repository
root:

    python tests/torch_bf16_card_vs_cpu.py [runs]

Each run trains DIN as ``chip_smoke.py``'s phase 4l does (the feedid table
and the history 128 wide, one epoch on 50,000 synthetic rows; the card's
training is not bit-reproducible, so each run's weights differ a little),
then serves 5,000 rows with the trained weights. It prints one JSON line a
run, the largest absolute gap between:

  * ``card_bf16_vs_cpu_card_arith``: the card's bf16 Predictor and the
    CPU's with B1 and B2 computed as on the card (f32 on the bf16 inputs),
    the pair the smoke holds to ``BF16_CARD_VS_CPU_ATOL``;
  * ``card_bf16_vs_cpu_plain_bf16``: the card's bf16 Predictor and the
    CPU's with the plain versions in bf16 (rank_tpu's jnp path);
  * ``card_plain_bf16_vs_cpu_plain_bf16``: the card's bf16 Predictor with
    ``kernel_backend='jnp'`` and the CPU's with the plain versions in bf16;
  * ``*_vs_f32``: each bf16 Predictor and the card's f32 one.
"""

import json
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as smoke  # noqa: E402

REQUEST_ROWS = 5000


def run_once(schema, cfg, train, test, request) -> dict:
    trainer = smoke.Trainer(schema, cfg, smoke.TrainConfig(batch_size=smoke.parity.BATCH_SIZE,
                                                           log_every=0), device="cuda")
    runner = smoke.StagedRunner(trainer, train, test, smoke.parity.BATCH_SIZE)
    state, stats = runner.train_epoch(trainer.init_state(), 1, trainer.cfg.seed)
    sd = state["model"].state_dict()

    def bf16(device="cuda", backend="auto"):
        return smoke.Predictor(schema, cfg.replace(kernel_backend=backend), state_dict=sd,
                               weights_dtype="bfloat16", device=device)

    cpu = bf16("cpu")
    scores = {"f32": smoke.Predictor(schema, cfg, state_dict=sd)(request),
              "card_bf16": bf16()(request),
              "card_plain_bf16": bf16(backend="jnp")(request),
              "cpu_plain_bf16": cpu(request)}
    with smoke.card_arithmetic_on_cpu():
        scores["cpu_card_arith"] = cpu(request)
    scores = {k: v["score"] for k, v in scores.items()}

    def gap(a, b):
        return float(np.max(np.abs(scores[a] - scores[b])))

    return {"train_loss": float(stats["loss"]),
            "card_bf16_vs_cpu_card_arith": gap("card_bf16", "cpu_card_arith"),
            "card_bf16_vs_cpu_plain_bf16": gap("card_bf16", "cpu_plain_bf16"),
            "card_plain_bf16_vs_cpu_plain_bf16": gap("card_plain_bf16", "cpu_plain_bf16"),
            **{f"{k}_vs_f32": gap(k, "f32")
               for k in ("card_bf16", "cpu_card_arith", "card_plain_bf16", "cpu_plain_bf16")}}


def main(argv) -> int:
    runs = int(argv[0]) if argv else 8
    if not torch.cuda.is_available():
        print("torch_bf16_card_vs_cpu: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    schema = smoke.din_schema(smoke.DIN_WIDE_D, 50)
    cfg = smoke.default_config("din")
    train, test = smoke.split_train_test(
        smoke.make_synthetic_dataset(schema, num_rows=smoke.DIN_ROWS, seed=smoke.SEED + 8))
    data = smoke.make_synthetic_dataset(schema, num_rows=REQUEST_ROWS, seed=smoke.SEED + 9)
    request = {k: v for k, v in data.items() if k != "labels"}
    for run in range(runs):
        print(json.dumps({"run": run, "D": smoke.DIN_WIDE_D, "rows": REQUEST_ROWS,
                          **run_once(schema, cfg, train, test, request),
                          "card": smoke.card_line()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
