"""Whole training runs of the port held against rank_tpu's, with the three
sources of difference between them split apart (``ROADMAP.md`` C4): the
initial draw, the epoch order, and the arithmetic of a whole run. Not
collected by pytest; it imports both packages and runs on the CPU.

Arms (one run each, a seed fixes the data's draws on each side):

  * ``J``: rank_tpu's ``Trainer`` and ``StagedRunner``, as
    ``scripts/parity_check.py:train_ours`` runs them;
  * ``P``: the port alone (its own initial draw, its own epoch order);
  * ``X``: the port's arithmetic from rank_tpu's initial state
    (``torch_jax_carry.load_jax_state``) on rank_tpu's epoch order
    (``torch_jax_carry.JaxOrderRunner``);
  * ``XI``: rank_tpu's initial state on the port's own order;
  * ``XO``: the port's own initial draw on rank_tpu's order;
  * ``J0`` and ``X0``: ``J`` and ``X`` at ``dropout_rate=0`` (the two
    frameworks draw their own dropout masks, which loosens X − J);
  * ``XG_<group>``: the port's own initial draw with rank_tpu's carried in
    for one leaf group (``LEAF_GROUPS``: tables, dense, interaction,
    tower, output) on rank_tpu's order; held against ``XO``, it names the
    group that carries an initial draw's lean.

Protocols: ``calib`` (``parity.calib_config`` on ``parity.calibrated_data
(0.05)``, 3 epochs, the eval AUC), ``mtl`` (``parity.mtl_config(model,
'sum', ...)`` on ``parity.mtl_data()``, 3 epochs, the mean of the task
AUCs) and ``fullscale`` (``fullscale.run_one``'s and
``scripts/fullscale_rehearsal.py:run_one``'s config, ``default_config(m,
dense_init='torch')``, batch 1024, 2 epochs, on the calibrated log at scale
1.0; the best eval AUC over the epochs, as both record it). The seed is
``TrainConfig.seed`` and the shuffle's seed on both sides (the rehearsal
scripts shuffle with 42, the default seed).

    PYTHONPATH=$PWD:$PYTHONPATH python tests/torch_c4_arms.py run --protocol calib \\
        --models pnn,dcn --arms J,P,X --seeds 42-61 --workers 8
    PYTHONPATH=$PWD:$PYTHONPATH python tests/torch_c4_arms.py table

``run`` appends one JSON line a run to ``--json_out`` (``C4_ARMS_CPU.jsonl``)
and skips the runs the file already holds; the runs go to ``--workers``
spawned processes of one thread each. ``table`` renders ``C4_ARMS_CPU.md``:
each arm's mean ± sd and the paired contrasts, with the card's runs
(``python -m rank_tpu_torch.parity calib/mtl ... --json_out
C4_ARMS_H100_*.jsonl``, and ``tests/torch_c4_card.py --protocol fullscale``
into ``C4_ARMS_H100_fullscale.jsonl``) as the arm ``P_card``.
"""

import argparse
import concurrent.futures as cf
import dataclasses
import functools
import json
import math
import multiprocessing as mp
import os
import sys
import time

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import jax  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

jax.config.update("jax_platforms", "cpu")

from rank_tpu.features import WECHAT_SCHEMA as JAX_WECHAT_SCHEMA  # noqa: E402
from rank_tpu.models import ModelConfig as JaxModelConfig  # noqa: E402
from rank_tpu.train import TrainConfig as JaxTrainConfig  # noqa: E402
from rank_tpu.train import Trainer as JaxTrainer  # noqa: E402
from rank_tpu.train.staged import StagedRunner as JaxStagedRunner  # noqa: E402
from rank_tpu_torch import WECHAT_SCHEMA, parity  # noqa: E402
from rank_tpu_torch.models import default_config  # noqa: E402
from rank_tpu_torch.models.base import jax_fields  # noqa: E402
from rank_tpu_torch.train import TrainConfig, Trainer  # noqa: E402
from rank_tpu_torch.train.staged import StagedRunner  # noqa: E402
from torch_jax_carry import JaxOrderRunner, jax_initial_state, load_jax_state  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JSON_OUT = "C4_ARMS_CPU.jsonl"
UNTRAINED_OUT = "C4_UNTRAINED_ROWS_CPU.jsonl"
CARD_FILES = ("C4_ARMS_H100_calib.jsonl", "C4_ARMS_H100_mtl.jsonl",
              "C4_ARMS_H100_kernels.jsonl", "C4_ARMS_H100_fullscale.jsonl")


@dataclasses.dataclass(frozen=True)
class Arm:
    framework: str  # "jax" or "port"
    init: str  # whose initial state: "jax", "port", or a leaf group of rank_tpu's
    order: str  # whose epoch order: "jax" or "port"
    dropout0: bool = False


def leaf_group(key: str, tables) -> str:
    """The group of a port state-dict key: the embedding tables, the dense
    features' layers, the tower, the output, or the interaction (the
    rest: cross, product, SENET, CIN, attention, field weights)."""
    if key.rsplit(".", 1)[0] in tables:
        return "tables"
    if key.startswith(("dense_bn", "dense_emb", "dense_layer", "wide_dense")):
        return "dense"
    if any(t in key for t in ("MLPTower", "dnn.", "expert_", "tower_", "gate_", "fcn.",
                              "residual")):
        return "tower"
    if key.startswith(("output", "deep_output", "final_layer", "p.", "Dense_0", "bias")):
        return "output"
    return "interaction"


LEAF_GROUPS = ("tables", "dense", "interaction", "tower", "output")


ARMS = {
    "J": Arm("jax", "jax", "jax"),
    "P": Arm("port", "port", "port"),
    "X": Arm("port", "jax", "jax"),
    "XI": Arm("port", "jax", "port"),
    "XO": Arm("port", "port", "jax"),
    "J0": Arm("jax", "jax", "jax", True),
    "X0": Arm("port", "jax", "jax", True),
    **{f"XG_{g}": Arm("port", g, "jax") for g in LEAF_GROUPS},
}


@dataclasses.dataclass(frozen=True)
class Protocol:
    epochs: int
    every_epoch: bool  # evaluate after each epoch and keep the best
    models: tuple


PROTOCOLS = {
    "calib": Protocol(parity.EPOCHS, False, parity.MODELS),
    "mtl": Protocol(parity.EPOCHS, False, parity.MTL_MODELS),
    "fullscale": Protocol(2, True, parity.MODELS),
}
MTL_WEIGHTING = "sum"
FULLSCALE = 1.0

_DATA = {}


def protocol_data(protocol: str, cache_dir=None) -> parity.Dataset:
    """The protocol's splits, made once a process."""
    if protocol not in _DATA:
        if protocol == "mtl":
            _DATA[protocol] = parity.mtl_data()
        else:
            scale = parity.CALIB_SCALE if protocol == "calib" else FULLSCALE
            _DATA[protocol] = parity.calibrated_data(scale, cache_dir)
    return _DATA[protocol]


def configs(protocol: str, model: str, seed: int):
    """(ModelConfig, TrainConfig) of the port; rank_tpu's are built from
    the same fields."""
    if protocol == "calib":
        return parity.calib_config(model, seed)
    if protocol == "mtl":
        return parity.mtl_config(model, MTL_WEIGHTING, seed)
    return (default_config(model, dense_init="torch"),
            TrainConfig(batch_size=parity.BATCH_SIZE, log_every=0, seed=seed))


def score_of(protocol: str, stats) -> float:
    if protocol == "mtl":
        return float(np.mean(list(stats["task_aucs"].values())))
    return float(stats["auc"])


def run_arm(protocol: str, model: str, arm_name: str, seed: int, cache_dir=None,
            every_epoch: bool = False) -> dict:
    """One run of one arm; returns its record. ``every_epoch`` evaluates
    after every epoch of any protocol (an eval pass leaves the training
    state and the random generators as they were); the score stays the
    protocol's."""
    arm = ARMS[arm_name]
    spec = PROTOCOLS[protocol]
    data = protocol_data(protocol, cache_dir)
    model_cfg, train_cfg = configs(protocol, model, seed)
    if arm.dropout0:
        model_cfg = model_cfg.replace(dropout_rate=0.0)
    bs = train_cfg.batch_size
    t0 = time.perf_counter()

    def jax_trainer():
        return JaxTrainer(JAX_WECHAT_SCHEMA, JaxModelConfig(**jax_fields(model_cfg)),
                          JaxTrainConfig(**dataclasses.asdict(train_cfg)))

    if arm.framework == "jax":
        jtrainer = jax_trainer()
        runner = JaxStagedRunner(jtrainer, data.train, data.eval, bs)
        state = runner.init_state()
        device = str(jax.devices()[0])
    else:
        trainer = Trainer(WECHAT_SCHEMA, model_cfg, train_cfg, device="cpu")
        runner_cls = JaxOrderRunner if arm.order == "jax" else StagedRunner
        runner = runner_cls(trainer, data.train, data.eval, bs)
        state = trainer.init_state()
        if arm.init != "port":
            host = jax.device_get(jax_initial_state(jax_trainer(), data.train, bs))
            if arm.init == "jax":
                load_jax_state(trainer, state, host)
            else:
                carry_group(state["model"], host, arm.init)
        device = str(trainer.device)
    train_losses, evals = [], []
    for epoch in range(1, spec.epochs + 1):
        state, stats = runner.train_epoch(state, epoch, seed)
        train_losses.append(float(stats["loss"]))
        if spec.every_epoch or every_epoch or epoch == spec.epochs:
            ev = runner.evaluate(state, epoch)
            evals.append({"epoch": epoch, "score": score_of(protocol, ev),
                          "auc": float(ev["auc"]), "loss": float(ev["loss"]),
                          "task_aucs": {k: float(v) for k, v in ev["task_aucs"].items()}})
    last = evals[-1]
    record = {
        "protocol": protocol, "model": model, "arm": arm_name, "seed": seed,
        "score": max(e["score"] for e in evals) if spec.every_epoch else last["score"],
        "auc": last["auc"], "task_aucs": last["task_aucs"], "eval_loss": last["loss"],
        "evals": evals, "train_losses": train_losses,
        "dropout_rate": model_cfg.dropout_rate,
        "seconds": time.perf_counter() - t0,
        "jax": jax.__version__, "torch": torch.__version__, "device": device,
    }
    if protocol == "mtl":
        record["weighting"] = MTL_WEIGHTING
    return record


def carry_group(model, host, group: str) -> None:
    """rank_tpu's initial draw of one leaf group into the port's model."""
    from rank_tpu_torch.interop import state_dict_from_flax

    want = state_dict_from_flax(model, {"params": host["params"], **host["extra"]})
    tables = {name for name, m in model.named_modules() if isinstance(m, torch.nn.Embedding)}
    keys = [k for k in model.state_dict() if leaf_group(k, tables) == group]
    if not keys:
        raise ValueError(f"the model has no {group} leaves")
    with torch.no_grad():
        for k, v in model.state_dict().items():
            if k in keys:
                v.copy_(want[k])


def untrained_rows(protocol: str, model: str, seed: int, feature: str = "feedid",
                   cache_dir=None) -> dict:
    """Train arm X, then score the eval split as trained and again with the
    port's own initial draw put into the rows of ``feature``'s tables that
    no train row names (rows that kept their initial values through the
    run). Returns both AUCs, the share of eval rows on such ids and, over
    those rows, the mean initial value of each side's ``wide_<feature>``
    weight where the model has one."""
    data = protocol_data(protocol, cache_dir)
    model_cfg, train_cfg = configs(protocol, model, seed)
    bs = train_cfg.batch_size
    trainer = Trainer(WECHAT_SCHEMA, model_cfg, train_cfg, device="cpu")
    runner = JaxOrderRunner(trainer, data.train, data.eval, bs)
    state = trainer.init_state()
    own = {k: v.clone() for k, v in state["model"].state_dict().items()}
    jtrainer = JaxTrainer(JAX_WECHAT_SCHEMA, JaxModelConfig(**jax_fields(model_cfg)),
                          JaxTrainConfig(**dataclasses.asdict(train_cfg)))
    load_jax_state(trainer, state, jax.device_get(jax_initial_state(jtrainer, data.train, bs)))
    carried = {k: v.clone() for k, v in state["model"].state_dict().items()}
    for epoch in range(1, PROTOCOLS[protocol].epochs + 1):
        state, _ = runner.train_epoch(state, epoch, seed)
    trained = runner.evaluate(state)["auc"]
    unseen = np.setdiff1d(np.arange(int(data.eval[feature].max()) + 1), data.train[feature])
    on_unseen = np.isin(data.eval[feature], unseen)
    keys = [f"{name}.weight" for name, m in state["model"].named_modules()
            if isinstance(m, torch.nn.Embedding) and name.endswith("_" + feature)]
    rows = torch.from_numpy(unseen)
    out = {"protocol": protocol, "model": model, "seed": seed, "feature": feature,
           "tables": keys, "eval_share_on_untrained_ids": float(on_unseen.mean()),
           "auc_trained": float(trained)}
    weights = np.bincount(data.eval[feature][on_unseen], minlength=len(carried[keys[0]]))
    wide = f"wide_{feature}.weight"
    if wide in carried:
        w = torch.from_numpy(weights / weights.sum()).float()
        out["row_weighted_mean_rank_tpu"] = float((w * carried[wide][:, 0]).sum())
        out["row_weighted_mean_port"] = float((w * own[wide][:, 0]).sum())
    with torch.no_grad():
        sd = state["model"].state_dict()
        for k in keys:
            assert torch.equal(sd[k][rows], carried[k][rows]), f"{k}: untrained rows moved"
            sd[k][rows] = own[k][rows]
    out["auc_port_draw_on_untrained_rows"] = float(runner.evaluate(state)["auc"])
    return out


@functools.lru_cache(maxsize=None)
def has_dropout(model: str) -> bool:
    """Whether the model runs any dropout site in train mode."""
    from rank_tpu_torch.models import build_model

    net = build_model(WECHAT_SCHEMA, default_config(model), device="cpu",
                      generator=torch.Generator().manual_seed(0))
    return any(isinstance(m, torch.nn.Dropout) for m in net.modules())


# -- run ---------------------------------------------------------------------


def _init_worker() -> None:
    torch.set_num_threads(1)
    sys.stdout = open(os.devnull, "w")  # the runners' epoch lines


def _job(args):
    """One run, unless another worker has claimed it (several ``run``
    commands may share a ``--json_out``): a claim is a file made with
    O_EXCL in ``<json_out>.claims/``."""
    *run_args, claims, every_epoch = args
    try:
        os.close(os.open(os.path.join(claims, "_".join(map(str, run_args[:4]))),
                         os.O_CREAT | os.O_EXCL))
    except FileExistsError:
        return None
    return run_arm(*run_args, every_epoch=every_epoch)


def read_jsonl(path):
    if not os.path.exists(path):
        return []
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def parse_seeds(text: str):
    seeds = []
    for part in text.split(","):
        lo, _, hi = part.partition("-")
        seeds += list(range(int(lo), int(hi or lo) + 1))
    return seeds


def cmd_run(args) -> int:
    models = args.models.split(",")
    arms = args.arms.split(",")
    unknown = [m for m in models if m not in PROTOCOLS[args.protocol].models]
    unknown += [a for a in arms if a not in ARMS]
    if unknown:
        raise SystemExit(f"unknown {unknown}")
    done = {(r["protocol"], r["model"], r["arm"], r["seed"]) for r in read_jsonl(args.json_out)}
    claims = args.json_out + ".claims"
    os.makedirs(claims, exist_ok=True)
    jobs = [(args.protocol, m, a, s, args.cache_dir, claims, args.every_epoch)
            for s in parse_seeds(args.seeds) for m in models for a in arms
            if (args.protocol, m, a, s) not in done
            and not (ARMS[a].dropout0 and not has_dropout(m))]
    print(f"{len(jobs)} runs to go on {args.workers} workers", flush=True)
    if args.protocol != "mtl":
        protocol_data(args.protocol, args.cache_dir)  # build the log's cache once
        _DATA.clear()  # the workers load it; a full-scale log holds 1.4 GiB
    # one thread a worker: XLA's CPU client and torch's intra-op pools
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                               + " --xla_cpu_multi_thread_eigen=false"
                               " intra_op_parallelism_threads=1").strip()
    os.environ["OMP_NUM_THREADS"] = "1"
    with cf.ProcessPoolExecutor(args.workers, mp_context=mp.get_context("spawn"),
                                initializer=_init_worker) as pool:
        futures = {pool.submit(_job, job): job for job in jobs}
        for fut in cf.as_completed(futures):
            job = futures[fut]
            try:
                rec = fut.result()
            except Exception as exc:  # a run that fails is reported, the others go on
                print(f"FAILED {job[:4]}: {exc!r}", flush=True)
                continue
            if rec is None:
                continue
            with open(args.json_out, "a") as f:
                f.write(json.dumps(rec) + "\n")
            print(f"{rec['protocol']} {rec['model']} {rec['arm']} {rec['seed']}: "
                  f"{rec['score']:.5f} ({rec['seconds']:.0f} s)", flush=True)
    return 0


# -- table -------------------------------------------------------------------

# (name, minuend arm, subtrahend arm, the factor it isolates, paired)
CONTRASTS = (
    ("X − J", "X", "J", "arithmetic", True),
    ("X0 − J0", "X0", "J0", "arithmetic, no dropout", True),
    ("XO − X", "XO", "X", "initial draw", True),
    ("XI − X", "XI", "X", "epoch order", True),
    ("P − XO", "P", "XO", "epoch order", True),
    ("P − J", "P", "J", "all three", False),
    ("P_card − P", "P_card", "P", "the card: its order, masks, arithmetic", True),
    ("P_card − J", "P_card", "J", "the card and all three", False),
    ("P_card_auto − P_card_jnp", "P_card_auto", "P_card_jnp", "hand kernels on the card",
     True),
    ("P_card_jnp − P", "P_card_jnp", "P", "card without the kernels", True),
    *((f"XG_{g} − XO", f"XG_{g}", "XO", f"rank_tpu's {g} draw", True) for g in LEAF_GROUPS),
)


def contrast(a: dict, b: dict, paired: bool):
    """a − b over {seed: score}: paired over the common seeds (the two arms
    share a factor seed by seed), else Welch's. Returns None with fewer
    than two runs."""
    from scipy import stats

    if paired:
        seeds = sorted(set(a) & set(b))
        d = np.array([a[s] - b[s] for s in seeds], np.float64)
        if len(d) < 2:
            return None
        n, delta = len(d), float(d.mean())
        se = float(d.std(ddof=1) / math.sqrt(n))
        df = n - 1
        ns = f"{n}"
    else:
        x, y = np.array(list(a.values()), np.float64), np.array(list(b.values()), np.float64)
        if len(x) < 2 or len(y) < 2:
            return None
        vx, vy = x.var(ddof=1) / len(x), y.var(ddof=1) / len(y)
        delta, se = float(x.mean() - y.mean()), math.sqrt(vx + vy)
        df = (vx + vy) ** 2 / (vx ** 2 / (len(x) - 1) + vy ** 2 / (len(y) - 1))
        ns = f"{len(x)}/{len(y)}"
    t = delta / se if se > 0 else math.inf
    p = float(2 * stats.t.sf(abs(t), df)) if se > 0 else 0.0
    return {"delta": delta, "se": se, "n": ns, "t": t, "df": df, "p": p,
            "flag": abs(delta) > 2 * se}


def card_records(paths):
    """The card's protocol runs as records of the arm ``P_card``, or of
    ``P_card_<kernel_backend>`` (``tests/torch_c4_card.py``)."""
    out = []
    for path in paths:
        for r in read_jsonl(path):
            if not r["protocol"] or r.get("superseded"):
                continue
            protocol = r["matrix"]
            if protocol == "mtl" and r["weighting"] != MTL_WEIGHTING:
                continue
            score = (float(np.mean(list(r["task_aucs"].values()))) if protocol == "mtl"
                     else float(r["port"]))
            arm = f"P_card_{r['kernel_backend']}" if "kernel_backend" in r else "P_card"
            out.append({"protocol": protocol, "model": r["model"], "arm": arm,
                        "seed": r["seed"], "score": score, "card": r["card"],
                        "seconds": r["t_port_s"]})
    return out


def cells(records):
    """{(protocol, model): {arm: {seed: score}}}; a later line of the same
    run wins."""
    out = {}
    for r in records:
        out.setdefault((r["protocol"], r["model"]), {}).setdefault(r["arm"], {})[r["seed"]] = \
            r["score"]
    return out


def chance_flag_rate(df: float) -> float:
    """P(|t| > 2) under no difference, at ``df`` degrees of freedom."""
    from scipy import stats

    return float(2 * stats.t.sf(2.0, df))


def render(records, card_recs, sources) -> str:
    by_cell = cells(records + card_recs)
    arm_order = list(ARMS) + ["P_card", "P_card_auto", "P_card_jnp"]
    order = [(p, m) for p in PROTOCOLS for m in sorted(PROTOCOLS[p].models)]
    lines = [
        "# C4: whole runs of the port against rank_tpu's, the factors split apart\n\n",
        f"Runs: `{'`, `'.join(sources)}` (one JSON line a run). Regenerate with\n"
        "`PYTHONPATH=$PWD:$PYTHONPATH python tests/torch_c4_arms.py table`.\n"
        "Arms: J rank_tpu; P the port alone; X the port from rank_tpu's initial state\n"
        "on rank_tpu's epoch order; XI rank_tpu's initial state on the port's order;\n"
        "XO the port's initial draw on rank_tpu's order; J0/X0 J/X at dropout 0;\n"
        "XG_<group> XO with rank_tpu's draw of one leaf group carried in; P_card the\n"
        "port alone on the card (`rank_tpu_torch.parity`, same seeds, so the same\n"
        "initial draw as P); P_card_auto/P_card_jnp DIN on the card through its hand\n"
        "kernel and through the plain version (`tests/torch_c4_card.py`). Score:\n"
        "calib the eval AUC after 3 epochs, mtl the mean task AUC under `sum`,\n"
        "fullscale the best eval AUC of 2 epochs.\n\n",
        "Seeds: 42–61; also 62–81 for J and X of dcn, deepcrossing and ple, run\n"
        "after their X − J flagged on the way to 20, to check; BST 42–47 and full\n"
        "scale 42–44 (widedeep to 47) only: their runs take 545–2,134 s and\n"
        "190–1,480 s on one thread of the shared 8-core CPU.\n\n",
        "Contrasts: paired over the common seeds where the two arms share a factor\n"
        "seed by seed (SE = sd of the differences / sqrt n, df = n − 1); Welch's\n"
        "where they share none (P − J, P_card − J). p: two-sided t. **flag** at\n"
        "|Δ| > 2·SE, as the parity tables flag.\n\n",
        "## Arms\n\n",
        "| Protocol | Model | " + " | ".join(arm_order) + " |\n",
        "|---|---|" + "---|" * len(arm_order) + "\n",
    ]
    for cell in order:
        arms = by_cell.get(cell)
        if not arms:
            continue
        row = []
        for a in arm_order:
            v = np.array(list(arms.get(a, {}).values()), np.float64)
            if len(v) == 0:
                row.append("")
            else:
                sd = v.std(ddof=1) if len(v) > 1 else 0.0
                row.append(f"{v.mean():.5f} ± {sd:.5f} ({len(v)})")
        lines.append(f"| {cell[0]} | {cell[1]} | " + " | ".join(row) + " |\n")
    lines += ["\nmean ± sd (n runs).\n\n## Contrasts\n\n",
              "| Protocol | Model | Contrast | Factor | Δ | SE | n | Δ/SE | df | p | flag |\n",
              "|---|---|---|---|---|---|---|---|---|---|---|\n"]
    flagged, chance = [], 0.0
    for cell in order:
        arms = by_cell.get(cell)
        if not arms:
            continue
        for name, a, b, factor, paired in CONTRASTS:
            if a not in arms or b not in arms:
                continue
            c = contrast(arms[a], arms[b], paired)
            if c is None:
                continue
            chance += chance_flag_rate(c["df"])
            if c["flag"]:
                flagged.append(f"{cell[0]} {cell[1]} {name}")
            lines.append(
                f"| {cell[0]} | {cell[1]} | {name} | {factor} | {c['delta']:+.5f} | "
                f"{c['se']:.5f} | {c['n']} | {c['t']:+.2f} | {c['df']:.1f} | {c['p']:.3f} | "
                f"{'**flag**' if c['flag'] else ''} |\n")
    lines.append(f"\nFlagged: {', '.join(flagged) or 'none'} ({len(flagged)}; with no "
                 f"difference anywhere, {chance:.1f} of these contrasts would flag by chance "
                 "on average: the sum of P(|t| > 2) at each one's df).\n")
    cards = sorted({r["card"] for r in card_recs})
    if cards:
        lines.append(f"\nP_card runs on {', '.join(cards)} (`nvidia-smi` name and power "
                     "limit, in each line of the card's files).\n")
    envs = sorted({(r["jax"], r["torch"], r["device"]) for r in records})
    lines.append("\nCPU runs: " + "; ".join(f"jax {j}, torch {t}, {d}" for j, t, d in envs)
                 + ".\n")
    rates = ", ".join(f"{chance_flag_rate(df):.3f} at df {df}" for df in (2, 4, 8, 19))
    lines.append(f"\nThe chance of a flag where there is no difference, P(|t| > 2): {rates}.\n")
    return "".join(lines)


def render_untrained(recs) -> str:
    """The ``untrained`` checks: arm X's eval AUC as trained and with the
    port's draw in the rows training never touched."""
    lines = ["\n## Rows that training never touches\n\n",
             f"`python tests/torch_c4_arms.py untrained` (`{UNTRAINED_OUT}`): arm X trained,\n"
             "then scored as trained and with the port's own initial draw put into the\n"
             "rows of the feature's tables that no train row names. Row-weighted mean:\n"
             "the initial wide weight over the eval rows on those ids, each side's draw.\n\n",
             "| Protocol | Model | Seed | Feature | Eval rows on them | AUC as trained | "
             "AUC, port's draw there | Δ | Mean, rank_tpu's draw | Mean, port's draw |\n",
             "|---|---|---|---|---|---|---|---|---|---|\n"]
    for r in recs:
        d = r["auc_port_draw_on_untrained_rows"] - r["auc_trained"]
        lines.append(
            f"| {r['protocol']} | {r['model']} | {r['seed']} | {r['feature']} | "
            f"{r['eval_share_on_untrained_ids']:.4f} | {r['auc_trained']:.5f} | "
            f"{r['auc_port_draw_on_untrained_rows']:.5f} | {d:+.5f} | "
            f"{r.get('row_weighted_mean_rank_tpu', float('nan')):+.3f} | "
            f"{r.get('row_weighted_mean_port', float('nan')):+.3f} |\n")
    return "".join(lines)


def cmd_table(args) -> int:
    records = read_jsonl(args.json_out)
    card_paths = [p for p in args.card.split(",") if p and os.path.exists(p)]
    md = render(records, card_records(card_paths),
                [os.path.basename(args.json_out)] + [os.path.basename(p) for p in card_paths])
    untrained = read_jsonl(os.path.join(os.path.dirname(args.json_out), UNTRAINED_OUT))
    if untrained:
        md += render_untrained(untrained)
    with open(args.md_out, "w") as f:
        f.write(md)
    print(f"wrote {args.md_out}")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="tests/torch_c4_arms.py", description=__doc__.split("\n\n")[0])
    sub = ap.add_subparsers(dest="command", required=True)
    p = sub.add_parser("run", help="run arms of one protocol")
    p.add_argument("--protocol", choices=tuple(PROTOCOLS), required=True)
    p.add_argument("--models", required=True)
    p.add_argument("--arms", default="J,P,X")
    p.add_argument("--seeds", default="42-61", help="e.g. 42-61 or 42,43,50-55")
    p.add_argument("--workers", type=int, default=8)
    p.add_argument("--json_out", default=os.path.join(ROOT, JSON_OUT))
    p.add_argument("--cache_dir", default=None,
                   help="the calibrated log's cache (default: under TMPDIR)")
    p.add_argument("--every_epoch", action="store_true",
                   help="evaluate after every epoch too (the record's evals)")
    p = sub.add_parser("untrained", help="score arm X with the port's draw put into "
                                         "the rows training never touched")
    p.add_argument("--protocol", choices=tuple(PROTOCOLS), default="fullscale")
    p.add_argument("--model", default="widedeep")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--feature", default="feedid")
    p.add_argument("--cache_dir", default=None)
    p.add_argument("--json_out", default=os.path.join(ROOT, UNTRAINED_OUT))
    p = sub.add_parser("table", help="render the arms and contrasts")
    p.add_argument("--json_out", default=os.path.join(ROOT, JSON_OUT))
    p.add_argument("--card", default=",".join(os.path.join(ROOT, f) for f in CARD_FILES))
    p.add_argument("--md_out", default=os.path.join(ROOT, "C4_ARMS_CPU.md"))
    args = ap.parse_args(argv)
    if args.command == "untrained":
        rec = untrained_rows(args.protocol, args.model, args.seed, args.feature, args.cache_dir)
        with open(args.json_out, "a") as f:
            f.write(json.dumps(rec) + "\n")
        print(json.dumps(rec), flush=True)
        return 0
    return cmd_run(args) if args.command == "run" else cmd_table(args)


if __name__ == "__main__":
    sys.exit(main())
