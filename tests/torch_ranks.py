"""Rank processes for the port's multi-rank tests on the CPU.

``spawn(fn, world, workdir, *args)`` starts ``world`` processes with the
``spawn`` method, one thread each; every rank joins a gloo process group
through a file store in ``workdir`` (no fixed TCP port: several pytest
workers run at once) and calls ``fn(rank, workdir, *args)``. Each rank has
a timeout; a rank that fails, or does not end in time, fails the caller.

The rank functions here import torch, numpy and ``rank_tpu_torch`` only:
the ranks never import JAX. They read their inputs from ``workdir`` and
write their results there.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import pickle

import numpy as np
import torch
import torch.distributed as dist

RANK_TIMEOUT_S = 240


def _entry(fn, rank: int, world: int, workdir: str, args) -> None:
    torch.set_num_threads(1)
    from rank_tpu_torch.parallel import init_distributed

    init_distributed(backend="gloo", init_method=f"file://{workdir}/store", rank=rank,
                     world_size=world, timeout_s=RANK_TIMEOUT_S)
    try:
        fn(rank, workdir, *args)
    finally:
        dist.destroy_process_group()


def spawn(fn, world: int, workdir, *args, timeout_s: float = RANK_TIMEOUT_S) -> None:
    """Run ``fn`` on ``world`` gloo ranks; raise unless every rank exits 0."""
    workdir = str(workdir)
    ctx = torch.multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_entry, args=(fn, rank, world, workdir, args))
             for rank in range(world)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout_s)
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join(10)
    codes = [p.exitcode for p in procs]
    if codes != [0] * world:
        raise RuntimeError(f"{fn.__name__} ranks exited {codes}")


def save(workdir: str, name: str, obj) -> None:
    with open(os.path.join(workdir, name), "wb") as f:
        pickle.dump(obj, f)


def load(workdir: str, name: str):
    with open(os.path.join(workdir, name), "rb") as f:
        return pickle.load(f)


# -- sharded lookups ------------------------------------------------------------

def lookup_rank(rank: int, workdir: str) -> None:
    """Every (table parallelism, mode) case of ``lookup_cases.pkl``: this
    rank's rows looked up through its shard, the loss sum(out * ct), and
    the shard's gradient summed over the data group."""
    from rank_tpu_torch.embedding.sharded import shard_table, sharded_lookup
    from rank_tpu_torch.parallel import DATA_AXIS, make_mesh

    inputs = load(workdir, "lookup_inputs.pkl")
    table = torch.from_numpy(inputs["table"])
    out = {}
    meshes = {t: make_mesh(table_parallelism=t, device="cpu") for t in inputs["parallelism"]}
    for t, mesh in meshes.items():
        d = mesh.shape[DATA_AXIS]
        rows = len(inputs["ids"]) // d
        block = slice(mesh.data_index * rows, (mesh.data_index + 1) * rows)
        ids = torch.from_numpy(inputs["ids"][block])
        ct = torch.from_numpy(inputs["ct"][block])
        for mode in ("psum", "alltoall"):
            shard = shard_table(table, mesh).clone().requires_grad_(True)
            got = sharded_lookup(shard, ids, mesh, mode)
            (got * ct).sum().backward()
            grad = mesh.all_reduce_(shard.grad.clone(), DATA_AXIS)
            out[(t, mode)] = {"data_index": mesh.data_index, "table_index": mesh.table_index,
                              "out": got.detach().numpy(), "grad": grad.numpy()}
    save(workdir, f"lookup_{rank}.pkl", out)


# -- the Trainer on a mesh -------------------------------------------------------

def _trainer(case: dict, mesh, device="cpu"):
    from rank_tpu_torch import default_config, tiny_schema
    from rank_tpu_torch.train import TrainConfig, Trainer

    schema = tiny_schema(vocab=case["vocab"], hist_len=case["hist_len"])
    cfg = default_config(case["model"], **case["overrides"])
    train_cfg = TrainConfig(batch_size=case["batch_size"], log_every=0,
                            table_parallelism=mesh.shape["table"], min_rows_to_shard=16,
                            **case.get("train", {}))
    return Trainer(schema, cfg, train_cfg, device=device, mesh=mesh)


def rank_rows(batch: dict, mesh) -> dict:
    """This rank's block of a global batch: data index i takes rows
    [i B/d, (i+1) B/d), the JAX ``P('data')`` layout."""
    d = mesh.shape["data"]
    n = len(next(iter(batch.values())))
    rows = slice(mesh.data_index * n // d, (mesh.data_index + 1) * n // d)
    return {k: v[rows] for k, v in batch.items()}


def train_case(trainer, case: dict, mesh) -> dict:
    """Load the case's normal-form weights, take a step a batch, and return
    the per-step losses, the normal-form state after the steps and the
    trainer's records."""
    state = trainer.init_state()
    init = {k: torch.from_numpy(v) for k, v in case["init"].items()}
    trainer.commit_state(state, trainer.repad_state({"model": init}, like=state))
    losses = []
    for batch in case["batches"]:
        meters = trainer.meters_init()
        trainer.train_step(state, meters, trainer.to_device(rank_rows(batch, mesh)))
        losses.append(trainer.read_meters(meters)["loss"])
    tree = trainer.depad_state(state)
    result = {
        "losses": losses,
        "model": {k: v.numpy() for k, v in tree["model"].items()},
        "decisions": trainer.shard_decisions,
        "table_padding": trainer.table_padding,
        "sharded_table_names": trainer.sharded_table_names,
    }
    if "mtl" in state:
        result["mtl"] = {k: v.numpy() for k, v in state["mtl"].items()}
    return result, state


def trainer_rank(rank: int, workdir: str) -> None:
    """Every case of ``cases.pkl`` on a (d x t) mesh; rank 0 writes the
    results. Then the checkpoint normal form of the ``dcn`` case: rank 0
    writes its best model and epoch checkpoint (``normal/``) and a padded,
    legacy one (``legacy/``); every rank restores both into a fresh
    trainer and records what it got."""
    from rank_tpu_torch.cli import _restore_normal_form
    from rank_tpu_torch.parallel import make_mesh
    from rank_tpu_torch.train import CheckpointManager

    cases = load(workdir, "cases.pkl")
    mesh = make_mesh(table_parallelism=cases["table_parallelism"], device="cpu")
    results, states = {}, {}
    for name, case in cases["cases"].items():
        trainer = _trainer(case, mesh)
        results[name], states[name] = train_case(trainer, case, mesh)

    case = cases["cases"]["dcn"]
    trainer, state = _trainer(case, mesh), states["dcn"]
    normal = CheckpointManager(os.path.join(workdir, "normal"))
    normal.save_best(trainer.depad_state(state))
    normal.save_epoch(trainer.depad_state(state), 1, {"eval_auc": 0.5, "best_auc": 0.5})
    legacy = CheckpointManager(os.path.join(workdir, "legacy"))
    legacy.save_best(trainer._full_state(state))

    want = trainer.depad_state(state)
    restored = {}
    for what, load_tree in (
        ("epoch", lambda: normal.load_epoch(1, "cpu")),
        ("legacy", lambda: {"model": legacy.load_best_state_dict("cpu")}),
    ):
        fresh = _trainer(case, mesh)
        fresh_state = fresh.init_state()
        printed = io.StringIO()
        with contextlib.redirect_stdout(printed):
            fresh_state = _restore_normal_form(fresh, fresh_state, what, load_tree)
        got = fresh.depad_state(fresh_state)
        restored[what] = {
            "max_diff": max(float((got["model"][k] - v).abs().max()) for k, v in want["model"].items()),
            "printed": printed.getvalue(),
            "step": int(fresh_state["step"]),
        }
        if what == "epoch":
            # the restored state trains on
            meters = fresh.meters_init()
            fresh.train_step(fresh_state, meters, fresh.to_device(rank_rows(case["batches"][0], mesh)))
            restored[what]["next_loss"] = fresh.read_meters(meters)["loss"]
            moments = [m for m in got["optimizer"]["state"].values()]
            restored[what]["moments_rows"] = sorted({tuple(m["exp_avg"].shape) for m in moments})
    if rank == 0:
        save(workdir, "trainer_results.pkl", {"cases": results, "restored": restored})


# -- the CLI on ranks -------------------------------------------------------------

def cli_rank(rank: int, workdir: str, argv) -> None:
    """``rank_tpu_torch.cli.main(argv)`` on this rank; its output and exit
    code go to ``cli_<rank>.json``."""
    from rank_tpu_torch import cli

    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        rc = cli.main(list(argv))
    with open(os.path.join(workdir, f"cli_{rank}.json"), "w") as f:
        json.dump({"rc": rc, "stdout": printed.getvalue()}, f)


# -- staged shuffles --------------------------------------------------------------

_COLLECTIVES = ("all_reduce", "all_to_all_single", "all_gather", "all_gather_object",
                "broadcast", "all_gather_into_tensor", "reduce_scatter_tensor", "barrier")


@contextlib.contextmanager
def count_collectives(calls: dict):
    """Count the calls of ``torch.distributed``'s collectives meanwhile."""
    saved = {name: getattr(dist, name) for name in _COLLECTIVES}

    def counted(name, fn):
        def wrapper(*args, **kwargs):
            calls[name] = calls.get(name, 0) + 1
            return fn(*args, **kwargs)
        return wrapper

    for name, fn in saved.items():
        setattr(dist, name, counted(name, fn))
    try:
        yield calls
    finally:
        for name, fn in saved.items():
            setattr(dist, name, fn)


def staged_rank(rank: int, workdir: str) -> None:
    """Both shuffle modes of ``StagedRunner`` on the data shard of
    ``staged_inputs.pkl`` (a ``rowid`` column names each row): the staged
    rows, each epoch's order and the collectives each shuffle called, and
    one trained epoch's valid count."""
    from rank_tpu_torch import default_config, tiny_schema
    from rank_tpu_torch.data.loader import shard_for_process
    from rank_tpu_torch.parallel import make_mesh
    from rank_tpu_torch.train import TrainConfig, Trainer
    from rank_tpu_torch.train.staged import StagedRunner

    inputs = load(workdir, "staged_inputs.pkl")
    mesh = make_mesh(device="cpu")
    d = mesh.shape["data"]
    shard = shard_for_process(inputs["data"], mesh.data_index, d)
    trainer = Trainer(tiny_schema(), default_config("dcn", hidden_units=(8,), num_cross_layers=1),
                      TrainConfig(batch_size=inputs["batch_size"], log_every=0), device="cpu",
                      mesh=mesh)
    out = {}
    for mode in ("global", "local"):
        runner = StagedRunner(trainer, shard, shard, inputs["batch_size"] // d, shuffle_mode=mode)
        staged = runner.train_staged["rowid"].clone()
        epochs, calls = {}, {}
        for epoch in (1, 2, 3):
            calls[epoch] = {}
            with count_collectives(calls[epoch]):
                shuffled = runner.shuffled(epoch, seed=42)
            epochs[epoch] = {"rowid": shuffled["rowid"].numpy(),
                             "valid": shuffled["_valid"].numpy()}
        state = trainer.init_state()
        _, stats = runner.train_epoch(state, 4, seed=42)
        out[mode] = {"staged": staged.numpy(), "interleaved": runner.train_staged["rowid"].numpy(),
                     "steps": runner.train_steps, "epochs": epochs, "calls": calls,
                     "trained_count": stats["count"]}
    save(workdir, f"staged_{rank}.pkl", out)
