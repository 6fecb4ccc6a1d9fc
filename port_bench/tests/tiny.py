"""Small versions of the benchmark's cells for the CPU tests: the real
configuration and traffic files with fewer table rows, a shorter history,
fewer rows and lower rates."""

from __future__ import annotations

import copy
import importlib.util
import time
from pathlib import Path

import torch

from port_bench import spec

CPU = torch.device("cpu")


def config(name: str, vocab: int = 64, history: int = 10) -> dict:
    c = copy.deepcopy(spec.config(spec.benchmark(), name))
    for k, (_, dim) in c["schema"]["categorical"].items():
        c["schema"]["categorical"][k] = [3 if k == "device" else vocab, dim]
    c["schema"]["sequence"]["his_read_comment_7d_seq"]["max_len"] = history
    return c


def traffic(name: str) -> dict:
    t = spec.traffic(name)
    if t["driver"] == "train_staged":
        t.update(rows=3000, batch_size=256, profile_steps=3, profile_at=0.2)
    else:
        t.update(rate_per_s=40.0, candidates=[4, 300], min_bucket=16, profile_s=0.3,
                 profile_at=0.2)
    return t


def run_module():
    """``port_bench/run.py`` as a module (it is a script, not a package member)."""
    path = Path(spec.HERE) / "run.py"
    s = importlib.util.spec_from_file_location("port_bench_run", path)
    mod = importlib.util.module_from_spec(s)
    s.loader.exec_module(mod)
    return mod


def run(cell_name: str, seed: int = 2**31 + 12345, seconds: float = 1.0, trace: bool = False,
        limits=None, vocab: int = 64):
    """One tiny run of a cell on the CPU, past the harness's look for a card;
    returns the result's line and the driver's outcome."""
    bench = spec.benchmark()
    cell = spec.workload(bench, cell_name)
    limits = spec.limits(cell_name) if limits is None else limits
    runner = run_module()
    outcome, extra, _ = runner.run_cell(bench, cell, config(cell["config"], vocab),
                                        traffic(cell["traffic"]), seed, seconds, trace,
                                        CPU, time.time())
    info = {"platform": "cpu", "kind": "cpu", "count": 1}
    return runner.result(bench, cell, outcome, extra, trace, info, limits), outcome
