"""Each fault a cell can have, planted in the program underneath a tiny run
on the CPU, makes ``correct`` come out false."""

import numpy as np
import pytest
import torch

from port_bench import spec
from port_bench.tests import tiny

BENCH = spec.benchmark()
TRAIN = [c["name"] for c in BENCH["workloads"]
         if spec.traffic(c["traffic"])["driver"] == "train_staged"]
SERVE = [c["name"] for c in BENCH["workloads"]
         if spec.traffic(c["traffic"])["driver"] == "serve_open_loop"]


def failing(line):
    return {k for k, c in line["checks"].items() if c["value"] > c["limit"]}


@pytest.mark.parametrize("cell", TRAIN)
def test_a_step_that_leaves_the_state_unchanged_fails(cell, monkeypatch):
    monkeypatch.setattr(torch.optim.Adam, "step", lambda self, closure=None: None)
    line, _ = tiny.run(cell)
    assert line["correct"] is False
    assert {"dense_change_gap", "table_change_gap"} <= failing(line)


@pytest.mark.parametrize("cell", TRAIN)
def test_a_step_that_goes_wrong_only_once_warm_fails(cell, monkeypatch):
    """A fault that engages after set-up (as a step captured or fused once
    warm would) shows in the stretch checked after the window alone."""
    real = torch.optim.Adam.step
    warm = spec.traffic(spec.workload(BENCH, cell)["traffic"])
    calls = []

    def step(self, closure=None):
        calls.append(1)
        if len(calls) <= warm["checked_steps"] + warm["warmup_steps"]:
            return real(self, closure)
        return None

    monkeypatch.setattr(torch.optim.Adam, "step", step)
    line, _ = tiny.run(cell)
    assert line["correct"] is False
    bad = failing(line)
    assert {"post_dense_change_gap", "post_table_change_gap"} <= bad
    assert not any(k in bad for k in ("loss_gap", "grad_gap", "dense_change_gap",
                                      "table_change_gap"))


@pytest.mark.parametrize("cell", TRAIN)
def test_an_update_wrong_in_the_tables_alone_fails(cell, monkeypatch):
    """Adam's update halved in the embedding tables and nowhere else: the
    dense leaves move apart only through the later steps' losses."""
    real = torch.optim.Adam.step
    rows = {r for r, _ in tiny.config(spec.workload(BENCH, cell)["config"])
            ["schema"]["categorical"].values()}

    def step(self, closure=None):
        tables = [p for g in self.param_groups for p in g["params"]
                  if p.dim() == 2 and p.shape[0] in rows]
        before = [p.detach().clone() for p in tables]
        out = real(self, closure)
        with torch.no_grad():
            for p, b in zip(tables, before):
                p.copy_(b + 0.5 * (p - b))
        return out

    monkeypatch.setattr(torch.optim.Adam, "step", step)
    line, _ = tiny.run(cell)
    assert line["correct"] is False
    checks = line["checks"]
    assert "table_change_gap" in failing(line)
    assert checks["table_change_gap"]["value"] > 10 * checks["dense_change_gap"]["value"]


@pytest.mark.parametrize("cell", TRAIN)
def test_a_loss_over_half_the_batch_fails(cell, monkeypatch):
    from rank_tpu_torch.train import loop

    real = loop._valid_and_denom

    def half(batch, mesh=None):
        valid, _ = real(batch, mesh)
        valid = valid.clone()
        valid[valid.numel() // 2:] = 0.0
        return valid, torch.clamp_min(valid.sum(), 1.0)

    monkeypatch.setattr(loop, "_valid_and_denom", half)
    line, _ = tiny.run(cell)
    assert line["correct"] is False


@pytest.mark.parametrize("cell", SERVE)
def test_an_answer_altered_where_it_is_produced_fails(cell, monkeypatch):
    from rank_tpu_torch.serve import Predictor

    real = Predictor.__call__
    calls = []

    def altered(self, batch):
        out = real(self, batch)
        calls.append(1)
        if len(calls) == 30:  # past the warm-up calls, inside the window
            out["score"][-1] += 0.01
        return out

    monkeypatch.setattr(Predictor, "__call__", altered)
    line, _ = tiny.run(cell)
    assert line["correct"] is False


@pytest.mark.parametrize("cell", SERVE)
def test_half_of_a_request_left_unscored_fails(cell, monkeypatch):
    from rank_tpu_torch.serve import Predictor

    real = Predictor.__call__

    def half(self, batch):
        n = next(iter(batch.values())).shape[0]
        out = real(self, {k: v[: max(1, n // 2)] for k, v in batch.items()})
        return {k: np.concatenate([v, np.zeros(n - v.shape[0], v.dtype)]) for k, v in out.items()}

    monkeypatch.setattr(Predictor, "__call__", half)
    line, _ = tiny.run(cell)
    assert line["correct"] is False


def test_a_request_that_raises_counts_as_failed(monkeypatch):
    from rank_tpu_torch.serve import Predictor

    real = Predictor.__call__
    calls = []

    def flaky(self, batch):
        calls.append(1)
        if len(calls) == 30:
            raise RuntimeError("planted")
        return real(self, batch)

    monkeypatch.setattr(Predictor, "__call__", flaky)
    line, _ = tiny.run(SERVE[0])
    assert line["correct"] is False and line["failed"] == 1
