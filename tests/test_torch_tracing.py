"""The port's spans (``rank_tpu_torch/utils/tracing.py``) on the CPU:

  * without a profiler ``span`` returns one shared null context, and no
    call site enters ``record_function``;
  * under a profiler a train step records ``trainer.step`` around its
    forward, backward, optimizer and meters, one each and in that order,
    with the kernels' backward spans inside the backward (xDeepFM, DIN,
    MMOE under PCGrad); ``Predictor.__call__`` records its pad, copy,
    forward and fetch in order; ``StagedRunner.shuffled`` records its
    shuffle; the CLI's ``--profile_dir`` trace holds the trainer's spans;
  * the profiler changes no number: the parameters, Adam's state, the
    meters and the Predictor's scores are bitwise equal with and without it.
"""

import contextlib
import json

import numpy as np
import pytest
import torch

from rank_tpu_torch import default_config, tiny_schema
from rank_tpu_torch.cli import main
from rank_tpu_torch.data.synthetic import make_synthetic_dataset
from rank_tpu_torch.serve import Predictor
from rank_tpu_torch.train import TrainConfig, Trainer
from rank_tpu_torch.train.staged import StagedRunner
from rank_tpu_torch.utils import tracing

STAGES = ("trainer.forward", "trainer.backward", "trainer.optimizer", "trainer.meters")
PREDICTOR = ("predictor.pad", "predictor.h2d", "predictor.forward", "predictor.d2h")
# model, configuration overrides, the span of its kernel's backward
MODELS = {
    "xdeepfm": ("xdeepfm", dict(hidden_units=(16, 8), cin_layer_sizes=(8, 8)), "cin.backward"),
    "din": ("din", dict(hidden_units=(16, 8)), "din_attention.backward"),
    "mmoe_pcgrad": ("mmoe", dict(task_weighting="pcgrad"), None),
}


def _trainer(case: str):
    model, overrides, _ = MODELS[case]
    return Trainer(tiny_schema(), default_config(model, **overrides),
                   TrainConfig(log_every=0, batch_size=32), device="cpu")


def _rows(rows: int, seed: int):
    data = make_synthetic_dataset(tiny_schema(), num_rows=rows, seed=seed)
    data["_valid"] = np.ones(rows, np.float32)
    return data


def _request(rows: int = 5):
    return {k: v for k, v in _rows(rows, 9).items() if k not in ("labels", "_valid")}


def _predictor(trainer, state):
    return Predictor(tiny_schema(), trainer.model_cfg, state_dict=state["model"].state_dict(),
                     min_bucket=16, device="cpu")


def _spans(prof, name: str):
    return [e for e in prof.events() if e.name == tracing.PREFIX + name]


def _inside(e, outer) -> bool:
    return outer.time_range.start <= e.time_range.start and \
        e.time_range.end <= outer.time_range.end


def test_span_without_a_profiler_never_enters_record_function(monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) entered without a profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert not torch.autograd.profiler._is_profiler_enabled
    assert tracing.span("a") is tracing.span("b")
    assert isinstance(tracing.span("a"), contextlib.nullcontext)
    with tracing.span("a"):
        pass
    trainer = _trainer("xdeepfm")
    state = trainer.init_state()
    trainer.train_step(state, trainer.meters_init(), trainer.to_device(_rows(32, 1)))
    assert _predictor(trainer, state)(_request())["score"].shape == (5,)
    StagedRunner(trainer, _rows(64, 2), _rows(16, 3), 32).shuffled(1, 0)


@pytest.mark.parametrize("case", sorted(MODELS))
def test_train_step_records_its_stages_inside_the_step(case):
    trainer = _trainer(case)
    state = trainer.init_state()
    batch = trainer.to_device(_rows(32, 1))
    with torch.profiler.profile() as prof:
        trainer.train_step(state, trainer.meters_init(), batch)
    (step,) = _spans(prof, "trainer.step")
    stages = [_spans(prof, s) for s in STAGES]
    assert [len(s) for s in stages] == [1] * len(STAGES)
    stages = [s for (s,) in stages]
    assert all(_inside(s, step) for s in stages)
    assert all(a.time_range.end <= b.time_range.start for a, b in zip(stages, stages[1:]))
    kernel = MODELS[case][2]
    if kernel is not None:
        backward = _spans(prof, kernel)
        assert backward and all(_inside(b, stages[1]) for b in backward)


def test_predictor_records_pad_copy_forward_fetch_in_order():
    trainer = _trainer("din")
    predictor = _predictor(trainer, trainer.init_state())
    with torch.profiler.profile() as prof:
        predictor(_request())
    (call,) = _spans(prof, "predictor.call")
    parts = [_spans(prof, s) for s in PREDICTOR]
    assert [len(p) for p in parts] == [1] * len(PREDICTOR)
    parts = [p for (p,) in parts]
    assert all(_inside(p, call) for p in parts)
    assert all(a.time_range.end <= b.time_range.start for a, b in zip(parts, parts[1:]))


def test_staged_shuffle_records_its_span():
    runner = StagedRunner(_trainer("xdeepfm"), _rows(64, 2), _rows(16, 3), 32)
    with torch.profiler.profile() as prof:
        runner.shuffled(1, 0)
    assert len(_spans(prof, "staged.shuffle")) == 1


@pytest.mark.parametrize("case", ["xdeepfm", "din"])
def test_the_profiler_changes_no_number(case):
    """Two steps (dropout on) and a padded request, once under the profiler
    and once without: every number bitwise equal."""
    runs = []
    for profiled in (False, True):
        trainer = _trainer(case)
        state, meters = trainer.init_state(), trainer.meters_init()
        torch.manual_seed(5)
        with torch.profiler.profile() if profiled else contextlib.nullcontext():
            for seed in (1, 2):
                trainer.train_step(state, meters, trainer.to_device(_rows(32, seed)))
            scores = _predictor(trainer, state)(_request())["score"]
        adam = state["optimizer"].state_dict()["state"]
        runs.append((state["model"].state_dict(), adam, meters, scores))
    (params, adam, meters, scores), (params_p, adam_p, meters_p, scores_p) = runs
    assert all(torch.equal(params[k], params_p[k]) for k in params)
    assert adam.keys() == adam_p.keys()
    assert all(torch.equal(torch.as_tensor(adam[i][k]), torch.as_tensor(adam_p[i][k]))
               for i in adam for k in adam[i])
    assert all(torch.equal(meters[k], meters_p[k]) for k in meters)
    np.testing.assert_array_equal(scores, scores_p)


def test_profile_dir_trace_holds_the_trainer_spans(tmp_path):
    assert main(["--model=xdeepfm", "--synthetic=600", "--batch_size=128", "--device=cpu",
                 "--hidden_units=16,8", f"--model_dir={tmp_path}/m", f"--output_dir={tmp_path}/o",
                 f"--profile_dir={tmp_path}/trace"]) == 0
    with open(tmp_path / "trace" / "trace_rank0.json") as f:
        names = [e.get("name", "") for e in json.load(f)["traceEvents"]]
    steps = names.count(tracing.PREFIX + "trainer.step")
    assert steps >= 2
    assert [names.count(tracing.PREFIX + s) for s in STAGES] == [steps] * len(STAGES)
    assert names.count(tracing.PREFIX + "cin.backward") == 2 * steps
