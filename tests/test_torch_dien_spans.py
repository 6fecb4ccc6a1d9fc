"""The recurrence's span and counter (``rank_tpu_torch/ops/rnn.py``) on the
CPU, in DIEN:

  * under a profiler one train step records ``rnn.gru`` then ``rnn.augru``,
    once each, inside ``trainer.forward``; without one, neither;
  * ``AttentionalGRU.steps`` grows by 2 T a forward, T the history's length;
  * the profiler changes no number: parameters and Adam's state are bitwise
    equal with and without it;
  * a serving artifact exported without a profiler holds no profiler op,
    though the span opens inside the GRU's forward.
"""

import contextlib

import numpy as np
import torch

from rank_tpu_torch import default_config, tiny_schema
from rank_tpu_torch.data.synthetic import make_synthetic_dataset
from rank_tpu_torch.ops.rnn import AttentionalGRU
from rank_tpu_torch.serve import Predictor, export_serving_artifact
from rank_tpu_torch.train import TrainConfig, Trainer
from rank_tpu_torch.utils import tracing

RNN = ("rnn.gru", "rnn.augru")


def _trainer():
    return Trainer(tiny_schema(), default_config("dien", hidden_units=(16, 8)),
                   TrainConfig(log_every=0, batch_size=32), device="cpu")


def _batch(trainer, seed: int = 1):
    data = make_synthetic_dataset(tiny_schema(), num_rows=32, seed=seed)
    data["_valid"] = np.ones(32, np.float32)
    return trainer.to_device(data)


def _spans(prof, name: str):
    return [e for e in prof.events() if e.name == tracing.PREFIX + name]


def _history_len() -> int:
    schema = tiny_schema()
    return schema.sequence_feature(default_config("dien").seq_feature).max_len


def test_a_train_step_records_the_recurrences_inside_its_forward():
    trainer = _trainer()
    state = trainer.init_state()
    with torch.profiler.profile() as prof:
        trainer.train_step(state, trainer.meters_init(), _batch(trainer))
    (forward,) = _spans(prof, "trainer.forward")
    (gru,), (augru,) = (_spans(prof, name) for name in RNN)
    assert gru.time_range.end <= augru.time_range.start
    for s in (gru, augru):
        assert forward.time_range.start <= s.time_range.start
        assert s.time_range.end <= forward.time_range.end


def test_no_span_without_a_profiler(monkeypatch):
    opened = []
    real = torch.profiler.record_function
    monkeypatch.setattr(torch.profiler, "record_function",
                        lambda name: opened.append(name) or real(name))
    trainer = _trainer()
    trainer.train_step(trainer.init_state(), trainer.meters_init(), _batch(trainer))
    assert opened == []


def test_the_step_counter_grows_by_both_recurrences_lengths():
    trainer = _trainer()
    state = trainer.init_state()
    before = AttentionalGRU.steps
    trainer.train_step(state, trainer.meters_init(), _batch(trainer))
    assert AttentionalGRU.steps - before == 2 * _history_len()


def test_the_profiler_changes_no_number():
    """Two steps, once under the profiler and once without: parameters and
    Adam's state bitwise equal."""
    runs = []
    for profiled in (False, True):
        trainer = _trainer()
        state, meters = trainer.init_state(), trainer.meters_init()
        torch.manual_seed(5)
        with torch.profiler.profile() if profiled else contextlib.nullcontext():
            for seed in (1, 2):
                trainer.train_step(state, meters, _batch(trainer, seed))
        runs.append((state["model"].state_dict(), state["optimizer"].state_dict()["state"]))
    (params, adam), (params_p, adam_p) = runs
    assert all(torch.equal(params[k], params_p[k]) for k in params)
    assert adam.keys() == adam_p.keys()
    assert all(torch.equal(torch.as_tensor(adam[i][k]), torch.as_tensor(adam_p[i][k]))
               for i in adam for k in adam[i])


def test_an_artifact_exported_without_a_profiler_holds_no_profiler_op(tmp_path):
    trainer = _trainer()
    predictor = Predictor(tiny_schema(), trainer.model_cfg,
                          state_dict=trainer.init_state()["model"].state_dict(),
                          min_bucket=16, device="cpu")
    path = str(tmp_path / "dien.pt2")
    export_serving_artifact(predictor, path, batch_size=16)
    graph = torch.export.load(path).graph_module.graph
    targets = {str(n.target) for n in graph.nodes if n.op == "call_function"}
    assert "aten.sigmoid.default" in targets
    assert not any("profiler" in t or "record_function" in t for t in targets)
