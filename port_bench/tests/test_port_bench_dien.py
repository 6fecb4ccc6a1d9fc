"""The DIEN cell on the CPU: a tiny run of ``dien.train.b1024`` is correct
and its traced line reads the new metrics that read on the CPU; two faults
planted in the recurrences each make ``correct`` false; the work count by
hand; the recurrence readers (``rnn_spans``) on hand-made traces, and their
tie from the forward's ops to the backward's nodes by autograd's sequence
numbers on a real trace of the port's DIEN."""

import json
import os
import tempfile

import numpy as np
import pytest
import torch

from port_bench import readers, spec
from port_bench import rnn_spans as rs
from port_bench.tests import tiny
from port_bench.tests.test_port_bench_program_spans import AUTOGRAD, DEV, MAIN, kernel, launch, span
from port_bench.trace import SLICE, Trace

CELL = "dien.train.b1024"
BENCH = spec.benchmark()
P = rs.ps.PREFIX


def test_a_tiny_run_is_correct_and_traced_reads_the_host_metrics(monkeypatch):
    real = tiny.traffic
    # the slice opens with the window's first step, which on a loaded host
    # may outlast the tiny window
    monkeypatch.setattr(tiny, "traffic", lambda name: {**real(name), "profile_at": 0.0})
    line, _ = tiny.run(CELL)
    assert line["correct"] is True
    traced, outcome = tiny.run(CELL, trace=True)
    assert traced["correct"] is True
    assert outcome["record"]["units"]
    # no device event on the CPU: the device and span-by-correlation readers
    # are silent, the host readers read
    assert set(traced["metrics"]) == {"step_host_ms.dien_train", "train_mfu_pct.dien_train"}
    assert spec.module("metrics", "step_host_ms.dien_train").read is readers.step_host_ms


def _failing(line):
    return {k for k, c in line["checks"].items() if c["value"] > c["limit"]}


def test_an_augru_without_its_attention_fails(monkeypatch):
    """The evolving layer's update gate taken without its attention score."""
    from rank_tpu_torch.ops.rnn import AttentionalGRU

    real = AttentionalGRU.forward

    def unscaled(self, inputs, lengths, att_scores=None):
        return real(self, inputs, lengths, None if att_scores is None
                    else torch.ones_like(att_scores))

    monkeypatch.setattr(AttentionalGRU, "forward", unscaled)
    line, _ = tiny.run(CELL)
    assert line["correct"] is False
    assert "loss_gap" in _failing(line)


def test_a_padded_step_that_moves_the_state_fails(monkeypatch):
    """The state zeroed at padded steps, as the outputs are: the final state
    is then the last timestep's output, zero for every row shorter than the
    history. (A padded step that runs the cell moves neither layer's final
    state: the extractor's valid outputs come first, and the AUGRU's update
    gate is zero where the attention is.)"""
    from rank_tpu_torch.ops.rnn import AttentionalGRU

    real = AttentionalGRU.forward

    def zeroed(self, inputs, lengths, att_scores=None):
        outs, _ = real(self, inputs, lengths, att_scores)
        return outs, outs[:, -1]

    monkeypatch.setattr(AttentionalGRU, "forward", zeroed)
    line, _ = tiny.run(CELL)
    assert line["correct"] is False
    assert "loss_gap" in _failing(line)


def test_dien_counts_by_hand():
    work = spec.module("work", "dien")
    cfg = tiny.config("dien-wechat")
    cfg["schema"]["categorical"]["feedid"][1] = 4
    cfg["model_config"].update(gru_hidden_dim=3, hidden_units=[5, 2])
    # D = 4, H = 3; tower in = 16 dense + (16 + 2 + 4 + 4 + 4 + 4) + 4 + 3 = 57
    extractor, evolution, score = 6 * 3 * 7, 6 * 3 * 6, 2 * 3
    assert extractor == 126 and evolution == 108
    assert work.recurrence_products(cfg, 2, 10) == 2 * 2 * 4 * 3 + 10 * (126 + 108 + 6)
    tower = 2 * (57 * 5 + 5 * 2 + 2 * 1)
    fwd = 2 * 4 * 3 + 7.5 * (126 + 108 + 6) + tower
    assert work.forward_products(cfg, {"mean_history": 7.5}) == fwd
    bwd = 4 * 4 * 3 + 7.5 * (2 * 126 + 2 * 108 + score) + \
        2 * (57 * 5 + 5 * 2 + 2) + 2 * ((57 - 16) * 5 + 5 * 2 + 2)
    assert work.train_products(cfg, {"mean_history": 7.5}) == fwd + bwd
    assert work.KERNELS == {}


def test_the_full_width_count_is_about_two_and_a_half_mflop():
    work = spec.module("work", "dien")
    cfg = spec.config(BENCH, "dien-wechat")
    assert 2.4e6 < work.train_products(cfg, {"mean_history": 25.0}) < 2.7e6


# -- the readers on hand-made traces -----------------------------------------------


def op(name, ts, seq, tid=MAIN, dur=2):
    return {"ph": "X", "name": name, "cat": "cpu_op", "ts": ts, "dur": dur, "tid": tid,
            "args": {rs.SEQ: seq}}


def _step(t, seq, corr):
    """A step at ``t``: the GRU's span makes nodes ``seq`` and ``seq + 1`` and
    peeks ``seq + 2``, which the attention's op after it makes; the AUGRU's
    makes ``seq + 3``. Forward launches: two in the GRU's span (one reaches
    no device event), one in the AUGRU's, one in the attention; backward on
    autograd's thread: one node each, ``seq + 1``'s without a launch."""
    node = lambda ts, s: op(rs.NODE + "XBackward0", ts, s, AUTOGRAD, dur=20)  # noqa: E731
    return [
        span(P + "trainer.step", t, 400), span(P + "trainer.forward", t + 10, 150),
        span(P + "rnn.gru", t + 20, 40), op("aten::addmm", t + 21, seq),
        op("aten::mul", t + 30, seq + 1), op("aten::lt", t + 50, seq + 2),
        launch(t + 22, corr), kernel(t + 25, 20, corr), launch(t + 32, corr + 1),
        op("aten::mm", t + 62, seq + 2), launch(t + 63, corr + 2), kernel(t + 64, 4, corr + 2),
        span(P + "rnn.augru", t + 70, 40), op("aten::addmm", t + 72, seq + 3),
        launch(t + 74, corr + 3), kernel(t + 80, 5, corr + 3),
        span(P + "trainer.backward", t + 200, 150),
        node(t + 210, seq + 3), launch(t + 212, corr + 4, AUTOGRAD), kernel(t + 215, 30, corr + 4),
        node(t + 240, seq + 2), launch(t + 242, corr + 5, AUTOGRAD), kernel(t + 245, 7, corr + 5),
        node(t + 270, seq), launch(t + 272, corr + 6, AUTOGRAD), kernel(t + 280, 11, corr + 6),
        node(t + 300, seq + 1),
    ]


def _record(events, units=2):
    return {"trace": Trace(events), "units": [{"rows": 1, "valid_steps": 0}] * units}


def _events():
    return [span(SLICE, 0, 1000), *_step(100, 10, 1), *_step(550, 20, 11)]


def test_recurrence_readers_on_a_hand_made_trace():
    r = _record(_events())
    assert rs.rnn_launches_per_step(r) == pytest.approx(2)
    assert rs.rnn_forward_device_ms(r) == pytest.approx(25e-3)
    # nodes seq + 3 (30 us) and seq (11 us); seq + 2 is the attention's
    assert rs.rnn_backward_device_ms(r) == pytest.approx(41e-3)
    assert sorted(rs.owned_numbers(r["trace"], [e for e in r["trace"].host
                                                if e["name"].startswith(rs.RNN)])) == \
        [10, 11, 13, 20, 21, 23]


def test_recurrence_readers_are_silent_without_their_spans_or_units():
    readers_ = (rs.rnn_launches_per_step, rs.rnn_forward_device_ms, rs.rnn_backward_device_ms)
    no_rnn = [e for e in _events() if not e["name"].startswith(rs.RNN)]
    host_only = [e for e in _events() if e["tid"] != DEV]
    for read in readers_:
        assert read(_record(no_rnn)) is None
        assert read(_record(host_only)) is None
        assert read(_record(_events(), units=3)) is None


def test_sequence_numbers_tie_the_recurrences_backward_on_a_real_trace():
    """Two steps of the port's DIEN on the CPU: the nodes that the
    recurrences' forward made are the GRU cell's, two products a cell a
    timestep; the tower's, the attention's and the lookups' are not."""
    from rank_tpu_torch import default_config, tiny_schema
    from rank_tpu_torch.data.synthetic import make_synthetic_dataset
    from rank_tpu_torch.train import TrainConfig, Trainer

    trainer = Trainer(tiny_schema(), default_config("dien", hidden_units=(16, 8)),
                      TrainConfig(log_every=0, batch_size=32), device="cpu")
    state = trainer.init_state()
    data = make_synthetic_dataset(tiny_schema(), num_rows=32, seed=1)
    data["_valid"] = np.ones(32, np.float32)
    batch = trainer.to_device(data)
    with torch.profiler.profile() as prof:
        with torch.profiler.record_function(SLICE):
            for _ in range(2):
                trainer.train_step(state, trainer.meters_init(), batch)
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            trace = Trace(json.load(f)["traceEvents"])
    finally:
        os.remove(path)
    rnn = [e for e in trace.host if e["name"].startswith(rs.RNN)]
    assert len(rnn) == 4
    owned = rs.owned_numbers(trace, rnn)
    nodes = [e["name"][len(rs.NODE):] for e in trace.host if e["name"].startswith(rs.NODE)]
    mine = [e["name"][len(rs.NODE):] for e in trace.host
            if e["name"].startswith(rs.NODE) and e["args"].get(rs.SEQ) in owned]
    t = tiny_schema().sequence_feature("his_read_comment_7d_seq").max_len
    assert mine.count("AddmmBackward0") == 2 * 2 * 2 * t
    assert nodes.count("AddmmBackward0") == 2 * 2 * 2 * t + 2 * 3  # and the tower's three
    for other in ("EmbeddingBackward0", "BmmBackward0", "MmBackward0",
                  "BinaryCrossEntropyWithLogitsBackward0", "torch::autograd::AccumulateGrad"):
        assert other in nodes and other not in mine
