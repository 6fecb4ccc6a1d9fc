"""The readers of the port's own spans on hand-made chrome traces: stage
means and medians, launches on autograd's thread counted within the step,
B2's backward device time by correlation on its own thread, copies a
request, silence where the spans do not match the units, and idle time by
program span."""

import pytest

from port_bench import program_spans as ps
from port_bench.trace import SLICE, Trace

P = ps.PREFIX
MAIN, AUTOGRAD, DEV = 1, 2, 7


def X(name, cat, ts, dur, tid=MAIN, **args):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur, "tid": tid, "args": args}


def span(name, ts, dur, tid=MAIN):
    return X(name, "user_annotation", ts, dur, tid)


def launch(ts, corr, tid=MAIN):
    return X("cudaLaunchKernel", "cuda_runtime", ts, 2, tid, correlation=corr)


def kernel(ts, dur, corr, cat="kernel", name="k"):
    return X(name, cat, ts, dur, DEV, correlation=corr)


def _step(t, forward=90, backward=150):
    """A step at ``t``: forward, backward (B2's on autograd's thread inside
    it), optimizer 30 us, meters 15 us."""
    b = t + 10 + forward
    return [span(P + "trainer.step", t, 300), span(P + "trainer.forward", t + 10, forward),
            span(P + "trainer.backward", b, backward),
            span(P + "cin.backward", b + 10, 90, AUTOGRAD),
            span(P + "trainer.optimizer", b + backward, 30),
            span(P + "trainer.meters", b + backward + 30, 15)]


def train_events():
    return [
        span(SLICE, 0, 1000), *_step(100), *_step(500, forward=60, backward=180),
        span(P + "trainer.step", 900, 200),                      # ends past the slice
        launch(120, 1), kernel(130, 20, 1),                      # forward, main thread
        launch(220, 2, AUTOGRAD), kernel(230, 50, 2),            # inside B2's backward
        launch(250, 8), kernel(285, 10, 8),                      # main thread, meanwhile
        launch(310, 3, AUTOGRAD), kernel(320, 10, 3),            # autograd, after B2's
        launch(360, 4),                                          # reaches no device event
        launch(450, 7), kernel(455, 15, 7),                      # between the steps
        launch(520, 5), kernel(530, 30, 5),
        launch(590, 6, AUTOGRAD), kernel(630, 60, 6),
        kernel(700, 5, 6, cat="gpu_memset", name="Memset (Device)"),
    ]


def serve_events():
    def request(t, parts, copies):
        """A request at ``t`` whose pad, h2d, forward and d2h take ``parts``
        us; ``copies`` of (stage index, correlation)."""
        out, s = [span("port_bench::request", t - 5, sum(parts) + 10),
                  span(P + "predictor.call", t, sum(parts))], t
        for name, dur in zip(ps.STAGES[ps.CALL], parts):
            out.append(span(P + name, s, dur))
            for i, corr in copies:
                if ps.STAGES[ps.CALL][i] == name:
                    out += [launch(s + 1, corr),
                            kernel(s + 3, 2, corr, cat="gpu_memcpy", name="Memcpy HtoD")]
            s += dur
        return out

    return [span(SLICE, 0, 1000),
            *request(100, (50, 50, 150, 50), [(1, 11), (1, 12), (3, 14)]),
            *request(500, (20, 80, 100, 100), [(1, 21), (3, 22)]),
            *request(850, (10, 10, 70, 10), [(1, 31)]),
            launch(210, 13), kernel(215, 30, 13)]


def record(events, units):
    return {"trace": Trace(events), "units": [{"rows": 1, "valid_steps": 0}] * units}


def test_stage_means_over_steps():
    r = record(train_events(), 2)
    assert ps.step_forward_host_ms(r) == pytest.approx((90 + 60) / 2 * 1e-3)
    assert ps.step_backward_host_ms(r) == pytest.approx((150 + 180) / 2 * 1e-3)
    assert ps.step_optimizer_host_ms(r) == pytest.approx(30e-3)


def test_launches_on_any_thread_within_the_step():
    # 1, 2, 8, 3 in the first step, 5, 6 in the second; 4 reaches no device
    # event and 7 lies between the steps
    assert ps.launches_per_step(record(train_events(), 2)) == pytest.approx(6 / 2)


def test_b2_backward_takes_its_own_threads_launches():
    # 2 (50 us) in the first step's span; 6 (60 us kernel and 5 us memset) in
    # the second's; 8 is the main thread's, 3 comes after the span
    assert ps.b2_backward_device_ms(record(train_events(), 2)) == pytest.approx(115 / 2 * 1e-3)


def test_serving_medians_and_copies_a_request():
    r = record(serve_events(), 3)
    assert ps.serve_input_ms(r) == pytest.approx(100e-3)     # 100, 100, 20
    assert ps.serve_forward_host_ms(r) == pytest.approx(100e-3)  # 150, 100, 70
    assert ps.serve_output_ms(r) == pytest.approx(50e-3)     # 50, 100, 10
    assert ps.serve_copies_per_request(r) == 2               # 3, 2, 1


@pytest.mark.parametrize("units", [1, 3])
def test_silent_where_the_spans_do_not_match_the_units(units):
    train, serve = record(train_events(), units), record(serve_events(), units + 1)
    for read in (ps.step_forward_host_ms, ps.step_backward_host_ms, ps.step_optimizer_host_ms,
                 ps.launches_per_step, ps.b2_backward_device_ms):
        assert read(train) is None
    for read in (ps.serve_input_ms, ps.serve_forward_host_ms, ps.serve_output_ms,
                 ps.serve_copies_per_request):
        assert read(serve) is None


def test_silent_without_program_spans_or_device_events():
    no_spans = [e for e in train_events() if not e["name"].startswith(P)]
    assert ps.step_forward_host_ms(record(no_spans, 2)) is None
    assert ps.launches_per_step(record(no_spans, 2)) is None
    # a run on the CPU: the host spans are there, no device event is
    host_only = [e for e in train_events() if e["tid"] != DEV]
    assert ps.step_forward_host_ms(record(host_only, 2)) is None
    assert ps.launches_per_step(record(host_only, 2)) is None
    assert ps.b2_backward_device_ms(record(host_only, 2)) is None
    serve_host_only = [e for e in serve_events() if e["tid"] != DEV]
    assert ps.serve_input_ms(record(serve_host_only, 3)) is None
    assert ps.serve_copies_per_request(record(serve_host_only, 3)) is None


def test_idle_by_the_innermost_program_span_on_any_thread():
    events = [span(SLICE, 0, 100), span("port_bench::train_step", 10, 80),
              span(P + "trainer.step", 20, 60), span(P + "trainer.backward", 30, 40),
              span(P + "cin.backward", 40, 20, AUTOGRAD), launch(41, 1, AUTOGRAD),
              kernel(45, 5, 1)]
    idle = dict(ps.idle_by_program_span(Trace(events)))
    assert idle == pytest.approx({"no span": 20e-6, "port_bench::train_step": 20e-6,
                                  P + "trainer.step": 20e-6, P + "trainer.backward": 20e-6,
                                  P + "cin.backward": 15e-6})
    assert sum(idle.values()) == pytest.approx(95e-6)


def test_span_table_shares_and_device_by_stage():
    trace = Trace(serve_events())
    table = ps.span_table(trace)
    assert table[ps.CALL]["count"] == 3 and table["port_bench::request"]["count"] == 3
    shares = ps.shares(table)
    assert shares[ps.CALL + " stages"] == pytest.approx(1.0)
    assert shares[ps.CALL + " over request"] == pytest.approx(300 / 310)
    by_stage = ps.device_by_stage(trace)
    assert by_stage[P + "predictor.h2d"]["gpu_memcpy"] == pytest.approx(4 / 3)
    assert by_stage[P + "predictor.forward"]["kernel"] == pytest.approx(1 / 3)
    assert by_stage[P + "predictor.forward"]["device_ms"] == pytest.approx(30e-3 / 3)
