"""The trace reader on a hand-made chrome trace: busy union, idle gaps by
span, operator attribution by correlation id, and the roofline share."""

import types

import pytest

from port_bench import peaks
from port_bench.trace import SLICE, Trace, roofline_pct

OP = "rank_tpu_torch::cin_layer_t"


def _events():
    X = lambda name, cat, ts, dur, tid=1, **args: {  # noqa: E731
        "ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur, "tid": tid, "args": args}
    return [
        X(SLICE, "user_annotation", 100, 1000),
        X(SLICE, "gpu_user_annotation", 100, 1000, tid=7),          # not device work
        X("port_bench::train_step", "user_annotation", 150, 900),
        X(OP, "cpu_op", 200, 60),
        X(OP, "cpu_op", 205, 50),                                    # nested: one call
        X("cudaLaunchKernel", "cuda_runtime", 210, 5, correlation=1),
        X("cudaMemsetAsync", "cuda_runtime", 240, 5, correlation=2),
        X("aten::mm", "cpu_op", 400, 80),
        X("aten::item", "cpu_op", 590, 110),
        X("cudaLaunchKernel", "cuda_runtime", 410, 5, correlation=3),
        X("cin_layer_fwd_kernel", "kernel", 300, 40, tid=7, correlation=1),
        X("Memset (Device)", "gpu_memset", 330, 20, tid=7, correlation=2),  # overlaps
        X("gemm", "kernel", 500, 100, tid=7, correlation=3),
        X("gemm", "kernel", 1050, 100, tid=7, correlation=4),        # half outside
    ]


def test_busy_is_the_union_inside_the_slice():
    t = Trace(_events())
    assert t.window_us == 1000
    assert t.busy_us == pytest.approx(50 + 100 + 50)  # [300,350), [500,600), [1050,1100)
    ops = dict(t.top_device_ops())
    assert ops["gemm"] == pytest.approx(150e-6)


def test_operator_calls_take_their_launches_device_time():
    assert Trace(_events()).op_calls(OP) == [60.0]
    assert Trace(_events()).op_calls("rank_tpu_torch::din_attention") == []


def test_idle_gaps_are_labelled_by_span_and_operator():
    gaps = dict(Trace(_events()).idle_gaps())
    # [100, 300) is cut where the span opens at 150; [350, 500); [600, 1050)
    assert gaps == pytest.approx({"no span / python": 50e-6,
                                  "port_bench::train_step / python": 150e-6 + 150e-6,
                                  "port_bench::train_step / aten::item": 450e-6})


def test_roofline_share_from_the_work_count():
    least = 30e-6  # a call whose work takes 30 us at the peaks
    work = types.SimpleNamespace(KERNELS={OP: lambda cfg, unit: [(least * peaks.PRODUCT_FLOPS, 0)]})
    record = {"trace": Trace(_events()), "units": [{"rows": 1, "valid_steps": 0}],
              "work": work, "config": {}}
    assert roofline_pct(record, OP) == pytest.approx(50.0)
    record["units"] = record["units"] * 2  # the count expects two calls, the slice has one
    assert roofline_pct(record, OP) is None
