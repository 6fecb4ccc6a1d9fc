"""A tiny run of each cell on the CPU, past the harness's look for a card:
the last line holds the contract's keys, the numbers compared come last,
and the traced run reports only per-layer metrics."""

import json

import pytest

from port_bench import readers, spec
from port_bench.tests import tiny

BENCH = spec.benchmark()
CELLS = [c["name"] for c in BENCH["workloads"]]


@pytest.mark.parametrize("cell", CELLS)
def test_line_has_the_contract_keys(cell):
    line, _ = tiny.run(cell)
    parsed = json.loads(json.dumps(line))
    assert list(parsed)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(parsed)[-1] == "checks"
    assert parsed["correct"] is True and parsed["failed"] == 0 and parsed["attempted"] > 0
    want = {m["name"] for m in spec.cell_metrics(BENCH, cell, "end_to_end")}
    assert set(parsed["metrics"]) == want and "setup_s" in want
    for m in parsed["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0
    assert set(parsed["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    for c in parsed["checks"].values():
        assert c["value"] <= c["limit"]


@pytest.mark.parametrize("cell", CELLS)
def test_traced_line_reports_per_layer_metrics(cell):
    line, outcome = tiny.run(cell, trace=True)
    names = {m["name"] for m in spec.cell_metrics(BENCH, cell, "per_layer")}
    assert set(line["metrics"]) <= names
    # on the CPU no device event exists: the device readers find nothing
    # and leave their metric out, the host spans and counts remain
    host_readers = (readers.step_host_ms, readers.train_mfu_pct, readers.serve_service_ms,
                    readers.serve_mfu_pct)
    host = {n for n in names if spec.module("metrics", n).read in host_readers}
    assert host and set(line["metrics"]) == host
    assert {"device_ops", "idle_gaps"} == set(line["breakdown"])
    assert line["device"]["window_s"] > 0
    assert outcome["record"]["units"]


def test_every_metric_and_cell_has_its_files():
    for cell in BENCH["workloads"]:
        t = spec.traffic(cell["traffic"])
        spec.module("drivers", t["driver"])
        spec.limits(cell["name"])
        cfg = spec.config(BENCH, cell["config"])
        spec.module("reference", cfg["model"])
        spec.module("work", cfg["model"])
    for m in BENCH["per_layer"]:
        assert callable(spec.module("metrics", m["name"]).read)


def test_benchmark_json_keeps_the_contract_shape():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["port_bench"]
    assert all(c["chips"] == 1 for c in BENCH["workloads"])
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
    ends = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in ends and m["workloads"]
        for w in m["workloads"]:
            assert w in {c["name"] for c in BENCH["workloads"]}
            assert m["moves"] in {e["name"] for e in spec.cell_metrics(BENCH, w, "end_to_end")}
