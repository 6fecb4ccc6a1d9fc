"""The control, on the card: the reference computed in TF32 in the
program's place fails a cell's limits, while the program passes them, at
the cells' own widths with fewer rows and a short window."""

import time

import pytest

from port_bench import calibrate, spec
from port_bench.drivers.common import Context

BENCH = spec.benchmark()


@pytest.mark.card
@pytest.mark.parametrize("cell", [c["name"] for c in BENCH["workloads"]])
def test_control_fails_where_the_program_passes(cell, card):
    entry = spec.workload(BENCH, cell)
    traffic = spec.traffic(entry["traffic"])
    if traffic["driver"] == "train_staged":
        traffic["rows"] = 4 * traffic["batch_size"] + 17
    ctx = Context(cell=entry, config=spec.config(BENCH, entry["config"]), traffic=traffic,
                  seed=2**31 + 99, seconds=1.0, trace=False, device=card,
                  started=time.time())
    out = calibrate.readings(ctx)
    limits = spec.limits(cell)
    assert all(out["program"][k] <= v for k, v in limits.items()), out
    assert any(out["control"][k] > v for k, v in limits.items()), out
