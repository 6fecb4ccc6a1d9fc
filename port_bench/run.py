#!/usr/bin/env python3
"""Run one cell of ``BENCHMARK.json`` once and print one JSON line.

    python3 port_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell names a configuration and a traffic mix; the traffic mix's
``driver`` (``port_bench/drivers/<driver>.py``) sets the cell up from the
seed, measures for ``--seconds``, and checks the window's output against
the plain reference. ``--trace 0`` reports the cell's end-to-end metrics,
``--trace 1`` its per-layer metrics, read from the run's record by
``port_bench/metrics/<metric>.py``. The last line of standard output is the
result; the numbers compared, each beside its limit, close standard error
and the result's line. The run exits non-zero, printing no result, without
the CUDA cards the cell asks for, or when JAX, flax or the JAX package are
loaded once the window has closed.
"""

import time

STARTED = time.time()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

CHECKOUT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(CHECKOUT))

FORBIDDEN = ("jax", "jaxlib", "flax", "rank_tpu")
# kernel and build caches at fixed paths inside the checkout
CACHES = {"TRITON_CACHE_DIR": "triton", "TORCHINDUCTOR_CACHE_DIR": "inductor",
          "TORCH_EXTENSIONS_DIR": "torch_extensions"}


def forbidden_modules(modules=None):
    """Loaded modules whose top-level name is, whole, one of ``FORBIDDEN``."""
    modules = sys.modules if modules is None else modules
    return sorted({name.split(".")[0] for name in modules} & set(FORBIDDEN))


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def number(x):
    """A JSON-safe number: infinities and NaN as strings."""
    return x if isinstance(x, (int, float)) and math.isfinite(x) else str(x)


def result(bench, cell, outcome, record_extra, trace: bool, device_info: dict, limits: dict):
    """The result's line, built from a driver's outcome."""
    from port_bench import checks, spec

    checked = checks.verdict(outcome.get("values", {}), limits)
    correct = checks.passed(checked) and "problem" not in outcome and outcome["failed"] == 0
    metrics = {}
    if not trace:
        # a metric ``<quantity>.<variant>`` reports the driver's ``<quantity>``:
        # cells that spread alike share a variant and its bound
        for m in spec.cell_metrics(bench, cell["name"], "end_to_end"):
            metrics[m["name"]] = {"value": number(outcome["end_to_end"][m["name"].split(".")[0]]),
                                  "unit": m["unit"]}
    else:
        record = {**outcome["record"], **record_extra}
        for m in spec.cell_metrics(bench, cell["name"], "per_layer"):
            value = spec.module("metrics", m["name"]).read(record)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device = dict(device_info, memory_peak_bytes=outcome["memory_peak_bytes"])
    line = {"correct": correct, "attempted": outcome["attempted"], "failed": outcome["failed"],
            "metrics": metrics, "device": device}
    tr = outcome["record"]["trace"] if trace and outcome["record"] else None
    if tr is not None:
        device["busy_s"] = tr.busy_us * 1e-6
        device["window_s"] = tr.window_us * 1e-6
        line["breakdown"] = {"device_ops": tr.top_device_ops(), "idle_gaps": tr.idle_gaps()}
    if "problem" in outcome:
        line["problem"] = outcome["problem"]
    line["checks"] = {k: {"value": number(c["value"]), "limit": c["limit"]}
                      for k, c in checked.items()}
    return line


def run_cell(bench, cell, config, traffic, seed, seconds, trace, device, started):
    """Set the cell up, measure, check; returns the driver's outcome and the
    context's notes."""
    from port_bench import spec
    from port_bench.drivers.common import Context

    ctx = Context(cell=cell, config=config, traffic=traffic, seed=seed, seconds=seconds,
                  trace=bool(trace), device=device, started=started)
    outcome = spec.module("drivers", traffic["driver"]).run(ctx)
    extra = {"work": ctx.work(), "config": config, "traffic": traffic}
    return outcome, extra, ctx.notes


def main(argv=None) -> int:
    args = parse(argv)
    from port_bench import spec

    bench = spec.benchmark()
    cell = spec.workload(bench, args.workload)
    config, traffic = spec.config(bench, cell["config"]), spec.traffic(cell["traffic"])
    limits = spec.limits(cell["name"])
    for var, sub in CACHES.items():
        os.environ[var] = str(CHECKOUT / "port_bench" / "_cache" / sub)

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"{cell['name']} needs {cell['chips']} CUDA device(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}, "
              f"device_count() {torch.cuda.device_count()}: no result", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.set_float32_matmul_precision("highest")
    with contextlib.redirect_stdout(sys.stderr):
        outcome, extra, notes = run_cell(bench, cell, config, traffic, args.seed,
                                         args.seconds, args.trace, device, STARTED)
        info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": cell["chips"]}
        line = result(bench, cell, outcome, extra, bool(args.trace), info, limits)
    loaded = forbidden_modules()
    if loaded:
        print(f"modules of {loaded} are loaded: the port must run without JAX, flax and "
              f"rank_tpu; no result", file=sys.stderr)
        return 3
    for note in notes:
        print(note, file=sys.stderr)
    for name, c in line["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})", file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
