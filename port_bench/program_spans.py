"""Readers of the port's own spans in a traced run's slice, and the slice's
idle device time by program span.

The port opens ``rank_tpu_torch.<stage>`` spans while a profiler records
(``rank_tpu_torch/utils/tracing.py``): ``trainer.step`` and its
``forward``, ``backward``, ``optimizer`` and ``meters``; ``cin.backward``
and ``din_attention.backward`` on whatever thread autograd runs them;
``staged.shuffle``; ``predictor.call`` and its ``pad``, ``h2d``,
``forward`` and ``d2h``. They sit in the slice's trace beside the kernels,
so device time and launches are tied to them by the launches' correlation
ids, as ``Trace.op_calls`` ties them to an operator.

A reader counts the ``trainer.step`` or ``predictor.call`` spans that lie
wholly inside the slice, and is silent (None) unless that count equals the
record's units: a program without the spans, as before they existed, reads
nothing. Training readers give a mean over steps, serving readers a median
over requests. Every reader is silent where the slice holds no device
event: these metrics describe the port's device path, and a traced run on
the CPU reports only the host readers of ``readers.py``.

    python3 -m port_bench.program_spans --workload <cell> --seed <n> --seconds <s>

runs one traced run of a cell and prints its per-layer metrics, each
program span's count and times, and the slice's idle device time by the
innermost program span open as each stretch of it begins.
"""

from __future__ import annotations

import argparse
import bisect
import collections
import contextlib
import json
import os
import statistics
import sys
import time
from typing import Dict, List, Optional, Sequence

from .trace import LAUNCH_CATS, SLICE, SPAN_PREFIX

PREFIX = "rank_tpu_torch."
STEP = PREFIX + "trainer.step"
CALL = PREFIX + "predictor.call"
STAGES = {STEP: ("trainer.forward", "trainer.backward", "trainer.optimizer", "trainer.meters"),
          CALL: ("predictor.pad", "predictor.h2d", "predictor.forward", "predictor.d2h")}


def spans(trace, name: str) -> List[dict]:
    """The host events ``name`` that lie wholly inside the slice, by start."""
    return sorted((e for e in trace.host if e["name"] == name
                   and e["ts"] >= trace.t0 and e["ts"] + e["dur"] <= trace.t1),
                  key=lambda e: e["ts"])


def _named(trace) -> List[dict]:
    """The program's spans and the benchmark's (the slice's own mark aside)."""
    return [e for e in trace.host if e["name"].startswith(PREFIX)
            or (e["name"].startswith(SPAN_PREFIX) and e["name"] != SLICE)]


def _units(record, outer: str) -> Optional[List[dict]]:
    """The ``outer`` spans of the slice, where there is one a unit."""
    trace, units = record.get("trace"), record.get("units", [])
    if trace is None or not units or not trace.device:
        return None
    found = spans(trace, outer)
    return found if len(found) == len(units) else None


def _holder(outers: List[dict], starts: List[float], t: float) -> Optional[dict]:
    """The span of ``outers`` (disjoint, by start) that holds time ``t``."""
    i = bisect.bisect_right(starts, t) - 1
    return outers[i] if i >= 0 and t <= outers[i]["ts"] + outers[i]["dur"] else None


def _within(e: dict, outer: dict) -> bool:
    return e["tid"] == outer["tid"] and outer["ts"] <= e["ts"] and \
        e["ts"] + e["dur"] <= outer["ts"] + outer["dur"]


def _stage_ms(record, outer: str, stages: Sequence[str]) -> Optional[List[float]]:
    """For each unit, the host ms of the ``stages`` spans inside its span."""
    outers = _units(record, outer)
    if outers is None:
        return None
    inner = [e for s in stages for e in spans(record["trace"], PREFIX + s)]
    return [sum(e["dur"] for e in inner if _within(e, o)) * 1e-3 for o in outers]


def _launches(trace) -> List[dict]:
    return [e for e in trace.host if e.get("cat") in LAUNCH_CATS
            and "correlation" in e.get("args", {})]


class _Launched:
    """The correlation ids of the launches each span made on its own thread."""

    def __init__(self, trace):
        self.by_tid: Dict[object, List[dict]] = collections.defaultdict(list)
        for e in sorted(_launches(trace), key=lambda e: e["ts"]):
            self.by_tid[e["tid"]].append(e)
        self.starts = {tid: [e["ts"] for e in lst] for tid, lst in self.by_tid.items()}

    def __call__(self, span: dict) -> List[int]:
        lst, starts = self.by_tid.get(span["tid"], []), self.starts.get(span["tid"], [])
        i = bisect.bisect_left(starts, span["ts"])
        j = bisect.bisect_right(starts, span["ts"] + span["dur"])
        return [e["args"]["correlation"] for e in lst[i:j]]


def _device_by_corr(trace, cats=None) -> Dict[int, List[dict]]:
    """The slice's device events (of ``cats``, or all) by correlation id."""
    out: Dict[int, List[dict]] = collections.defaultdict(list)
    for e in trace.device:
        corr = e.get("args", {}).get("correlation")
        if corr is not None and (cats is None or e.get("cat") in cats):
            out[corr].append(e)
    return out


# -- training: xdeepfm.train.b1024, xdeepfm.train.b65536 ----------------------------


def _step_mean(record, stage: str) -> Optional[float]:
    per_step = _stage_ms(record, STEP, (stage,))
    return statistics.fmean(per_step) if per_step else None


def step_forward_host_ms(record) -> Optional[float]:
    return _step_mean(record, "trainer.forward")


def step_backward_host_ms(record) -> Optional[float]:
    return _step_mean(record, "trainer.backward")


def step_optimizer_host_ms(record) -> Optional[float]:
    return _step_mean(record, "trainer.optimizer")


def launches_per_step(record) -> Optional[float]:
    """Runtime calls on any thread inside ``trainer.step`` spans whose
    correlation id reaches a device event, a step."""
    steps = _units(record, STEP)
    if steps is None:
        return None
    reached = _device_by_corr(record["trace"])
    starts = [s["ts"] for s in steps]
    n = sum(1 for e in _launches(record["trace"])
            if e["args"]["correlation"] in reached and _holder(steps, starts, e["ts"]))
    return n / len(steps)


def b2_backward_device_ms(record) -> Optional[float]:
    """The device ms of every kernel, copy and memset launched inside a
    ``cin.backward`` span (on its own thread, by correlation id), a step."""
    steps = _units(record, STEP)
    if steps is None:
        return None
    trace = record["trace"]
    starts = [s["ts"] for s in steps]
    backward = [b for b in spans(trace, PREFIX + "cin.backward") if _holder(steps, starts, b["ts"])]
    if not backward:
        return None
    device, launched = _device_by_corr(trace), _Launched(trace)
    us = sum(d["dur"] for b in backward for corr in launched(b) for d in device.get(corr, ()))
    return us / len(steps) * 1e-3 if us > 0 else None


# -- serving: din.serve.poisson ---------------------------------------------------


def _call_median(record, stages: Sequence[str]) -> Optional[float]:
    per_call = _stage_ms(record, CALL, stages)
    return statistics.median(per_call) if per_call else None


def serve_input_ms(record) -> Optional[float]:
    return _call_median(record, ("predictor.pad", "predictor.h2d"))


def serve_forward_host_ms(record) -> Optional[float]:
    return _call_median(record, ("predictor.forward",))


def serve_output_ms(record) -> Optional[float]:
    return _call_median(record, ("predictor.d2h",))


def serve_copies_per_request(record) -> Optional[float]:
    """The ``gpu_memcpy`` device events launched inside each
    ``predictor.call`` span (on its own thread), median over requests."""
    calls = _units(record, CALL)
    if calls is None:
        return None
    copies = _device_by_corr(record["trace"], ("gpu_memcpy",))
    launched = _Launched(record["trace"])
    return statistics.median(sum(len(copies.get(corr, ())) for corr in launched(c))
                             for c in calls)


# -- where the idle time goes ---------------------------------------------------------


def idle_by_program_span(trace) -> List[list]:
    """Idle device seconds of the slice by the innermost ``rank_tpu_torch.*``
    span open on any thread (the one that opened last) as each stretch of
    idle time begins, else by the innermost benchmark span, else "no span".
    Each idle stretch is cut where a span opens or closes; the pieces add
    up to the slice's idle time."""
    named = _named(trace)
    cuts = sorted({trace.t0, trace.t1} | {x for e in named for x in (e["ts"], e["ts"] + e["dur"])
                                          if trace.t0 < x < trace.t1})

    def label(t: float) -> str:
        for prefix in (PREFIX, SPAN_PREFIX):
            held = [e for e in named if e["name"].startswith(prefix)
                    and e["ts"] <= t < e["ts"] + e["dur"]]
            if held:
                return max(held, key=lambda e: (e["ts"], -e["dur"]))["name"]
        return "no span"

    segments = [(a, b, label(a)) for a, b in zip(cuts, cuts[1:])]
    edges = [trace.t0] + [x for span in trace.busy for x in span] + [trace.t1]
    total: Dict[str, float] = collections.defaultdict(float)
    j = 0
    for a, b in zip(edges[::2], edges[1::2]):
        while j < len(segments) and segments[j][1] <= a:
            j += 1
        k = j
        while k < len(segments) and segments[k][0] < b:
            lo, hi = max(a, segments[k][0]), min(b, segments[k][1])
            if hi > lo:
                total[segments[k][2]] += hi - lo
            k += 1
    return [[name, us * 1e-6] for name, us in sorted(total.items(), key=lambda kv: -kv[1])]


def span_table(trace) -> Dict[str, dict]:
    """Each program span and benchmark span wholly inside the slice: count,
    total, mean and median host ms, and the threads it ran on."""
    out = {}
    for name in sorted({e["name"] for e in _named(trace)}):
        found = spans(trace, name)
        ms = [e["dur"] * 1e-3 for e in found]
        if ms:
            out[name] = {"count": len(ms), "total_ms": sum(ms), "mean_ms": statistics.fmean(ms),
                         "median_ms": statistics.median(ms),
                         "threads": sorted({str(e["tid"]) for e in found})}
    return out


def device_by_stage(trace) -> Dict[str, Dict[str, float]]:
    """For each stage of ``STAGES`` in the slice, a unit's device events
    launched inside it (on any thread, by the launch's time): their device
    ms, their count by category, and the copies by name."""
    device = _device_by_corr(trace)
    launches = sorted(_launches(trace), key=lambda e: e["ts"])
    starts = [e["ts"] for e in launches]
    out = {}
    for outer, stages in STAGES.items():
        n = len(spans(trace, outer))
        for stage in stages if n else ():
            counts: Dict[str, float] = collections.Counter()
            for s in spans(trace, PREFIX + stage):
                i = bisect.bisect_left(starts, s["ts"])
                j = bisect.bisect_right(starts, s["ts"] + s["dur"])
                for corr in (e["args"]["correlation"] for e in launches[i:j]):
                    for d in device.get(corr, ()):
                        counts["device_ms"] += d["dur"] * 1e-3
                        counts[d["cat"]] += 1
                        if d["cat"] == "gpu_memcpy":
                            counts[d["name"]] += 1
            out[PREFIX + stage] = {k: v / n for k, v in counts.items()}
    return out


def shares(table: Dict[str, dict]) -> Dict[str, float]:
    """The stages' total over their outer span's total, for each outer span
    in ``table``; and the median ``predictor.call`` over the median
    benchmark request around it."""
    out = {}
    for outer, stages in STAGES.items():
        if outer in table:
            inner = sum(table.get(PREFIX + s, {}).get("total_ms", 0.0) for s in stages)
            out[outer + " stages"] = inner / table[outer]["total_ms"]
    request = table.get(SPAN_PREFIX + "request")
    if CALL in table and request:
        out[CALL + " over request"] = table[CALL]["median_ms"] / request["median_ms"]
    return out


def main(argv=None) -> int:
    started = time.time()
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    args = p.parse_args(argv)
    from port_bench import run as runner
    from port_bench import spec

    bench = spec.benchmark()
    cell = spec.workload(bench, args.workload)
    config, traffic = spec.config(bench, cell["config"]), spec.traffic(cell["traffic"])
    for var, sub in runner.CACHES.items():
        os.environ[var] = str(runner.CHECKOUT / "port_bench" / "_cache" / sub)

    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA device: no result", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.set_float32_matmul_precision("highest")
    with contextlib.redirect_stdout(sys.stderr):
        outcome, extra, _ = runner.run_cell(bench, cell, config, traffic, args.seed,
                                            args.seconds, True, device, started)
        info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": cell["chips"]}
        line = runner.result(bench, cell, outcome, extra, True, info, spec.limits(cell["name"]))
    trace = outcome["record"]["trace"]
    table = span_table(trace)
    print(json.dumps({"workload": cell["name"], "seed": args.seed, "correct": line["correct"],
                      "device": line["device"], "metrics": line["metrics"]}))
    print(json.dumps({"spans": table, "shares": shares(table)}))
    print(json.dumps({"device_by_stage": device_by_stage(trace)}))
    print(json.dumps({"idle_by_program_span": idle_by_program_span(trace)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
