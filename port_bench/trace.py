"""The traced run's record: a short profiled slice inside the window, read
from ``torch.profiler``'s chrome trace.

``Slice`` starts the profiler (CPU and CUDA activity; no input shapes,
whose recording held every profiled step's tensors on the card), first
runs ``WARMUP_S`` of tiny kernels (the profiler has lost the device records
of a session's first kernels on the H100), then opens the span ``SLICE``;
``stop`` synchronises the device and closes the span and the profiler;
``read``, after the window, exports and parses the trace.

``Trace`` answers from the events inside that span:

  * ``busy_us``: the union of the device's kernels, copies and memsets (the
    arithmetic of ``chip_smoke.py:device_busy``, clipped to the span);
  * ``op_calls``: for each outermost call of a registered operator on the
    host, the device time of every kernel, copy and memset launched inside
    it (matched by the launch's correlation id);
  * ``top_device_ops`` and ``idle_gaps``: the breakdown a traced run prints,
    idle time labelled by the benchmark's span (``port_bench::*``) the host
    was in and the innermost operator it was in as that stretch began.
"""

from __future__ import annotations

import bisect
import collections
import json
import os
import tempfile
import time
from typing import Dict, List, Optional, Tuple

import torch

from .peaks import least_seconds

SLICE = "port_bench::slice"
SPAN_PREFIX = "port_bench::"
WARMUP_S = 0.02
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
NAME_CHARS = 160  # of a kernel's name in the breakdown


class Slice:
    def __init__(self, device: torch.device):
        self.device = device
        self.prof = None
        self.mark = None
        self.memory = {}  # device bytes allocated at the slice's start and stop

    def start(self) -> None:
        activities = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        self.prof = torch.profiler.profile(activities=activities)
        self.prof.start()
        if self.device.type == "cuda":
            warm = torch.zeros((), device=self.device)
            end = time.perf_counter() + WARMUP_S
            while time.perf_counter() < end:
                warm.add_(1.0)
            torch.cuda.synchronize(self.device)
        self.mark = torch.profiler.record_function(SLICE)
        self.mark.__enter__()
        if self.device.type == "cuda":
            self.memory["start"] = torch.cuda.memory_allocated(self.device)

    def stop(self) -> None:
        """Close the slice; its events wait in the profiler for ``read``."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
            self.memory["stop"] = torch.cuda.memory_allocated(self.device)
            self.memory["peak"] = torch.cuda.max_memory_allocated(self.device)
        self.mark.__exit__(None, None, None)
        self.prof.stop()

    def read(self) -> "Trace":
        """The slice's trace, read once the window has closed: exporting and
        parsing take seconds that the window does not pay."""
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            os.remove(path)
        self.prof = None
        return Trace(events)


def _union(spans: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    merged: List[List[float]] = []
    for a, b in sorted(spans):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return [(a, b) for a, b in merged]


class Trace:
    def __init__(self, events: List[dict]):
        timed = [e for e in events if e.get("ph") == "X" and "dur" in e]
        marks = [e for e in timed if e["name"] == SLICE and e.get("cat") == "user_annotation"]
        if len(marks) != 1:
            raise RuntimeError(f"the trace holds {len(marks)} '{SLICE}' spans, not 1")
        mark = marks[0]
        self.t0, self.t1 = float(mark["ts"]), float(mark["ts"]) + float(mark["dur"])
        self.main_tid = mark["tid"]
        inside = [e for e in timed if e["ts"] < self.t1 and e["ts"] + e["dur"] > self.t0]
        self.device = [e for e in inside if e.get("cat") in DEVICE_CATS]
        self.host = [e for e in inside if e.get("cat") not in DEVICE_CATS
                     and e.get("cat") != "gpu_user_annotation"]
        self.busy = _union([(max(e["ts"], self.t0), min(e["ts"] + e["dur"], self.t1))
                            for e in self.device])

    @property
    def window_us(self) -> float:
        return self.t1 - self.t0

    @property
    def busy_us(self) -> float:
        return sum(b - a for a, b in self.busy)

    def op_calls(self, name: str) -> List[float]:
        """The device us of each outermost host call of the operator
        ``name``: every kernel, copy and memset launched inside it."""
        by_corr: Dict[int, float] = collections.defaultdict(float)
        for e in self.device:
            corr = e.get("args", {}).get("correlation")
            if corr is not None:
                by_corr[corr] += e["dur"]
        launches: Dict[object, List[dict]] = collections.defaultdict(list)
        for e in self.host:
            if e.get("cat") in LAUNCH_CATS and "correlation" in e.get("args", {}):
                launches[e["tid"]].append(e)
        for tid in launches:
            launches[tid].sort(key=lambda e: e["ts"])
        named = sorted((e for e in self.host if e["name"] == name and e.get("cat") == "cpu_op"),
                       key=lambda e: (e["tid"], e["ts"], -e["dur"]))
        out, outer = [], None
        for e in named:
            if outer is not None and e["tid"] == outer["tid"] and \
                    e["ts"] + e["dur"] <= outer["ts"] + outer["dur"]:
                continue
            outer = e
            lst = launches.get(e["tid"], [])
            i = bisect.bisect_left([x["ts"] for x in lst], e["ts"])
            device_us = 0.0
            while i < len(lst) and lst[i]["ts"] <= e["ts"] + e["dur"]:
                device_us += by_corr.get(lst[i]["args"]["correlation"], 0.0)
                i += 1
            out.append(device_us)
        return out

    def top_device_ops(self, n: int = 10) -> List[list]:
        total: Dict[str, float] = collections.defaultdict(float)
        for e in self.device:
            total[e["name"]] += min(e["ts"] + e["dur"], self.t1) - max(e["ts"], self.t0)
        ranked = sorted(total.items(), key=lambda kv: -kv[1])[:n]
        return [[name[:NAME_CHARS], us * 1e-6] for name, us in ranked]

    def _innermost(self, times: List[float], pick) -> List[Optional[str]]:
        """For each of the sorted ``times``, the name of the innermost event
        of the main thread that ``pick`` takes and that holds it. Events of
        one thread nest, so the ones holding a time form a stack."""
        evs = sorted((e for e in self.host if e["tid"] == self.main_tid and pick(e)),
                     key=lambda e: (e["ts"], -e["dur"]))
        stack: List[dict] = []
        out, j = [], 0
        for t in times:
            while j < len(evs) and evs[j]["ts"] <= t:
                while stack and stack[-1]["ts"] + stack[-1]["dur"] <= evs[j]["ts"]:
                    stack.pop()
                stack.append(evs[j])
                j += 1
            while stack and stack[-1]["ts"] + stack[-1]["dur"] <= t:
                stack.pop()
            out.append(stack[-1]["name"] if stack else None)
        return out

    def _span_segments(self) -> List[Tuple[float, float, str]]:
        """The slice cut where the host's innermost benchmark span changes:
        (start, end, span) pieces, "no span" where none is open."""
        spans = sorted((e for e in self.host if e["tid"] == self.main_tid
                        and e["name"].startswith(SPAN_PREFIX) and e["name"] != SLICE),
                       key=lambda e: (e["ts"], -e["dur"]))
        cuts = sorted({self.t0, self.t1} | {x for e in spans for x in (e["ts"], e["ts"] + e["dur"])
                                             if self.t0 < x < self.t1})
        ids = {id(e) for e in spans}
        names = self._innermost(cuts[:-1], lambda e: id(e) in ids)
        return [(a, b, name or "no span") for a, b, name in zip(cuts, cuts[1:], names)]

    def idle_gaps(self, n: int = 10) -> List[list]:
        """Idle device time summed by what the host was in: each gap is cut
        where the host's benchmark span changes, and each piece is labelled
        ``<benchmark span> / <innermost operator at its start>``."""
        edges = [self.t0] + [x for span in self.busy for x in span] + [self.t1]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] - edges[i] > 1.0]
        pieces, j = [], 0
        segments = self._span_segments()
        for a, b in gaps:
            while j < len(segments) and segments[j][1] <= a:
                j += 1
            k = j
            while k < len(segments) and segments[k][0] < b:
                lo, hi = max(a, segments[k][0]), min(b, segments[k][1])
                if hi > lo:
                    pieces.append((lo, hi, segments[k][2]))
                k += 1
        ops = self._innermost([lo for lo, _, _ in pieces], lambda e: e.get("cat") == "cpu_op")
        total: Dict[str, float] = collections.defaultdict(float)
        for (lo, hi, span), op in zip(pieces, ops):
            total[f"{span} / {op or 'python'}"] += hi - lo
        ranked = sorted(total.items(), key=lambda kv: -kv[1])[:n]
        return [[label, us * 1e-6] for label, us in ranked]


def roofline_pct(record: dict, op: str) -> Optional[float]:
    """The share of the least time of ``op``'s launches' work in the device
    time of the kernels those launches ran, in %. The cell's work count
    (``work/<model>.py``, ``KERNELS[op]``) gives each profiled unit's calls
    of ``op`` in order, from the unit's rows and valid timesteps. None where
    the slice holds no call with device time, or not the calls the work
    count expects (a program that calls the operator otherwise)."""
    trace, units = record.get("trace"), record.get("units", [])
    work = record["work"].KERNELS.get(op)
    if trace is None or not units or work is None:
        return None
    calls = trace.op_calls(op)
    expected = [w for unit in units for w in work(record["config"], unit)]
    device = sum(calls) * 1e-6
    if len(calls) != len(expected) or device <= 0:
        return None
    return 100.0 * sum(least_seconds(f, b) for f, b in expected) / device
