"""Serving cells: the port's ``Predictor`` under an open loop of Poisson
arrivals at the rate the traffic mix fixes.

Set-up (counted in ``setup_s``): the model is built and drawn on the device
as a served model (``weights.redraw_(served=True)``) and handed to
``Predictor`` as a state dict; ``rate_per_s`` x the window's seconds
requests are drawn (``traffic.requests``) and copied to the host as numpy
columns, as a client sends them; each padding bucket the requests reach is
warmed with ``warmup_calls`` calls.

The window: one server, which takes the requests in order of arrival. A
request that finds the server idle starts when it is due (the loop sleeps,
then spins, until then); one that finds it busy waits. Its latency runs
from its due time to the numpy scores on the host, so the wait counts; its
service time from its start. How late the generator started requests that
found the server idle is printed to stderr. A request that raises is
failed, and counts in the tail as infinitely late.

After the window every request's scores are held against the reference's.
A traced run profiles the requests due in ``profile_s`` seconds from
``profile_at`` of the window on.
"""

from __future__ import annotations

import contextlib
import math
import time
from typing import List, Optional

import numpy as np
import torch

from .. import traffic as T
from .. import trace as tr
from .. import weights
from ..reference import common as ref_common
from .common import (Context, Phases, memory_peak, model_config, port_schema, release,
                     synchronize)

BLOCK_ROWS = 1 << 17  # rows the reference scores at a time


def buckets(lo: int, hi: int, min_bucket: int) -> List[int]:
    """The padding buckets (powers of two from ``min_bucket``) that requests
    of lo..hi rows reach."""
    out, b = [], min_bucket
    while True:
        if b >= lo:
            out.append(b)
        if b >= hi:
            return out
        b *= 2


def wait_until(t: float) -> None:
    while True:
        left = t - time.perf_counter()
        if left <= 0:
            return
        if left > 0.002:
            time.sleep(left - 0.001)


class ServeCell:
    def __init__(self, ctx: Context):
        from rank_tpu_torch.models import build_model
        from rank_tpu_torch.serve import Predictor

        self.ctx = ctx
        cfg, traffic, dev = ctx.config, ctx.traffic, ctx.device
        self.phase = Phases(ctx)
        data_seed, weight_seed = T.derived_seeds(ctx.seed, 2)
        schema, mcfg = port_schema(cfg), model_config(cfg)
        model = build_model(schema, mcfg, device=dev, generator=torch.Generator().manual_seed(0))
        weights.redraw_(model, torch.Generator(device=dev).manual_seed(weight_seed), served=True)
        self.state = {k: v.detach().clone() for k, v in model.state_dict().items()}
        del model
        self.predictor = Predictor(schema, mcfg, state_dict=self.state,
                                   min_bucket=traffic["min_bucket"], device=dev)
        self.phase("model built and drawn")
        lo, hi = traffic["candidates"]
        self.n = max(1, round(traffic["rate_per_s"] * ctx.seconds))
        catalog = T.Catalog(T.Layout.from_config(cfg), traffic["feed_zipf_alpha"],
                            torch.Generator(device=dev).manual_seed(data_seed))
        self.requests = T.requests(catalog, self.n, traffic["rate_per_s"], lo, hi)
        del catalog
        self.phase("requests drawn and copied to the host")
        self.outputs: List[Optional[np.ndarray]] = [None] * self.n
        self.wait = np.full(self.n, math.nan)  # seconds from due to start

    def warm(self) -> None:
        lo, hi = self.ctx.traffic["candidates"]
        cols = self.requests.columns
        for b in buckets(lo, hi, self.ctx.traffic["min_bucket"]):
            for _ in range(self.ctx.traffic["warmup_calls"]):
                self.predictor({k: v[:b] for k, v in cols.items()})
        synchronize(self.ctx.device)
        self.phase("buckets warmed")

    def window(self) -> dict:
        ctx, traffic, reqs = self.ctx, self.ctx.traffic, self.requests
        latency = self.latency = np.full(self.n, math.inf)
        service = self.service = np.full(self.n, math.nan)
        late: List[float] = []
        failed = 0
        units, profiling, profiled = [], False, False
        profile_from = traffic["profile_at"] * ctx.seconds
        profile_to = profile_from + traffic["profile_s"]
        probe = tr.Slice(ctx.device) if ctx.trace else None
        span = torch.profiler.record_function if ctx.trace else (lambda name: contextlib.nullcontext())
        setup_s = time.time() - ctx.started
        t_open = time.perf_counter()
        for i in range(self.n):
            if probe is not None and not profiled:
                if not profiling and reqs.due[i] >= profile_from:
                    probe.start()
                    profiling = True
                elif profiling and reqs.due[i] >= profile_to:
                    probe.stop()
                    profiling, profiled = False, True
            due = t_open + reqs.due[i]
            if time.perf_counter() < due:
                with span("port_bench::wait_arrival"):
                    wait_until(due)
                late.append(time.perf_counter() - due)
            start = time.perf_counter()
            try:
                with span("port_bench::request"):
                    out = self.predictor(reqs.batch(i))["score"]
            except Exception as e:  # noqa: BLE001 -- a failed request is counted, not fatal
                failed += 1
                ctx.notes.append(f"request {i} failed: {type(e).__name__}: {e}")
                continue
            end = time.perf_counter()
            latency[i], service[i], self.wait[i] = end - due, end - start, start - due
            self.outputs[i] = out
            if profiling:
                units.append({"rows": reqs.rows(i),
                              "valid_steps": reqs.rows(i) * int(reqs.history_len[i])})
        if profiling:
            probe.stop()
            profiled = True
        self.phase("window")
        late_ms = np.array(late or [0.0]) * 1e3
        ctx.notes.append(
            f"open loop: {len(late)} of {self.n} requests found the server idle; the generator "
            f"started them late by median {np.median(late_ms):.4f} ms, p99 "
            f"{np.percentile(late_ms, 99):.4f} ms, max {late_ms.max():.4f} ms")
        done = np.isfinite(latency)
        ctx.notes.append(f"service: median {np.nanmedian(service) * 1e3:.4f} ms, busy share "
                         f"{np.nansum(service) / ctx.seconds:.4f}; latency p95 "
                         f"{np.percentile(latency, 95, method='higher') * 1e3:.4f} ms, p99 "
                         f"{np.percentile(latency, 99, method='higher') * 1e3:.4f} ms")
        outcome = {
            "end_to_end": {"serve_p50_ms": float(np.percentile(latency, 50) * 1e3),
                           "setup_s": setup_s},
            "attempted": self.n, "failed": failed, "record": None}
        if ctx.trace:
            rows = np.diff(reqs.offsets)
            work = ctx.work()
            products = sum(work.forward_products(ctx.config, {"mean_history": int(L)}) * r
                           for r, L in zip(rows[done], reqs.history_len[done]))
            outcome["record"] = {
                "trace": probe.read() if profiled else None, "units": units,
                "spans": {"service": service[done].tolist()},
                "window": {"requested_products": float(products),
                           "service_seconds": float(service[done].sum())}}
        return outcome

    def free_program(self) -> None:
        self.predictor = None
        release(self.ctx.device)

    def reference_scores(self, tf32: bool = False) -> List[np.ndarray]:
        """The reference's probabilities for every request, scored in blocks."""
        ref, cfg, dev = self.ctx.reference(), self.ctx.config, self.ctx.device
        ref_common.expect(self.state, ref.shapes(cfg))
        cols, offsets = self.requests.columns, self.requests.offsets
        out = np.empty(offsets[-1], np.float32)
        with ref_common.precision(tf32):
            for a in range(0, offsets[-1], BLOCK_ROWS):
                b = min(a + BLOCK_ROWS, offsets[-1])
                batch = {k: torch.as_tensor(v[a:b]).to(dev) for k, v in cols.items()}
                out[a:b] = ref_common.scores(ref.forward, self.state, batch, cfg).cpu().numpy()
        return [out[offsets[i]:offsets[i + 1]] for i in range(self.n)]

    def score_gap(self, got: List[Optional[np.ndarray]], want: List[np.ndarray]) -> float:
        """The largest gap over every row of every request; infinite where a
        request has no answer or one of the wrong length."""
        gap = 0.0
        for g, w in zip(got, want):
            if g is None or g.shape != w.shape:
                return math.inf
            d = np.abs(g.astype(np.float64) - w)
            if not np.all(np.isfinite(d)):
                return math.inf
            gap = max(gap, float(d.max(initial=0.0)))
        return gap


def run(ctx: Context) -> dict:
    cell = ServeCell(ctx)
    cell.warm()
    outcome = cell.window()
    outcome["memory_peak_bytes"] = memory_peak(ctx.device)
    cell.free_program()
    try:
        outcome["values"] = {"score_gap": cell.score_gap(cell.outputs, cell.reference_scores())}
    except ValueError as e:
        outcome["values"], outcome["problem"] = {}, str(e)
    return outcome
