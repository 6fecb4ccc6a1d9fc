"""Training cells: the port's ``Trainer`` over ``StagedRunner``'s
device-resident epochs, as ``rank_tpu_torch/fullscale.py`` drives them.

Set-up (counted in ``setup_s``):

  1. the rows are drawn on the device (``traffic.train_rows``) with a row id
     column, ``bench_row``, that the model does not read, and handed to the
     runner as numpy arrays, which it pads to whole batches and stages;
  2. the Trainer's model is drawn anew on the device from the seed
     (``weights.redraw_``) and its initial state kept for the reference;
  3. the first checked stretch: torch's default generators are seeded for
     dropout, and the first ``checked_steps`` batches of epoch 1's order go
     through ``Trainer.train_epoch`` one at a time: each step's loss, the
     first step's gradient as Adam's first moment holds it, and each leaf's
     change over the stretch are the program's readings;
  4. ``warmup_steps`` more batches go through ``train_epoch``, and a second
     epoch's order is drawn once and dropped, so that no allocation of that
     size falls in the window.

The window drives ``train_epoch`` over the rest of the epoch's slices, a new
global shuffle (``StagedRunner.shuffled``) each epoch, until the deadline;
``train_examples_per_s`` is the valid rows trained over the wall time from
its first step to the final meter read, which synchronises. After it comes
a second checked stretch, from the state the window left (all of an epoch's
rows, a new epoch's if fewer than ``checked_steps`` batches are left), and
the reference replays both: the first from the benchmark's initial state,
the second from the program's parameters and Adam moments before it, each
on the rows the program's batches name, with the same dropout stream.

A traced run also wraps ``Trainer.train_step`` and ``read_meters`` in
spans and profiles ``profile_steps`` steps from ``profile_at`` of the
window on.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional

import numpy as np
import torch

from .. import traffic as T
from .. import trace as tr
from .. import weights
from ..checks import train_gaps
from ..reference import common as ref_common
from .common import (Context, Phases, memory_peak, model_config, port_schema, release,
                     synchronize)

ROW_ID = "bench_row"


class Feed:
    """One epoch's order cut into batch-sized views, as the runner cuts it."""

    def __init__(self, order: Dict[str, torch.Tensor], steps: int, batch_size: int):
        self.order, self.steps, self.bs, self.i = order, steps, batch_size, 0

    @property
    def left(self) -> int:
        return self.steps - self.i

    def next(self) -> Dict[str, torch.Tensor]:
        a = self.i * self.bs
        self.i += 1
        return {k: v[a:a + self.bs] for k, v in self.order.items()}


def spanned(fn, name: str, times: List[float]):
    """``fn`` inside the benchmark span ``name``; its host seconds go to ``times``."""
    def wrapper(*args, **kwargs):
        t = time.perf_counter()
        with torch.profiler.record_function(name):
            out = fn(*args, **kwargs)
        times.append(time.perf_counter() - t)
        return out
    return wrapper


class Probe:
    """The traced slice: ``steps`` steps from the first one fed at or after
    ``at`` (perf_counter seconds); keeps each profiled step's history
    lengths, summed once the slice has closed."""

    def __init__(self, device: torch.device, at: float, steps: int, lengths_key: str,
                 notes: List[str]):
        self.slice, self.notes = tr.Slice(device), notes
        self.at, self.steps, self.key = at, steps, lengths_key
        self.on, self.done, self.lengths = False, False, []

    def before_step(self) -> None:
        if not (self.on or self.done) and time.perf_counter() >= self.at:
            self.slice.start()
            self.on = True
        elif self.on and len(self.lengths) >= self.steps:
            self.close()

    def fed(self, batch: Dict[str, torch.Tensor]) -> None:
        if self.on:
            self.lengths.append(batch[self.key])

    def close(self) -> None:
        if self.on:
            self.slice.stop()
            self.on, self.done = False, True
            self.notes.append(f"traced slice: {len(self.lengths)} steps, device bytes "
                              f"{self.slice.memory}")

    def units(self) -> List[dict]:
        if not self.lengths:
            return []
        sums = torch.stack([x.sum() for x in self.lengths]).tolist()
        return [{"rows": int(x.numel()), "valid_steps": int(s)}
                for x, s in zip(self.lengths, sums)]


class TrainCell:
    def __init__(self, ctx: Context):
        from rank_tpu_torch.train.loop import TrainConfig, Trainer
        from rank_tpu_torch.train.staged import StagedRunner

        self.ctx = ctx
        cfg, traffic, dev = ctx.config, ctx.traffic, ctx.device
        phase = Phases(ctx)
        (data_seed, weight_seed, self.dropout_seed, self.shuffle_seed,
         self.post_seed) = T.derived_seeds(ctx.seed, 5)
        self.layout = T.Layout.from_config(cfg)
        self.bs = traffic["batch_size"]
        catalog = T.Catalog(self.layout, traffic["feed_zipf_alpha"],
                            torch.Generator(device=dev).manual_seed(data_seed))
        rows = T.train_rows(catalog, traffic["rows"])
        rows[ROW_ID] = torch.arange(traffic["rows"], dtype=torch.int32, device=dev)
        self.host = {k: v.cpu().numpy() for k, v in rows.items()}
        del rows, catalog
        self.stats = {"mean_history": float(self.host[self.layout.history + "_length"].mean())}
        phase("rows drawn and copied to the host")

        opt = cfg["optimizer"]
        self.trainer = Trainer(
            port_schema(cfg), model_config(cfg),
            TrainConfig(batch_size=self.bs, learning_rate=opt["learning_rate"], seed=0,
                        log_every=0, label=cfg["schema"]["label"], matmul_precision="float32"),
            device=dev)
        self.state = self.trainer.init_state()
        model = self.state["model"]
        weights.redraw_(model, torch.Generator(device=dev).manual_seed(weight_seed))
        self.names = [n for n, _ in model.named_parameters()]
        phase("model built and drawn")
        self.runner = StagedRunner(self.trainer, self.host,
                                   {k: v[:1] for k, v in self.host.items()}, self.bs,
                                   shuffle_mode=traffic["shuffle"])
        phase("rows staged")
        self.phase = phase
        self.epoch, self.feed = 0, None  # the first checked stretch opens epoch 1
        self.first: Optional[dict] = None   # the checked stretches
        self.after: Optional[dict] = None

    # -- set-up ---------------------------------------------------------------

    def _snapshot(self):
        """The program's state dict, each leaf's Adam moments, and Adam's
        step count (None before the first step)."""
        model, opt = self.state["model"], self.state["optimizer"]
        params = {k: v.detach().clone() for k, v in model.state_dict().items()}
        moments, steps = {}, None
        for n, p in model.named_parameters():
            st = opt.state.get(p)
            if st:
                moments[n] = (st["exp_avg"].detach().clone(), st["exp_avg_sq"].detach().clone())
                steps = int(st["step"])
            else:
                moments[n] = (torch.zeros_like(p), torch.zeros_like(p))
        return params, (moments if steps else None), steps or 0

    def _next_epoch(self) -> None:
        self.epoch += 1
        with torch.profiler.record_function("port_bench::shuffle"):
            order = self.runner.shuffled(self.epoch, self.shuffle_seed)
        self.feed = Feed(order, self.runner.train_steps, self.bs)

    def checked(self, dropout_seed: int) -> dict:
        """A checked stretch: ``checked_steps`` of the program's steps, one
        ``train_epoch`` call each, on rows of one epoch, from the state the
        program is in. Keeps that state, the rows of each batch and the
        program's readings."""
        n = self.ctx.traffic["checked_steps"]
        if self.feed is None or self.feed.left < n:
            self._next_epoch()
        model, opt = self.state["model"], self.state["optimizer"]
        before, moments, steps = self._snapshot()
        beta1 = opt.param_groups[0]["betas"][0]
        torch.manual_seed(dropout_seed)
        losses, grads, rows = [], {}, []
        for i in range(n):
            batch = self.feed.next()
            rows.append((batch[ROW_ID], batch["_valid"]))
            _, out = self.trainer.train_epoch(self.state, [batch], self.epoch)
            losses.append(out["loss"])
            if i == 0:
                grads = {name: float((opt.state[p]["exp_avg"] - beta1 * moments[name][0]
                                      if moments else opt.state[p]["exp_avg"]).norm()) / (1 - beta1)
                         if p in opt.state else 0.0 for name, p in model.named_parameters()}
        change = {name: float((p.detach() - before[name]).norm())
                  for name, p in model.named_parameters()}
        self.phase(f"checked stretch at step {steps}")
        return {"readings": {"losses": losses, "grad_norms": grads, "change_norms": change},
                "state": before, "moments": moments, "steps_before": steps,
                "rows": [(i.cpu().numpy(), v.cpu().numpy()) for i, v in rows],
                "dropout_seed": dropout_seed}

    def warm(self) -> None:
        steps = min(self.ctx.traffic["warmup_steps"], self.feed.left - 1)
        self.trainer.train_epoch(self.state, (self.feed.next() for _ in range(steps)), self.epoch)
        self.runner.shuffled(self.epoch + 1, self.shuffle_seed)
        synchronize(self.ctx.device)
        self.phase("warm-up steps")

    # -- the window -------------------------------------------------------------

    def _batches(self, deadline: float, probe: Optional[Probe]):
        while self.feed.left and time.perf_counter() < deadline:
            if probe is not None:
                probe.before_step()
            batch = self.feed.next()
            if probe is not None:
                probe.fed(batch)
            self.steps += 1
            yield batch

    def window(self) -> dict:
        ctx, traffic = self.ctx, self.ctx.traffic
        step_s: List[float] = []
        probe = None
        if ctx.trace:
            self.trainer.train_step = spanned(self.trainer.train_step,
                                              "port_bench::train_step", step_s)
            self.trainer.read_meters = spanned(self.trainer.read_meters,
                                               "port_bench::read_meters", [])
        self.steps, count = 0, 0.0
        t_start = time.perf_counter()
        setup_s = time.time() - ctx.started
        deadline = t_start + ctx.seconds
        if ctx.trace:
            probe = Probe(ctx.device, t_start + traffic["profile_at"] * ctx.seconds,
                          traffic["profile_steps"], self.layout.history + "_length", ctx.notes)
        while time.perf_counter() < deadline:
            if not self.feed.left:
                self._next_epoch()
            _, out = self.trainer.train_epoch(self.state, self._batches(deadline, probe),
                                              self.epoch)
            count += out["count"]
        seconds = time.perf_counter() - t_start
        if probe is not None:
            probe.close()
        self.phase("window")
        record = None
        if ctx.trace:
            record = {"trace": probe.slice.read() if probe.done else None, "units": probe.units(),
                      "spans": {"train_step": step_s}, "stats": self.stats,
                      "window": {"examples": count, "seconds": seconds, "steps": self.steps}}
        return {"end_to_end": {"train_examples_per_s": count / seconds, "setup_s": setup_s},
                "attempted": self.steps, "failed": 0, "record": record}

    def free_program(self) -> None:
        self.trainer = self.state = self.runner = self.feed = None
        release(self.ctx.device)

    # -- the reference ------------------------------------------------------------

    def _reference_batch(self, ids: np.ndarray, valid: np.ndarray, half: bool):
        """The rows the program's batch names, from the benchmark's own data.
        Rows other than row 0 are valid; the runner pads an epoch with copies
        of row 0, of which at most one may be valid."""
        real = ids != 0
        if len(np.unique(ids[real])) != int(real.sum()):
            raise ValueError("a checked batch names a row twice")
        want = np.where(real, 1.0, valid).astype(np.float32)
        if want[~real].sum() > 1:
            raise ValueError("a checked batch holds row 0 valid more than once")
        if half:
            want[len(want) // 2:] = 0.0
        dev = self.ctx.device
        batch = {k: torch.as_tensor(v[ids]).to(dev) for k, v in self.host.items() if k != ROW_ID}
        batch["_valid"] = torch.as_tensor(want).to(dev)
        return batch

    def reference_readings(self, stretch: dict, tf32: bool = False,
                           half_batch: bool = False) -> dict:
        """The reference's replay of a checked stretch from the state before
        it; ``tf32`` computes it a precision below the configuration's (the
        control), ``half_batch`` takes the loss over half of each batch (a
        planted fault)."""
        ref = self.ctx.reference()
        ref_common.expect(stretch["state"], ref.shapes(self.ctx.config))
        batches = [self._reference_batch(i, v, half_batch) for i, v in stretch["rows"]]
        with ref_common.precision(tf32):
            return ref_common.replay(ref.forward, stretch["state"], self.names, batches,
                                     self.ctx.config, stretch["dropout_seed"],
                                     stretch["moments"], stretch["steps_before"])

    def stretches(self):
        """(prefix of the numbers, stretch) of each checked stretch."""
        return [(p, s) for p, s in (("", self.first), ("post_", self.after)) if s is not None]

    def values(self) -> dict:
        """The numbers compared: the program's readings against the
        reference's replay, for each checked stretch."""
        tables = self.ctx.reference().tables(self.ctx.config)
        out = {}
        for prefix, stretch in self.stretches():
            out.update(train_gaps(stretch["readings"], self.reference_readings(stretch),
                                  tables, prefix))
        return out


def run(ctx: Context) -> dict:
    cell = TrainCell(ctx)
    cell.first = cell.checked(cell.dropout_seed)
    cell.warm()
    outcome = cell.window()
    outcome["memory_peak_bytes"] = memory_peak(ctx.device)
    cell.after = cell.checked(cell.post_seed)
    cell.free_program()
    try:
        outcome["values"] = cell.values()
    except ValueError as e:
        outcome["values"], outcome["problem"] = {}, str(e)
    if outcome["record"] is not None:
        outcome["record"]["products_per_example"] = ctx.work().train_products(
            ctx.config, cell.stats)
    return outcome
