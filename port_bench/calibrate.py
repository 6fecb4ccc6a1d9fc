#!/usr/bin/env python3
"""Readings that the limits of the output check are set from, on the card.

    python3 port_bench/calibrate.py --workload <cell> --seeds 1,2,3 [--seconds 30]

For each seed, one JSON line with the numbers that decide ``correct``:

  * ``program``: the program against the reference, as a run reads them
    (training: the checked stretches before and after a window of
    ``--seconds``, by default the benchmark's ``run_seconds``, so that the
    second stretch starts from the state a timed run leaves; serving: a
    window of ``--seconds`` at the cell's load, every request compared);
  * ``control``: the reference computed in TF32, in the program's place,
    against the reference in f32;
  * training only, ``half_batch``: the reference with the loss taken over
    half of each batch, in the program's place.

The lower limit is the largest ``program`` reading over a dozen seeds or
more, the upper the smallest ``control`` (or fault) reading.
"""

import argparse
import contextlib
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def beside(got: dict, ref: dict) -> dict:
    """The readings the compared numbers stand in for: each step's loss gap,
    the worst leaf's change gap with that leaf, and the leaf of the worst
    gradient gap with its two norms and the median leaf's."""
    import statistics

    from port_bench.checks import leaf_gaps, moving_leaves

    gaps = leaf_gaps(got["change_norms"], ref["change_norms"], moving_leaves(ref))
    leaf = max(gaps, key=gaps.get)
    grads = leaf_gaps(got["grad_norms"], ref["grad_norms"], ref["grad_norms"])
    worst = max(grads, key=grads.get)
    return {"loss_gaps": [abs(a - b) / abs(b) for a, b in zip(got["losses"], ref["losses"])],
            "worst_change_gap": gaps[leaf], "worst_change_leaf": leaf,
            "worst_grad_leaf": worst, "worst_grad_norms": [got["grad_norms"][worst],
                                                           ref["grad_norms"][worst]],
            "median_grad_norm": statistics.median(ref["grad_norms"].values())}


def readings(ctx) -> dict:
    from port_bench.checks import train_gaps
    from port_bench.drivers import serve_open_loop, train_staged

    if ctx.traffic["driver"] == "train_staged":
        cell = train_staged.TrainCell(ctx)
        cell.first = cell.checked(cell.dropout_seed)
        cell.warm()
        cell.window()
        cell.after = cell.checked(cell.post_seed)
        cell.free_program()
        tables = ctx.reference().tables(ctx.config)
        out = {"program": {}, "control": {}, "half_batch": {}, "beside": {}}
        for prefix, stretch in cell.stretches():
            ref = cell.reference_readings(stretch)
            control = cell.reference_readings(stretch, tf32=True)
            half = cell.reference_readings(stretch, half_batch=True)
            out["program"].update(train_gaps(stretch["readings"], ref, tables, prefix))
            out["control"].update(train_gaps(control, ref, tables, prefix))
            out["half_batch"].update(train_gaps(half, ref, tables, prefix))
            out["beside"][prefix + "program"] = beside(stretch["readings"], ref)
            out["beside"][prefix + "control"] = beside(control, ref)
        return out
    cell = serve_open_loop.ServeCell(ctx)
    cell.warm()
    cell.window()
    cell.free_program()
    ref = cell.reference_scores()
    return {"program": {"score_gap": cell.score_gap(cell.outputs, ref)},
            "control": {"score_gap": cell.score_gap(cell.reference_scores(tf32=True), ref)}}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated seeds")
    p.add_argument("--seconds", type=float, default=None,
                   help="the window (default: the benchmark's run_seconds)")
    args = p.parse_args(argv)

    import torch

    from port_bench import spec
    from port_bench.drivers.common import Context

    if not torch.cuda.is_available():
        print("calibrate.py reads the card: no CUDA device", file=sys.stderr)
        return 2
    bench = spec.benchmark()
    cell = spec.workload(bench, args.workload)
    config, traffic = spec.config(bench, cell["config"]), spec.traffic(cell["traffic"])
    for seed in (int(s) for s in args.seeds.split(",")):
        ctx = Context(cell=cell, config=config, traffic=traffic, seed=seed,
                      seconds=args.seconds or bench["run_seconds"], trace=False,
                      device=torch.device("cuda", 0), started=time.time())
        t = time.time()
        with contextlib.redirect_stdout(sys.stderr):
            out = readings(ctx)
        print(json.dumps({"workload": cell["name"], "seed": seed, **out,
                          "seconds": time.time() - t}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
