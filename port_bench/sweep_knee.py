#!/usr/bin/env python3
"""Find the highest rate a serving cell sustains, once, on the card.

    python3 port_bench/sweep_knee.py --workload din.serve.poisson --rates 300,400,500 \
        --seconds 10 --seed 7

For each rate, the cell's open loop for ``--seconds`` (its traffic mix with
``rate_per_s`` replaced), and one JSON line: p50, p95 and p99 latency, the
median service time, the server's busy share, and the mean queue wait of
the first and the last fifth of the requests. The backlog grows where the
last fifth waits far longer than the first; the knee is the highest rate
where it does not. The cell's rate is then set at about four fifths of it.
"""

import argparse
import contextlib
import json
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--rates", required=True, help="comma-separated requests a second")
    p.add_argument("--seconds", type=float, default=10.0)
    p.add_argument("--seed", type=int, default=7)
    args = p.parse_args(argv)

    import torch

    from port_bench import spec
    from port_bench.drivers.common import Context
    from port_bench.drivers.serve_open_loop import ServeCell

    if not torch.cuda.is_available():
        print("sweep_knee.py reads the card: no CUDA device", file=sys.stderr)
        return 2
    bench = spec.benchmark()
    cell = spec.workload(bench, args.workload)
    config = spec.config(bench, cell["config"])
    for rate in (float(r) for r in args.rates.split(",")):
        traffic = dict(spec.traffic(cell["traffic"]), rate_per_s=rate)
        ctx = Context(cell=cell, config=config, traffic=traffic, seed=args.seed,
                      seconds=args.seconds, trace=False, device=torch.device("cuda", 0),
                      started=time.time())
        with contextlib.redirect_stdout(sys.stderr):
            serve = ServeCell(ctx)
            serve.warm()
            out = serve.window()
        wait = serve.wait[np.isfinite(serve.wait)]
        fifth = max(1, len(wait) // 5)
        e2e = out["end_to_end"]
        rows = np.diff(serve.requests.offsets)
        line = {"rate_per_s": rate, "requests": serve.n, "failed": out["failed"],
                "p50_ms": e2e["serve_p50_ms"],
                "p95_ms": float(np.percentile(serve.latency, 95) * 1e3),
                "p99_ms": float(np.percentile(serve.latency, 99) * 1e3),
                "service_p50_ms": float(np.nanmedian(serve.service) * 1e3),
                "busy_share": float(np.nansum(serve.service) / args.seconds),
                "wait_first_fifth_ms": float(wait[:fifth].mean() * 1e3),
                "wait_last_fifth_ms": float(wait[-fifth:].mean() * 1e3),
                "mean_rows": float(rows.mean())}
        print(json.dumps(line), flush=True)
        serve.free_program()
    return 0


if __name__ == "__main__":
    sys.exit(main())
