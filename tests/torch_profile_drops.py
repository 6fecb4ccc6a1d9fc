"""How many device records the profiler loses at the start of a session,
without and with the profiled epoch's warm-up (``Trainer._warm_profiler``).
On a machine with one H100, from the repository root:

    python tests/torch_profile_drops.py [sessions]

Builds the kernels, then trains DIN through the CLI (the smoke's 50,000
synthetic rows, 1 epoch, full width) with ``--profile_dir``, ``sessions``
times (default 5) with ``PROFILER_WARMUP_S`` at 0 and as many
times at its default, all in one process. One JSON line a session: B1's
device events in the trace against B1's launches in epoch 1, the first
B1 event's offset (µs) from the trace's first event, and the kernel
launch records without a device record with their offsets.
"""

import json
import os
import sys
import tempfile

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as smoke  # noqa: E402
from rank_tpu_torch.train import loop  # noqa: E402

KERNEL = "din_attention_fwd_kernel"


def losses(path: str) -> dict:
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    start = min(e["ts"] for e in events if "ts" in e and "dur" in e)
    kernels = [e for e in events if e.get("cat") == "kernel"]
    recorded = {e["args"].get("correlation") for e in kernels}
    lost = sorted(e["ts"] - start for e in events
                  if e.get("cat") == "cuda_runtime" and "LaunchKernel" in e["name"]
                  and e["args"].get("correlation") not in recorded)
    b1 = sorted(e["ts"] - start for e in kernels if KERNEL in e["name"])
    return {"b1_events": len(b1), "first_b1_us": b1[0] if b1 else None, "lost": len(lost),
            "lost_offsets_us": lost}


def main(sessions: int = 5) -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    card = smoke.card_line()
    smoke.build_kernels()
    default = loop.PROFILER_WARMUP_S
    with tempfile.TemporaryDirectory() as workdir:
        for warmup in (0.0, default):
            loop.PROFILER_WARMUP_S = warmup
            for i in range(sessions):
                run = f"warmup{warmup}_{i}"
                trace_dir = os.path.join(workdir, run, "trace")
                with smoke.epoch_one_launches() as epoch1:
                    smoke.run_cli("din", smoke.SHARDED_ROWS, 1, workdir, card, run=run,
                                  extra=[f"--profile_dir={trace_dir}"])
                print(json.dumps({"warmup_s": warmup, "session": i,
                                  "b1_launches": epoch1["din_attention_fwd"],
                                  **losses(os.path.join(trace_dir, "trace_rank0.json")),
                                  "card": card}), flush=True)
    loop.PROFILER_WARMUP_S = default


if __name__ == "__main__":
    main(*(int(a) for a in sys.argv[1:]))
