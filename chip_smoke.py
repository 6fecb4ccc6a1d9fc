"""Smoke test of the PyTorch/CUDA port (``rank_tpu_torch``) on one GPU.

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases; any failure raises and the script exits non-zero:

  1. device: requires ``torch.cuda.is_available()``; prints the card's
     name and power limit (``nvidia-smi``);
  2. build: compiles every hand-written kernel from the sources in the
     checkout and prints the build time and the compiler's register and
     shared-memory report;
  3. kernels vs plain: each kernel against its plain torch version on the
     card, at the main path's shapes and at edge cases (B=1, B=7, empty
     and full rows, both softmax modes), within rtol/atol 1e-5;
  4. main path: full-width DIN (``WECHAT_SCHEMA``, ``default_config("din")``,
     random seeded weights, random BatchNorm statistics and Dice alphas)
     served by ``Predictor`` for requests of 1, 100, 1000 and 5000 rows.
     Launch counts are zeroed just before and read just after; every
     kernel of the path must have launched. Each answer is held against
     the same weights served with the plain attention on the card, and a
     profiler trace of one request must show the kernel on the device;
  5. times on the card: each kernel, its plain version (no yardstick of
     speed: it repeats the kernel's arithmetic in unfused torch ops) and
     the least time the card could take (``bound_ms``), by CUDA events
     with a cold L2; Predictor latency per request size by host clock,
     with the kernel and the plain attention in turns.

Then it prints one line ``{"kernels": [...]}``, the card's line and, last,
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from rank_tpu_torch import WECHAT_SCHEMA, Predictor, build_model, default_config
from rank_tpu_torch.data.synthetic import make_synthetic_dataset
from rank_tpu_torch.ops.kernels import _build
from rank_tpu_torch.ops.kernels import din_attention as din_kernels

SEED = 0
TOL = dict(rtol=1e-5, atol=1e-5)
REQUEST_ROWS = (1, 100, 1000, 5000)
# Published H100 SXM peaks (NVIDIA data sheet, dense): f32 outside the
# tensor cores, and HBM3. The bound is stated against them.
PEAK_F32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def emit(**fields) -> None:
    print(json.dumps(fields), flush=True)


def check(ok, message: str) -> None:
    """Raise on a failed check (``assert`` would vanish under ``python -O``)."""
    if not ok:
        raise RuntimeError(message)


def din_inputs(b: int, gen: torch.Generator, t: int = 50, d: int = 16):
    """DIN attention inputs as the main path makes them: N(0,1) embedding
    rows, lengths uniform in [0, T] with an empty and a full row, and
    lecun-scaled weights with random biases."""
    q = torch.randn(b, d, generator=gen)
    k = torch.randn(b, t, d, generator=gen)
    lengths = torch.randint(0, t + 1, (b,), generator=gen, dtype=torch.int32)
    lengths[-1] = t
    if b > 1:
        lengths[0] = 0
    shapes = [(4 * d, 64), (64,), (64, 32), (32,), (32, 1), (1,)]
    params = [torch.randn(s, generator=gen) * (s[0] ** -0.5 if len(s) == 2 else 0.3)
              for s in shapes]
    cuda = lambda x: x.cuda().contiguous()
    return cuda(q), cuda(k), cuda(lengths), tuple(map(cuda, params))


def din_bound(lengths: torch.Tensor, t: int, d: int, h1: int, h2: int):
    """(ms, 'bytes' | 'operations'): the least time the card could take for
    DIN attention on these inputs. Only timesteps below each row's length
    affect the output, so only they are counted: their keys are read once,
    and each costs the folded first layer (2*2*D*H1), the second and third
    layers (2*H1*H2 + 2*H2) and the pool (2*D); each row adds q@w1q
    (2*D*H1). Output written once; weights read once."""
    b = lengths.numel()
    valid = int(lengths.clamp(0, t).sum())
    flops = b * 2 * d * h1 + valid * (4 * d * h1 + 2 * h1 * h2 + 2 * h2 + 2 * d)
    weights = 4 * d * h1 + h1 + h1 * h2 + 2 * h2 + 1
    nbytes = 4 * (b * d + valid * d + b + weights + b * d)
    t_ops, t_bytes = flops / PEAK_F32_FLOPS * 1e3, nbytes / PEAK_HBM_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def device_ms(fn, flush: torch.Tensor) -> float:
    """Device time of one call by CUDA events, with L2 flushed first (the
    50 MB L2 would otherwise hold the inputs)."""
    flush.zero_()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def host_ms(fn) -> float:
    """Host time of one call whose result is already on the host."""
    t0 = time.perf_counter()
    fn()
    return (time.perf_counter() - t0) * 1e3


def times_in_turns(fns, timer, runs: int = 30, warmup: int = 5):
    """``runs`` times of each of ``fns``, run in turns (a, b, b, a, ...) so
    that a drift of clocks or of neighbours on the host falls on all alike."""
    for fn in fns:
        for _ in range(warmup):
            fn()
    times = [[] for _ in fns]
    for i in range(runs):
        for j in (range(len(fns)) if i % 2 == 0 else reversed(range(len(fns)))):
            times[j].append(timer(fns[j]))
    return times


def check_din_kernel(gen: torch.Generator) -> float:
    """Phase 3: the kernel against its plain version; returns the largest
    error at the main path's shapes (B = 256 and 8192)."""
    worst = 0.0
    for b in (1, 7, 256, 8192):
        q, k, lengths, params = din_inputs(b, gen)
        for use_softmax in (False, True):
            got = din_kernels.din_attention_cuda(q, k, lengths, params, use_softmax)
            want = din_kernels.din_attention_plain(q, k, lengths, params, use_softmax)
            torch.cuda.synchronize()
            err = (got - want).abs().max().item()
            emit(phase="kernel_vs_plain", kernel="din_attention_fwd", B=b,
                 use_softmax=use_softmax, max_abs_err=err)
            torch.testing.assert_close(got, want, **TOL)
            if b > 1:
                check(torch.all(got[0] == 0), "a zero-length row must pool to zeros")
            if b >= 256:
                worst = max(worst, err)
    return worst


def randomize_eval_state(model: torch.nn.Module, gen: torch.Generator) -> None:
    """Random non-trivial BatchNorm statistics and affine parameters and
    Dice alphas, so eval-mode BatchNorm and Dice do real work."""
    with torch.no_grad():
        for name, tensor in model.state_dict().items():
            leaf = name.rsplit(".", 1)[-1]
            if leaf == "running_var":
                tensor.copy_(torch.rand(tensor.shape, generator=gen) * 1.5 + 0.5)
            elif leaf == "running_mean" or leaf == "alpha" or (
                leaf == "bias" and "BatchNorm" in name
            ):
                tensor.copy_(torch.randn(tensor.shape, generator=gen) * 0.5)
            elif leaf == "weight" and "BatchNorm" in name:
                tensor.copy_(torch.randn(tensor.shape, generator=gen) * 0.5 + 1.0)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke test runs on the GPU only",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain versions in full f32
    torch.backends.cudnn.allow_tf32 = False

    # 1. device
    card = card_line()
    print(card, flush=True)
    emit(phase="device", card=card, kind=torch.cuda.get_device_name(0),
         torch=torch.__version__, cuda=torch.version.cuda)

    # 2. build
    t0 = time.perf_counter()
    _, report = _build.build("din_attention")
    din_kernels.library()
    emit(phase="build", kernel="din_attention_fwd", seconds=time.perf_counter() - t0,
         ptxas=[line.strip() for line in report.splitlines()
                if "registers" in line or "Compiling entry" in line])

    # 3. kernels against their plain versions
    gen = torch.Generator().manual_seed(SEED)
    max_abs_err = check_din_kernel(gen)

    # 4. main path: full-width DIN served by Predictor
    cfg = default_config("din")
    model = build_model(WECHAT_SCHEMA, cfg, device="cuda", generator=gen)
    randomize_eval_state(model, gen)
    state_dict = model.state_dict()
    pred = Predictor(WECHAT_SCHEMA, cfg, state_dict=state_dict)
    plain_pred = Predictor(WECHAT_SCHEMA, cfg.replace(kernel_backend="jnp"), state_dict=state_dict)
    data = make_synthetic_dataset(WECHAT_SCHEMA, num_rows=max(REQUEST_ROWS), seed=SEED)
    requests = {n: {k: v[:n] for k, v in data.items() if k != "labels"} for n in REQUEST_ROWS}

    din_kernels.din_attention_cuda.launches = 0
    answers = {n: pred(req)["score"] for n, req in requests.items()}
    launches = din_kernels.din_attention_cuda.launches
    check(launches > 0, "the main path never launched din_attention_fwd")
    for n, got in answers.items():
        want = plain_pred(requests[n])["score"]
        err = float(np.max(np.abs(got - want)))
        emit(phase="main_path", rows=n, max_abs_err_vs_plain=err,
             mean_score=float(got.mean()))
        check(got.shape == (n,) and got.dtype == np.float32,
              f"{n} rows: scores of shape {got.shape} and type {got.dtype}")
        check(np.all(np.isfinite(got)) and np.all((got > 0) & (got < 1)),
              f"{n} rows: scores not finite or outside (0, 1)")
        np.testing.assert_allclose(got, want, **TOL)

    with torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    ) as prof:
        traced_ms = host_ms(lambda: pred(requests[max(REQUEST_ROWS)]))
    device_events = [e for e in prof.key_averages()
                     if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA]
    names = [e.key for e in device_events]
    check(any("din_attention_fwd_kernel" in name for name in names),
          f"din_attention_fwd_kernel not among the CUDA kernels traced: {names}")

    def device_us(e) -> float:  # renamed from cuda_time_total in newer torch
        return getattr(e, "device_time_total", None) or getattr(e, "cuda_time_total", 0.0)

    top = sorted(device_events, key=lambda e: -device_us(e))[:8]
    device_total_us = sum(device_us(e) for e in device_events)
    emit(phase="profile", rows=max(REQUEST_ROWS),
         device_us={e.key[:80]: device_us(e) for e in top},
         device_us_total=device_total_us, device_launches=sum(e.count for e in device_events),
         traced_request_ms=traced_ms)

    # 5. times on the card
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    timings = {}
    for b in (256, 8192):
        q, k, lengths, params = din_inputs(b, gen)
        kernel_ms, plain_ms = map(statistics.median, times_in_turns(
            [lambda: din_kernels.din_attention_cuda(q, k, lengths, params, True),
             lambda: din_kernels.din_attention_plain(q, k, lengths, params, True)],
            lambda fn: device_ms(fn, flush)))
        bound_ms, bound_by = din_bound(lengths, 50, 16, 64, 32)
        timings[b] = (kernel_ms, plain_ms, bound_ms, bound_by)
        emit(phase="time", kernel="din_attention_fwd", B=b, ms=kernel_ms,
             plain_ms_no_yardstick=plain_ms, bound_ms=bound_ms, bound_by=bound_by, card=card)
    kernel_latency = {}
    for n, req in requests.items():
        # 100 requests each: p90 is then the highest percentile with ten beyond it
        both = times_in_turns([lambda: pred(req), lambda: plain_pred(req)], host_ms, runs=100)
        for attention, lat in zip(("kernel", "plain"), both):
            emit(phase="predictor_latency", attention=attention, rows=n, requests=len(lat),
                 median_ms=statistics.median(lat), p90_ms=float(np.percentile(lat, 90)),
                 card=card)
        kernel_latency[n] = statistics.median(both[0])
    # the traced request's device time against the untraced latency (the
    # profiler itself slows the host several times over)
    emit(phase="device_busy", rows=max(REQUEST_ROWS),
         share=device_total_us / 1e3 / kernel_latency[max(REQUEST_ROWS)], card=card)

    kernel_ms, plain_ms, bound_ms, bound_by = timings[8192]
    emit(kernels=[{
        "name": "din_attention_fwd",
        "route": "cuda",
        "source": "rank_tpu_torch/ops/kernels/csrc/din_attention.cu",
        "replaces": "rank_tpu/ops/pallas/din_attention.py:156",
        "launches": launches,
        "max_abs_err": max_abs_err,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,  # no single PyTorch call computes DIN attention
    }])
    print(card, flush=True)
    emit(ok=True, device={"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                          "count": torch.cuda.device_count()})
    return 0


if __name__ == "__main__":
    sys.exit(main())
