"""Smoke test of the PyTorch/CUDA port (``rank_tpu_torch``) on one GPU.

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases; any failure raises and the script exits non-zero:

  1. device: requires ``torch.cuda.is_available()``; prints the card's
     name and power limit (``nvidia-smi``);
  2. build: compiles every hand-written kernel from the sources in the
     checkout, one ``nvcc`` per source, all started together, and prints
     the build time and the compiler's register and shared-memory report;
     then ``cuobjdump -sass`` of each library counts the tensor-core
     instructions (HMMA, HGMMA) of each kernel, and fails if a kernel has
     none;
  3. kernels vs plain: each kernel against its plain torch version on the
     card, within rtol/atol 1e-5: B1 (DIN attention) at B in {1, 7, 256,
     1024, 8192}, lengths that include 0, 1, 15, 16, 17, 49 and 50, both
     softmax modes, and at D in {8, 32, 64} (the kernel's other
     instantiations); B2 (one CIN layer) at both layers' shapes of the
     default xDeepFM and B in {1, 7, 256, 1001, 1024, 8192} (B = 1001: rows
     that are not a multiple of the block's row tile), one shape whose H
     and O need padding and one with O over three output tiles; and for
     both, the gradients through their autograd Function against autograd
     through the plain version, at B = 1024;
  4. main paths, each with the launch counts zeroed just before it and
     read just after; every kernel of the path must have launched:
     a. training: ``rank_tpu_torch.cli.main`` on ``--model=xdeepfm
        --synthetic=200000 --num_epochs=2`` at the defaults (full width)
        in a temporary directory; B2 must launch in every train and eval
        step, the loss must be finite, ``best_model`` and
        ``predictions.csv`` must exist and eval AUC must pass 0.6 (a
        learning-sanity bar). Then ``--model=din`` at 50,000 rows: B1 must
        launch, and the attention weights must move from their initial
        values (their gradient flows through B1's autograd Function);
     b. serving from ``model_dir``: ``Predictor`` serves the xDeepFM run's
        best model through B2, held against the same weights served with
        the plain CIN to 1e-5;
     c. serving DIN at full width (random seeded weights, random BatchNorm
        statistics and Dice alphas) for requests of 1, 100, 1000 and 5000
        rows, held against the plain attention; a profiler trace of one
        request must show B1 on the device;
     d. the rest of the single-task zoo (slice 4: afm, autoint, bst, dcn,
        deepcrossing, deepfm, dien, ffm, fibinet, flen, fwfm, pnn,
        widedeep), which runs no hand-written kernel: each trains through
        ``cli.main`` at ``default_config`` on the full schema
        (``--synthetic=100000 --num_epochs=1``); the loss must be finite,
        ``best_model`` and ``predictions.csv`` must exist, and where the
        JAX package's record passes 0.7 eval AUC must pass 0.6. Then
        ``Predictor(model_dir=...)`` serves requests of 1, 1000 and 5000
        rows on the card, held against the same best model served on the
        CPU (the card's own arithmetic): f32 models to 1e-5, BST and
        AutoInt at their bf16 defaults to the probability bar of
        ``tests/test_torch_zoo_forward.py`` (0.05), and BST once more at
        f32, to 1e-5; and its latency at 1000 rows;
     e. the multi-task models (slice 5), which run no hand-written kernel:
        mmoe, ple and esmm through ``cli.main`` at ``default_config``
        (``--synthetic=100000 --num_epochs=1``), and mmoe again under
        ``--task_weighting`` uncertainty, gradnorm and pcgrad (3 tasks).
        Each run's loss must be finite and every task AUC above 0.6; under
        gradnorm the saved GradNorm weights must sum to T and have moved
        from 1. Each ``model_dir`` is served like the zoo's, every head
        on the card against the CPU at f32 to 1e-5;
  5. times on the card: each kernel, its plain version (no yardstick of
     speed: it repeats the kernel's arithmetic in unfused torch ops), the
     one PyTorch call that computes the same function where there is one
     (``library_ms``) and the least time the card could take, in f32
     outside the tensor cores (``bound_ms``) and through the tensor cores
     in 3xTF32 (``bound_tc_ms``; ``bound_mma_sync_ms`` at the mma.sync TF32
     rate measured first by ``csrc/mma_ceiling.cu``), by CUDA events with
     a cold L2, at B in {256, 1024, 8192} (B2: both layers); Predictor
     latency per request size by host clock, kernel and plain in turns;
     and profiler traces of xDeepFM, BST, DIEN, MMOE and MMOE under PCGrad
     train steps (B = 1024): step time, the top device operations,
     launches a step and the device-busy share.

Then it prints one line ``{"kernels": [...]}``, the card's line and, last,
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import concurrent.futures
import ctypes
import json
import math
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from rank_tpu_torch import WECHAT_SCHEMA, Predictor, build_model, default_config
from rank_tpu_torch import cli
from rank_tpu_torch.data.synthetic import make_synthetic_dataset
from rank_tpu_torch.ops.cin import xavier_uniform_
from rank_tpu_torch.ops.kernels import _build
from rank_tpu_torch.ops.kernels import cin as cin_kernels
from rank_tpu_torch.ops.kernels import din_attention as din_kernels
from rank_tpu_torch.train import TrainConfig, Trainer

SEED = 0
TOL = dict(rtol=1e-5, atol=1e-5)
REQUEST_ROWS = (1, 100, 1000, 5000)
XDEEPFM_ROWS = 200_000
DIN_ROWS = 50_000
# slice 4: the single-task models without a hand-written kernel, trained
# one epoch each; the JAX package's synthetic record (RESULTS_synthetic.md)
# passes 0.7 eval AUC for those of ZOO_AUC_BAR. DeepFM, FwFM, FFM and PNN
# see no dense features and sit near 0.5 there, so theirs is printed only.
ZOO_MODELS = ("afm", "autoint", "bst", "dcn", "deepcrossing", "deepfm", "dien", "ffm",
              "fibinet", "flen", "fwfm", "pnn", "widedeep")
ZOO_AUC_BAR = ("afm", "autoint", "bst", "dcn", "deepcrossing", "dien", "fibinet", "flen")
ZOO_ROWS = 100_000
# slice 5: the multi-task models, and mmoe under each gradient weighting;
# the JAX package's synthetic record gives 0.78-0.87 for every task AUC
MULTITASK_RUNS = (("mmoe", "sum"), ("ple", "sum"), ("esmm", "sum"), ("mmoe", "uncertainty"),
                  ("mmoe", "gradnorm"), ("mmoe", "pcgrad"))
ZOO_REQUEST_ROWS = (1, 1000, 5000)
# card against CPU at the bf16 defaults of BST and AutoInt: the probability
# bar of tests/test_torch_zoo_forward.py (BF16_BAR)
BF16_PROB_ATOL = 0.05
F32_TRANSFORMER = dict(transformer_dtype="float32", transformer_score_dtype="float32")
# Published H100 SXM peaks (NVIDIA data sheet, dense): f32 outside the
# tensor cores, TF32 on the tensor cores, and HBM3. The bounds are stated
# against them.
PEAK_F32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12
PEAK_HBM_BYTES = 3.35e12
# The kernels' B values at the main paths' shapes, and the lengths around
# B1's 16-row tiles that every B1 check holds.
TIMED_B = (256, 1024, 8192)
RAGGED_LENGTHS = (0, 1, 15, 16, 17, 49, 50)
# (H, F, O) of B2 checks beside the default xDeepFM's layers: H and O that
# the kernel pads, and O over three 128-wide output tiles, the last partial.
OTHER_CIN_SHAPES = {"padded": (12, 5, 10), "wide": (64, 7, 300)}


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


def bound(flops: float, nbytes: float):
    """(ms, 'bytes' | 'operations'): the larger of the two least times, in
    f32 outside the tensor cores."""
    t_ops, t_bytes = flops / PEAK_F32_FLOPS * 1e3, nbytes / PEAK_HBM_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def bound_tc(product_flops: float, f32_flops: float, nbytes: float,
             tf32_flops: float = PEAK_TF32_FLOPS) -> float:
    """The least time through the tensor cores in 3xTF32, ms: three TF32
    products for each product FLOP at ``tf32_flops``, the rest in f32, or
    the bytes, whichever is longer."""
    t_ops = (3 * product_flops / tf32_flops + f32_flops / PEAK_F32_FLOPS) * 1e3
    return max(t_ops, nbytes / PEAK_HBM_BYTES * 1e3)


def bounds(f32_flops: float, product_flops: float, rest_flops: float, nbytes: float,
           mma_sync_tflops: float) -> dict:
    """A kernel's least times, ms: in f32 outside the tensor cores
    (``bound_ms``, with what bounds it), through the tensor cores in
    3xTF32 at the published TF32 peak (``bound_tc_ms``), and the same at
    the mma.sync rate measured on this card (``bound_mma_sync_ms``)."""
    ms, by = bound(f32_flops, nbytes)
    return {"bound_ms": ms, "bound_by": by,
            "bound_tc_ms": bound_tc(product_flops, rest_flops, nbytes),
            "bound_mma_sync_ms": bound_tc(product_flops, rest_flops, nbytes,
                                          mma_sync_tflops * 1e12)}


def din_inputs(b: int, gen: torch.Generator, t: int = 50, d: int = 16):
    """DIN attention inputs as the main path makes them: N(0,1) embedding
    rows, lengths uniform in [0, T] with a full last row and, in the first
    rows, the lengths of ``RAGGED_LENGTHS``, and lecun-scaled weights with
    random biases."""
    q = torch.randn(b, d, generator=gen)
    k = torch.randn(b, t, d, generator=gen)
    lengths = torch.randint(0, t + 1, (b,), generator=gen, dtype=torch.int32)
    lengths[-1] = t
    if b > 1:
        ragged = torch.tensor(RAGGED_LENGTHS[: b], dtype=torch.int32).clamp(max=t)
        lengths[: len(ragged)] = ragged
    shapes = [(4 * d, 64), (64,), (64, 32), (32,), (32, 1), (1,)]
    params = [torch.randn(s, generator=gen) * (s[0] ** -0.5 if len(s) == 2 else 0.3)
              for s in shapes]
    cuda = lambda x: x.cuda().contiguous()
    return cuda(q), cuda(k), cuda(lengths), tuple(map(cuda, params))


def din_bound(lengths: torch.Tensor, t: int, d: int, h1: int, h2: int,
              mma_sync_tflops: float) -> dict:
    """The least time for DIN attention on these inputs. Only timesteps
    below each row's length affect the output, so only they are counted:
    their keys are read once, and each costs the folded first layer
    (2*2*D*H1), the second and third layers (2*H1*H2 + 2*H2) and the pool
    (2*D); each row adds q@w1q (2*D*H1). Output written once; weights read
    once. On the tensor cores the products are the folded first layer and
    the second layer (``bounds``)."""
    b = lengths.numel()
    valid = int(lengths.clamp(0, t).sum())
    products = valid * (4 * d * h1 + 2 * h1 * h2)
    rest = b * 2 * d * h1 + valid * (2 * h2 + 2 * d)
    weights = 4 * d * h1 + h1 + h1 * h2 + 2 * h2 + 1
    nbytes = 4 * (b * d + valid * d + b + weights + b * d)
    return bounds(products + rest, products, rest, nbytes, mma_sync_tflops)


def cin_inputs(b: int, layer, gen: torch.Generator, d: int = 16, f: int = 7, o: int = 128):
    """One CIN layer's inputs as the default xDeepFM gives them: x0 of N(0,1)
    embeddings, flax-xavier weights, and for layer 1 the first half of
    layer 0's output (split_half). A named layer of ``OTHER_CIN_SHAPES``
    takes random inputs of its (H, F, O)."""
    if layer in OTHER_CIN_SHAPES:
        h, f, o = OTHER_CIN_SHAPES[layer]
        xk_t, x0_t = torch.randn(b, d, h, generator=gen), torch.randn(b, d, f, generator=gen)
        return xk_t.cuda(), x0_t.cuda(), xavier_uniform_(torch.empty(o, h, f), gen).cuda()
    x0_t = torch.randn(b, d, f, generator=gen).cuda()
    w0 = xavier_uniform_(torch.empty(o, f, f), gen).cuda()
    if layer == 0:
        return x0_t, x0_t, w0
    xk_t = cin_kernels.cin_layer_plain_t(x0_t, x0_t, w0)[..., : o // 2].contiguous()
    w1 = xavier_uniform_(torch.empty(o, o // 2, f), gen).cuda()
    return xk_t, x0_t, w1


def cin_bound(xk_t: torch.Tensor, x0_t: torch.Tensor, w: torch.Tensor,
              mma_sync_tflops: float) -> dict:
    """The least time for one CIN layer: 2*F*O*(H + 1) FLOP a row m = (b, d)
    in the factored form (xk @ W_all, then F multiply-accumulates); xk, x0
    and w read once, the output written once. On the tensor cores
    (``bounds``) the product is the GEMM over K = H*F, 2*H*F*O FLOP a row,
    and forming A costs H*F multiplies."""
    b, d, h = xk_t.shape
    f, o = x0_t.shape[2], w.shape[0]
    m = b * d
    nbytes = 4 * (m * (h + f + o) + o * h * f)
    return bounds(2 * m * f * o * (h + 1), 2 * m * h * f * o, m * h * f, nbytes,
                  mma_sync_tflops)


def device_ms(fn, flush: torch.Tensor) -> float:
    """Device time of one call by CUDA events, with L2 flushed first (the
    50 MB L2 would otherwise hold the inputs). The stream then spins for
    a few milliseconds, longer than the host takes to enqueue the plain
    versions' dozens of ops, so the whole call is enqueued before the
    start event fires: the time holds no host-side gap."""
    flush.zero_()
    torch.cuda._sleep(5_000_000)  # clock cycles
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


def device_us(e) -> float:  # renamed from cuda_time_total in newer torch
    return getattr(e, "device_time_total", None) or getattr(e, "cuda_time_total", 0.0)


def profile_device(fn):
    """(CUDA events from one traced run of ``fn``, their total device us,
    the host operations with the most self time in us)."""
    # Ranges that ``record_function`` marks on the device timeline (such as
    # ``Optimizer.step#Adam.step``) span kernels listed on their own, gaps
    # included, so they are left out of the device events.
    with torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    ) as prof:
        fn()
        torch.cuda.synchronize()
    averages = prof.key_averages()
    events = [e for e in averages
              if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA
              and not getattr(e, "is_user_annotation", False)]
    host = sorted((e for e in averages
                   if getattr(e, "device_type", None) == torch.autograd.DeviceType.CPU),
                  key=lambda e: -e.self_cpu_time_total)[:10]
    return events, sum(device_us(e) for e in events), {e.key[:80]: e.self_cpu_time_total
                                                       for e in host}


def top_device(events, n: int = 8):
    return {e.key[:80]: device_us(e) for e in sorted(events, key=lambda e: -device_us(e))[:n]}


# -- phase 2 ------------------------------------------------------------------


def build_kernels() -> None:
    t0 = time.perf_counter()
    kernels = ("din_attention", "cin")
    names = kernels + ("mma_ceiling",)
    with concurrent.futures.ThreadPoolExecutor(len(names)) as pool:
        reports = dict(zip(names, pool.map(lambda n: _build.build(n)[1], names)))
    din_kernels.library()
    cin_kernels.library()
    emit(phase="build", seconds=time.perf_counter() - t0,
         ptxas={name: [line.strip() for line in report.splitlines()
                       if "registers" in line or "Compiling entry" in line or "spill" in line]
                for name, report in reports.items()})
    for name in kernels:
        check_tensor_cores(name)


def check_tensor_cores(name: str) -> None:
    """Count the tensor-core instructions in the SASS of each kernel of a
    library (``cuobjdump``, beside ``nvcc`` in the toolkit); fail if a
    kernel has none."""
    cuobjdump = os.path.join(os.path.dirname(_build.nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", str(_build.library_path(name))],
                          capture_output=True, text=True, check=True, timeout=300).stdout
    counts = {}
    for function in re.split(r"\n\s*Function : ", sass)[1:]:
        kernel = function.split("\n", 1)[0].strip()
        counts[kernel] = {op: len(re.findall(rf"\b{op}\b", function)) for op in ("HMMA", "HGMMA")}
    emit(phase="tensor_cores", library=name, sass_counts=counts)
    check(counts, f"{name}: no kernel found in the SASS")
    for kernel, c in counts.items():
        check(c["HMMA"] + c["HGMMA"] > 0, f"{name}: {kernel} has no tensor-core instruction")


def mma_sync_ceiling(card: str) -> float:
    """TFLOP/s of mma.sync m16n8k8 in TF32 on this card
    (``csrc/mma_ceiling.cu``): 4 blocks of 8 warps on each SM, each warp 8
    independent products a round; the fastest of 5 timed runs."""
    lib = _build.load("mma_ceiling")
    lib.mma_tf32_ceiling.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    lib.mma_tf32_ceiling.restype = ctypes.c_int
    blocks, iters = 4 * torch.cuda.get_device_properties(0).multi_processor_count, 4096
    out = torch.empty(blocks * 256, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream

    def run(n):
        check(lib.mma_tf32_ceiling(out.data_ptr(), blocks, n, 0, stream) == 0,
              "mma_tf32_ceiling launch failed")

    run(16)
    times = []
    for _ in range(5):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        run(iters)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    tflops = blocks * 8 * iters * 8 * 2048 / (min(times) * 1e-3) / 1e12
    emit(phase="mma_sync_tf32_ceiling", tflops=tflops, ms=min(times), blocks=blocks, card=card)
    return tflops


# -- phase 3 ------------------------------------------------------------------


def errors_vs_f64(got: torch.Tensor, want: torch.Tensor, exact: torch.Tensor) -> dict:
    """The kernel's and the plain f32 version's largest and mean errors
    against the same function in f64, and the largest share of the
    rtol/atol allowance the kernel uses against the plain version."""
    kernel, plain = (got.double() - exact).abs(), (want.double() - exact).abs()
    allowed = TOL["atol"] + TOL["rtol"] * want.double().abs()
    return {"kernel_vs_f64": [kernel.max().item(), kernel.mean().item()],
            "plain_vs_f64": [plain.max().item(), plain.mean().item()],
            "tolerance_used": ((got - want).double().abs() / allowed).max().item()}


def check_din_kernel(gen: torch.Generator) -> float:
    """B1 against its plain version; returns the largest error at the main
    paths' shapes (D = 16, B = 256, 1024 and 8192)."""
    worst = 0.0
    cases = [(b, 16) for b in (1, 7) + TIMED_B] + [(256, d) for d in (8, 32, 64)]
    for b, d in cases:
        q, k, lengths, params = din_inputs(b, gen, d=d)
        for use_softmax in (False, True):
            got = din_kernels.din_attention_cuda(q, k, lengths, params, use_softmax)
            want = din_kernels.din_attention_plain(q, k, lengths, params, use_softmax)
            exact = din_kernels.din_attention_plain(
                q.double(), k.double(), lengths, [p.double() for p in params], use_softmax)
            torch.cuda.synchronize()
            err = (got - want).abs().max().item()
            emit(phase="kernel_vs_plain", kernel="din_attention_fwd", B=b, D=d,
                 use_softmax=use_softmax, max_abs_err=err, **errors_vs_f64(got, want, exact),
                 lengths=lengths[: len(RAGGED_LENGTHS)].tolist())
            torch.testing.assert_close(got, want, **TOL)
            if b > 1:
                check(torch.all(got[0] == 0), "a zero-length row must pool to zeros")
            if b >= 256 and d == 16:
                worst = max(worst, err)
    return worst


def check_cin_kernel(gen: torch.Generator) -> float:
    """B2 against its plain version at both layers' shapes; returns the
    largest error. A sum of up to H*F = 448 products in another order than
    the plain version's, each in 3xTF32, whose error is of the order of an
    f32 product's (tests/test_torch_tensor_core_operands.py): at these
    magnitudes (outputs up to a few units) it stays far inside rtol = atol
    = 1e-5."""
    worst = 0.0
    cases = [(b, layer) for b in (1, 7, 256, 1001, 1024, 8192) for layer in (0, 1)]
    for b, layer in cases + [(7, name) for name in OTHER_CIN_SHAPES]:
        xk_t, x0_t, w = cin_inputs(b, layer, gen)
        got = cin_kernels.cin_layer_cuda_t(xk_t, x0_t, w)
        want = cin_kernels.cin_layer_plain_t(xk_t, x0_t, w)
        exact = cin_kernels.cin_layer_plain_t(xk_t.double(), x0_t.double(), w.double())
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        emit(phase="kernel_vs_plain", kernel="cin_layer_fwd", B=b, layer=layer,
             shape=[list(xk_t.shape), list(x0_t.shape), list(w.shape)],
             max_abs_err=err, max_abs_out=want.abs().max().item(),
             **errors_vs_f64(got, want, exact))
        torch.testing.assert_close(got, want, **TOL)
        worst = max(worst, err)
    return worst


def grads_of(fn, inputs, g):
    leaves = [x.detach().requires_grad_() for x in inputs]
    out = fn(*leaves)
    return out, torch.autograd.grad(out, leaves, g)


def check_gradients(gen: torch.Generator) -> None:
    """Each kernel's autograd Function against autograd through the plain
    version at B = 1024: outputs within the kernel tolerance, gradients too
    (both backward passes recompute the plain version)."""
    q, k, lengths, params = din_inputs(1024, gen)
    g = torch.randn(1024, 16, generator=gen).cuda()
    cases = {
        "din_attention_fwd": (
            lambda q, k, *p: din_kernels.din_attention_cuda_fn(q, k, lengths, p, True),
            lambda q, k, *p: din_kernels.din_attention_plain(q, k, lengths, p, True),
            (q, k, *params), g),
    }
    for layer in (0, 1):
        xk_t, x0_t, w = cin_inputs(1024, layer, gen)
        inputs = (xk_t, x0_t, w) if layer else (x0_t.clone(), x0_t, w)
        cases[f"cin_layer_fwd/layer{layer}"] = (
            cin_kernels.cin_layer_cuda_fn_t, cin_kernels.cin_layer_plain_t, inputs,
            torch.randn(1024, 16, 128, generator=gen).cuda())
    for name, (kernel_fn, plain_fn, inputs, g) in cases.items():
        got, got_grads = grads_of(kernel_fn, inputs, g)
        want, want_grads = grads_of(plain_fn, inputs, g)
        torch.testing.assert_close(got, want, **TOL)
        errs = []
        for a, b in zip(got_grads, want_grads):
            torch.testing.assert_close(a, b, **TOL)
            errs.append((a - b).abs().max().item())
        emit(phase="gradient_vs_plain", kernel=name, B=1024, max_abs_err=max(errs),
             grads=len(errs))


# -- phase 4 ------------------------------------------------------------------


def read_history(output_dir: str):
    with open(os.path.join(output_dir, "metrics_history.jsonl")) as f:
        return [json.loads(line) for line in f]


def run_cli(model: str, rows: int, epochs: int, workdir: str, card: str, extra=(),
            run: str = ""):
    """One CLI run at the defaults plus ``extra`` flags, in ``workdir``'s
    directory ``run`` (the model's name by default); returns (model_dir,
    history, launches of each kernel in the run)."""
    run = run or model
    model_dir, output_dir = (os.path.join(workdir, run, d) for d in ("model_dir", "output_dir"))
    din_kernels.din_attention_cuda.launches = 0
    cin_kernels.cin_layer_cuda_t.launches = 0
    t0 = time.perf_counter()
    rc = cli.main([f"--model={model}", f"--synthetic={rows}", f"--num_epochs={epochs}",
                   f"--model_dir={model_dir}", f"--output_dir={output_dir}", *extra])
    seconds = time.perf_counter() - t0
    launches = {"din_attention_fwd": din_kernels.din_attention_cuda.launches,
                "cin_layer_fwd": cin_kernels.cin_layer_cuda_t.launches}
    check(rc == 0, f"the {model} CLI run exited {rc}")
    check(os.path.exists(os.path.join(model_dir, "best_model")), f"{model}: no best_model")
    check(os.path.exists(os.path.join(output_dir, "predictions.csv")), f"{model}: no predictions.csv")
    history = read_history(output_dir)
    check(len(history) == epochs, f"{model}: {len(history)} epochs in the history")
    for h in history:
        check(all(math.isfinite(h[k]) for k in ("train_loss", "eval_loss", "eval_auc")),
              f"{model}: non-finite metrics {h}")
        emit(phase="train_epoch", model=model, run=run, rows=rows, epoch=h["epoch"],
             train_loss=h["train_loss"], train_auc=h["train_auc"], eval_loss=h["eval_loss"],
             eval_auc=h["eval_auc"], eval_task_aucs=h["eval_task_aucs"],
             train_examples_per_s=h["train_examples_per_s"], card=card)
    emit(phase="train_run", model=model, run=run, rows=rows, epochs=epochs, seconds=seconds,
         launches=launches)
    return model_dir, history, launches


def steps_of(rows: int, batch_size: int = 1024):
    """(train steps, eval steps) an epoch for the CLI's 85/15 split."""
    n_train = int(rows * 0.85)
    return -(-n_train // batch_size), -(-(rows - n_train) // batch_size)


def train_xdeepfm(workdir: str, card: str):
    model_dir, history, launches = run_cli("xdeepfm", XDEEPFM_ROWS, 2, workdir, card)
    train_steps, eval_steps = steps_of(XDEEPFM_ROWS)
    layers = len(default_config("xdeepfm").cin_layer_sizes)
    # every train step of both epochs, and 3 eval passes (one an epoch and
    # the best model's): B2 ran in training and in eval
    want = layers * (2 * train_steps + 3 * eval_steps)
    check(launches["cin_layer_fwd"] == want,
          f"xdeepfm launched cin_layer_fwd {launches['cin_layer_fwd']} times, want {want}")
    best_auc = max(h["eval_auc"] for h in history)
    check(best_auc > 0.6, f"xdeepfm eval AUC {best_auc} is not above 0.6")
    return model_dir, launches["cin_layer_fwd"]


def train_din(workdir: str, card: str):
    model_dir, history, launches = run_cli("din", DIN_ROWS, 2, workdir, card)
    train_steps, eval_steps = steps_of(DIN_ROWS)
    want = 2 * train_steps + 3 * eval_steps
    check(launches["din_attention_fwd"] == want,
          f"din launched din_attention_fwd {launches['din_attention_fwd']} times, want {want}")
    # the trainer draws the model from a generator seeded with its seed
    cfg = default_config("din")
    initial = build_model(WECHAT_SCHEMA, cfg, device="cuda",
                          generator=torch.Generator().manual_seed(TrainConfig.seed))
    trained = torch.load(os.path.join(model_dir, "best_model"), map_location="cuda",
                         weights_only=True)
    moved = {}
    for name in ("w1", "b1", "w2", "b2", "w3", "b3"):
        before = getattr(initial.attention, name).detach()
        moved[name] = (trained[f"attention.{name}"] - before).abs().max().item()
    emit(phase="din_attention_trained", max_abs_change=moved)
    # b3 shifts every valid score alike, which the softmax cancels: its
    # gradient is rounding noise, so it is reported and not held to a bar.
    # The rest move by Adam steps of the order of the learning rate.
    check(all(moved[name] > 1e-3 for name in ("w1", "b1", "w2", "b2", "w3")),
          f"attention weights that did not move in training: {moved}")
    return launches["din_attention_fwd"]


def serve_xdeepfm(model_dir: str) -> None:
    cfg = default_config("xdeepfm")
    pred = Predictor(WECHAT_SCHEMA, cfg, model_dir=model_dir)
    plain = Predictor(WECHAT_SCHEMA, cfg, model_dir=model_dir)
    plain.model.cin.backend = "jnp"
    data = make_synthetic_dataset(WECHAT_SCHEMA, num_rows=5000, seed=SEED + 1)
    cin_kernels.cin_layer_cuda_t.launches = 0
    answers = {n: pred({k: v[:n] for k, v in data.items()})["score"] for n in (1, 1000, 5000)}
    launches = cin_kernels.cin_layer_cuda_t.launches
    check(launches == 2 * len(answers), f"xdeepfm serving launched cin_layer_fwd {launches} times")
    for n, got in answers.items():
        want = plain({k: v[:n] for k, v in data.items()})["score"]
        err = float(np.max(np.abs(got - want)))
        emit(phase="serve_model_dir", model="xdeepfm", rows=n, max_abs_err_vs_plain=err,
             mean_score=float(got.mean()), launches=launches)
        check(got.shape == (n,) and np.all(np.isfinite(got)) and np.all((got > 0) & (got < 1)),
              f"{n} rows: scores not finite, of the wrong shape or outside (0, 1)")
        np.testing.assert_allclose(got, want, **TOL)


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


def serve_din(gen: torch.Generator, card: str):
    """Slice 1's path: full-width DIN served by Predictor; then its latency."""
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
    check(launches == len(REQUEST_ROWS), f"DIN serving launched din_attention_fwd {launches} times")
    for n, got in answers.items():
        want = plain_pred(requests[n])["score"]
        err = float(np.max(np.abs(got - want)))
        emit(phase="serve_din", rows=n, max_abs_err_vs_plain=err, mean_score=float(got.mean()),
             launches=launches)
        check(got.shape == (n,) and got.dtype == np.float32,
              f"{n} rows: scores of shape {got.shape} and type {got.dtype}")
        check(np.all(np.isfinite(got)) and np.all((got > 0) & (got < 1)),
              f"{n} rows: scores not finite or outside (0, 1)")
        np.testing.assert_allclose(got, want, **TOL)

    big = requests[max(REQUEST_ROWS)]
    events, device_total_us, _ = profile_device(lambda: pred(big))
    names = [e.key for e in events]
    check(any("din_attention_fwd_kernel" in name for name in names),
          f"din_attention_fwd_kernel not among the CUDA kernels traced: {names}")
    emit(phase="profile_serve_din", rows=max(REQUEST_ROWS), device_us=top_device(events),
         device_us_total=device_total_us, device_launches=sum(e.count for e in events))

    latency = {}
    for n, req in requests.items():
        both = times_in_turns([lambda: pred(req), lambda: plain_pred(req)], host_ms, runs=30)
        for attention, lat in zip(("kernel", "plain"), both):
            emit(phase="predictor_latency", attention=attention, rows=n, requests=len(lat),
                 median_ms=statistics.median(lat), p90_ms=float(np.percentile(lat, 90)),
                 card=card)
        latency[n] = statistics.median(both[0])
    # the traced request's device time against the untraced latency (the
    # profiler itself slows the host several times over)
    emit(phase="device_busy_serve_din", rows=max(REQUEST_ROWS),
         share=device_total_us / 1e3 / latency[max(REQUEST_ROWS)], card=card)


def serve_against_cpu(model: str, cfg, model_dir: str, requests, atol: float, rtol: float,
                      card: str, run: str = "") -> None:
    """Serve ``model_dir``'s best model on the card and on the CPU; every
    head's scores on the card must match the CPU's within the tolerance
    (single-task models have one head, ``score``; the multi-task ones one
    a task, or ESMM's ``ctr`` and ``ctcvr``). A probability may saturate
    to 0 or 1 in f32 (DCN's cross terms grow with the square of the dense
    features), so the scores are held to [0, 1]."""
    pred = Predictor(WECHAT_SCHEMA, cfg, model_dir=model_dir)
    cpu = Predictor(WECHAT_SCHEMA, cfg, model_dir=model_dir, device="cpu")
    dtype = cfg.transformer_dtype if model in ("bst", "autoint") else "float32"
    for n, req in requests.items():
        got_heads, want_heads = pred(req), cpu(req)
        check(sorted(got_heads) == sorted(want_heads), f"{model}: heads {sorted(got_heads)}")
        for head, got in got_heads.items():
            want = want_heads[head]
            check(got.shape == (n,) and got.dtype == np.float32
                  and np.all(np.isfinite(got)) and np.all((got >= 0) & (got <= 1)),
                  f"{model} {head}, {n} rows: scores not finite, of the wrong shape or "
                  "outside [0, 1]")
            err = float(np.max(np.abs(got - want)))
            emit(phase="serve_vs_cpu", model=model, run=run or model, head=head, rows=n,
                 dtype=dtype, max_abs_err=err, atol=atol, rtol=rtol,
                 mean_score=float(got.mean()), saturated=int(np.sum((got == 0) | (got == 1))))
            np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)
    lat = times_in_turns([lambda: pred(requests[1000])], host_ms, runs=20)[0]
    emit(phase="predictor_latency", model=model, run=run or model, rows=1000, dtype=dtype,
         requests=len(lat), median_ms=statistics.median(lat),
         p90_ms=float(np.percentile(lat, 90)), card=card)


def train_and_serve_zoo(workdir: str, card: str) -> None:
    """Slice 4's path for each model: the CLI, then serving its model_dir on
    the card against the CPU. No hand-written kernel is on these paths, so
    each run's kernel launches must be 0."""
    data = make_synthetic_dataset(WECHAT_SCHEMA, num_rows=max(ZOO_REQUEST_ROWS), seed=SEED + 3)
    requests = {n: {k: v[:n] for k, v in data.items() if k != "labels"}
                for n in ZOO_REQUEST_ROWS}
    for model in ZOO_MODELS:
        model_dir, history, launches = run_cli(model, ZOO_ROWS, 1, workdir, card)
        check(not any(launches.values()), f"{model} launched a kernel of another path: {launches}")
        auc = history[-1]["eval_auc"]
        if model in ZOO_AUC_BAR:
            check(auc > 0.6, f"{model} eval AUC {auc} is not above 0.6")
        cfg = default_config(model)
        bf16 = model in ("bst", "autoint")
        serve_against_cpu(model, cfg, model_dir, requests, BF16_PROB_ATOL if bf16 else 1e-5,
                          0.0 if bf16 else 1e-5, card)
        if model == "bst":
            serve_against_cpu(model, cfg.replace(**F32_TRANSFORMER), model_dir, requests,
                              1e-5, 1e-5, card)


def train_and_serve_multitask(workdir: str, card: str) -> None:
    """Slice 5's path for each run of ``MULTITASK_RUNS``: the CLI (no
    hand-written kernel, so no launch), every task AUC above 0.6, GradNorm's
    saved weights, then serving the model_dir, every head on the card
    against the CPU."""
    data = make_synthetic_dataset(WECHAT_SCHEMA, num_rows=max(ZOO_REQUEST_ROWS), seed=SEED + 4)
    requests = {n: {k: v[:n] for k, v in data.items() if k != "labels"}
                for n in ZOO_REQUEST_ROWS}
    for model, weighting in MULTITASK_RUNS:
        run = f"{model}-{weighting}"
        extra = [f"--task_weighting={weighting}"]
        if weighting == "gradnorm":  # a checkpoint, to read GradNorm's state
            extra.append("--save_checkpoints_steps=1")
        model_dir, history, launches = run_cli(model, ZOO_ROWS, 1, workdir, card, extra, run)
        check(not any(launches.values()), f"{run} launched a kernel of another path: {launches}")
        cfg = default_config(model, task_weighting=weighting)
        aucs = history[-1]["eval_task_aucs"]
        heads = ("ctr", "ctcvr") if model == "esmm" else cfg.tasks
        check(sorted(aucs) == sorted(heads), f"{run}: task AUCs of {sorted(aucs)}")
        check(all(auc > 0.6 for auc in aucs.values()), f"{run}: a task AUC not above 0.6: {aucs}")
        if weighting == "gradnorm":
            saved = torch.load(os.path.join(model_dir, "checkpoint_epoch_1"), map_location="cpu",
                               weights_only=True)["mtl"]
            w = saved["w"]
            emit(phase="gradnorm_weights", run=run, w=w.tolist(), l0=saved["l0"].tolist())
            check(abs(float(w.sum()) - len(cfg.tasks)) < 1e-4, f"{run}: weights {w} sum != T")
            check(float((w - 1).abs().max()) > 1e-3, f"{run}: weights {w} did not move from 1")
        serve_against_cpu(model, cfg, model_dir, requests, 1e-5, 1e-5, card, run)


# -- phase 5 ------------------------------------------------------------------


def time_kernels(gen: torch.Generator, card: str, mma_sync_tflops: float):
    """Kernel, plain, library and bound times by CUDA events, cold L2."""
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    timings = {}
    for b in TIMED_B:
        q, k, lengths, params = din_inputs(b, gen)
        kernel_ms, plain_ms = map(statistics.median, times_in_turns(
            [lambda: din_kernels.din_attention_cuda(q, k, lengths, params, True),
             lambda: din_kernels.din_attention_plain(q, k, lengths, params, True)],
            lambda fn: device_ms(fn, flush), runs=20))
        least = din_bound(lengths, 50, 16, 64, 32, mma_sync_tflops)
        timings["din_attention_fwd", b] = dict(ms=kernel_ms, plain_ms=plain_ms,
                                               library_ms=None, **least)
        emit(phase="time", kernel="din_attention_fwd", B=b, ms=kernel_ms,
             plain_ms_no_yardstick=plain_ms, **least, card=card)
    for b in TIMED_B:
        for layer in (0, 1):
            xk_t, x0_t, w = cin_inputs(b, layer, gen)
            kernel_ms, plain_ms, library_ms = map(statistics.median, times_in_turns(
                [lambda: cin_kernels.cin_layer_cuda_t(xk_t, x0_t, w),
                 lambda: cin_kernels.cin_layer_plain_t(xk_t, x0_t, w),
                 lambda: torch.einsum("bdh,bdf,ohf->bdo", xk_t, x0_t, w)],
                lambda fn: device_ms(fn, flush), runs=20))
            least = cin_bound(xk_t, x0_t, w, mma_sync_tflops)
            timings[f"cin_layer_fwd/layer{layer}", b] = dict(
                ms=kernel_ms, plain_ms=plain_ms, library_ms=library_ms, **least)
            emit(phase="time", kernel="cin_layer_fwd", B=b, layer=layer, ms=kernel_ms,
                 plain_ms_no_yardstick=plain_ms, library_ms=library_ms, **least, card=card)
    return timings


def profile_train_step(model: str, card: str, steps: int = 10, **overrides) -> None:
    """Where the time of a train step goes (B = 1024, full width, the
    model's defaults with ``overrides``): untraced step time by host clock
    over synchronised steps, then one trace of the same steps."""
    trainer = Trainer(WECHAT_SCHEMA, default_config(model, **overrides), TrainConfig(log_every=0))
    state = trainer.init_state()
    data = make_synthetic_dataset(WECHAT_SCHEMA, num_rows=1024, seed=SEED + 2)
    data["_valid"] = np.ones(1024, np.float32)
    batch = trainer.to_device(data)
    meters = trainer.meters_init()

    def run():
        for _ in range(steps):
            trainer.train_step(state, meters, batch)
        torch.cuda.synchronize()

    run()  # warm-up
    step_ms = statistics.median(host_ms(run) for _ in range(5)) / steps
    events, device_total_us, host_top = profile_device(run)
    name = "_".join([model, *map(str, overrides.values())])
    emit(phase=f"profile_train_{name}", batch=1024, steps=steps, step_ms=step_ms,
         examples_per_s=1024 / step_ms * 1e3, device_us_per_step=device_total_us / steps,
         device_busy_share=device_total_us / 1e3 / (step_ms * steps),
         device_launches_per_step=sum(e.count for e in events) / steps,
         top_device_us=top_device(events, 12), top_host_self_us=host_top, card=card)


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
    build_kernels()

    # 3. kernels against their plain versions
    gen = torch.Generator().manual_seed(SEED)
    din_err = check_din_kernel(gen)
    cin_err = check_cin_kernel(gen)
    check_gradients(gen)

    # 4. main paths
    with tempfile.TemporaryDirectory() as workdir:
        xdeepfm_dir, cin_launches = train_xdeepfm(workdir, card)
        din_launches = train_din(workdir, card)
        serve_xdeepfm(xdeepfm_dir)
        train_and_serve_zoo(workdir, card)
        train_and_serve_multitask(workdir, card)
    serve_din(gen, card)

    # 5. times on the card
    timings = time_kernels(gen, card, mma_sync_ceiling(card))
    profile_train_step("xdeepfm", card)
    profile_train_step("bst", card)
    profile_train_step("dien", card, steps=3)
    profile_train_step("mmoe", card)
    profile_train_step("mmoe", card, task_weighting="pcgrad")

    rows = []
    for name, timed, source, replaces, launches, err in (
        ("din_attention_fwd", "din_attention_fwd",
         "rank_tpu_torch/ops/kernels/csrc/din_attention.cu",
         "rank_tpu/ops/pallas/din_attention.py:156", din_launches, din_err),
        ("cin_layer_fwd", "cin_layer_fwd/layer1", "rank_tpu_torch/ops/kernels/csrc/cin.cu",
         "rank_tpu/ops/pallas/cin.py:140", cin_launches, cin_err),
    ):
        # B = 1024: the batch of the training path; B2 at its heavier layer.
        # library_ms: none for B1 (no single PyTorch call computes DIN
        # attention); B2: one einsum.
        t = timings[timed, 1024]
        rows.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches, "max_abs_err": err,
            **{key: t[key] for key in ("ms", "plain_ms", "bound_ms", "bound_by", "bound_tc_ms",
                                       "library_ms")},
        })
    emit(kernels=rows)
    print(card, flush=True)
    emit(ok=True, device={"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                          "count": torch.cuda.device_count()})
    return 0


if __name__ == "__main__":
    sys.exit(main())
