"""Smoke test of the PyTorch/CUDA port (``rank_tpu_torch``) on one GPU.

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py                  # every phase and the result lines
    python3 chip_smoke.py --kernels-only   # phases 1-3: build, kernels vs plain

Phases; any failure raises and the script exits non-zero:

  1. device: requires ``torch.cuda.is_available()``; prints the card's
     name and power limit (``nvidia-smi``);
  2. build: compiles every hand-written kernel from the sources in the
     checkout, one ``nvcc`` per source, all started together, and prints
     the build time and the compiler's register and shared-memory report;
     then ``cuobjdump -sass`` of each library counts the tensor-core
     instructions (HMMA, HGMMA) of each kernel, and fails if a kernel has
     none (B1's generic kernel, on the CUDA cores by design, apart);
  3. kernels vs plain: each kernel against its plain torch version on the
     card, within rtol/atol 1e-5: B1 (DIN attention) at B in {1, 7, 256,
     1024, 8192}, lengths that include 0, 1, 15, 16, 17, 49 and 50, both
     softmax modes, and at D in {8, 32, 64} (the kernel's other
     instantiations); B2 (one CIN layer) at both layers' shapes of the
     default xDeepFM and B in {1, 7, 256, 1001, 1024, 8192} (B = 1001: rows
     that are not a multiple of the block's row tile), one shape whose H
     and O need padding and one with O over three output tiles; then the
     shapes past the kernels' former limits (fault C2), each error also
     against f64: B1 at D = 12 and 128 and hidden widths (32, 16) and
     (64, 64) (its generic kernel), T = 4096 at D = 16 and T = 1024 at
     D = 64 (its tensor-core kernel), both softmax modes, and B2 at
     H = 300 and at F = 80, at B in {7, 1024}; the registered operators on
     bf16 inputs against the plain version run on the same inputs in f32,
     to one bf16 ulp (plus the f32 1e-5 near zero); and for both kernels, the gradients through their
     autograd Function and their registered operator against autograd
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
        values (their gradient flows through B1's operator);
     b. serving from ``model_dir``: ``Predictor`` serves the xDeepFM run's
        best model through B2, held against the same weights served with
        the plain CIN to 1e-5; then at ``weights_dtype='bfloat16'`` (B2 must
        launch), against the f32 Predictor to 2e-2 and the CPU's bf16
        Predictor to 1e-2; then exported (``export_serving_artifact`` on
        the card, ``load_serving_artifact``): the loaded artifact must
        launch B2 and match the Predictor to rtol = atol = 1e-6;
     c. serving DIN at full width (random seeded weights, random BatchNorm
        statistics and Dice alphas) for requests of 1, 100, 1000 and 5000
        rows, held against the plain attention; a profiler trace of one
        request must show B1 on the device. Then the same weights at bf16
        for 1, 1000 and 5000 rows (B1 must launch), held like xDeepFM's,
        with the latency and the profiler's gather time at 5000 rows at f32
        and at bf16; and exported like xDeepFM (B1 must launch);
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
        on the card against the CPU at f32 to 1e-5; PLE's is also exported
        and its artifact held to its Predictor, every head;
     f. the shapes past the kernels' former limits through ``Predictor``
        (slice 6): DIN with a 12-wide feedid table (B1's generic kernel),
        DIN over histories of 4096 and xDeepFM with CIN layers (600, 128),
        random seeded weights, 1000 rows, each against the plain versions
        to 1e-5; each kernel variant must launch;
     g. training from files (slice 7): the port's producers write the
        calibrated log at scale 0.05 (166,115 train and 30,452 eval rows)
        and run the WeChat ETL over it (``arrays/*.npz``,
        ``dataframe/*.parquet``, ``vocabulary/``; host seconds printed,
        with ``native`` saying whether the host library loaded); the
        parquet frames must encode to the npz arrays; ``cli.main`` trains
        xDeepFM and DIN from the npz files (2 epochs each) and xDeepFM
        from the parquet files (1 epoch) at the defaults and the
        vocabulary-sized schema: B2 must launch once a layer and B1 once
        a step, train and eval, DIN's attention weights must move, eval
        AUC must pass 0.6 (printed beside rank_tpu's calibrated record,
        no parity test). Each ``model_dir`` is served on the card against
        the CPU to 1e-5 at 1000 eval rows. Then B1 against its plain
        version, to 1e-5, on a 1024-row batch of the eval file (the
        trained model's query, keys and weights, the file's skewed history
        lengths, whose shares are printed);
  5. times on the card: each kernel, its plain version (no yardstick of
     speed: it repeats the kernel's arithmetic in unfused torch ops), the
     one PyTorch call that computes the same function where there is one
     (``library_ms``) and the least time the card could take, in f32
     outside the tensor cores (``bound_ms``) and through the tensor cores
     in 3xTF32 (``bound_tc_ms``; ``bound_mma_sync_ms`` at the mma.sync TF32
     rate measured first by ``csrc/mma_ceiling.cu``), by CUDA events with
     a cold L2, at B in {256, 1024, 8192} (B2: both layers) and at the C2
     shapes at B = 1024; Predictor latency per request size by host clock,
     kernel and plain in turns; the host time a call of B1's registered
     operator, the promoting ``Linear`` and BatchNorm's eval path adds
     over a direct call, and what that adds to a 1-row DIN request;
     B1 on the file batch against the same inputs with uniform lengths;
     and profiler traces of xDeepFM, BST, DIEN,
     MMOE and MMOE under PCGrad train steps (B = 1024): step time, the top
     device operations, launches a step and the device-busy share.

Then it prints one line ``{"kernels": [...]}`` (a row for each kernel
variant, with the C2 shapes it ran), the card's line and, last,
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import ctypes
import dataclasses
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

from rank_tpu_torch import (WECHAT_SCHEMA, Predictor, build_model, default_config,
                            export_serving_artifact, load_serving_artifact)
from rank_tpu_torch import cli, native
from rank_tpu_torch.data import calibrated
from rank_tpu_torch.data.synthetic import make_synthetic_dataset
from rank_tpu_torch.features import schema_from_vocab_dir
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
# slice 7: the calibrated log at the scale of the training-quality protocol
# (PARITY_CALIB_r05.md: 166,115 train and 30,452 eval rows), written by the
# port's producers. The card's machine has pandas and pyarrow, so the
# phase writes the ETL's npz and parquet files and trains from both; a
# machine without them fails the phase. rank_tpu's eval AUC on that log
# (mean of 3 seeds, 3 epochs, --dense_init torch) is printed beside the
# port's; it is no parity test (ROADMAP A15).
CALIBRATED_SCALE = 0.05
CALIBRATED_RECORD = {"xdeepfm": 0.893, "din": 0.899}
FILE_SERVE_ROWS = 1000
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
# the kernel pads, O over three 128-wide output tiles, the last partial,
# and the shapes past the limits the kernel once had (H <= 256, F <= 64),
# whose rows it stages in several panels.
OTHER_CIN_SHAPES = {"padded": (12, 5, 10), "wide": (64, 7, 300), "h300": (300, 7, 128),
                    "f80": (64, 80, 128)}
C2_CIN_SHAPES = ("h300", "f80")
# B1 shapes past the limits it once had (D in {8, 16, 32, 64}, hidden
# widths (64, 32), T bounded by shared memory): (name, T, D, hidden).
C2_DIN_SHAPES = (("D12", 50, 12, (64, 32)), ("D128", 50, 128, (64, 32)),
                 ("hidden32x16", 50, 16, (32, 16)), ("hidden64x64", 50, 16, (64, 64)),
                 ("T4096", 4096, 16, (64, 32)), ("T1024_D64", 1024, 64, (64, 32)))
C2_B = (7, 1024)
# The bf16 Predictor against the f32 one (tests/test_serve.py's bar), and
# the card's bf16 Predictor against the CPU's: on the card B1 and B2
# compute in f32 what the CPU's plain versions compute in bf16, so the two
# differ by bf16 rounding, held to the bar tests/test_torch_serve_extras.py
# states for the port against JAX's bf16 Predictor.
BF16_VS_F32_ATOL = 2e-2
BF16_CARD_VS_CPU_ATOL = 1e-2
# an exported artifact against the Predictor it came from, on the card
# (the CPU test holds rtol 1e-6 / atol 1e-7, tests/test_serve.py's bar)
EXPORT_TOL = dict(rtol=1e-6, atol=1e-6)
EXPORT_BATCH = 256


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


def din_inputs(b: int, gen: torch.Generator, t: int = 50, d: int = 16, hidden=(64, 32)):
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
    h1, h2 = hidden
    shapes = [(4 * d, h1), (h1,), (h1, h2), (h2,), (h2, 1), (1,)]
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


# kernels on the CUDA cores by design: B1's generic kernel, for the shapes
# outside the tensor-core kernel's instantiations
CUDA_CORE_KERNELS = ("din_attention_generic_kernel",)


def check_tensor_cores(name: str) -> None:
    """Count the tensor-core instructions in the SASS of each kernel of a
    library (``cuobjdump``, beside ``nvcc`` in the toolkit); fail if a
    kernel has none, ``CUDA_CORE_KERNELS`` apart."""
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
        if any(k in kernel for k in CUDA_CORE_KERNELS):
            continue
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


def check_against_plain(kernel: str, got: torch.Tensor, want: torch.Tensor,
                        exact: torch.Tensor, c2_shape: bool) -> None:
    """The kernel within rtol = atol = 1e-5 of the plain version. At a C2
    shape (one the kernels once refused), where f32 rounding alone exceeds
    that, the plain version's rounding is not the target: the kernel must
    then lie within 1e-5 (absolute and relative) of the f64 function,
    widened by the largest error the plain f32 version makes on the same
    inputs. (B1 at T = 4096 without softmax pools 4096 raw-scored keys into
    outputs up to 1,600; there the plain version lies up to 3.6e-4 from
    f64 and the kernel 1.7e-4.) Every other shape holds the plain bar."""
    if not c2_shape:
        torch.testing.assert_close(got, want, **TOL)
        return
    tol = TOL["atol"] + TOL["rtol"] * want.double().abs()
    if ((got - want).double().abs() <= tol).all():
        return
    plain_err = (want.double() - exact).abs().max()
    allowed = TOL["atol"] + TOL["rtol"] * exact.abs() + plain_err
    excess = ((got.double() - exact).abs() - allowed).max().item()
    check(excess <= 0, f"{kernel}: {excess} further from f64 than 1e-5 and the plain "
          f"version's own error ({plain_err.item()}) allow")


def launched_din_kernel(fn):
    """Run ``fn``; return the B1 variant it launched (one launch exactly)."""
    before = (din_kernels.din_attention_cuda.launches,
              din_kernels.din_attention_cuda.generic_launches)
    out = fn()
    tc = din_kernels.din_attention_cuda.launches - before[0]
    generic = din_kernels.din_attention_cuda.generic_launches - before[1]
    check(tc + generic == 1, f"{tc} tensor-core and {generic} generic launches, want one")
    return out, "din_attention_fwd" if tc else "din_attention_generic_fwd"


def check_din_kernel(gen: torch.Generator):
    """B1 against its plain version: the main paths' shapes and the other
    tensor-core instantiations at T = 50, then ``C2_DIN_SHAPES`` at B in
    ``C2_B``. Returns the largest error at the main paths' shapes (D = 16,
    B = 256, 1024 and 8192) and the largest error of each kernel variant
    at the C2 shapes."""
    worst, c2_worst = 0.0, {}
    cases = [(b, 50, 16, (64, 32), "") for b in (1, 7) + TIMED_B]
    cases += [(256, 50, d, (64, 32), "") for d in (8, 32, 64)]
    cases += [(b, t, d, hidden, name) for b in C2_B for name, t, d, hidden in C2_DIN_SHAPES]
    for b, t, d, hidden, c2 in cases:
        q, k, lengths, params = din_inputs(b, gen, t=t, d=d, hidden=hidden)
        for use_softmax in (False, True):
            got, kernel = launched_din_kernel(
                lambda: din_kernels.din_attention_cuda(q, k, lengths, params, use_softmax))
            want = din_kernels.din_attention_plain(q, k, lengths, params, use_softmax)
            exact = din_kernels.din_attention_plain(
                q.double(), k.double(), lengths, [p.double() for p in params], use_softmax)
            torch.cuda.synchronize()
            err = (got - want).abs().max().item()
            emit(phase="kernel_vs_plain", kernel=kernel, B=b, T=t, D=d, hidden=list(hidden),
                 c2_shape=c2 or None, use_softmax=use_softmax, max_abs_err=err,
                 max_abs_out=want.abs().max().item(), **errors_vs_f64(got, want, exact),
                 lengths=lengths[: len(RAGGED_LENGTHS)].tolist())
            check_against_plain(kernel, got, want, exact, bool(c2))
            if b > 1:
                check(torch.all(got[0] == 0), "a zero-length row must pool to zeros")
            if b >= 256 and (t, d, hidden) == (50, 16, (64, 32)):
                worst = max(worst, err)
            if c2:
                c2_worst[kernel] = max(c2_worst.get(kernel, 0.0), err)
    return worst, c2_worst


def check_cin_kernel(gen: torch.Generator) -> float:
    """B2 against its plain version at both layers' shapes, the shapes of
    ``OTHER_CIN_SHAPES`` and the C2 shapes at B in ``C2_B``; returns the
    largest error. A sum of up to H*F = 448 products in another order than
    the plain version's, each in 3xTF32, whose error is of the order of an
    f32 product's (tests/test_torch_tensor_core_operands.py): at these
    magnitudes (outputs up to a few units) it stays far inside rtol = atol
    = 1e-5."""
    worst = 0.0
    cases = [(b, layer) for b in (1, 7, 256, 1001, 1024, 8192) for layer in (0, 1)]
    cases += [(7, name) for name in OTHER_CIN_SHAPES] + [(1024, name) for name in C2_CIN_SHAPES]
    for b, layer in cases:
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
        check_against_plain("cin_layer_fwd", got, want, exact, layer in C2_CIN_SHAPES)
        worst = max(worst, err)
    return worst


def grads_of(fn, inputs, g):
    leaves = [x.detach().requires_grad_() for x in inputs]
    out = fn(*leaves)
    return out, torch.autograd.grad(out, leaves, g)


def check_gradients(gen: torch.Generator) -> None:
    """Each kernel's autograd Function, and its registered operator (the
    training path's), against autograd through the plain version at
    B = 1024: outputs within the kernel tolerance, gradients too (every
    backward pass recomputes the plain version)."""
    q, k, lengths, params = din_inputs(1024, gen)
    g = torch.randn(1024, 16, generator=gen).cuda()
    plain = lambda q, k, *p: din_kernels.din_attention_plain(q, k, lengths, p, True)  # noqa: E731
    cases = {
        "din_attention_fwd": (
            lambda q, k, *p: din_kernels.DINAttentionFn.apply(
                din_kernels.din_attention_cuda, True, q, k, lengths, *p),
            plain, (q, k, *params), g),
        "din_attention_fwd/operator": (
            lambda q, k, *p: din_kernels.din_attention_cuda_fn(q, k, lengths, p, True),
            plain, (q, k, *params), g),
    }
    for layer in (0, 1):
        xk_t, x0_t, w = cin_inputs(1024, layer, gen)
        inputs = (xk_t, x0_t, w) if layer else (x0_t.clone(), x0_t, w)
        g = torch.randn(1024, 16, 128, generator=gen).cuda()
        cases[f"cin_layer_fwd/layer{layer}"] = (
            lambda *x: cin_kernels.CINLayerFn.apply(cin_kernels.cin_layer_cuda_t, *x),
            cin_kernels.cin_layer_plain_t, inputs, g)
        cases[f"cin_layer_fwd/layer{layer}/operator"] = (
            cin_kernels.cin_layer_cuda_fn_t, cin_kernels.cin_layer_plain_t, inputs, g)
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


def bf16_ulps(got: torch.Tensor, want: torch.Tensor):
    """(largest |got - want| in units of want's bf16 ulp, largest share used
    of the allowance: one bf16 ulp plus the kernels' f32 tolerance)."""
    _, exponent = torch.frexp(want.float())
    ulp = torch.ldexp(torch.ones_like(want, dtype=torch.float32), exponent - 8)
    diff = (got.float() - want.float()).abs()
    allowed = ulp + TOL["atol"] + TOL["rtol"] * want.float().abs()
    return (diff / ulp).max().item(), (diff / allowed).max().item()


def check_bf16_inputs(gen: torch.Generator) -> None:
    """The registered operators on bf16 inputs (the bf16 Predictor's): cast
    to f32, the kernel, the result cast back to bf16, against the plain
    version run on the same inputs cast to f32, then rounded to bf16. Two
    f32 results within the kernels' 1e-5 of each other round to bf16 values
    at most one bf16 ulp plus that 1e-5 apart; the 1e-5 decides only near
    zero, where a bf16 ulp is smaller."""
    bf16 = lambda x: x.to(torch.bfloat16)  # noqa: E731
    for d, hidden in ((16, (64, 32)), (12, (64, 32))):
        q, k, lengths, params = din_inputs(1024, gen, d=d, hidden=hidden)
        q, k, params = bf16(q), bf16(k), tuple(map(bf16, params))
        for use_softmax in (False, True):
            got, kernel = launched_din_kernel(
                lambda: din_kernels.din_attention(q, k, lengths, params, use_softmax))
            want = bf16(din_kernels.din_attention_plain(
                q.float(), k.float(), lengths, [p.float() for p in params], use_softmax))
            check(got.dtype == torch.bfloat16, f"{kernel} returned {got.dtype} for bf16 inputs")
            ulps, used = bf16_ulps(got, want)
            emit(phase="bf16_inputs_vs_plain", kernel=kernel, B=1024, D=d, hidden=list(hidden),
                 use_softmax=use_softmax, max_bf16_ulps=ulps, allowance_used=used)
            check(used <= 1.0, f"{kernel} on bf16 inputs: {used} of the allowance")
    for layer in (0, 1):
        xk_t, x0_t, w = map(bf16, cin_inputs(1024, layer, gen))
        before = cin_kernels.cin_layer_cuda_t.launches
        got = cin_kernels.cin_layer_t(xk_t, x0_t, w)
        check(cin_kernels.cin_layer_cuda_t.launches == before + 1, "cin_layer_fwd did not launch")
        want = bf16(cin_kernels.cin_layer_plain_t(xk_t.float(), x0_t.float(), w.float()))
        check(got.dtype == torch.bfloat16, f"cin_layer_fwd returned {got.dtype} for bf16 inputs")
        ulps, used = bf16_ulps(got, want)
        emit(phase="bf16_inputs_vs_plain", kernel="cin_layer_fwd", B=1024, layer=layer,
             max_bf16_ulps=ulps, allowance_used=used)
        check(used <= 1.0, f"cin_layer_fwd on bf16 inputs: {used} of the allowance")


# -- phase 4 ------------------------------------------------------------------


def read_history(output_dir: str):
    with open(os.path.join(output_dir, "metrics_history.jsonl")) as f:
        return [json.loads(line) for line in f]


def run_cli(model: str, rows: int, epochs: int, workdir: str, card: str, extra=(),
            run: str = "", data=()):
    """One CLI run at the defaults plus ``extra`` flags, on ``--synthetic=rows``
    or, where ``data`` gives file flags, on those files (``rows`` is then
    the train file's), in ``workdir``'s directory ``run`` (the model's
    name by default); returns (model_dir, history, launches of each kernel
    in the run)."""
    run = run or model
    model_dir, output_dir = (os.path.join(workdir, run, d) for d in ("model_dir", "output_dir"))
    din_kernels.din_attention_cuda.launches = 0
    cin_kernels.cin_layer_cuda_t.launches = 0
    t0 = time.perf_counter()
    rc = cli.main([f"--model={model}", *(data or [f"--synthetic={rows}"]), f"--num_epochs={epochs}",
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
    check_attention_moved(model_dir, WECHAT_SCHEMA)
    return launches["din_attention_fwd"]


def check_attention_moved(model_dir: str, schema) -> None:
    """DIN's attention weights in ``model_dir``'s best model moved from the
    trainer's initial values (their gradient flows through B1's operator)."""
    # the trainer draws the model from a generator seeded with its seed
    cfg = default_config("din")
    initial = build_model(schema, cfg, device="cuda",
                          generator=torch.Generator().manual_seed(TrainConfig.seed))
    trained = torch.load(os.path.join(model_dir, "best_model"), map_location="cuda",
                         weights_only=True)
    moved = {}
    for name in ("w1", "b1", "w2", "b2", "w3", "b3"):
        before = getattr(initial.attention, name).detach()
        moved[name] = (trained[f"attention.{name}"] - before).abs().max().item()
    emit(phase="din_attention_trained", model_dir=model_dir, max_abs_change=moved)
    # b3 shifts every valid score alike, which the softmax cancels: its
    # gradient is rounding noise, so it is reported and not held to a bar.
    # The rest move by Adam steps of the order of the learning rate.
    check(all(moved[name] > 1e-3 for name in ("w1", "b1", "w2", "b2", "w3")),
          f"attention weights that did not move in training: {moved}")


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
    requests = {n: {k: v[:n] for k, v in data.items() if k != "labels"} for n in (1, 1000, 5000)}
    state_dict = pred.model.state_dict()
    serve_bf16("xdeepfm", WECHAT_SCHEMA, cfg, state_dict, pred, requests, "cin_layer_fwd",
               per_request=len(cfg.cin_layer_sizes))
    launches = check_export("xdeepfm", pred)
    check(launches["cin_layer_fwd"] == 2, f"the loaded xDeepFM artifact launched {launches}")


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
    serve_din_bf16(pred, state_dict, requests, card)
    launches = check_export("din", pred)
    check(launches["din_attention_fwd"] == 1, f"the loaded DIN artifact launched {launches}")


def kernel_launches() -> dict:
    return {"din_attention_fwd": din_kernels.din_attention_cuda.launches,
            "din_attention_generic_fwd": din_kernels.din_attention_cuda.generic_launches,
            "cin_layer_fwd": cin_kernels.cin_layer_cuda_t.launches}


def zero_launches() -> None:
    din_kernels.din_attention_cuda.launches = 0
    din_kernels.din_attention_cuda.generic_launches = 0
    cin_kernels.cin_layer_cuda_t.launches = 0


def gathers(events):
    """Device us of the embedding gathers in a trace (nn.Embedding's
    index_select kernels: names with 'index' or 'gather') and their names."""
    picked = [e for e in events if re.search(r"index|gather", e.key, re.IGNORECASE)]
    return sum(device_us(e) for e in picked), sorted({e.key[:80] for e in picked})


def serve_bf16(model: str, schema, cfg, state_dict, f32_pred, requests, kernel: str,
               per_request: int = 1) -> Predictor:
    """``Predictor(weights_dtype='bfloat16')`` on the card: ``kernel`` must
    launch ``per_request`` times a request, and every head must track the f32 Predictor to
    ``BF16_VS_F32_ATOL`` and the CPU's bf16 Predictor to
    ``BF16_CARD_VS_CPU_ATOL``."""
    pred = Predictor(schema, cfg, state_dict=state_dict, weights_dtype="bfloat16")
    cpu = Predictor(schema, cfg, state_dict=state_dict, weights_dtype="bfloat16", device="cpu")
    zero_launches()
    answers = {n: pred(req) for n, req in requests.items()}
    launches = kernel_launches()
    check(launches[kernel] == per_request * len(requests),
          f"{model} bf16 serving launched {kernel} {launches[kernel]} times")
    for n, heads in answers.items():
        want_f32, want_cpu = f32_pred(requests[n]), cpu(requests[n])
        for head, got in heads.items():
            check(got.shape == (n,) and np.all(np.isfinite(got)), f"{model} bf16 {head}: {n} rows")
            err_f32 = float(np.max(np.abs(got - want_f32[head])))
            err_cpu = float(np.max(np.abs(got - want_cpu[head])))
            emit(phase="serve_bf16", model=model, head=head, rows=n, max_abs_err_vs_f32=err_f32,
                 max_abs_err_vs_cpu_bf16=err_cpu, launches=launches)
            np.testing.assert_allclose(got, want_f32[head], rtol=0, atol=BF16_VS_F32_ATOL)
            np.testing.assert_allclose(got, want_cpu[head], rtol=0, atol=BF16_CARD_VS_CPU_ATOL)
    return pred


def serve_din_bf16(pred, state_dict, requests, card) -> None:
    """DIN at full width served with bf16 weights (B1 on bf16 inputs), then
    the latency and the profiler's gather time at 5000 rows, f32 and bf16.
    bf16 tables halve the gathers' bytes; this records, it claims nothing."""
    rows = {n: requests[n] for n in ZOO_REQUEST_ROWS}
    bf16 = serve_bf16("din", WECHAT_SCHEMA, pred.model_cfg, state_dict, pred, rows,
                      "din_attention_fwd")
    big = requests[max(ZOO_REQUEST_ROWS)]
    lat = times_in_turns([lambda: pred(big), lambda: bf16(big)], host_ms, runs=30)
    for dtype, predictor, times in zip(("float32", "bfloat16"), (pred, bf16), lat):
        events, total_us, _ = profile_device(lambda: predictor(big))
        gather_us, names = gathers(events)
        emit(phase="serve_din_dtype", dtype=dtype, rows=len(big["feedid"]),
             median_ms=statistics.median(times), p90_ms=float(np.percentile(times, 90)),
             device_us_total=total_us, gather_us=gather_us, gather_kernels=names,
             top_device_us=top_device(events), card=card)


def check_export(model: str, pred: Predictor) -> dict:
    """``export_serving_artifact`` of ``pred`` on the card, then
    ``load_serving_artifact``: the loaded program's heads must match the
    Predictor's to ``EXPORT_TOL`` on a batch of ``EXPORT_BATCH`` rows.
    Returns the kernel launches of the loaded program's call."""
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, f"{model}.pt2")
        t0 = time.perf_counter()
        export_serving_artifact(pred, path, batch_size=EXPORT_BATCH)
        export_s = time.perf_counter() - t0
        size = os.path.getsize(path)
        fn = load_serving_artifact(path)
    data = make_synthetic_dataset(pred.schema, num_rows=EXPORT_BATCH, seed=SEED + 5)
    request = {k: v for k, v in data.items() if k != "labels"}
    zero_launches()
    got = fn(request)
    launches = kernel_launches()
    want = pred(request)
    check(sorted(got) == sorted(want), f"{model} artifact heads {sorted(got)}, want {sorted(want)}")
    errs = {}
    for head in want:
        errs[head] = float(np.max(np.abs(got[head] - want[head])))
        np.testing.assert_allclose(got[head], want[head], **EXPORT_TOL)
    emit(phase="export_round_trip", model=model, batch=EXPORT_BATCH, max_abs_err=errs,
         launches=launches, artifact_bytes=size, export_seconds=export_s)
    return launches


def din_schema(d: int, t: int):
    """WECHAT_SCHEMA with the feedid table, the DIN attention's D, ``d``
    wide and the history ``t`` long."""
    cats = tuple(dataclasses.replace(f, emb_dim=d) if f.name == "feedid" else f
                 for f in WECHAT_SCHEMA.categorical)
    seqs = tuple(dataclasses.replace(f, emb_dim=d, max_len=t)
                 if f.name == "his_read_comment_7d_seq" else f for f in WECHAT_SCHEMA.sequence)
    return dataclasses.replace(WECHAT_SCHEMA, categorical=cats, sequence=seqs)


def serve_c2_shapes(gen: torch.Generator, card: str) -> dict:
    """Slice 6's path, at shapes the kernels once refused, served by
    ``Predictor`` on the card (random seeded weights) against the same
    weights with the plain versions, to 1e-5: DIN with a 12-wide feedid
    table (B1's generic kernel), DIN over histories of 4096 (B1's
    tensor-core kernel, 256 tiles a full row) and xDeepFM with CIN layers
    (600, 128) (B2 at H = 300, F = 7). Returns the launches of the run."""
    cases = (("din_D12", din_schema(12, 50), default_config("din")),
             ("din_T4096", din_schema(16, 4096), default_config("din")),
             ("xdeepfm_cin600", WECHAT_SCHEMA, default_config("xdeepfm", cin_layer_sizes=(600, 128))))
    preds = {}
    for name, schema, cfg in cases:
        model = build_model(schema, cfg, device="cuda", generator=gen)
        randomize_eval_state(model, gen)
        state_dict = model.state_dict()
        preds[name] = (Predictor(schema, cfg, state_dict=state_dict),
                       Predictor(schema, cfg.replace(kernel_backend="jnp"), state_dict=state_dict),
                       {k: v for k, v in make_synthetic_dataset(schema, num_rows=1000, seed=SEED + 6)
                        .items() if k != "labels"})
    zero_launches()
    answers = {name: pred(request)["score"] for name, (pred, _, request) in preds.items()}
    launches = kernel_launches()
    for name, (_, plain, request) in preds.items():
        got, want = answers[name], plain(request)["score"]
        err = float(np.max(np.abs(got - want)))
        emit(phase="serve_c2_shape", model=name, rows=1000, max_abs_err_vs_plain=err,
             mean_score=float(got.mean()), card=card)
        check(np.all(np.isfinite(got)) and np.all((got >= 0) & (got <= 1)), f"{name}: scores")
        np.testing.assert_allclose(got, want, **TOL)
    emit(phase="serve_c2_launches", launches=launches)
    want = {"din_attention_fwd": 1, "din_attention_generic_fwd": 1, "cin_layer_fwd": 2}
    check(launches == want, f"C2 serving launched {launches}, want {want}")
    return launches


def serve_against_cpu(model: str, cfg, model_dir: str, requests, atol: float, rtol: float,
                      card: str, run: str = "", schema=WECHAT_SCHEMA) -> None:
    """Serve ``model_dir``'s best model on the card and on the CPU; every
    head's scores on the card must match the CPU's within the tolerance
    (single-task models have one head, ``score``; the multi-task ones one
    a task, or ESMM's ``ctr`` and ``ctcvr``). A probability may saturate
    to 0 or 1 in f32 (DCN's cross terms grow with the square of the dense
    features), so the scores are held to [0, 1]."""
    pred = Predictor(schema, cfg, model_dir=model_dir)
    cpu = Predictor(schema, cfg, model_dir=model_dir, device="cpu")
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
        if run == "ple-sum":
            launches = check_export("ple", Predictor(WECHAT_SCHEMA, cfg, model_dir=model_dir))
            check(not any(launches.values()), f"the PLE artifact launched a kernel: {launches}")


def length_shares(lengths: np.ndarray, t: int = 50) -> dict:
    """The share of rows of each history length class."""
    return {"zero": float(np.mean(lengths == 0)), "under_10": float(np.mean(lengths < 10)),
            "full": float(np.mean(lengths == t)), "mean": float(np.mean(lengths))}


def train_from_files(workdir: str, card: str):
    """Slice 7's path: the port's producers write the calibrated log's files
    (``make_calibrated_dataset`` at ``CALIBRATED_SCALE``: the log, the
    WeChat ETL, ``arrays/*.npz`` and ``dataframe/*.parquet``), the CLI
    trains xDeepFM and DIN from the npz files (2 epochs each) and xDeepFM
    from the parquet files (1 epoch), at the defaults and the
    vocabulary-sized schema; each run's kernel must launch once a step
    (B2: once a layer), train and eval; the parquet frames must encode to
    the npz arrays; each ``model_dir`` is served on the card against the
    CPU to 1e-5 at ``FILE_SERVE_ROWS`` eval rows. Returns the phase's
    launches of each kernel and one 1024-row batch of DIN's attention
    inputs from the eval file (query, keys, lengths, weights, softmax)."""
    emit(phase="native", native_available=native.available(), library=native._LIB_PATH)
    cache = os.path.join(workdir, "calibrated")
    t0 = time.perf_counter()
    train, test, schema = calibrated.make_calibrated_dataset(
        scale=CALIBRATED_SCALE, seed=SEED, cache_dir=cache)
    etl_s = time.perf_counter() - t0
    cfg_log = calibrated.CalibratedLogConfig(scale=CALIBRATED_SCALE, seed=SEED)
    etl = os.path.join(cache, calibrated.log_cache_tag(cfg_log), "etl")
    n_train, n_eval = len(train["labels"]), len(test["labels"])
    emit(phase="etl_host_seconds", seconds=etl_s, scale=CALIBRATED_SCALE, train_rows=n_train,
         eval_rows=n_eval, vocab_rows={f.name: f.vocab_size for f in schema.categorical},
         eval_history_lengths=length_shares(test["his_read_comment_7d_seq_length"]), card=card)
    check(schema == schema_from_vocab_dir(WECHAT_SCHEMA, os.path.join(etl, "vocabulary")),
          "the dataset's schema is not the one its vocabulary files give")

    t0 = time.perf_counter()
    for split, arrays in (("train", train), ("test", test)):
        frame = cli._load_split(os.path.join(etl, "dataframe", f"{split}.parquet"), schema,
                                os.path.join(etl, "vocabulary"))
        check(sorted(frame) == sorted(arrays), f"{split}.parquet encodes to keys {sorted(frame)}")
        for key, value in arrays.items():
            check(frame[key].dtype == value.dtype and np.array_equal(frame[key], value),
                  f"{split}.parquet encodes {key} unlike {split}.npz")
    emit(phase="parquet_equals_npz", splits=["train", "test"], encode_seconds=time.perf_counter() - t0)

    def files(fmt):
        sub = "arrays" if fmt == "npz" else "dataframe"
        return [f"--train_data={etl}/{sub}/train.{fmt}", f"--eval_data={etl}/{sub}/test.{fmt}",
                f"--vocabulary_dir={etl}/vocabulary"]

    train_steps, eval_steps = -(-n_train // 1024), -(-n_eval // 1024)
    layers = len(default_config("xdeepfm").cin_layer_sizes)
    requests = {FILE_SERVE_ROWS: {k: v[:FILE_SERVE_ROWS] for k, v in test.items() if k != "labels"}}
    launches = {"din_attention_fwd": 0, "cin_layer_fwd": 0}
    model_dirs = {}
    for model, fmt, epochs in (("xdeepfm", "npz", 2), ("din", "npz", 2), ("xdeepfm", "parquet", 1)):
        run = f"{model}-{fmt}"
        model_dir, history, got = run_cli(model, n_train, epochs, workdir, card, run=run,
                                          data=files(fmt))
        kernel, per_step = ("cin_layer_fwd", layers) if model == "xdeepfm" else ("din_attention_fwd", 1)
        # every train step, and an eval pass an epoch and the best model's
        want = per_step * (epochs * train_steps + (epochs + 1) * eval_steps)
        check(got[kernel] == want, f"{run} launched {kernel} {got[kernel]} times, want {want}")
        check(sum(got.values()) == got[kernel], f"{run} launched a kernel of another path: {got}")
        best = max(h["eval_auc"] for h in history)
        emit(phase="file_data_auc", model=model, run=run, epochs=epochs, best_eval_auc=best,
             rank_tpu_calibrated_record=CALIBRATED_RECORD[model],
             record_note="rank_tpu, 3 epochs, mean of 3 seeds, --dense_init torch "
                         "(PARITY_CALIB_r05.md); no parity test (ROADMAP A15)", card=card)
        check(best > 0.6, f"{run} eval AUC {best} is not above 0.6")
        for key in launches:
            launches[key] += got[key]
        model_dirs[run] = model_dir
    check_attention_moved(model_dirs["din-npz"], schema)

    for run in ("xdeepfm-npz", "din-npz"):
        model = run.split("-")[0]
        zero_launches()
        serve_against_cpu(model, default_config(model), model_dirs[run], requests, 1e-5, 1e-5,
                          card, run=run, schema=schema)
        served = kernel_launches()
        check(served["din_attention_fwd" if model == "din" else "cin_layer_fwd"] > 0,
              f"serving {run} launched {served}")
        for key in launches:
            launches[key] += served[key]
    emit(phase="file_data_launches", launches=launches)

    cfg = default_config("din")
    din = Predictor(schema, cfg, model_dir=model_dirs["din-npz"]).model
    seq = cfg.seq_feature
    batch = {k: torch.as_tensor(v[:1024]).cuda() for k, v in test.items() if k != "labels"}
    with torch.no_grad():
        q = din.tables.lookup("feedid", batch["feedid"]).contiguous()
        keys = din.tables.lookup(seq, batch[seq]).contiguous()
        attention = din.attention
        params = tuple(getattr(attention, n).detach().contiguous()
                       for n in ("w1", "b1", "w2", "b2", "w3", "b3"))
    return launches, (q, keys, batch[seq + "_length"].contiguous(), params, cfg.use_softmax)


def check_din_on_file_data(file_b1) -> float:
    """B1 against its plain version on a 1024-row batch of the eval file
    (the trained model's query, keys and weights, the file's history
    lengths), to 1e-5; returns the largest error."""
    q, keys, lengths, params, use_softmax = file_b1
    got, kernel = launched_din_kernel(
        lambda: din_kernels.din_attention_cuda(q, keys, lengths, params, use_softmax))
    want = din_kernels.din_attention_plain(q, keys, lengths, params, use_softmax)
    exact = din_kernels.din_attention_plain(q.double(), keys.double(), lengths,
                                            [p.double() for p in params], use_softmax)
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    emit(phase="kernel_vs_plain_file_data", kernel=kernel, B=q.shape[0], T=keys.shape[1],
         D=q.shape[1], use_softmax=use_softmax, max_abs_err=err,
         max_abs_out=want.abs().max().item(), **errors_vs_f64(got, want, exact),
         history_lengths=length_shares(lengths.cpu().numpy(), keys.shape[1]))
    check(kernel == "din_attention_fwd", f"B1 ran {kernel} on the file data")
    check_against_plain(kernel, got, want, exact, False)
    return err


def time_file_lengths(file_b1, card: str, mma_sync_tflops: float) -> None:
    """B1 on the file batch against the same query and keys with lengths
    uniform in [0, 50] (the synthetic generator's), and the plain version
    on each, in turns, CUDA events with a cold L2; each beside its bound
    for its own lengths."""
    q, keys, lengths, params, use_softmax = file_b1
    gen = torch.Generator().manual_seed(SEED + 7)
    t = keys.shape[1]
    uniform = torch.randint(0, t + 1, lengths.shape, generator=gen, dtype=torch.int32).cuda()
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    fns = [lambda lens=lens, fn=fn: fn(q, keys, lens, params, use_softmax)
           for lens in (lengths, uniform)
           for fn in (din_kernels.din_attention_cuda, din_kernels.din_attention_plain)]
    times = [statistics.median(ms) for ms in
             times_in_turns(fns, lambda fn: device_ms(fn, flush), runs=20)]
    h1, h2 = params[0].shape[1], params[2].shape[1]
    for name, lens, (ms, plain_ms) in (("file", lengths, times[:2]), ("uniform", uniform, times[2:])):
        emit(phase="time_file_lengths", lengths=name, B=q.shape[0], T=t, ms=ms,
             plain_ms=plain_ms, valid_steps=int(lens.sum()),
             **din_bound(lens, t, q.shape[1], h1, h2, mma_sync_tflops),
             history_lengths=length_shares(lens.cpu().numpy(), t), card=card)


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
    # the shapes past the former limits, at B = 1024 (B1 with softmax)
    for name, t, d, hidden in C2_DIN_SHAPES:
        q, k, lengths, params = din_inputs(1024, gen, t=t, d=d, hidden=hidden)
        kernel = din_kernels.kernel_for(d, *hidden)
        kernel_ms, plain_ms = map(statistics.median, times_in_turns(
            [lambda: din_kernels.din_attention_cuda(q, k, lengths, params, True),
             lambda: din_kernels.din_attention_plain(q, k, lengths, params, True)],
            lambda fn: device_ms(fn, flush), runs=10))
        least = din_bound(lengths, t, d, *hidden, mma_sync_tflops)
        timings[kernel, name] = dict(ms=kernel_ms, plain_ms=plain_ms, library_ms=None, **least)
        emit(phase="time", kernel=kernel, c2_shape=name, B=1024, T=t, D=d, hidden=list(hidden),
             ms=kernel_ms, plain_ms_no_yardstick=plain_ms, **least, card=card)
    for name in C2_CIN_SHAPES:
        xk_t, x0_t, w = cin_inputs(1024, name, gen)
        kernel_ms, plain_ms, library_ms = map(statistics.median, times_in_turns(
            [lambda: cin_kernels.cin_layer_cuda_t(xk_t, x0_t, w),
             lambda: cin_kernels.cin_layer_plain_t(xk_t, x0_t, w),
             lambda: torch.einsum("bdh,bdf,ohf->bdo", xk_t, x0_t, w)],
            lambda fn: device_ms(fn, flush), runs=10))
        least = cin_bound(xk_t, x0_t, w, mma_sync_tflops)
        timings["cin_layer_fwd", name] = dict(ms=kernel_ms, plain_ms=plain_ms,
                                              library_ms=library_ms, **least)
        emit(phase="time", kernel="cin_layer_fwd", c2_shape=name, B=1024,
             shape=[list(xk_t.shape), list(x0_t.shape), list(w.shape)], ms=kernel_ms,
             plain_ms_no_yardstick=plain_ms, library_ms=library_ms, **least, card=card)
    return timings


def host_overhead(gen: torch.Generator, card: str) -> None:
    """Host time that slice 6 put on every call, at DIN's 1-row bucket
    (B = 256), f32: B1's registered operator, the promoting ``Linear`` (in
    inference mode, and with autograd recording as in a train step) and
    BatchNorm's eval path, each against the route the port took before
    slice 6 (``DINAttentionFn`` around the CUDA wrapper, ``nn.Linear``,
    ``nn.BatchNorm1d``) and against the bare call (the wrapper,
    ``F.linear``, ``F.batch_norm``). Each is the host clock of enqueueing
    100 calls, no sync inside (so a short kernel's device time is not
    counted), median of 10 runs in turns. Forward hooks count the calls
    of each in one 1-row DIN request and one MMOE train forward
    (B = 1024); with the differences to the earlier routes they give the
    host time each path gained."""
    from rank_tpu_torch.ops.activations import BatchNorm
    from rank_tpu_torch.ops.mlp import Linear

    q, k, lengths, params = din_inputs(256, gen)
    x = torch.randn(256, 512, generator=gen).cuda()
    linear = Linear(512, 256).cuda()
    parent_linear = torch.nn.Linear(512, 256).cuda()
    norm = BatchNorm(512).cuda().eval()
    parent_norm = torch.nn.BatchNorm1d(512).cuda().eval()
    f = torch.nn.functional
    # (the call slice 6 makes, the one made before it, the bare one)
    routes = {
        "din_attention": (
            lambda: din_kernels.din_attention(q, k, lengths, params, True),
            lambda: din_kernels.DINAttentionFn.apply(din_kernels.din_attention_cuda, True,
                                                     q, k, lengths, *params),
            lambda: din_kernels.din_attention_cuda(q, k, lengths, params, True)),
        "linear": (lambda: linear(x), lambda: parent_linear(x),
                   lambda: f.linear(x, linear.weight, linear.bias)),
        "batch_norm": (lambda: norm(x), lambda: parent_norm(x),
                       lambda: f.batch_norm(x, norm.running_mean, norm.running_var, norm.weight,
                                            norm.bias, False, 0.0, norm.eps)),
    }

    def enqueue_us(fn, calls: int = 100) -> float:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        us = (time.perf_counter() - t0) / calls * 1e6
        torch.cuda.synchronize()
        return us

    per_call = {}
    with torch.inference_mode():
        for kind, fns in routes.items():
            per_call[kind] = tuple(map(statistics.median, times_in_turns(fns, enqueue_us, runs=10)))
    per_call["linear_train"] = tuple(map(statistics.median, times_in_turns(
        routes["linear"], enqueue_us, runs=10)))

    kinds = {Linear: "linear", BatchNorm: "batch_norm"}

    def calls_of(model, run) -> dict:
        counts = dict.fromkeys(kinds.values(), 0)

        def counter(kind):
            def hook(*_):
                counts[kind] += 1
            return hook

        hooks = [m.register_forward_hook(counter(kinds[type(m)]))
                 for m in model.modules() if type(m) in kinds]
        before = din_kernels.din_attention_cuda.launches
        run()
        counts["din_attention"] = din_kernels.din_attention_cuda.launches - before
        for hook in hooks:
            hook.remove()
        return counts

    cfg = default_config("din")
    pred = Predictor(WECHAT_SCHEMA, cfg, state_dict=build_model(
        WECHAT_SCHEMA, cfg, device="cuda", generator=gen).state_dict())
    request = make_synthetic_dataset(WECHAT_SCHEMA, num_rows=1, seed=SEED)
    din_calls = calls_of(pred.model, lambda: pred({key: v for key, v in request.items()
                                                   if key != "labels"}))
    mmoe = build_model(WECHAT_SCHEMA, default_config("mmoe"), device="cuda", generator=gen)
    batch = {key: torch.as_tensor(v).cuda()
             for key, v in make_synthetic_dataset(WECHAT_SCHEMA, num_rows=1024, seed=SEED).items()}
    mmoe_calls = calls_of(mmoe.train(), lambda: mmoe(batch))
    mmoe_calls["linear_train"] = mmoe_calls.pop("linear")
    for kind, (ours, parent, bare) in per_call.items():
        emit(phase="host_overhead", call=kind, us=ours, parent_route_us=parent, bare_us=bare,
             calls_per_din_request=din_calls.get(kind, 0),
             calls_per_mmoe_train_forward=mmoe_calls.get(kind, 0), card=card)
    for name, calls in (("din_request_1_row", din_calls), ("mmoe_train_forward", mmoe_calls)):
        added = {base: sum(n * (per_call[kind][0] - per_call[kind][i])
                           for kind, n in calls.items() if kind in per_call)
                 for i, base in ((1, "vs_parent_route_us"), (2, "vs_bare_us"))}
        emit(phase="host_overhead_added", path=name, **added, card=card)


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


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--kernels-only", action="store_true",
                        help="phases 1-3 only (build and hold the kernels against their plain "
                             "versions), without the result lines")
    args = parser.parse_args(argv)
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
    din_err, din_c2_err = check_din_kernel(gen)
    cin_err = check_cin_kernel(gen)
    check_bf16_inputs(gen)
    check_gradients(gen)
    if args.kernels_only:
        emit(phase="kernels_only_done")
        return 0

    # 4. main paths
    with tempfile.TemporaryDirectory() as workdir:
        xdeepfm_dir, cin_launches = train_xdeepfm(workdir, card)
        din_launches = train_din(workdir, card)
        serve_xdeepfm(xdeepfm_dir)
        train_and_serve_zoo(workdir, card)
        train_and_serve_multitask(workdir, card)
        file_launches, file_b1 = train_from_files(workdir, card)
    file_err = check_din_on_file_data(file_b1)
    serve_din(gen, card)
    c2_launches = serve_c2_shapes(gen, card)

    # 5. times on the card
    mma_sync_tflops = mma_sync_ceiling(card)
    timings = time_kernels(gen, card, mma_sync_tflops)
    time_file_lengths(file_b1, card, mma_sync_tflops)
    host_overhead(gen, card)
    profile_train_step("xdeepfm", card)
    profile_train_step("bst", card)
    profile_train_step("dien", card, steps=3)
    profile_train_step("mmoe", card)
    profile_train_step("mmoe", card, task_weighting="pcgrad")

    keys = ("ms", "plain_ms", "bound_ms", "bound_by", "bound_tc_ms", "library_ms")
    rows = []
    for name, timed, source, replaces, launches, err in (
        ("din_attention_fwd", ("din_attention_fwd", 1024),
         "rank_tpu_torch/ops/kernels/csrc/din_attention.cu",
         "rank_tpu/ops/pallas/din_attention.py:156",
         din_launches + file_launches["din_attention_fwd"], max(din_err, file_err)),
        # the generic B1 kernel, launched on slice 6's path (DIN at D = 12)
        ("din_attention_generic_fwd", ("din_attention_generic_fwd", "D12"),
         "rank_tpu_torch/ops/kernels/csrc/din_attention.cu",
         "rank_tpu/ops/pallas/din_attention.py:156",
         c2_launches["din_attention_generic_fwd"], din_c2_err["din_attention_generic_fwd"]),
        ("cin_layer_fwd", ("cin_layer_fwd/layer1", 1024), "rank_tpu_torch/ops/kernels/csrc/cin.cu",
         "rank_tpu/ops/pallas/cin.py:140", cin_launches + file_launches["cin_layer_fwd"],
         cin_err),
    ):
        # B = 1024: the batch of the training path; B2 at its heavier layer.
        # library_ms: none for B1 (no single PyTorch call computes DIN
        # attention); B2: one einsum. c2_shapes: the shapes past the former
        # limits that the variant ran, at B = 1024.
        kernel = name
        c2 = [{"shape": shape, **{key: t[key] for key in keys}}
              for (k, shape), t in timings.items() if k == kernel and isinstance(shape, str)]
        rows.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches, "max_abs_err": err, **{key: timings[timed][key] for key in keys},
            "c2_max_abs_err": din_c2_err.get(name, cin_err if name == "cin_layer_fwd" else None),
            "c2_shapes": c2,
        })
    emit(kernels=rows)
    print(card, flush=True)
    emit(ok=True, device={"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                          "count": torch.cuda.device_count()})
    return 0


if __name__ == "__main__":
    sys.exit(main())
