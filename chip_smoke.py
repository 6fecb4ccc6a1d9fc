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
     none (every kernel, B1's generic kernel's four variants among them,
     but B2's sum of partial weight gradients, which makes no product; the
     sequence kernels of ``csrc/gru_sequence.cu`` run f32 FMAs on the CUDA
     cores by design and are not counted);
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
     to one bf16 ulp (plus the f32 1e-5 near zero); B1's generic kernel
     (on the tensor cores at zero-padded widths) at B in {1, 7,
     256, 1024, 8192} at D = 12 and 128, at D in {10, 12, 128} with hidden
     widths (32, 16), (64, 64) and (24, 12) at T = 50 and at T = 1024, at
     hidden widths (136, 72) (h1 and h2 past one 64-column chunk), at
     D = 256 and 4096 (weights, and then keys, read through L1/L2) and on
     keys that do not start on a 16-byte boundary (4-byte copies), both
     softmax modes, each against the plain version to 1e-5 and against
     f64; B2's backward kernels (``cin_layer_bwd``) against the plain
     gradient (``cin_layer_vjp_plain``) at both layers and B in {1024,
     8192}, each gradient's error against f64, with their time, bounds and
     the plain gradient's time (``kernel_vs_plain`` lines with
     ``kernel="cin_layer_bwd"``), and at ``OTHER_CIN_SHAPES`` (O = 10 and
     300, H = 300, F = 80; ``cin_backward_shape`` lines); and for both kernels, the gradients
     through their autograd Function and their registered operator against
     autograd through the plain version, at B = 1024 (B1 also through its
     generic kernel's operator at D = 128; B2's through its backward
     kernels, which must launch once a backward); then DIEN's sequence
     kernels (``gru_seq_fwd``, ``gru_seq_bwd``) against their plain
     versions and against the f64 plain versions at B = 1024, T = 50,
     D = H = 36 for gru, agru and augru (``kernel_vs_plain`` lines with
     ``kernel="gru_seq"``), with their times beside their bounds and the
     times of the paths they replace (``check_gru_kernel``);
  4. main paths, each with the launch counts zeroed just before it and
     read just after; every kernel of the path must have launched:
     a. training: ``rank_tpu_torch.cli.main`` on ``--model=xdeepfm
        --synthetic=200000 --num_epochs=2`` at the defaults (full width)
        in a temporary directory; B2 must launch in every train and eval
        step and its backward kernels once a layer in every train step
        (``cin_layer_bwd_cuda_t.launches``; every xDeepFM training path
        of phase 4 is held to that, and the ``kernels`` line sums them),
        the loss must be finite, ``best_model`` and
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
        widedeep), which runs no hand-written kernel but DIEN's sequence
        kernels (in DIEN's run exactly one forward launch a recurrence a
        forward, one backward launch a recurrence a train step, counted
        from the run's steps): each trains through
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
        the port's own test is phase j). Each ``model_dir`` is served on the card against
        the CPU to 1e-5 at 1000 eval rows. Then B1 against its plain
        version, to 1e-5, on a 1024-row batch of the eval file (the
        trained model's query, keys and weights, the file's skewed history
        lengths, whose shares are printed);
     h. the table-sharded path (slice 8): ``cli.main`` on two ranks at
        ``--table_parallelism=2`` (one data rank), spawned after the build,
        each rank's kernel launches read in the rank: NCCL on two cards
        when there are two, else gloo over CUDA tensors with both ranks on
        the one card (the phase fails, it is not skipped, when neither
        runs). xDeepFM (B2) under ``--embedding_mode=gspmd`` and DIN (B1)
        under ``psum`` and ``alltoall``, 50,000 rows, 1 epoch, full width
        on ``WECHAT_SCHEMA`` at the default ``min_rows_to_shard``: feedid,
        userid and bgm_singer_id padded to an even row count, those and
        authorid and bgm_song_id row-sharded, device and manual_tag_list
        replicated. Each model also runs on one rank (t = 1, same seed).
        Both ranks' losses must be equal and every train step's must agree
        with the one-rank run's to rtol 2e-4 / atol 2e-5 (every run in
        torch's deterministic mode: ``sharded_rank``), the eval AUC to
        1e-4, B2 or B1 must launch
        on every rank, and the best model, in the normal form, served on
        one rank must match the one-rank run's to 1e-5 on 1000 rows. One
        ``sharded`` line a run (backend, the epoch time beside the
        one-rank time);
     i. the measurement tools (slice 9), full width on ``WECHAT_SCHEMA``:
        ``cli.main`` trains xDeepFM and DIN (50,000 rows, 1 epoch) with
        ``--profile_dir``: the one chrome trace must parse and hold B2's or
        B1's device events with durations, as many as the wrapper counted
        in epoch 1 (``profile_trace`` lines, with the device-busy share);
        a 1024^2 f32 product under each ``--matmul_precision`` against f64
        tells the arithmetic cuBLAS ran, which must be the one whose peak
        the roofline divides by; xDeepFM (200,000 rows, 1 epoch) under
        each setting, in one spawned process in torch's deterministic
        mode: ``float32`` and ``highest`` give the default run's losses
        bit for bit, ``bfloat16`` a finite loss and eval AUC over 0.6, and
        each leaves the process's setting as it was (``matmul_precision``
        lines); ``roofline`` lines for xDeepFM, DIN and DCN at batch 1024
        (``step_costs``, 20 synchronised steps after a warm-up, the top 8
        byte buckets): the kernels' FLOP formulas must be in the count and
        no share may pass 100%; ``step_memory`` lines for xDeepFM and DIN
        (``StagedRunner.step_memory_analysis`` beside
        ``max_memory_allocated``): each value at least 0 and under 80 GB,
        the state unchanged;
     j. training quality (slice 10): ``parity.run_calibrated`` trains
        xDeepFM and DIN at seed 42 under rank_tpu's calibrated protocol
        (the log of phase g, reused from its cache: scale 0.05, seed 0;
        3 epochs, batch 1024, ``dense_init='torch'``): B2 must launch on
        both CIN layers and B1 once in every train and eval step, and each
        eval AUC must lie within 0.02 of the range of rank_tpu's three
        recorded seeds (``PARITY_CALIB_r05.jsonl``; about 5 of the eval's
        per-seed standard errors of 0.004). One ``parity`` line a model;
     k. the full-scale rehearsal (slice 11): the port's producers build the
        calibrated log at scale 1.0 (3,322,312 train and 609,036 eval
        rows) in a spawned child that starts with phase 4 and runs beside
        phases a to j (``fullscale_data`` gives its build seconds and what
        the phase waited for it), and
        ``fullscale.run_one`` trains xDeepFM and DIN on it for one epoch
        each at full width (``dense_init='torch'``): every train row
        trained, all 609,036 eval rows in ``predictions.csv``, the peak
        card memory measured and above the staged splits, eval AUC over
        0.80 (printed beside rank_tpu's 2-epoch record), the saved best
        model served by ``Predictor(model_dir=...)`` on 1,000 eval rows
        equal to the eval's probabilities to 1e-5, and B2 exactly
        2 x (3,245 + 595 + 1 + 1) = 7,684 and B1 3,842 launches (train and
        eval steps, ``step_memory_analysis``'s step, the served request).
        One ``fullscale`` line a model with its record, and the phase's
        seconds (``fullscale_seconds``);
     l. DIN with the feedid table and the history 128 wide (the
        D of rank_tpu's ``scripts/bench_din_dims.py`` that B1's generic
        kernel takes; run after phase g, while phase k's log builds):
        ``Trainer`` and ``StagedRunner``, as ``parity.py``
        drives them, train one epoch on 50,000 synthetic rows at
        ``default_config`` and evaluate once: the generic kernel must
        launch exactly once a train and eval step and no other kernel, the
        loss must be finite, the attention weights must move and eval AUC
        must pass 0.6. ``Predictor`` then serves the trained weights for
        1, 1000 and 5000 rows on the card, held against the plain
        attention to 1e-5, at ``weights_dtype='bfloat16'`` (as phase c
        holds DIN's) and exported and reloaded; each launches the generic
        kernel once a request (``din_wide`` lines);
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
variant, with the C2 shapes it ran; the launches include phase 4h's, every
rank's, and phases 4i's, 4j's and 4k's; the generic B1 kernel's phases 4f
and 4l), the card's line and, last,
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import contextlib
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
from torch.utils.flop_counter import FlopCounterMode

from rank_tpu_torch import (WECHAT_SCHEMA, Predictor, build_model, default_config,
                            export_serving_artifact, load_serving_artifact)
from rank_tpu_torch import cli, fullscale, native, parity
from rank_tpu_torch.data import calibrated
from rank_tpu_torch.data.loader import split_train_test
from rank_tpu_torch.data.synthetic import make_synthetic_dataset
from rank_tpu_torch.features import schema_from_vocab_dir
from rank_tpu_torch.ops.cin import xavier_uniform_
from rank_tpu_torch.ops.kernels import _build
from rank_tpu_torch.ops.kernels import cin as cin_kernels
from rank_tpu_torch.ops.kernels import din_attention as din_kernels
from rank_tpu_torch.ops.kernels import gru_sequence as gru_kernels
from rank_tpu_torch.ops.mlp import promoted_dtype
from rank_tpu_torch.ops import rnn as rnn_ops
from rank_tpu_torch.ops.rnn import AttentionalGRU
from rank_tpu_torch.train import TrainConfig, Trainer
from rank_tpu_torch.train import loop as train_loop
from rank_tpu_torch.train.staged import StagedRunner
from rank_tpu_torch.utils import graphs, op_bytes, roofline
# Published H100 SXM peaks (NVIDIA data sheet, dense): f32 outside the
# tensor cores, TF32 on the tensor cores, and HBM3. The bounds are stated
# against them.
from rank_tpu_torch.utils.roofline import (H100_HBM_BYTES, H100_PEAK_F32_FLOPS, H100_PEAK_HBM,
                                           H100_PEAK_TF32_FLOPS)

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
# (mean of 3 seeds, 3 epochs, --dense_init torch; parity.jax_records) is
# printed beside the port's; the parity test is phase 4j's.
CALIBRATED_SCALE = 0.05
FILE_SERVE_ROWS = 1000
# phase 4j: rank_tpu's calibrated protocol for the two kernel models at
# one seed, held to the range of rank_tpu's recorded seeds widened by
# QUALITY_BAND (about 5 per-seed standard errors of the 30,452-row eval)
QUALITY_MODELS = (("xdeepfm", "cin_layer_fwd"), ("din", "din_attention_fwd"))
QUALITY_SEED = 42
QUALITY_BAND = 0.02
# phase 4k: the full-scale rehearsal's two kernel models, one epoch each
# on the calibrated log at scale 1.0 (the reference's 3,322,312 train and
# 609,036 eval rows), at full width through fullscale.run_one; eval AUC
# must pass a learning-sanity bar (rank_tpu's 2-epoch records are 0.84031
# and 0.86404) and the served best model match the eval's probabilities
FULLSCALE_SCALE = 1.0
FULLSCALE_MODELS = QUALITY_MODELS
FULLSCALE_ROWS = (3_322_312, 609_036)
FULLSCALE_EPOCHS = 1
FULLSCALE_AUC_BAR = 0.80
FULLSCALE_SERVE_ROWS = 1000
# the log's build (about 4 min of host time on the card's machine) runs in
# a spawned child from the start of phase 4, beside the earlier phases
FULLSCALE_LOG_TIMEOUT_S = 900
# card against CPU at the bf16 defaults of BST and AutoInt: the probability
# bar of tests/test_torch_zoo_forward.py (BF16_BAR)
BF16_PROB_ATOL = 0.05
F32_TRANSFORMER = dict(transformer_dtype="float32", transformer_score_dtype="float32")
# phase 4i: the measurement tools. The profiled runs take phase 4h's
# rows; the precision runs the xDeepFM training path's; the roofline and
# memory steps the training batch (1024) at full width.
PRECISIONS = (None, "bfloat16", "float32", "highest")
ROOFLINE_MODELS = ("xdeepfm", "din", "dcn")
ROOFLINE_STEPS = 20
PROFILED_KERNELS = {"xdeepfm": ("cin_layer_fwd", "cin_layer_fwd_kernel"),
                    "din": ("din_attention_fwd", "din_attention_fwd_kernel")}
# a 1024^2 f32 product's relative error against f64, which tells the
# arithmetic cuBLAS ran: f32 about 1e-7, TF32 (10-bit mantissa) 4e-4 to
# 8e-4, bf16 (7-bit) 3e-3 to 7e-3
ARITHMETIC_BY_ERROR = ((1e-5, "float32"), (1.6e-3, "tf32"), (float("inf"), "bfloat16"))
# The kernels' B values at the main paths' shapes, and the lengths around
# B1's 16-row tiles that every B1 check holds.
TIMED_B = (256, 1024, 8192)
# kernels that make no products, which the tensor-core check passes over:
# the sum of B2's partial weight gradients over the row splits
NO_PRODUCTS = ("cin_layer_bwd_dw_reduce",)
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
# B1's generic kernel, beside the C2 shapes: (B, T, D, hidden,
# name). At D = 128 it stages its weights as TF32 fragments with a 2-stage
# key ring at B <= 256, in f32 with 2 stages at B = 512 and with 1 stage at
# B >= 1024; at D = 256 its weights are read through L1/L2 (2 stages at
# B = 256, 1 at 1024), and at D = 4096 its keys too
# (``csrc/din_attention.cu``: they do not fit in shared memory); (136, 72)
# runs h1 in three chunks and h2 in two passes; "misaligned" keys start 4
# bytes past a 16-byte boundary.
GENERIC_DIN_HIDDEN = ((32, 16), (64, 64), (24, 12))
GENERIC_DIN_CASES = (
    [(b, 50, d, (64, 32), "") for d in (12, 128) for b in (1, 7) + TIMED_B]
    + [(1024, 50, d, h, "") for d in (10, 12, 128) for h in GENERIC_DIN_HIDDEN]
    + [(256, 1024, d, h, "T1024") for d, h in zip((10, 12, 128), GENERIC_DIN_HIDDEN)]
    + [(1024, 50, 5, (136, 72), "chunks"), (7, 1024, 128, (64, 32), "T1024"),
       (512, 50, 128, (64, 32), ""), (256, 50, 256, (64, 32), "global_weights"),
       (1024, 50, 256, (64, 32), "global_weights"), (7, 50, 4096, (64, 32), "global_keys"),
       (256, 50, 128, (64, 32), "misaligned"), (256, 50, 10, (24, 12), "misaligned")])
# phase 4l: DIN with the feedid table and the history this wide
DIN_WIDE_D = 128
# phase 4h: the table-sharded path on two ranks at t = 2 against one rank,
# full width on WECHAT_SCHEMA at the default min_rows_to_shard (1024)
SHARDED_ROWS = 50_000
SHARDED_RUNS = (("xdeepfm", "gspmd"), ("din", "psum"), ("din", "alltoall"))
SHARDED_TABLES = ("authorid", "bgm_singer_id", "bgm_song_id", "feedid", "userid")
PADDED_TABLES = {"feedid": (106_445, 106_446), "userid": (19_627, 19_628),
                 "bgm_singer_id": (17_501, 17_502)}
# The bf16 Predictor against the f32 one (tests/test_serve.py's bar), and
# the card's bf16 Predictor against the CPU's, held to the bar
# tests/test_torch_serve_extras.py states for the port against JAX's bf16
# Predictor. On the card B1 and B2 compute in f32 on the bf16 inputs
# (rank_tpu's Pallas kernels run their products in f32), where the CPU's
# plain versions compute in bf16; so the CPU's Predictor runs them as the card does
# (``card_arithmetic_on_cpu``). Against the plain versions in bf16 the
# difference is the plain versions' own bf16 rounding, which grows with B1's
# depth 4D and passes the bar at D = 128 (phase 4l), while the card's own
# plain path in bf16 stays close to the CPU's (``python
# tests/torch_bf16_card_vs_cpu.py`` measures these gaps); it is recorded,
# not checked.
BF16_VS_F32_ATOL = 2e-2
BF16_CARD_VS_CPU_ATOL = 1e-2
# an exported artifact against the Predictor it came from, on the card
# (the CPU test holds rtol 1e-6 / atol 1e-7, tests/test_serve.py's bar)
EXPORT_TOL = dict(rtol=1e-6, atol=1e-6)
EXPORT_BATCH = 256


card_line = parity.card_line


def emit(**fields) -> None:
    print(json.dumps(fields), flush=True)


def check(ok, message: str) -> None:
    """Raise on a failed check (``assert`` would vanish under ``python -O``)."""
    if not ok:
        raise RuntimeError(message)


def bound(flops: float, nbytes: float):
    """(ms, 'bytes' | 'operations'): the larger of the two least times, in
    f32 outside the tensor cores."""
    t_ops, t_bytes = flops / H100_PEAK_F32_FLOPS * 1e3, nbytes / H100_PEAK_HBM * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def bound_tc(product_flops: float, f32_flops: float, nbytes: float,
             tf32_flops: float = H100_PEAK_TF32_FLOPS) -> float:
    """The least time through the tensor cores in 3xTF32, ms: three TF32
    products for each product FLOP at ``tf32_flops``, the rest in f32, or
    the bytes, whichever is longer."""
    t_ops = (3 * product_flops / tf32_flops + f32_flops / H100_PEAK_F32_FLOPS) * 1e3
    return max(t_ops, nbytes / H100_PEAK_HBM * 1e3)


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
    kernels = ("din_attention", "cin")  # on the tensor cores
    names = kernels + ("gru_sequence", "mma_ceiling")
    with concurrent.futures.ThreadPoolExecutor(len(names)) as pool:
        reports = dict(zip(names, pool.map(lambda n: _build.build(n)[1], names)))
    din_kernels.library()
    cin_kernels.library()
    gru_kernels.library()
    emit(phase="build", seconds=time.perf_counter() - t0,
         ptxas={name: [line.strip() for line in report.splitlines()
                       if "registers" in line or "Compiling entry" in line or "spill" in line]
                for name, report in reports.items()})
    for name in kernels:
        check_tensor_cores(name)


def check_tensor_cores(name: str) -> None:
    """Count the tensor-core instructions in the SASS of each kernel of a
    library (``cuobjdump``, beside ``nvcc`` in the toolkit); fail if a
    kernel has none, but one of ``NO_PRODUCTS``."""
    cuobjdump = os.path.join(os.path.dirname(_build.nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", str(_build.library_path(name))],
                          capture_output=True, text=True, check=True, timeout=300).stdout
    counts = {}
    for function in re.split(r"\n\s*Function : ", sass)[1:]:
        kernel = function.split("\n", 1)[0].strip()
        counts[kernel] = {op: len(re.findall(rf"\b{op}\b", function)) for op in ("HMMA", "HGMMA")}
    emit(phase="tensor_cores", library=name, sass_counts=counts)
    check(counts, f"{name}: no kernel found in the SASS")
    if name == "din_attention":  # the generic kernel's (weights, keys) variants
        generic = [k for k in counts if "din_attention_generic_kernel" in k]
        check(len(generic) == 4, f"din_attention: generic kernel variants {generic}, want 4")
    for kernel, c in counts.items():
        if any(k in kernel for k in NO_PRODUCTS):
            continue
        check(c["HMMA"] + c["HGMMA"] > 0, f"{name}: {kernel} has no tensor-core instruction")


def mma_sync_ceiling(card: str) -> float:
    """TFLOP/s of mma.sync m16n8k8 in TF32 on this card
    (``csrc/mma_ceiling.cu``): 4 blocks of 8 warps on each SM, each warp 8
    independent products a round; the fastest of 5 timed runs."""
    lib = _build.load("mma_ceiling", {
        "mma_tf32_ceiling": [ctypes.c_void_p] + [ctypes.c_int] * 3 + [ctypes.c_void_p]})
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
    shape (one the kernels once refused), and for B2's dw (a sum of B*D
    products an entry), where f32 rounding alone exceeds that, the plain
    version's rounding is not the target: the kernel must
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


def misaligned(x: torch.Tensor) -> torch.Tensor:
    """A contiguous copy of ``x`` that starts 4 bytes past a 16-byte
    boundary."""
    buf = torch.empty(x.numel() + 4, dtype=x.dtype, device=x.device)
    out = buf[1: 1 + x.numel()].view(x.shape)
    out.copy_(x)
    check(out.data_ptr() % 16 == 4 and out.is_contiguous(), "misaligned copy")
    return out


def check_din_kernel(gen: torch.Generator):
    """B1 against its plain version: the main paths' shapes and the other
    tensor-core instantiations at T = 50, then ``C2_DIN_SHAPES`` at B in
    ``C2_B``, then the generic kernel's ``GENERIC_DIN_CASES``. Returns the
    largest error at the main paths' shapes (D = 16, B = 256, 1024 and
    8192), the largest error of each kernel variant at the C2 shapes, and
    the generic kernel's largest error at its cases. At T = 1024 a row
    without softmax pools up to 1,024 raw-scored keys, so there, as at the
    C2 shapes, the kernel may use the plain version's own distance from
    f64 (``check_against_plain``)."""
    worst, c2_worst, generic_worst = 0.0, {}, 0.0
    cases = [(b, 50, 16, (64, 32), "", "") for b in (1, 7) + TIMED_B]
    cases += [(256, 50, d, (64, 32), "", "") for d in (8, 32, 64)]
    cases += [(b, t, d, hidden, name, "") for b in C2_B for name, t, d, hidden in C2_DIN_SHAPES]
    cases += [(b, t, d, hidden, "", name or "generic")
              for b, t, d, hidden, name in GENERIC_DIN_CASES]
    for b, t, d, hidden, c2, generic in cases:
        q, k, lengths, params = din_inputs(b, gen, t=t, d=d, hidden=hidden)
        if generic == "misaligned":
            k = misaligned(k)
        for use_softmax in (False, True):
            got, kernel = launched_din_kernel(
                lambda: din_kernels.din_attention_cuda(q, k, lengths, params, use_softmax))
            want = din_kernels.din_attention_plain(q, k, lengths, params, use_softmax)
            exact = din_kernels.din_attention_plain(
                q.double(), k.double(), lengths, [p.double() for p in params], use_softmax)
            torch.cuda.synchronize()
            err = (got - want).abs().max().item()
            emit(phase="kernel_vs_plain", kernel=kernel, B=b, T=t, D=d, hidden=list(hidden),
                 c2_shape=c2 or None, generic_case=generic or None, use_softmax=use_softmax,
                 max_abs_err=err, max_abs_out=want.abs().max().item(),
                 **errors_vs_f64(got, want, exact),
                 lengths=lengths[: len(RAGGED_LENGTHS)].tolist())
            check_against_plain(kernel, got, want, exact, bool(c2) or generic == "T1024")
            if generic:
                check(kernel == "din_attention_generic_fwd", f"{generic} case ran {kernel}")
                generic_worst = max(generic_worst, err)
            if b > 1:
                check(torch.all(got[0] == 0), "a zero-length row must pool to zeros")
            if b >= 256 and (t, d, hidden) == (50, 16, (64, 32)):
                worst = max(worst, err)
            if c2:
                c2_worst[kernel] = max(c2_worst.get(kernel, 0.0), err)
    return worst, c2_worst, generic_worst


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


GRU_SHAPE = (1024, 50, 36, 36)  # DIEN's cell: B, T, D, H


def gru_inputs(mode: str, gen: torch.Generator, shape=GRU_SHAPE):
    """An ``AttentionalGRU`` of DIEN's widths (flax-xavier kernels, biases
    U(-0.5, 0.5)) and its inputs as the cell gives them: N(0,1) x, lengths
    uniform in [0, T] with ``RAGGED_LENGTHS`` first and a full last row,
    att in [0, 1) for agru and augru; on the card, x and att requiring
    gradients."""
    b, t, d, h = shape
    cell = AttentionalGRU(d, h, mode, generator=gen)
    with torch.no_grad():
        for p in (cell.gates_bias, cell.candidate_bias):
            p.uniform_(-0.5, 0.5, generator=gen)
    x = torch.randn(b, t, d, generator=gen)
    lengths = torch.randint(0, t + 1, (b,), generator=gen, dtype=torch.int32)
    lengths[: len(RAGGED_LENGTHS)] = torch.tensor(RAGGED_LENGTHS, dtype=torch.int32).clamp(max=t)
    lengths[-1] = t
    att = torch.rand(b, t, generator=gen) if mode != "gru" else None
    leaf = lambda v: None if v is None else v.cuda().requires_grad_()  # noqa: E731
    return cell.cuda(), leaf(x), lengths.cuda(), leaf(att)


def gru_bounds(lengths: torch.Tensor, t: int, h: int) -> dict:
    """The least times of the two kernels (``bound``, f32 outside the tensor
    cores), counting the valid steps only: 2 * 3H * H FLOP a row's step in
    each direction (forward h U_g and (r h) U_c; backward dc U_c^T and
    dg U_g^T). Forward bytes: P and a_t of the valid steps read; outputs,
    u, r, c, h and r*h of every step written, the final state. Backward:
    u, r, c, h, the output gradient and a_t of the valid steps read; the
    pre-activation gradients and d a_t of every step written. The weights
    (3 H^2) read once a block from L2 are left out. The chain of T
    dependent steps, which binds, is no roofline and is not counted."""
    b = lengths.numel()
    valid = int(lengths.clamp(0, t).sum())
    flops = valid * 6 * h * h
    fwd = bound(flops, 4 * (valid * (3 * h + 1) + b * t * 6 * h + b * h))
    bwd = bound(flops, 4 * (valid * (6 * h + 1) + b * t * (3 * h + 1) + b * h))
    return {"fwd_bound_ms": fwd[0], "fwd_bound_by": fwd[1],
            "bwd_bound_ms": bwd[0], "bwd_bound_by": bwd[1]}


def captured(fn):
    """``fn`` (no autograd) captured in a CUDA graph after a warm-up on a
    side stream; returns the graph's replay. The plain versions' hundreds of
    small ops then run without the host's gaps between them."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return graph.replay


def fwd_bwd_ms(cell, fn, x, lengths, att, flush: torch.Tensor):
    """(forward ms, backward ms) by CUDA events of one call of
    ``fn(cell, x, lengths, att)`` and of the backward of a weighted sum of
    its outputs, cold L2 before the forward; the stream spins first, as in
    ``device_ms``."""
    args = (x, lengths) if att is None else (x, lengths, att)
    flush.zero_()
    torch.cuda._sleep(5_000_000)
    events = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    events[0].record()
    outs, h = fn(cell, *args)
    events[1].record()
    torch.autograd.backward([outs, h], [torch.ones_like(outs), torch.ones_like(h)])
    events[2].record()
    events[2].synchronize()
    return events[0].elapsed_time(events[1]), events[1].elapsed_time(events[2])


def check_gru_kernel(gen: torch.Generator, card: str):
    """DIEN's sequence kernels at the cell's shape, for gru, agru and
    augru: each output of ``gru_seq_cuda`` and ``gru_seq_bwd_cuda`` against
    the plain versions on the same f32 inputs, within 1e-5 of the plain
    tensor's largest entry (sums in another order: FMAs in k order against
    the plain matmuls), with both one's errors against the plain versions
    in f64. Then, for DIEN's two modes, device times by CUDA events, cold
    L2, in turns: each kernel; the plain versions
    replayed from a CUDA graph (their arithmetic; no yardstick of speed);
    a direction through ``AttentionalGRU._recurrence`` (the projection and
    the kernel; the kernel and the gradient's products), eager and replayed
    from CUDA graphs as the cell runs it (``utils/graphs.py``); and the
    loop it replaces, ``_loop``, from CUDA graphs as the parent ran it.
    Returns the largest error against the plain versions and the times of
    the augru (DIEN's evolving layer)."""
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    b, t, d, h = GRU_SHAPE
    worst, timed = 0.0, {}
    for mode in ("gru", "agru", "augru"):
        cell, x, lengths, att = gru_inputs(mode, gen)
        with torch.no_grad():
            proj, _ = rnn_ops._project(x.detach(), *cell.parameters())
            ug, uc = cell.gates_kernel[d:].detach(), cell.candidate_kernel[d:].detach()
            a = None if att is None else att.detach()
            g_out = torch.randn(b, t, h, generator=gen).cuda()
            g_h = torch.randn(b, h, generator=gen).cuda()
            before = gru_kernels.gru_seq_cuda.launches, gru_kernels.gru_seq_bwd_cuda.launches
            fwd = gru_kernels.gru_seq_cuda(proj, lengths, a, ug, uc, mode, True)
            bwd = gru_kernels.gru_seq_bwd_cuda(*fwd[2][:2], lengths, a, ug, uc, g_out, g_h, mode)
            check((gru_kernels.gru_seq_cuda.launches, gru_kernels.gru_seq_bwd_cuda.launches)
                  == (before[0] + 1, before[1] + 1), "the sequence kernels did not launch")
            plain_f = gru_kernels.gru_seq_fwd_plain(proj, lengths, a, ug, uc, mode, True)
            plain_b = gru_kernels.gru_seq_bwd_plain(*plain_f[2][:2], lengths, a, ug, uc, g_out,
                                                    g_h, mode)
            f64 = lambda v: None if v is None else v.double()  # noqa: E731
            exact_f = gru_kernels.gru_seq_fwd_plain(f64(proj), lengths, f64(a), f64(ug), f64(uc),
                                                    mode, True)
            exact_b = gru_kernels.gru_seq_bwd_plain(*exact_f[2][:2], lengths, f64(a), f64(ug),
                                                    f64(uc), f64(g_out), f64(g_h), mode)
            torch.cuda.synchronize()
        names = ("outs", "h_final", "gates", "hprev", "rh", "d_pre", "d_att")
        got = [fwd[0], fwd[1], *fwd[2], *bwd]
        want = [plain_f[0], plain_f[1], *plain_f[2], *plain_b]
        exact = [exact_f[0], exact_f[1], *exact_f[2], *exact_b]
        errors = {}
        for name, g, w, e in zip(names, got, want, exact):
            if g is None:
                continue
            scale = w.abs().max().item()
            err = (g - w).abs().max().item()
            errors[name] = dict(max_abs_err=err, max_abs=scale,
                                kernel_vs_f64=(g.double() - e).abs().max().item(),
                                plain_vs_f64=(w.double() - e).abs().max().item())
            check(err <= 1e-5 * scale, f"gru_seq {mode} {name}: {err} from the plain version, "
                  f"over 1e-5 of its largest entry {scale}")
            worst = max(worst, err / max(scale, 1e-30))
        emit(phase="kernel_vs_plain", kernel="gru_seq", mode=mode, shape=list(GRU_SHAPE),
             errors=errors, card=card)
        if mode == "agru":
            continue
        kernel = [statistics.median(ts) for ts in times_in_turns(
            [lambda: gru_kernels.gru_seq_cuda(proj, lengths, a, ug, uc, mode, True),
             lambda: gru_kernels.gru_seq_bwd_cuda(*fwd[2][:2], lengths, a, ug, uc, g_out, g_h,
                                                  mode)],
            lambda fn: device_ms(fn, flush), runs=20)]
        plain = [captured(lambda: gru_kernels.gru_seq_fwd_plain(proj, lengths, a, ug, uc, mode,
                                                                True)),
                 captured(lambda: gru_kernels.gru_seq_bwd_plain(*plain_f[2][:2], lengths, a, ug,
                                                                uc, g_out, g_h, mode))]
        plain_ms = [statistics.median(ts) for ts in times_in_turns(
            plain, lambda fn: device_ms(fn, flush), runs=10)]
        recur = AttentionalGRU._recurrence
        paths = {"sequence_eager": lambda c, *args: recur(c, *args),
                 "sequence_graphed": lambda c, *args: graphs.call(c, recur, *args),
                 "loop_graphed": lambda c, *args: graphs.call(c, AttentionalGRU._loop, *args)}
        runs = times_in_turns([lambda fn=fn: fwd_bwd_ms(cell, fn, x, lengths, att, flush)
                               for fn in paths.values()], lambda fn: fn(), runs=10)
        medians = {name: [statistics.median(r[i] for r in rs) for i in (0, 1)]
                   for name, rs in zip(paths, runs)}
        timed[mode] = dict(
            fwd_ms=kernel[0], bwd_ms=kernel[1], plain_fwd_ms=plain_ms[0], plain_bwd_ms=plain_ms[1],
            **{f"{name}_{way}_ms": ms[i] for name, ms in medians.items()
               for i, way in enumerate(("fwd", "bwd"))},
            **gru_bounds(lengths, t, h))
        emit(phase="gru_seq_times", mode=mode, shape=list(GRU_SHAPE), **timed[mode], card=card)
    return worst, timed


def check_gradients(gen: torch.Generator) -> None:
    """Each kernel's registered operator (the training path's, the one
    gradient route) against autograd through the plain version at
    B = 1024: outputs within the kernel tolerance, gradients too. B1's
    backward recomputes through its plain version; B2's runs its backward
    kernels, which must launch once, and whose dw sums B*D products an
    entry: there the plain f32 gradient's own rounding may pass the bar,
    and ``check_against_plain`` holds the kernel to f64 instead."""
    q, k, lengths, params = din_inputs(1024, gen)
    g = torch.randn(1024, 16, generator=gen).cuda()
    plain = lambda q, k, *p: din_kernels.din_attention_plain(q, k, lengths, p, True)  # noqa: E731
    wq, wk, wlengths, wparams = din_inputs(1024, gen, d=DIN_WIDE_D)
    wg = torch.randn(1024, DIN_WIDE_D, generator=gen).cuda()
    cases = {
        "din_attention_generic_fwd/operator": (
            lambda q, k, *p: din_kernels.din_attention(q, k, wlengths, p, True),
            lambda q, k, *p: din_kernels.din_attention_plain(q, k, wlengths, p, True),
            (wq, wk, *wparams), wg),
        "din_attention_fwd/operator": (
            lambda q, k, *p: din_kernels.din_attention(q, k, lengths, p, True),
            plain, (q, k, *params), g),
    }
    for layer in (0, 1):
        xk_t, x0_t, w = cin_inputs(1024, layer, gen)
        inputs = (xk_t, x0_t, w) if layer else (x0_t.clone(), x0_t, w)
        g = torch.randn(1024, 16, 128, generator=gen).cuda()
        cases[f"cin_layer_fwd/layer{layer}/operator"] = (
            cin_kernels.cin_layer_t, cin_kernels.cin_layer_plain_t, inputs, g)
    for name, (kernel_fn, plain_fn, inputs, g) in cases.items():
        kernel = name.split("/")[0]
        cin = kernel == "cin_layer_fwd"
        before = kernel_launches()
        got, got_grads = grads_of(kernel_fn, inputs, g)
        after = kernel_launches()
        check(after[kernel] == before[kernel] + 1, f"{name} did not launch {kernel} once")
        bwd = after["cin_layer_bwd"] - before["cin_layer_bwd"]
        check(bwd == cin, f"{name}: cin_layer_bwd launched {bwd} times, want {int(cin)}")
        want, want_grads = grads_of(plain_fn, inputs, g)
        torch.testing.assert_close(got, want, **TOL)
        exact = (grads_of(plain_fn, [x.double() for x in inputs], g.double())[1] if cin
                 else [None] * len(want_grads))
        errs = []
        for a, b, e in zip(got_grads, want_grads, exact):
            if cin:
                check_against_plain(name, a, b, e, True)
            else:
                torch.testing.assert_close(a, b, **TOL)
            errs.append((a - b).abs().max().item())
        emit(phase="gradient_vs_plain", kernel=name, B=1024, max_abs_err=max(errs),
             grads=len(errs))


def cin_backward_bound(xk_t: torch.Tensor, x0_t: torch.Tensor, w: torch.Tensor,
                       mma_sync_tflops: float) -> dict:
    """The least time for one CIN layer's gradient (``bounds``): the two
    GEMMs G.W and G^T.Z, 2*M*H*F*O product FLOP each, with m = (b, d);
    dxk's and dx0's reductions and forming Z, M*H*F multiply-adds or
    multiplies each, in f32; g, xk, x0 and w read once, dxk, dx0 and dw
    written once."""
    b, d, h = xk_t.shape
    f, o = x0_t.shape[2], w.shape[0]
    m = b * d
    products, rest = 4 * m * h * f * o, 5 * m * h * f
    nbytes = 4 * (m * (o + 2 * h + 2 * f) + 2 * o * h * f)
    return bounds(products + rest, products, rest, nbytes, mma_sync_tflops)


def check_cin_backward(gen: torch.Generator, card: str, mma_sync_tflops: float):
    """B2's backward kernels against the plain gradient at both layers and
    B in {1024, 8192}: each gradient's errors against f64, held by
    ``check_against_plain`` (dw sums B*D products an entry, where the plain
    f32 gradient's own rounding may pass the bar), and the kernels' and the
    plain gradient's device times by CUDA events, cold L2. Returns the
    largest error against the plain gradient and the times at B = 1024,
    layer 1."""
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    worst, timed = 0.0, None
    for b in (1024, 8192):
        for layer in (0, 1):
            xk_t, x0_t, w = cin_inputs(b, layer, gen)
            g = torch.randn(b, 16, w.shape[0], generator=gen).cuda()
            before = cin_kernels.cin_layer_bwd_cuda_t.launches
            got = cin_kernels.cin_layer_bwd_cuda_t(xk_t, x0_t, w, g)
            check(cin_kernels.cin_layer_bwd_cuda_t.launches == before + 1,
                  "cin_layer_bwd did not launch")
            want = cin_kernels.cin_layer_vjp_plain(xk_t, x0_t, w, g)
            exact = cin_kernels.cin_layer_vjp_plain(*(x.double() for x in (xk_t, x0_t, w, g)))
            torch.cuda.synchronize()
            errors = {}
            for name, a, p, e in zip(("dxk", "dx0", "dw"), got, want, exact):
                errors[name] = dict(max_abs_err=(a - p).abs().max().item(),
                                    max_abs=p.abs().max().item(), **errors_vs_f64(a, p, e))
                check_against_plain(f"cin_layer_bwd {name}", a, p, e, True)
                worst = max(worst, errors[name]["max_abs_err"])
            kernel_ms, plain_ms = map(statistics.median, times_in_turns(
                [lambda: cin_kernels.cin_layer_bwd_cuda_t(xk_t, x0_t, w, g),
                 lambda: cin_kernels.cin_layer_vjp_plain(xk_t, x0_t, w, g)],
                lambda fn: device_ms(fn, flush), runs=20))
            least = cin_backward_bound(xk_t, x0_t, w, mma_sync_tflops)
            emit(phase="kernel_vs_plain", kernel="cin_layer_bwd", B=b, layer=layer,
                 shape=[list(xk_t.shape), list(x0_t.shape), list(w.shape)], ms=kernel_ms,
                 plain_ms_no_yardstick=plain_ms, **least, errors=errors, card=card)
            if (b, layer) == (1024, 1):
                timed = dict(ms=kernel_ms, plain_ms=plain_ms, library_ms=None, **least)
    # the other shapes, held alike and not timed: O = 10 and 300 (past one
    # 128-wide panel of g in dz and one o tile in dw, neither a multiple of
    # 8), H = 300, F = 80, at B = 7 (112 rows, under one tile) and 1024
    for b, layer in [(7, name) for name in OTHER_CIN_SHAPES] + [(1024, "wide")]:
        xk_t, x0_t, w = cin_inputs(b, layer, gen)
        g = torch.randn(b, 16, w.shape[0], generator=gen).cuda()
        got = cin_kernels.cin_layer_bwd_cuda_t(xk_t, x0_t, w, g)
        want = cin_kernels.cin_layer_vjp_plain(xk_t, x0_t, w, g)
        exact = cin_kernels.cin_layer_vjp_plain(*(x.double() for x in (xk_t, x0_t, w, g)))
        errors = {}
        for name, a, p, e in zip(("dxk", "dx0", "dw"), got, want, exact):
            errors[name] = dict(max_abs_err=(a - p).abs().max().item(), **errors_vs_f64(a, p, e))
            check_against_plain(f"cin_layer_bwd {layer} {name}", a, p, e, True)
            worst = max(worst, errors[name]["max_abs_err"])
        emit(phase="cin_backward_shape", B=b, layer=layer,
             shape=[list(xk_t.shape), list(x0_t.shape), list(w.shape)], errors=errors, card=card)
    return worst, timed


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
    zero_launches()
    t0 = time.perf_counter()
    rc = cli.main([f"--model={model}", *(data or [f"--synthetic={rows}"]), f"--num_epochs={epochs}",
                   f"--model_dir={model_dir}", f"--output_dir={output_dir}", *extra])
    seconds = time.perf_counter() - t0
    launches = kernel_launches()
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
    # the best model's): B2 ran in training and in eval, its backward
    # kernels once a layer in every train step
    want = layers * (2 * train_steps + 3 * eval_steps)
    check(launches["cin_layer_fwd"] == want,
          f"xdeepfm launched cin_layer_fwd {launches['cin_layer_fwd']} times, want {want}")
    backward = check_backward_launches("xdeepfm", launches, "xdeepfm", 2 * train_steps)
    emit(phase="train_backward_launches", model="xdeepfm", cin_layer_bwd=backward)
    best_auc = max(h["eval_auc"] for h in history)
    check(best_auc > 0.6, f"xdeepfm eval AUC {best_auc} is not above 0.6")
    return model_dir, launches["cin_layer_fwd"], backward


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
            "cin_layer_fwd": cin_kernels.cin_layer_cuda_t.launches,
            "cin_layer_bwd": cin_kernels.cin_layer_bwd_cuda_t.launches,
            "gru_seq_fwd": gru_kernels.gru_seq_cuda.launches,
            "gru_seq_bwd": gru_kernels.gru_seq_bwd_cuda.launches}


def zero_launches() -> None:
    din_kernels.din_attention_cuda.launches = 0
    din_kernels.din_attention_cuda.generic_launches = 0
    cin_kernels.cin_layer_cuda_t.launches = 0
    cin_kernels.cin_layer_bwd_cuda_t.launches = 0
    gru_kernels.gru_seq_cuda.launches = 0
    gru_kernels.gru_seq_bwd_cuda.launches = 0


def check_backward_launches(run: str, got: dict, model: str, train_steps: int) -> int:
    """B2's backward kernels launched once a CIN layer in each of the run's
    ``train_steps`` train steps (none for a model without a CIN); returns
    their launches."""
    want = len(default_config(model).cin_layer_sizes) * train_steps if model == "xdeepfm" else 0
    check(got["cin_layer_bwd"] == want,
          f"{run} launched cin_layer_bwd {got['cin_layer_bwd']} times, want {want}")
    return got["cin_layer_bwd"]


def gathers(events):
    """Device us of the embedding gathers in a trace (nn.Embedding's
    index_select kernels: names with 'index' or 'gather') and their names."""
    picked = [e for e in events if re.search(r"index|gather", e.key, re.IGNORECASE)]
    return sum(device_us(e) for e in picked), sorted({e.key[:80] for e in picked})


@contextlib.contextmanager
def card_arithmetic_on_cpu():
    """B1's and B2's operators on CPU tensors computed as the card computes
    them: the inputs cast to f32, the plain version, the result cast back to
    the inputs' promoted dtype (the operators' CUDA implementations, with
    the plain version in the kernel's place)."""
    din_op, cin_op = din_kernels.din_attention, cin_kernels.cin_layer_t

    def din(query, keys, lengths, params, use_softmax):
        out = din_kernels.din_attention_plain(query.float(), keys.float(), lengths,
                                              [p.float() for p in params], use_softmax)
        return out.to(promoted_dtype(query, keys, *params))

    def cin(xk_t, x0_t, w):
        out = cin_kernels.cin_layer_plain_t(xk_t.float(), x0_t.float(), w.float())
        return out.to(promoted_dtype(xk_t, x0_t, w))

    din_kernels.din_attention, cin_kernels.cin_layer_t = din, cin
    try:
        yield
    finally:
        din_kernels.din_attention, cin_kernels.cin_layer_t = din_op, cin_op


def serve_bf16(model: str, schema, cfg, state_dict, f32_pred, requests, kernel: str,
               per_request: int = 1) -> Predictor:
    """``Predictor(weights_dtype='bfloat16')`` on the card: ``kernel`` must
    launch ``per_request`` times a request, and every head must track the f32 Predictor to
    ``BF16_VS_F32_ATOL`` and the CPU's bf16 Predictor, with the kernels'
    operators computed as on the card (``card_arithmetic_on_cpu``), to
    ``BF16_CARD_VS_CPU_ATOL``. The distance to the CPU's bf16 Predictor with
    the plain versions in bf16 is recorded."""
    pred = Predictor(schema, cfg, state_dict=state_dict, weights_dtype="bfloat16")
    cpu = Predictor(schema, cfg, state_dict=state_dict, weights_dtype="bfloat16", device="cpu")
    zero_launches()
    answers = {n: pred(req) for n, req in requests.items()}
    launches = kernel_launches()
    check(launches[kernel] == per_request * len(requests),
          f"{model} bf16 serving launched {kernel} {launches[kernel]} times")
    for n, heads in answers.items():
        want_f32, want_plain = f32_pred(requests[n]), cpu(requests[n])
        with card_arithmetic_on_cpu():
            want_cpu = cpu(requests[n])
        for head, got in heads.items():
            check(got.shape == (n,) and np.all(np.isfinite(got)), f"{model} bf16 {head}: {n} rows")
            err_f32 = float(np.max(np.abs(got - want_f32[head])))
            err_cpu = float(np.max(np.abs(got - want_cpu[head])))
            err_plain = float(np.max(np.abs(got - want_plain[head])))
            emit(phase="serve_bf16", model=model, head=head, rows=n, max_abs_err_vs_f32=err_f32,
                 max_abs_err_vs_cpu_bf16=err_cpu, max_abs_err_vs_cpu_plain_bf16=err_plain,
                 launches=launches)
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
    want = {"din_attention_fwd": 1, "din_attention_generic_fwd": 1, "cin_layer_fwd": 2,
            "cin_layer_bwd": 0, "gru_seq_fwd": 0, "gru_seq_bwd": 0}
    check(launches == want, f"C2 serving launched {launches}, want {want}")
    return launches


def din_wide_phase(card: str) -> dict:
    """Phase 4l: DIN on ``din_schema(DIN_WIDE_D, 50)``, where B1 takes its
    generic kernel. ``Trainer`` and ``StagedRunner`` (as ``parity.py``
    drives them) train one epoch on ``DIN_ROWS`` synthetic rows and
    evaluate once: the generic kernel must launch once a train and eval
    step and no other kernel, the attention weights must move and eval AUC
    pass 0.6. ``Predictor`` serves the trained weights for
    ``ZOO_REQUEST_ROWS`` rows against the plain attention to 1e-5, at
    bf16 (``serve_bf16``) and exported (``check_export``), each one launch
    a request. Returns the phase's launches."""
    kernel = "din_attention_generic_fwd"
    schema = din_schema(DIN_WIDE_D, 50)
    cfg = default_config("din")
    check(din_kernels.kernel_for(DIN_WIDE_D, 64, 32) == kernel,
          f"D = {DIN_WIDE_D} does not take {kernel}")
    train, test = split_train_test(make_synthetic_dataset(schema, num_rows=DIN_ROWS, seed=SEED + 8))
    trainer = Trainer(schema, cfg, TrainConfig(batch_size=parity.BATCH_SIZE, log_every=0),
                      device="cuda")
    runner = StagedRunner(trainer, train, test, parity.BATCH_SIZE)
    zero_launches()
    state = trainer.init_state()
    attention = state["model"].attention
    before = {name: p.detach().clone() for name, p in attention.named_parameters()}
    t0 = time.perf_counter()
    state, stats = runner.train_epoch(state, 1, trainer.cfg.seed)
    ev = runner.evaluate(state, 1)
    seconds = time.perf_counter() - t0
    got = kernel_launches()
    want = runner.train_steps + runner.eval_steps
    moved = {name: (p.detach() - before[name]).abs().max().item()
             for name, p in attention.named_parameters()}
    emit(phase="din_wide", D=DIN_WIDE_D, rows=DIN_ROWS, train_steps=runner.train_steps,
         eval_steps=runner.eval_steps, train_loss=float(stats["loss"]), eval_auc=float(ev["auc"]),
         eval_loss=float(ev["loss"]), seconds=seconds, launches=got, want_launches=want,
         attention_max_abs_change=moved, card=card)
    check(got[kernel] == want and sum(got.values()) == want,
          f"DIN at D = {DIN_WIDE_D} launched {got}, want {want} of {kernel} alone")
    check(math.isfinite(float(stats["loss"])), f"DIN at D = {DIN_WIDE_D}: loss {stats['loss']}")
    check(ev["auc"] > 0.6, f"DIN at D = {DIN_WIDE_D}: eval AUC {ev['auc']} is not above 0.6")
    # b3 is left out, as in check_attention_moved: the softmax cancels it
    check(all(moved[name] > 1e-3 for name in ("w1", "b1", "w2", "b2", "w3")),
          f"attention weights that did not move in training: {moved}")
    launches = got[kernel]

    state_dict = state["model"].state_dict()
    pred = Predictor(schema, cfg, state_dict=state_dict)
    plain = Predictor(schema, cfg.replace(kernel_backend="jnp"), state_dict=state_dict)
    data = make_synthetic_dataset(schema, num_rows=max(ZOO_REQUEST_ROWS), seed=SEED + 9)
    requests = {n: {k: v[:n] for k, v in data.items() if k != "labels"} for n in ZOO_REQUEST_ROWS}
    zero_launches()
    answers = {n: pred(req)["score"] for n, req in requests.items()}
    got = kernel_launches()
    check(got[kernel] == len(requests) and sum(got.values()) == len(requests),
          f"DIN at D = {DIN_WIDE_D} serving launched {got}")
    launches += got[kernel]
    for n, score in answers.items():
        want_score = plain(requests[n])["score"]
        err = float(np.max(np.abs(score - want_score)))
        emit(phase="din_wide_serve", D=DIN_WIDE_D, rows=n, max_abs_err_vs_plain=err,
             mean_score=float(score.mean()), card=card)
        # a trained model may saturate the sigmoid of a row to 0 or 1 in f32
        check(score.shape == (n,) and np.all(np.isfinite(score)) and np.all((score >= 0) & (score <= 1)),
              f"{n} rows: scores not finite, of the wrong shape or outside [0, 1]")
        np.testing.assert_allclose(score, want_score, **TOL)
    serve_bf16("din_wide", schema, cfg, state_dict, pred, requests, kernel)
    launches += len(requests)
    got = check_export("din_wide", pred)
    check(got[kernel] == 1 and sum(got.values()) == 1, f"the loaded wide DIN artifact launched {got}")
    return {kernel: launches + 1}


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


def dien_launches_want(rows: int) -> dict:
    """The sequence kernels' launches of a one-epoch DIEN CLI run on
    ``rows``: two recurrences, each one forward launch in every train step
    and in the two eval passes (the epoch's and the best model's, whose
    forwards also give the predictions) and one backward launch in every
    train step."""
    train_steps, eval_steps = steps_of(rows)
    return {"gru_seq_fwd": 2 * (train_steps + 2 * eval_steps), "gru_seq_bwd": 2 * train_steps}


def train_and_serve_zoo(workdir: str, card: str) -> dict:
    """Slice 4's path for each model: the CLI, then serving its model_dir on
    the card against the CPU. No hand-written kernel is on these paths but
    DIEN's sequence kernels, so each run's other kernel launches must be 0,
    and DIEN's run must launch the sequence kernels once a recurrence (two)
    in each of its forwards and backwards: ``dien_launches_want``. Returns
    DIEN's run's launches."""
    data = make_synthetic_dataset(WECHAT_SCHEMA, num_rows=max(ZOO_REQUEST_ROWS), seed=SEED + 3)
    requests = {n: {k: v[:n] for k, v in data.items() if k != "labels"}
                for n in ZOO_REQUEST_ROWS}
    for model in ZOO_MODELS:
        model_dir, history, launches = run_cli(model, ZOO_ROWS, 1, workdir, card)
        own = ("gru_seq_fwd", "gru_seq_bwd") if model == "dien" else ()
        check(not any(n for k, n in launches.items() if k not in own),
              f"{model} launched a kernel of another path: {launches}")
        if model == "dien":
            want = dien_launches_want(ZOO_ROWS)
            check({k: launches[k] for k in own} == want,
                  f"dien launched {launches}, want {want} of the sequence kernels")
            dien_launches = launches
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
    return dien_launches


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
    launches = {"din_attention_fwd": 0, "cin_layer_fwd": 0, "cin_layer_bwd": 0}
    model_dirs = {}
    for model, fmt, epochs in (("xdeepfm", "npz", 2), ("din", "npz", 2), ("xdeepfm", "parquet", 1)):
        run = f"{model}-{fmt}"
        model_dir, history, got = run_cli(model, n_train, epochs, workdir, card, run=run,
                                          data=files(fmt))
        kernel, per_step = ("cin_layer_fwd", layers) if model == "xdeepfm" else ("din_attention_fwd", 1)
        # every train step, and an eval pass an epoch and the best model's
        want = per_step * (epochs * train_steps + (epochs + 1) * eval_steps)
        check(got[kernel] == want, f"{run} launched {kernel} {got[kernel]} times, want {want}")
        backward = check_backward_launches(run, got, model, epochs * train_steps)
        check(sum(got.values()) == got[kernel] + backward,
              f"{run} launched a kernel of another path: {got}")
        best = max(h["eval_auc"] for h in history)
        emit(phase="file_data_auc", model=model, run=run, epochs=epochs, best_eval_auc=best,
             rank_tpu_calibrated_record=float(np.mean(rank_tpu_seeds(model))),
             record_note="rank_tpu, 3 epochs, mean of 3 seeds, --dense_init torch "
                         "(PARITY_CALIB_r05.jsonl); the parity test is phase 4j's", card=card)
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


def rank_tpu_seeds(model: str):
    """rank_tpu's recorded eval AUC of ``model`` on the calibrated log, one
    a seed of the protocol."""
    record = parity.jax_records("calib")
    return [record[(model, seed)]["auc"] for seed in parity.SEEDS]


def quality_phase(workdir: str, card: str) -> dict:
    """Phase 4j: ``parity.run_calibrated`` for xDeepFM and DIN at
    ``QUALITY_SEED`` under rank_tpu's calibrated protocol, on phase 4g's
    log (the same cache, scale and seed). Each kernel must launch in every
    train and eval step (B2 once a CIN layer) and no other kernel; each
    eval AUC must lie in rank_tpu's recorded range widened by
    ``QUALITY_BAND``. Returns the phase's launches of each kernel."""
    data = parity.calibrated_data(CALIBRATED_SCALE, os.path.join(workdir, "calibrated"))
    train_steps = parity.EPOCHS * -(-len(data.train["labels"]) // parity.BATCH_SIZE)
    steps = train_steps + -(-len(data.eval["labels"]) // parity.BATCH_SIZE)
    launches = {"din_attention_fwd": 0, "cin_layer_fwd": 0, "cin_layer_bwd": 0}
    for model, kernel in QUALITY_MODELS:
        zero_launches()
        rec = parity.run_calibrated(model, QUALITY_SEED, data)
        got = kernel_launches()
        per_step = len(default_config(model).cin_layer_sizes) if model == "xdeepfm" else 1
        check(got[kernel] == per_step * steps,
              f"{model} launched {kernel} {got[kernel]} times, want {per_step * steps}")
        backward = check_backward_launches(model, got, model, train_steps)
        check(sum(got.values()) == got[kernel] + backward,
              f"{model} launched a kernel of another path: {got}")
        check(rec["protocol"] and rec["rank_tpu"] is not None,
              f"{model} did not run rank_tpu's protocol: {rec}")
        seeds = rank_tpu_seeds(model)
        band = [min(seeds) - QUALITY_BAND, max(seeds) + QUALITY_BAND]
        mean = float(np.mean(seeds))
        emit(phase="parity", model=model, seed=QUALITY_SEED, port_auc=rec["port"],
             rank_tpu_seeds=dict(zip(parity.SEEDS, seeds)), rank_tpu_mean=mean,
             delta=rec["port"] - mean, band=band, seconds=rec["t_port_s"], steps=steps,
             launches=got, card=card)
        check(band[0] <= rec["port"] <= band[1],
              f"{model} eval AUC {rec['port']} is outside rank_tpu's band {band}")
        launches[kernel] += got[kernel]
        launches["cin_layer_bwd"] += backward
    return launches


def build_fullscale_log(cache_dir: str, out_path: str) -> None:
    """Phase 4k's data, in a spawned child: the port's producers write the
    calibrated log at ``FULLSCALE_SCALE`` and its ETL into ``cache_dir``;
    the build's host seconds go to ``out_path``."""
    t0 = time.perf_counter()
    calibrated.make_calibrated_dataset(scale=FULLSCALE_SCALE, cache_dir=cache_dir)
    with open(out_path, "w") as f:
        json.dump({"seconds": time.perf_counter() - t0}, f)


def start_fullscale_log(workdir: str):
    """Start ``build_fullscale_log`` in a spawned child (no CUDA there);
    returns the process, its cache dir and its output file."""
    cache, out = os.path.join(workdir, "calibrated_fullscale"), os.path.join(workdir, "log.json")
    proc = torch.multiprocessing.get_context("spawn").Process(target=build_fullscale_log,
                                                              args=(cache, out))
    proc.start()
    return proc, cache, out


def stop(proc) -> None:
    if proc.is_alive():
        proc.kill()
        proc.join(30)


def fullscale_phase(workdir: str, card: str, log_build) -> dict:
    """Phase 4k: ``fullscale.run_one`` for xDeepFM and DIN, one epoch each,
    on the calibrated log at ``FULLSCALE_SCALE`` (``log_build``: the child
    of ``start_fullscale_log``, joined here; its build seconds and the
    wait are printed), full width, ``dense_init='torch'``. Each run must
    train every train row and export every eval row, measure a peak above
    its staged splits, pass ``FULLSCALE_AUC_BAR``, and launch its kernel
    exactly once a step (B2 once a CIN layer) in training, eval, the
    memory analysis's step and the served request and no other kernel;
    ``Predictor(model_dir=...)`` serves the saved best model on the card,
    held to the eval's probabilities (its ``predictions.csv``) at
    ``FULLSCALE_SERVE_ROWS`` rows to 1e-5. Returns the phase's launches
    of each kernel."""
    t_phase = time.perf_counter()
    proc, cache, out = log_build
    proc.join(FULLSCALE_LOG_TIMEOUT_S)
    stop(proc)
    check(proc.exitcode == 0, f"the full-scale log's build exited {proc.exitcode}")
    waited = time.perf_counter() - t_phase
    with open(out) as f:
        built = json.load(f)["seconds"]
    data = parity.calibrated_data(FULLSCALE_SCALE, cache)  # the child's cached files
    t_data = time.perf_counter() - t_phase
    rows = (len(data.train["labels"]), len(data.eval["labels"]))
    emit(phase="fullscale_data", scale=FULLSCALE_SCALE, build_seconds=built,
         waited_seconds=waited, seconds=t_data, train_rows=rows[0], eval_rows=rows[1],
         card=card)
    check(rows == FULLSCALE_ROWS, f"the calibrated log at {FULLSCALE_SCALE} has {rows} rows, "
          f"want {FULLSCALE_ROWS}")
    train_steps, eval_steps = (-(-n // parity.BATCH_SIZE) for n in rows)
    serve_rows = {k: v[:FULLSCALE_SERVE_ROWS] for k, v in data.eval.items() if k != "labels"}
    record = fullscale.rank_tpu_record()
    out = os.path.join(workdir, "fullscale")
    launches = {"din_attention_fwd": 0, "cin_layer_fwd": 0, "cin_layer_bwd": 0}
    for model, kernel in FULLSCALE_MODELS:
        t0 = time.perf_counter()
        zero_launches()
        rec = fullscale.run_one(model, data.train, data.eval, FULLSCALE_EPOCHS, parity.BATCH_SIZE,
                                out, *rows, dense_init="torch")
        cfg = default_config(model, dense_init="torch")
        served = Predictor(WECHAT_SCHEMA, cfg, model_dir=os.path.join(out, model, "model"))(serve_rows)
        got = kernel_launches()
        probs = np.loadtxt(os.path.join(out, model, "out", "predictions.csv"), delimiter=",",
                           skiprows=1, max_rows=FULLSCALE_SERVE_ROWS, dtype=np.float32)[:, 1]
        err = float(np.abs(served["score"] - probs).max())
        per_step = len(cfg.cin_layer_sizes) if model == "xdeepfm" else 1
        # train and eval steps, the memory analysis's step, one served bucket
        want = per_step * (FULLSCALE_EPOCHS * (train_steps + eval_steps) + 1 + 1)
        emit(phase="fullscale", **rec, launches=got, want_launches=want,
             serve_rows=FULLSCALE_SERVE_ROWS, serve_max_abs_err_vs_eval=err,
             rank_tpu_record_2_epochs={k: record[model][k] for k in ("eval_auc", "best_auc")},
             auc_bar=FULLSCALE_AUC_BAR, seconds=time.perf_counter() - t0)
        check(rec["trained_rows_per_epoch"] == rows[0] and rec["predictions_rows"] == rows[1],
              f"{model} trained {rec['trained_rows_per_epoch']} rows and exported "
              f"{rec['predictions_rows']}, want {rows}")
        staged = rec["staged_train_gb"] + rec["staged_eval_gb"]
        check(rec["peak_hbm_gb"] is not None and rec["peak_hbm_gb"] > staged,
              f"{model} peak {rec['peak_hbm_gb']} GiB is not above its staged {staged} GiB")
        check(rec["eval_auc"] > FULLSCALE_AUC_BAR,
              f"{model} eval AUC {rec['eval_auc']} is not above {FULLSCALE_AUC_BAR}")
        check(err <= 1e-5, f"{model} served best model differs from its eval by {err}")
        check(got[kernel] == want, f"{model} launched {kernel} {got[kernel]} times, want {want}")
        # the backward: every train step and the memory analysis's step
        backward = check_backward_launches(model, got, model, FULLSCALE_EPOCHS * train_steps + 1)
        check(sum(got.values()) == got[kernel] + backward,
              f"{model} launched a kernel of another path: {got}")
        launches[kernel] += got[kernel]
        launches["cin_layer_bwd"] += backward
    emit(phase="fullscale_seconds", seconds=time.perf_counter() - t_phase, data_seconds=t_data)
    return launches


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


# -- phase 4h: the table-sharded path on ranks ----------------------------------


def deterministic_mode() -> None:
    """torch's deterministic algorithms and f32 products, in a spawned child
    before cuBLAS starts."""
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    torch.use_deterministic_algorithms(True, warn_only=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def sharded_rank(rank: int, world: int, store: str, backend: str, argv, out_path: str) -> None:
    """One rank of the ``sharded`` phase, spawned: ``cli.main(argv)`` in a
    process group of ``world`` ranks (none for one rank), recording every
    train step's loss, the epoch's time, the trainer's shard records and
    this process's kernel launches, which are read here, in the child.

    Every run of the phase, the one-rank runs too, takes torch's
    deterministic algorithms: CUDA's embedding backward over a small table
    with many repeated ids (DIN's 351-row tag table, 14 tags a row) sums
    in no fixed order, so two one-rank runs differ by rounding that Adam
    turns into steps of +-lr, which the phase's bars (losses to rtol 2e-4,
    served scores to 1e-5) would read as the sharded path's error."""
    deterministic_mode()
    from rank_tpu_torch.parallel import init_distributed
    from rank_tpu_torch.train import loop

    if world > 1:
        # the ranks share the host's cores: without this, each rank's
        # intra-op threads spin against the other's
        torch.set_num_threads(max(1, (os.cpu_count() or world) // world))
        init_distributed(backend=backend, init_method=f"file://{store}", rank=rank,
                         world_size=world, timeout_s=600)
    record = {"losses": [], "epoch_seconds": []}
    step, epoch, init = loop.Trainer.train_step, loop.Trainer.train_epoch, loop.Trainer.init_state

    def train_step(self, state, meters, batch):
        before = float(meters["loss"])
        step(self, state, meters, batch)
        record["losses"].append(float(meters["loss"]) - before)

    def train_epoch(self, *args, **kwargs):
        t0 = time.perf_counter()
        out = epoch(self, *args, **kwargs)
        record["epoch_seconds"].append(time.perf_counter() - t0)
        return out

    def init_state(self):
        state = init(self)
        record.update(decisions=self.shard_decisions, table_padding=self.table_padding,
                      sharded_tables=list(self.sharded_table_names),
                      backend=self.mesh.backend,
                      device=str(self.device))
        return state

    loop.Trainer.train_step, loop.Trainer.train_epoch = train_step, train_epoch
    loop.Trainer.init_state = init_state
    zero_launches()
    record["rc"] = cli.main(list(argv))
    record["launches"] = kernel_launches()
    if world > 1:
        torch.distributed.destroy_process_group()
    with open(out_path, "w") as f:
        json.dump(record, f)


def spawn_ranks(world: int, backend: str, argv, workdir: str, timeout_s: float = 600):
    """Run ``sharded_rank`` on ``world`` spawned ranks; every rank must exit 0."""
    ctx = torch.multiprocessing.get_context("spawn")
    store = os.path.join(workdir, "store")
    outs = [os.path.join(workdir, f"rank_{r}.json") for r in range(world)]
    procs = [ctx.Process(target=sharded_rank, args=(r, world, store, backend, argv, outs[r]))
             for r in range(world)]
    for proc in procs:
        proc.start()
    deadline = time.monotonic() + timeout_s
    for proc in procs:
        proc.join(max(deadline - time.monotonic(), 1))
    for proc in procs:
        if proc.is_alive():
            proc.kill()
            proc.join(30)
    codes = [proc.exitcode for proc in procs]
    check(codes == [0] * world, f"sharded ranks {argv[:3]} exited {codes}")
    records = []
    for out in outs:
        with open(out) as f:
            records.append(json.load(f))
    check(all(r["rc"] == 0 for r in records), f"sharded ranks {argv[:3]}: the CLI failed")
    return records


def embedding_backward_repeats(card: str) -> None:
    """Why the sharded phase runs in torch's deterministic mode: the
    largest difference between two identical embedding backwards on the
    card, outside that mode, at DIN's tag-table and feedid shapes."""
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    for name, (ids, rows, dim) in {"manual_tag_seq": (1024 * 14, 352, 4),
                                   "his_read_comment_7d_seq": (1024 * 50, 106_446, 16)}.items():
        idx = torch.randint(0, rows, (ids,), device="cuda", generator=gen)
        ct = torch.randn(ids, dim, device="cuda", generator=gen)
        grads = []
        for _ in range(2):
            weight = torch.zeros(rows, dim, device="cuda", requires_grad=True)
            torch.nn.functional.embedding(idx, weight).backward(ct)
            grads.append(weight.grad)
        emit(phase="embedding_backward_repeat", table=name, ids=ids, rows=rows, dim=dim,
             max_abs_diff=float((grads[0] - grads[1]).abs().max()), card=card)


def sharded_phase(workdir: str, card: str) -> dict:
    """Phase 4h: ``cli.main`` on two ranks at t = 2 (NCCL on two cards,
    else gloo over CUDA tensors, both ranks on the one card), at full width
    on ``WECHAT_SCHEMA``: xDeepFM under ``gspmd`` (its ``uniform_tables``),
    DIN under ``psum`` and ``alltoall``; and each model on one rank at
    t = 1, same seed. Returns the phase's launches of each kernel."""
    embedding_backward_repeats(card)
    backend = "nccl" if torch.cuda.device_count() >= 2 else "gloo"
    kernel = {"xdeepfm": "cin_layer_fwd", "din": "din_attention_fwd"}
    totals = {"cin_layer_fwd": 0, "din_attention_fwd": 0, "cin_layer_bwd": 0}
    ones = {}
    for model, mode in SHARDED_RUNS:
        runs = {}
        for t in (1, 2):
            name = f"{model}_t{t}" if t == 1 else f"{model}_{mode}_t2"
            if t == 1 and model in ones:
                runs[t] = ones[model]
                continue
            run_dir = os.path.join(workdir, "sharded", name)
            os.makedirs(run_dir)
            argv = [f"--model={model}", f"--synthetic={SHARDED_ROWS}", "--num_epochs=1",
                    f"--table_parallelism={t}", f"--embedding_mode={mode}",
                    f"--model_dir={run_dir}/model_dir", f"--output_dir={run_dir}/output_dir"]
            records = spawn_ranks(t, backend, argv, run_dir)
            for i, r in enumerate(records):
                totals[kernel[model]] += r["launches"][kernel[model]]
                totals["cin_layer_bwd"] += check_backward_launches(
                    f"{name} rank {i}", r["launches"], model, len(r["losses"]))
            runs[t] = (run_dir, records, read_history(f"{run_dir}/output_dir"))
            if t == 1:
                ones[model] = runs[t]
        (dir1, (one,), hist1), (dir2, ranks, hist2) = runs[1], runs[2]
        losses = np.asarray(ranks[0]["losses"])
        want = np.asarray(one["losses"])
        check(len(losses) == len(want) > 0, f"{model} {mode}: {len(losses)} steps, want {len(want)}")
        # the table peers hold replicas of every dense parameter: equal losses
        rank_diff = max(float(np.max(np.abs(np.asarray(r["losses"]) - losses))) for r in ranks)
        check(rank_diff == 0.0, f"{model} {mode}: the ranks' losses differ by {rank_diff}")
        rel = float(np.max(np.abs(losses - want) / np.maximum(np.abs(want), 1e-12)))
        np.testing.assert_allclose(losses, want, rtol=2e-4, atol=2e-5)
        auc, auc1 = hist2[0]["eval_auc"], hist1[0]["eval_auc"]
        check(abs(auc - auc1) <= 1e-4, f"{model} {mode}: eval AUC {auc} against {auc1} at t = 1")
        launches = [r["launches"][kernel[model]] for r in ranks]
        check(all(n > 0 for n in launches), f"{model} {mode}: {kernel[model]} launches {launches}")
        rec = ranks[0]
        sharded = sorted(rec["sharded_tables"])
        check(sharded == sorted(SHARDED_TABLES), f"{model} {mode}: sharded {sharded}")
        for feature, rows in PADDED_TABLES.items():
            check(tuple(rec["table_padding"].get(feature, ())) == rows,
                  f"{model} {mode}: {feature} padded {rec['table_padding'].get(feature)}")
        replicated = rec["decisions"]["replicated"]
        for feature in ("device", "manual_tag_list"):
            check(any(f"_{feature}']" in leaf for leaf in replicated)
                  and not any(f"_{feature}']" in leaf for leaf in rec["decisions"]["sharded"]),
                  f"{model} {mode}: {feature} is not replicated")
        # the best model in the normal form, served on one rank, against the t = 1 run's
        cfg = default_config(model)
        rows = {k: v[:1000] for k, v in make_synthetic_dataset(WECHAT_SCHEMA, num_rows=1000,
                                                              seed=7).items()}
        got = Predictor(WECHAT_SCHEMA, cfg, model_dir=f"{dir2}/model_dir")(rows)["score"]
        ref = Predictor(WECHAT_SCHEMA, cfg, model_dir=f"{dir1}/model_dir")(rows)["score"]
        serve_err = float(np.max(np.abs(got - ref)))
        check(serve_err <= 1e-5, f"{model} {mode}: served scores {serve_err} from the t = 1 run's")
        emit(phase="sharded", model=model, embedding_mode=mode, backend=rec["backend"],
             ranks=len(ranks), table_shards=2,
             device=rec["device"], sharded_tables=sharded,
             padded_tables={k: rec["table_padding"][k] for k in PADDED_TABLES},
             replicated=replicated, steps=len(losses), max_loss_rel_diff=rel,
             max_rank_loss_diff=rank_diff,
             max_loss_abs_diff=float(np.max(np.abs(losses - want))),
             eval_auc=auc, eval_auc_t1=auc1, launches_per_rank=launches,
             launches_t1=one["launches"][kernel[model]], serve_max_abs_diff_vs_t1=serve_err,
             epoch_seconds=ranks[0]["epoch_seconds"][0], epoch_seconds_t1=one["epoch_seconds"][0],
             card=card)
    return totals


# -- phase 4i: the measurement tools ---------------------------------------------


@contextlib.contextmanager
def epoch_one_launches():
    """Yields a dict that holds, after the block, each kernel's launches
    in the training of epoch 1 (``Trainer.train_epoch``), the profiled span."""
    counts = {}
    epoch = train_loop.Trainer.train_epoch

    def train_epoch(self, state, batches, epoch_number=1):
        before = kernel_launches()
        out = epoch(self, state, batches, epoch_number)
        if epoch_number == 1:
            counts.update({k: n - before[k] for k, n in kernel_launches().items()})
        return out

    train_loop.Trainer.train_epoch = train_epoch
    try:
        yield counts
    finally:
        train_loop.Trainer.train_epoch = epoch


def device_busy(events) -> float:
    """The share of a chrome trace's span in which the card ran a kernel,
    a copy or a memset: the union of those events over the span of all."""
    spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                   if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"))
    timed = [e for e in events if "ts" in e and "dur" in e]
    first = min(e["ts"] for e in timed)
    last = max(e["ts"] + e["dur"] for e in timed)
    busy, end = 0.0, first
    for a, b in spans:
        busy += max(0.0, b - max(a, end))
        end = max(end, b)
    return busy / (last - first)


def profile_traces(workdir: str, card: str) -> dict:
    """``cli.main`` with ``--profile_dir`` for xDeepFM and DIN: one trace,
    holding the kernel's device events, as many as the wrapper counted in
    epoch 1, each with a duration. Returns the runs' launches."""
    totals = {"cin_layer_fwd": 0, "din_attention_fwd": 0, "cin_layer_bwd": 0}
    for model, (counter, kernel) in PROFILED_KERNELS.items():
        trace_dir = os.path.join(workdir, f"trace_{model}")
        with epoch_one_launches() as epoch1:
            _, _, launches = run_cli(model, SHARDED_ROWS, 1, workdir, card,
                                     run=f"{model}-profile", extra=[f"--profile_dir={trace_dir}"])
        check_backward_launches(f"{model}-profile", launches, model, steps_of(SHARDED_ROWS)[0])
        for k in totals:
            totals[k] += launches[k]
        check(os.listdir(trace_dir) == ["trace_rank0.json"],
              f"{model}: the profile dir holds {os.listdir(trace_dir)}")
        path = os.path.join(trace_dir, "trace_rank0.json")
        with open(path) as f:
            events = json.load(f)["traceEvents"]
        launched = [e for e in events if e.get("cat") == "kernel" and kernel in e["name"]]
        durations = [e["dur"] for e in launched]
        check(len(launched) == epoch1[counter] > 0,
              f"{model}: {len(launched)} {kernel} events in the trace, {epoch1[counter]} launches")
        check(min(durations) > 0, f"{model}: a {kernel} event without a duration")
        emit(phase="profile_trace", model=model, rows=SHARDED_ROWS, kernel=kernel,
             device_events=len(launched), epoch1_launches=epoch1[counter],
             kernel_us_median=statistics.median(durations), trace_mb=os.path.getsize(path) / 1e6,
             device_busy_share=device_busy(events), card=card)
    return totals


def precision_child(argvs, out_path: str) -> None:
    """Spawned: ``cli.main`` once for each of ``argvs`` in torch's
    deterministic mode (as ``sharded_rank``), recording each run's train
    step losses, the process's matmul precision before and after it and
    its kernel launches."""
    deterministic_mode()
    from rank_tpu_torch.train import loop

    runs = []
    step = loop.Trainer.train_step

    def train_step(self, state, meters, batch):
        before = float(meters["loss"])
        step(self, state, meters, batch)
        runs[-1]["losses"].append(float(meters["loss"]) - before)

    loop.Trainer.train_step = train_step
    for argv in argvs:
        runs.append({"losses": [], "precision_before": torch.get_float32_matmul_precision()})
        zero_launches()
        runs[-1]["rc"] = cli.main(list(argv))
        runs[-1]["precision_after"] = torch.get_float32_matmul_precision()
        runs[-1]["launches"] = kernel_launches()
    with open(out_path, "w") as f:
        json.dump(runs, f)


def product_arithmetic(card: str) -> None:
    """A 1024^2 f32 product under each precision setting against f64, and
    the arithmetic its error tells: the roofline's peak for each setting
    must be that arithmetic's."""
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    a, b = (torch.randn(1024, 1024, device="cuda", generator=gen) for _ in range(2))
    exact = a.double() @ b.double()
    for precision in PRECISIONS:
        with train_loop.matmul_precision_scope(precision):
            got = a @ b
        err = float((got.double() - exact).norm() / exact.norm())
        arithmetic = next(name for bar, name in ARITHMETIC_BY_ERROR if err < bar)
        emit(phase="matmul_precision_error", matmul_precision=precision, rel_err_vs_f64=err,
             arithmetic=arithmetic, roofline_peak_tflops=roofline.peak_flops(precision) / 1e12,
             card=card)
        check(arithmetic == roofline.PRODUCT_ARITHMETIC[precision],
              f"under {precision} cuBLAS ran {arithmetic}; the roofline assumes "
              f"{roofline.PRODUCT_ARITHMETIC[precision]}")


def precision_runs(workdir: str, card: str) -> dict:
    """xDeepFM trained once under each setting of ``--matmul_precision`` in
    one spawned process: float32 and highest give the default run's losses
    bit for bit, bfloat16 a finite loss and eval AUC over 0.6, and each run
    leaves the process's setting as it found it. Returns the launches."""
    product_arithmetic(card)
    argvs, dirs = [], []
    for precision in PRECISIONS:
        run_dir = os.path.join(workdir, "precision", str(precision))
        dirs.append(run_dir)
        argvs.append(["--model=xdeepfm", f"--synthetic={XDEEPFM_ROWS}", "--num_epochs=1",
                      f"--model_dir={run_dir}/model_dir", f"--output_dir={run_dir}/output_dir",
                      *([f"--matmul_precision={precision}"] if precision else [])])
    out_path = os.path.join(workdir, "precision.json")
    proc = torch.multiprocessing.get_context("spawn").Process(target=precision_child,
                                                              args=(argvs, out_path))
    t0 = time.perf_counter()
    proc.start()
    proc.join(600)
    if proc.is_alive():
        proc.kill()
        proc.join(30)
    check(proc.exitcode == 0, f"the precision runs exited {proc.exitcode}")
    with open(out_path) as f:
        runs = json.load(f)
    default = np.asarray(runs[0]["losses"])
    launches = {"cin_layer_fwd": 0, "din_attention_fwd": 0, "cin_layer_bwd": 0}
    for precision, run, run_dir in zip(PRECISIONS, runs, dirs):
        losses = np.asarray(run["losses"])
        (h,) = read_history(os.path.join(run_dir, "output_dir"))
        check(run["rc"] == 0 and run["launches"]["cin_layer_fwd"] > 0,
              f"{precision}: rc {run['rc']}, launches {run['launches']}")
        check_backward_launches(f"xdeepfm at {precision}", run["launches"], "xdeepfm", len(losses))
        check(run["precision_after"] == run["precision_before"],
              f"{precision}: the precision went {run['precision_before']} -> "
              f"{run['precision_after']}")
        check(np.all(np.isfinite(losses)), f"{precision}: non-finite losses")
        if precision in ("float32", "highest"):
            check(np.array_equal(losses, default),
                  f"{precision}: losses differ from the default run's by "
                  f"{np.max(np.abs(losses - default))}")
        if precision == "bfloat16":
            check(h["eval_auc"] > 0.6, f"bfloat16: eval AUC {h['eval_auc']}")
        for k in launches:
            launches[k] += run["launches"][k]
        emit(phase="matmul_precision", model="xdeepfm", rows=XDEEPFM_ROWS,
             matmul_precision=precision, steps=len(losses), mean_loss=float(losses.mean()),
             max_abs_loss_diff_vs_default=float(np.max(np.abs(losses - default))),
             eval_auc=h["eval_auc"], train_examples_per_s=h["train_examples_per_s"],
             precision_before=run["precision_before"], precision_after=run["precision_after"],
             launches=run["launches"]["cin_layer_fwd"], card=card)
    emit(phase="matmul_precision_seconds", seconds=time.perf_counter() - t0)
    return launches


def formula_flops(model: str, trainer, state, batch):
    """(the FLOPs ``FlopCounterMode`` gives the model's kernel operator in one
    train step, the formula's at the model's shapes), or None for a model
    without one. Counted on a restored step (``Trainer.restoring``)."""
    net = state["model"]
    b = batch["labels"].shape[0]
    if model == "xdeepfm":
        op, d = torch.ops.rank_tpu_torch.cin_layer_t, trainer.model_cfg.embedding_dim
        want = sum(2 * b * d * w.numel() for name, w in net.cin.named_parameters())
    elif model == "din":
        op = torch.ops.rank_tpu_torch.din_attention
        t = batch[trainer.model_cfg.seq_feature].shape[1]
        (four_d, h1), (_, h2) = net.attention.w1.shape, net.attention.w2.shape
        want = 2 * b * t * (four_d * h1 + h1 * h2 + h2) + 2 * b * t * (four_d // 4)
    else:
        return None
    with trainer.restoring(state), FlopCounterMode(display=False) as counter:
        trainer.train_step(state, trainer.meters_init(), batch)
    return counter.get_flop_counts()["Global"].get(op, 0), want


def roofline_lines(card: str) -> None:
    """Each of ``ROOFLINE_MODELS`` at batch 1024, full width: FLOPs and bytes
    a step (``step_costs``), steady examples/s over ``ROOFLINE_STEPS``
    synchronised steps after a warm-up, the roofline at the H100's peaks
    and the top 8 byte buckets. The kernels' formulas must be in the count
    and no share may pass 100%."""
    for model in ROOFLINE_MODELS:
        trainer = Trainer(WECHAT_SCHEMA, default_config(model), TrainConfig(log_every=0))
        state = trainer.init_state()
        data = make_synthetic_dataset(WECHAT_SCHEMA, num_rows=1024, seed=SEED + 3)
        data["_valid"] = np.ones(1024, np.float32)
        batch = trainer.to_device(data)
        meters = trainer.meters_init()
        for _ in range(5):
            trainer.train_step(state, meters, batch)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(ROOFLINE_STEPS):
            trainer.train_step(state, meters, batch)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        examples_per_s = ROOFLINE_STEPS * 1024 / seconds
        costs = roofline.step_costs(trainer, state, batch)
        check(costs is not None, f"{model}: no product FLOPs counted")
        line = roofline.roofline(costs["flops"] / 1024, costs["bytes"] / 1024, examples_per_s)
        kernel = formula_flops(model, trainer, state, batch)
        if kernel is not None:
            check(kernel[0] == kernel[1] > 0,
                  f"{model}: the counter gave the kernel operator {kernel[0]} FLOPs, "
                  f"its formula {kernel[1]}")
            check(costs["flops"] > kernel[0], f"{model}: the step's FLOPs miss the kernel's")
        shares = {k: line[k] for k in ("mfu_pct", "hbm_bw_pct", "pct_of_roofline")}
        check(all(v is not None and 0 <= v <= 100 for v in shares.values()),
              f"{model}: a share outside [0, 100]: {shares}")
        buckets = op_bytes.grouped(op_bytes.step_rows(trainer, state, batch), top=8)
        emit(phase="roofline", model=model, batch=1024, steps=ROOFLINE_STEPS,
             step_ms=seconds / ROOFLINE_STEPS * 1e3, examples_per_s=examples_per_s,
             flops_per_step=costs["flops"], bytes_per_step=costs["bytes"],
             kernel_flops_per_step=kernel and kernel[0], **line,
             top_bytes_per_step=dict(buckets), card=card)


def _tree_bytes(state) -> dict:
    """The model's, the optimizer's and the generators' state as bytes."""
    tree = {"model": state["model"].state_dict(), "optimizer": state["optimizer"].state_dict(),
            "step": state["step"], "rng": torch.get_rng_state(),
            "cuda_rng": torch.cuda.get_rng_state()}
    flat, _ = torch.utils._pytree.tree_flatten_with_path(tree)
    return {torch.utils._pytree.keystr(k): v.cpu().numpy().tobytes() if torch.is_tensor(v) else v
            for k, v in flat}


def step_memory(card: str) -> None:
    """``StagedRunner.step_memory_analysis`` of xDeepFM and DIN (batch 1024,
    after one step, so Adam holds its moments), beside
    ``max_memory_allocated``: every value at least 0 and under the card's
    80 GB, and the state unchanged."""
    for model in ("xdeepfm", "din"):
        trainer = Trainer(WECHAT_SCHEMA, default_config(model), TrainConfig(log_every=0))
        data = make_synthetic_dataset(WECHAT_SCHEMA, num_rows=SHARDED_ROWS, seed=SEED + 4)
        runner = StagedRunner(trainer, *split_train_test(data, test_fraction=0.15), 1024)
        state = trainer.init_state()
        trainer.train_step(state, trainer.meters_init(), next(runner._slices(
            runner.train_staged, 1)))
        before = _tree_bytes(state)
        mem = runner.step_memory_analysis(state)
        peak_gb = torch.cuda.max_memory_allocated() / 2**30
        check(_tree_bytes(state) == before, f"{model}: the memory analysis changed the state")
        check(all(0 <= v * 2**30 < H100_HBM_BYTES for v in mem.values()) and peak_gb > 0,
              f"{model}: memory analysis {mem}, peak {peak_gb} GiB")
        emit(phase="step_memory", model=model, batch=1024, **mem,
             max_memory_allocated_gb=peak_gb, card=card)


def measurement_phase(workdir: str, card: str) -> dict:
    """Phase 4i; returns its launches of each kernel (the spawned precision
    runs' included)."""
    launches = profile_traces(workdir, card)
    zero_launches()
    roofline_lines(card)
    step_memory(card)
    for kernel, n in kernel_launches().items():
        launches[kernel] = launches.get(kernel, 0) + n
    for kernel, n in precision_runs(workdir, card).items():
        launches[kernel] += n
    emit(phase="measurement_launches", launches=launches)
    return launches

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
    """Host time the port's wrappers put on every call, at DIN's 1-row
    bucket (B = 256), f32: B1's registered operator, the promoting
    ``Linear`` (in inference mode, and with autograd recording as in a
    train step) and BatchNorm's eval path, each against the bare call (the
    CUDA wrapper, ``F.linear``, ``F.batch_norm``). Each is the host clock
    of enqueueing 100 calls, no sync inside (so a short kernel's device
    time is not counted), median of 10 runs in turns. Forward hooks count
    the calls of each in one 1-row DIN request and one MMOE train forward
    (B = 1024); with the differences to the bare calls they give the host
    time each path adds."""
    from rank_tpu_torch.ops.activations import BatchNorm
    from rank_tpu_torch.ops.mlp import Linear

    q, k, lengths, params = din_inputs(256, gen)
    x = torch.randn(256, 512, generator=gen).cuda()
    linear = Linear(512, 256).cuda()
    norm = BatchNorm(512).cuda().eval()
    f = torch.nn.functional
    # (the port's call, the bare one)
    routes = {
        "din_attention": (
            lambda: din_kernels.din_attention(q, k, lengths, params, True),
            lambda: din_kernels.din_attention_cuda(q, k, lengths, params, True)),
        "linear": (lambda: linear(x), lambda: f.linear(x, linear.weight, linear.bias)),
        "batch_norm": (lambda: norm(x),
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
    for kind, (ours, bare) in per_call.items():
        emit(phase="host_overhead", call=kind, us=ours, bare_us=bare,
             calls_per_din_request=din_calls.get(kind, 0),
             calls_per_mmoe_train_forward=mmoe_calls.get(kind, 0), card=card)
    for name, calls in (("din_request_1_row", din_calls), ("mmoe_train_forward", mmoe_calls)):
        added = sum(n * (per_call[kind][0] - per_call[kind][1])
                    for kind, n in calls.items() if kind in per_call)
        emit(phase="host_overhead_added", path=name, vs_bare_us=added, card=card)


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
    mma_sync_tflops = mma_sync_ceiling(card)

    # 3. kernels against their plain versions
    gen = torch.Generator().manual_seed(SEED)
    din_err, din_c2_err, generic_err = check_din_kernel(gen)
    cin_err = check_cin_kernel(gen)
    cin_bwd_err, cin_bwd_timed = check_cin_backward(gen, card, mma_sync_tflops)
    gru_err, gru_timed = check_gru_kernel(gen, card)
    check_bf16_inputs(gen)
    check_gradients(gen)
    if args.kernels_only:
        emit(phase="kernels_only_done")
        return 0

    # 4. main paths
    with tempfile.TemporaryDirectory() as workdir:
        log_build = start_fullscale_log(workdir)
        try:
            xdeepfm_dir, cin_launches, cin_bwd_launches = train_xdeepfm(workdir, card)
            din_launches = train_din(workdir, card)
            serve_xdeepfm(xdeepfm_dir)
            dien_launches = train_and_serve_zoo(workdir, card)
            train_and_serve_multitask(workdir, card)
            file_launches, file_b1 = train_from_files(workdir, card)
            wide_launches = din_wide_phase(card)
            quality_launches = quality_phase(workdir, card)
            fullscale_launches = fullscale_phase(workdir, card, log_build)
        finally:
            stop(log_build[0])
        sharded_launches = sharded_phase(workdir, card)
        measure_launches = measurement_phase(workdir, card)
    file_err = check_din_on_file_data(file_b1)
    serve_din(gen, card)
    c2_launches = serve_c2_shapes(gen, card)

    # 5. times on the card
    timings = time_kernels(gen, card, mma_sync_tflops)
    timings["cin_layer_bwd", 1024] = cin_bwd_timed
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
         din_launches + file_launches["din_attention_fwd"] + sharded_launches["din_attention_fwd"]
         + measure_launches["din_attention_fwd"] + quality_launches["din_attention_fwd"]
         + fullscale_launches["din_attention_fwd"],
         max(din_err, file_err)),
        # the generic B1 kernel, launched on slice 6's path (DIN at D = 12)
        # and phase 4l's (DIN at D = 128, trained and served), timed at
        # D = 128
        ("din_attention_generic_fwd", ("din_attention_generic_fwd", "D128"),
         "rank_tpu_torch/ops/kernels/csrc/din_attention.cu",
         "rank_tpu/ops/pallas/din_attention.py:156",
         c2_launches["din_attention_generic_fwd"] + wide_launches["din_attention_generic_fwd"],
         max(din_c2_err["din_attention_generic_fwd"], generic_err)),
        ("cin_layer_fwd", ("cin_layer_fwd/layer1", 1024), "rank_tpu_torch/ops/kernels/csrc/cin.cu",
         "rank_tpu/ops/pallas/cin.py:140",
         cin_launches + file_launches["cin_layer_fwd"] + sharded_launches["cin_layer_fwd"]
         + measure_launches["cin_layer_fwd"] + quality_launches["cin_layer_fwd"]
         + fullscale_launches["cin_layer_fwd"], cin_err),
        # B2's gradient: replaces no Pallas kernel (rank_tpu's _bwd
        # recomputes through the plain version)
        ("cin_layer_bwd", ("cin_layer_bwd", 1024), "rank_tpu_torch/ops/kernels/csrc/cin.cu",
         None,
         cin_bwd_launches + file_launches["cin_layer_bwd"] + sharded_launches["cin_layer_bwd"]
         + measure_launches["cin_layer_bwd"] + quality_launches["cin_layer_bwd"]
         + fullscale_launches["cin_layer_bwd"], cin_bwd_err),
    ):
        # B = 1024: the batch of the training path; B2 at its heavier layer.
        # library_ms: none for B1 (no single PyTorch call computes DIN
        # attention) and B2's gradient; B2: one einsum. c2_shapes: the
        # shapes past the former limits that the variant ran, at B = 1024.
        kernel = name
        c2 = [{"shape": shape, **{key: t[key] for key in keys}}
              for (k, shape), t in timings.items() if k == kernel and isinstance(shape, str)]
        rows.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches, "max_abs_err": err, **{key: timings[timed][key] for key in keys},
            "c2_max_abs_err": din_c2_err.get(name, cin_err if name == "cin_layer_fwd" else None),
            "c2_shapes": c2,
        })
    # DIEN's sequence kernels, timed at the cell's shape in augru mode (the
    # evolving layer; the extractor's gru reads alike in its
    # gru_seq_times line); they replace no Pallas kernel (the JAX package
    # runs a lax.scan); max_abs_err: the largest error against the plain
    # version as a share of the plain tensor's largest entry
    gru = gru_timed["augru"]
    for name, way in (("gru_seq_fwd", "fwd"), ("gru_seq_bwd", "bwd")):
        rows.append({
            "name": name, "route": "cuda",
            "source": "rank_tpu_torch/ops/kernels/csrc/gru_sequence.cu",
            "replaces": None, "launches": dien_launches[name], "max_abs_err": gru_err,
            "ms": gru[f"{way}_ms"], "plain_ms": gru[f"plain_{way}_ms"],
            "bound_ms": gru[f"{way}_bound_ms"], "bound_by": gru[f"{way}_bound_by"],
            "bound_tc_ms": None, "library_ms": None, "c2_max_abs_err": None, "c2_shapes": [],
            "loop_graphed_ms": gru[f"loop_graphed_{way}_ms"],
            "sequence_graphed_ms": gru[f"sequence_graphed_{way}_ms"]})
    emit(kernels=rows)
    print(card, flush=True)
    emit(ok=True, device={"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                          "count": torch.cuda.device_count()})
    return 0


if __name__ == "__main__":
    sys.exit(main())
