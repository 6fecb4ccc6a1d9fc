"""Measure the gap between the JAX package and the port at bf16 on the CPU,
the evidence for the bf16 bars of ``test_torch_zoo_forward.py`` and
``test_torch_sequence.py``. Not collected by pytest; run from the
repository root:

    PYTHONPATH=$PWD:$PYTHONPATH JAX_PLATFORMS=cpu python tests/torch_bf16_gap.py

It prints one JSON line per measurement, each the worst over 5 seeds:

  * ``model``: BST and AutoInt at their bf16 defaults, 256 rows, tiny and
    full width: the largest logit and probability gap, and at full width
    how far each side's bf16 logits lie from its own f32 logits;
  * ``bst_block``: one block at bf16 compute and score storage, T = 51,
    B = 64, each JAX ``attn_impl``;
  * ``autoint_layer``: one interacting layer at bf16, 23 fields, att_dim
    32, B = 64.
"""

import json
import os
import sys

import jax.numpy as jnp
import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import test_torch_sequence as seq  # noqa: E402
import test_torch_zoo_forward as fwd  # noqa: E402
from rank_tpu import ops as jops  # noqa: E402
from rank_tpu.ops.autoint import AutoIntLayer as JaxAutoIntLayer  # noqa: E402
from rank_tpu_torch.ops.attention import length_mask  # noqa: E402
from rank_tpu_torch.ops.autoint import AutoIntLayer  # noqa: E402
from rank_tpu_torch.ops.transformer import BSTTransformerBlock  # noqa: E402

SEEDS = range(5)


def models():
    for name in ("bst", "autoint"):
        for width in ("tiny", "full"):
            overrides = fwd.TINY[name] if width == "tiny" else {}
            logit = prob = jax_vs_f32 = port_vs_f32 = 0.0
            for seed in SEEDS:
                want, got = fwd._models_both(name, overrides, width, rows=256, seed=seed)
                logit = max(logit, float(np.abs(got - want).max()))
                prob = max(prob, float(np.abs(fwd._sigmoid(got) - fwd._sigmoid(want)).max()))
                if width == "full":
                    want32, got32 = fwd._models_both(name, {**overrides, **fwd.F32}, width,
                                                     rows=256, seed=seed)
                    jax_vs_f32 = max(jax_vs_f32, float(np.abs(want - want32).max()))
                    port_vs_f32 = max(port_vs_f32, float(np.abs(got - got32).max()))
            print(json.dumps(dict(measure="model", model=name, width=width, logit_gap=logit,
                                  prob_gap=prob, jax_bf16_vs_f32=jax_vs_f32,
                                  port_bf16_vs_f32=port_vs_f32)), flush=True)


def bst_block():
    for impl in ("vpu", "vpu2", "einsum"):
        worst = 0.0
        for seed in SEEDS:
            rng = np.random.default_rng(seed)
            x = rng.normal(size=(64, 51, 16)).astype(np.float32)
            valid = length_mask(torch.from_numpy(rng.integers(0, 51, 64).astype(np.int32)), 51)
            kwargs = dict(dropout_rate=0.0, compute_dtype="bfloat16", score_dtype="bfloat16",
                          attn_impl=impl)
            jmod = jops.BSTTransformerBlock(d_model=16, num_heads=2, max_len=51, **kwargs)
            args = (jnp.asarray(x), jnp.asarray(valid.numpy()))
            variables = seq._jax_vars(jmod, *args, seed=seed)
            want = np.asarray(jmod.apply(variables, *args), np.float32)
            mod = seq._port(BSTTransformerBlock(16, 2, 51, **kwargs), variables)
            with torch.no_grad():
                got = mod(torch.from_numpy(x), valid).numpy()
            worst = max(worst, float(np.abs(got - want).max()))
        print(json.dumps(dict(measure="bst_block", attn_impl=impl, gap=worst)), flush=True)


def autoint_layer():
    worst = largest = 0.0
    for seed in SEEDS:
        e = fwd._fields(b=64, f=23, d=16, seed=seed)
        jmod = JaxAutoIntLayer(num_heads=2, att_dim=32, compute_dtype="bfloat16",
                               score_dtype="bfloat16")
        variables = fwd._jax_vars(jmod, e, seed=seed)
        want = np.asarray(jmod.apply(variables, jnp.asarray(e)), np.float32)
        mod = fwd._port(AutoIntLayer(16, 2, 32, "bfloat16", "bfloat16"), variables)
        with torch.no_grad():
            got = mod(torch.from_numpy(e)).numpy()
        worst = max(worst, float(np.abs(got - want).max()))
        largest = max(largest, float(np.abs(want).max()))
    print(json.dumps(dict(measure="autoint_layer", gap=worst, largest_output=largest)),
          flush=True)


if __name__ == "__main__":
    models()
    bst_block()
    autoint_layer()
