"""Measure the gap between the JAX package and the port at bf16 on the CPU,
the evidence for the bf16 bars of ``test_torch_zoo_forward.py``,
``test_torch_sequence.py`` and ``test_torch_serve_extras.py``. Not
collected by pytest; run from the repository root, naming the measures to
take (all of them when none is named):

    PYTHONPATH=$PWD:$PYTHONPATH JAX_PLATFORMS=cpu python tests/torch_bf16_gap.py [measure ...]

It prints one JSON line per measurement, each the worst over 5 seeds:

  * ``model``: BST and AutoInt at their bf16 defaults, 256 rows, tiny and
    full width: the largest logit and probability gap, and at full width
    how far each side's bf16 logits lie from its own f32 logits;
  * ``bst_block``: one block at bf16 compute and score storage, T = 51,
    B = 64, each JAX ``attn_impl``;
  * ``autoint_layer``: one interacting layer at bf16, 23 fields, att_dim
    32, B = 64;
  * ``serving``: ``Predictor(weights_dtype='bfloat16')``, 256 rows at
    tiny width: for dcn, din, xdeepfm, mmoe, fwfm and autoint at JAX's
    N(0, 1) tables, against JAX's bf16 Predictor on the same weights, and
    each side's bf16 Predictor against its own f32 one; then the port's
    bf16 against its f32 Predictor for every model, at N(0, 1) and
    N(0, 0.1) tables (3 seeds).
"""

import json
import os
import sys

import jax.numpy as jnp
import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import test_torch_sequence as seq  # noqa: E402
import test_torch_serve_extras as serve  # noqa: E402
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


def _heads_gap(got, want) -> float:
    return max(float(np.abs(got[h] - np.asarray(want[h], np.float32)).max()) for h in want)


def serving():
    from rank_tpu.features import tiny_schema as jax_tiny_schema
    from rank_tpu.models import build_model as jax_build_model
    from rank_tpu.models import default_config as jax_default_config
    from rank_tpu.serve import Predictor as JaxPredictor
    from rank_tpu_torch import Predictor, build_model, default_config
    from rank_tpu_torch.data.synthetic import make_synthetic_dataset
    from rank_tpu_torch.interop import state_dict_from_flax
    from rank_tpu_torch.models.registry import DEFAULT_CONFIGS

    schema = serve.SCHEMA
    for name in ("dcn", "din", "xdeepfm", "mmoe", "fwfm", "autoint"):
        worst = jax_own = port_own = 0.0
        for seed in SEEDS:
            request = serve._request(256, seed=seed)
            jax_cfg = jax_default_config(name, hidden_units=(16, 8))
            variables = serve._jax_variables(jax_build_model(jax_tiny_schema(), jax_cfg),
                                             make_synthetic_dataset(schema, num_rows=2), seed=seed)
            want32 = JaxPredictor(jax_tiny_schema(), jax_cfg, variables=variables,
                                  min_bucket=64)(request)
            want = JaxPredictor(jax_tiny_schema(), jax_cfg, variables=variables, min_bucket=64,
                                weights_dtype="bfloat16")(request)
            cfg = default_config(name, hidden_units=(16, 8))
            state_dict = state_dict_from_flax(build_model(schema, cfg, device="cpu"), variables)
            got32 = Predictor(schema, cfg, state_dict=state_dict, min_bucket=64,
                              device="cpu")(request)
            got = Predictor(schema, cfg, state_dict=state_dict, min_bucket=64, device="cpu",
                            weights_dtype="bfloat16")(request)
            worst = max(worst, _heads_gap(got, want))
            jax_own = max(jax_own, _heads_gap(want, want32))
            port_own = max(port_own, _heads_gap(got, got32))
        print(json.dumps(dict(measure="serving", model=name, embedding_init="normal",
                              port_bf16_vs_jax_bf16=worst, jax_bf16_vs_jax_f32=jax_own,
                              port_bf16_vs_port_f32=port_own)), flush=True)
    for init in ("normal", "normal_small"):
        for name in sorted(DEFAULT_CONFIGS):
            cfg = default_config(name, hidden_units=(16, 8), embedding_init=init)
            worst = 0.0
            for seed in range(3):
                state_dict = serve._state_dict(cfg, seed=seed)
                request = serve._request(256)
                f32 = Predictor(schema, cfg, state_dict=state_dict, min_bucket=64, device="cpu")
                bf16 = Predictor(schema, cfg, state_dict=state_dict, min_bucket=64, device="cpu",
                                 weights_dtype="bfloat16")
                worst = max(worst, _heads_gap(bf16(request), f32(request)))
            print(json.dumps(dict(measure="serving", model=name, embedding_init=init,
                                  port_bf16_vs_port_f32=worst)), flush=True)


MEASURES = {"models": models, "bst_block": bst_block, "autoint_layer": autoint_layer,
            "serving": serving}

if __name__ == "__main__":
    for measure in sys.argv[1:] or MEASURES:
        MEASURES[measure]()
