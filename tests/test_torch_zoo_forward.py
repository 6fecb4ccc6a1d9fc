"""The port's non-sequence zoo ops and all 13 models of slice 4 held against
the JAX package on the CPU.

Both sides get the same weights (the JAX package's variables, carried over
by ``interop.state_dict_from_flax``, with random non-trivial biases,
BatchNorm and LayerNorm statistics and scales) and the same numpy inputs
made from a seed.

Tolerances:
  * ops at f32: rtol = atol = 1e-5 (sums of a few products in another
    order);
  * models at f32: logits rtol = atol = 1e-4 (the bar of
    tests/test_forward_parity.py), probabilities 1e-5;
  * BST and AutoInt at their bf16 defaults: ``BF16_BAR``, logits within
    0.25 and probabilities within 0.05. bf16 keeps 8 bits of mantissa and
    the two sides round at different points (XLA fuses and sums in its own
    order; torch rounds each op's output and sums matmuls in f32).
    Measured on the CPU over 5 seeds x 256 rows at both widths
    (``tests/torch_bf16_gap.py``): the worst gap is 0.131 in logits and
    0.031 in probabilities (AutoInt at full width), while each side's bf16
    result lies up to 3.4 logits from its own f32 result (AutoInt's
    unscaled scores make sharp softmaxes). The port follows the JAX
    package's bf16 arithmetic, not f32.
"""

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rank_tpu import ops as jops
from rank_tpu.features import WECHAT_SCHEMA as JAX_WECHAT
from rank_tpu.features import tiny_schema as jax_tiny_schema
from rank_tpu.models import build_model as jax_build_model
from rank_tpu.models import default_config as jax_default_config
from rank_tpu.ops.autoint import AutoIntLayer as JaxAutoIntLayer
from rank_tpu_torch import WECHAT_SCHEMA, build_model, default_config, tiny_schema
from rank_tpu_torch.data.synthetic import make_synthetic_dataset
from rank_tpu_torch.interop import state_dict_from_flax
from rank_tpu_torch.models import MODEL_CLASSES
from rank_tpu_torch.ops import fm
from rank_tpu_torch.ops.autoint import AutoIntLayer, DenseGeneral
from rank_tpu_torch.ops.cross import CrossNetwork, ResidualStack
from rank_tpu_torch.ops.mlp import dense_layer
from rank_tpu_torch.ops.product import InnerProductLayer, OuterProductLayer
from rank_tpu_torch.ops.senet import BilinearInteraction, SENETLayer

TOL = dict(rtol=1e-5, atol=1e-5)
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)
BF16_BAR = dict(logits=0.25, probs=0.05)

NEW_MODELS = ("afm", "autoint", "bst", "dcn", "deepcrossing", "deepfm", "dien", "ffm",
              "fibinet", "flen", "fwfm", "pnn", "widedeep")
F32 = dict(transformer_dtype="float32", transformer_score_dtype="float32")
# narrow settings for the tiny schema; every branch a model has stays on
TINY = {
    "afm": dict(embedding_dim=8, attention_factor=16),
    "autoint": dict(embedding_dim=8, autoint_layers=2, autoint_att_dim=8),
    "bst": dict(hidden_units=(32, 16)),
    "dcn": dict(hidden_units=(32, 16), num_cross_layers=2),
    "deepcrossing": dict(residual_internal_dim=32),
    "deepfm": dict(hidden_units=(32, 16), embedding_dim=8),
    "dien": dict(hidden_units=(32, 16), gru_hidden_dim=8, use_aux_loss=True),
    "ffm": dict(embedding_dim=4),
    "fibinet": dict(hidden_units=(32, 16), embedding_dim=8),
    "flen": dict(hidden_units=(32, 16), embedding_dim=8),
    "fwfm": dict(embedding_dim=8),
    "pnn": dict(hidden_units=(32, 16), embedding_dim=8, pnn_mode="both", outer_outputs=8),
    "widedeep": dict(hidden_units=(32, 16)),
}


def _randomize(tree, rng):
    """Random non-trivial biases, BatchNorm statistics, LayerNorm and
    BatchNorm scales, Dice/PReLU alphas and FLEN's r weights, so that every
    parameter does real work on both sides."""
    out = {}
    for key, value in tree.items():
        if isinstance(value, dict):
            out[key] = _randomize(value, rng)
            continue
        value = np.asarray(value)
        if key == "var":
            value = rng.uniform(0.5, 2.0, value.shape)
        elif key in ("scale", "r_intra", "r_inter"):
            value = rng.normal(1.0, 0.5, value.shape)
        elif key in ("mean", "alpha") or key.endswith("bias") or key.startswith("b_"):
            value = rng.normal(0.0, 0.5, value.shape)
        out[key] = np.asarray(value, np.float32)
    return out


def _jax_vars(module, *args, seed=0, **kwargs):
    variables = nn.meta.unbox(jax.jit(lambda r, *a: module.init(r, *a, **kwargs))(
        jax.random.PRNGKey(seed), *map(jnp.asarray, args)))
    return _randomize(jax.tree_util.tree_map(np.asarray, dict(variables)),
                      np.random.default_rng(seed))


def _port(module, variables):
    module.load_state_dict(state_dict_from_flax(module, variables))
    return module.eval()


def _fields(b=7, f=6, d=8, seed=0):
    return np.random.default_rng(seed).normal(size=(b, f, d)).astype(np.float32)


# -- ops ----------------------------------------------------------------------


@pytest.mark.parametrize("frozen_random", [False, True])
def test_cross_network_matches_jax(frozen_random):
    """Forward, and gradients: a frozen stack's weights get none (the JAX
    ``stop_gradient``), yet stay in the state dict."""
    x0 = np.random.default_rng(1).normal(size=(7, 12)).astype(np.float32)
    jmod = jops.CrossNetwork(3, frozen_random=frozen_random)
    variables = _jax_vars(jmod, x0)
    want = np.asarray(jmod.apply(variables, jnp.asarray(x0)))
    jgrads = jax.grad(lambda p: jnp.sum(jmod.apply({"params": p}, jnp.asarray(x0)) ** 2))(
        variables["params"])

    mod = _port(CrossNetwork(12, 3, frozen_random=frozen_random), variables)
    x = torch.from_numpy(x0).requires_grad_()
    got = mod(x)
    np.testing.assert_allclose(got.detach().numpy(), want, **TOL)
    (got ** 2).sum().backward()
    assert sorted(mod.state_dict()) == sorted(f"{p}_{l}" for p in "bw" for l in range(3))
    for name, p in mod.named_parameters():
        if frozen_random:
            assert p.grad is None and not np.any(np.asarray(jgrads[name])), name
        else:
            np.testing.assert_allclose(p.grad.numpy(), np.asarray(jgrads[name]),
                                       rtol=1e-4, atol=1e-5)
    assert x.grad is not None


def test_cross_network_init_follows_flax():
    """lecun: flax's truncated xavier_normal, std sqrt(2/(d+1)) before the
    cut; torch: N(0, 0.02); frozen_random: N(0, 1)."""
    g = torch.Generator().manual_seed(0)
    d = 4096
    for kwargs, std in ((dict(), np.sqrt(2.0 / (d + 1))), (dict(dense_init="torch"), 0.02),
                        (dict(frozen_random=True), 1.0)):
        w = CrossNetwork(d, 1, generator=g, **kwargs).w_0.detach().numpy()
        assert w.shape == (d, 1)
        assert abs(w.std() - std) < 0.06 * std, kwargs


def test_residual_stack_matches_jax():
    x = np.random.default_rng(2).normal(size=(7, 12)).astype(np.float32)
    jmod = jops.ResidualStack(20, 2)
    variables = _jax_vars(jmod, x)
    mod = _port(ResidualStack(12, 20, 2), variables)
    with torch.no_grad():
        got = mod(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(jmod.apply(variables, jnp.asarray(x))), **TOL)


FM_OPS = {
    "fm_first_order": lambda m, e, r: m.fm_first_order(e[..., :1]),
    "fm_second_order": lambda m, e, r: m.fm_second_order(e),
    "fm_second_order_vector": lambda m, e, r: m.fm_second_order_vector(e),
    "flen_field_wise_bi_interaction": lambda m, e, r: m.flen_field_wise_bi_interaction(
        e, ((0, 2), (2, 5), (5, 6)), r[:3], r[3:6]),
    "pairwise_hadamard": lambda m, e, r: m.pairwise_hadamard(e),
    "pairwise_dot": lambda m, e, r: m.pairwise_dot(e),
    "fwfm_interaction": lambda m, e, r: m.fwfm_interaction(e, r),
    "ffm_interaction": lambda m, e, r: m.ffm_interaction(e),  # e: (B, F, F, D)
}


@pytest.mark.parametrize("name", sorted(FM_OPS))
def test_fm_ops_match_jax(name):
    rng = np.random.default_rng(3)
    shape = (7, 6, 6, 8) if name == "ffm_interaction" else (7, 6, 8)
    emb = rng.normal(size=shape).astype(np.float32)
    r = rng.normal(size=(15,)).astype(np.float32)
    want = FM_OPS[name](jops, jnp.asarray(emb), jnp.asarray(r))
    got = FM_OPS[name](fm, torch.from_numpy(emb), torch.from_numpy(r))
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    for a, b in zip(fm.pair_indices(6), jops.pair_indices(6)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("layer", ["inner", "outer"])
def test_product_layers_match_jax(layer):
    emb = _fields(seed=6)
    jmod = jops.InnerProductLayer() if layer == "inner" else jops.OuterProductLayer(5)
    variables = _jax_vars(jmod, emb)
    mod = InnerProductLayer() if layer == "inner" else OuterProductLayer(8, 5)
    mod = _port(mod, variables)
    with torch.no_grad():
        got = mod(torch.from_numpy(emb)).numpy()
    np.testing.assert_allclose(got, np.asarray(jmod.apply(variables, jnp.asarray(emb))), **TOL)


@pytest.mark.parametrize("which", ["senet", "all", "each", "interaction"])
def test_senet_and_bilinear_match_jax(which):
    emb = _fields(seed=7)
    if which == "senet":
        jmod, mod = jops.SENETLayer(3), SENETLayer(6, 3)
    else:
        jmod, mod = jops.BilinearInteraction(which), BilinearInteraction(6, 8, which)
    variables = _jax_vars(jmod, emb)
    mod = _port(mod, variables)
    with torch.no_grad():
        got = mod(torch.from_numpy(emb)).numpy()
    np.testing.assert_allclose(got, np.asarray(jmod.apply(variables, jnp.asarray(emb))), **TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_autoint_layer_matches_jax(dtype):
    """At f32 to 1e-5; at the bf16 defaults (compute and score storage in
    bf16) to atol 0.5 on outputs of up to about 9: the scores are unscaled,
    so a bf16 rounding of a score moves a sharp softmax. Measured on the CPU
    at F = 23, att_dim 32, B = 64 over 5 seeds (``tests/torch_bf16_gap.py``):
    worst gap 0.25."""
    e = _fields(b=9, f=23, d=16, seed=8)
    jmod = JaxAutoIntLayer(num_heads=2, att_dim=8, compute_dtype=dtype, score_dtype=dtype)
    variables = _jax_vars(jmod, e)
    want = np.asarray(jmod.apply(variables, jnp.asarray(e)), np.float32)
    mod = _port(AutoIntLayer(16, 2, 8, dtype, dtype), variables)
    with torch.no_grad():
        got = mod(torch.from_numpy(e))
    assert got.dtype == torch.float32 and got.shape == (9, 23, 16)
    tol = TOL if dtype == "float32" else dict(rtol=0, atol=0.5)
    np.testing.assert_allclose(got.numpy(), want, **tol)


# -- interop leaf rules ----------------------------------------------------------


def test_interop_layer_norm_rule():
    """``weight`` <- ``scale``, ``bias`` <- ``bias``."""
    x = _fields(f=3, seed=9)
    jmod = nn.LayerNorm(epsilon=1e-6)
    variables = _jax_vars(jmod, x)
    mod = _port(torch.nn.LayerNorm(8, eps=1e-6), variables)
    np.testing.assert_array_equal(mod.weight.detach().numpy(), variables["params"]["scale"])
    with torch.no_grad():
        got = mod(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(jmod.apply(variables, jnp.asarray(x))), **TOL)


def test_interop_dense_general_rule():
    """A DenseGeneral kernel keeps flax's (D_in, heads, att_dim) layout."""
    x = _fields(f=3, d=5, seed=10)
    jmod = nn.DenseGeneral((2, 4), use_bias=False)
    variables = _jax_vars(jmod, x)
    mod = _port(DenseGeneral(5, 2, 4), variables)
    assert list(mod.state_dict()) == ["kernel"] and mod.kernel.shape == (5, 2, 4)
    with torch.no_grad():
        got = mod(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(jmod.apply(variables, jnp.asarray(x))), **TOL)


def test_interop_bias_free_linear_rule():
    """``weight`` <- ``kernel`` transposed, and nothing else: a stray flax
    bias raises."""
    x = _fields(f=3, d=5, seed=11)
    jmod = nn.Dense(4, use_bias=False)
    variables = _jax_vars(jmod, x)
    mod = _port(dense_layer(5, 4, bias=False), variables)
    assert list(mod.state_dict()) == ["weight"]
    with torch.no_grad():
        got = mod(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(jmod.apply(variables, jnp.asarray(x))), **TOL)
    stray = {"params": {**variables["params"], "bias": np.zeros(4, np.float32)}}
    with pytest.raises(KeyError, match="bias"):
        state_dict_from_flax(mod, stray)


# -- models ---------------------------------------------------------------------


def _models_both(name, overrides, width, rows=32, seed=0):
    """(JAX logits, port logits) from the same carried-over weights."""
    jax_schema, schema = ((jax_tiny_schema(), tiny_schema()) if width == "tiny"
                          else (JAX_WECHAT, WECHAT_SCHEMA))
    data = make_synthetic_dataset(schema, num_rows=rows, seed=seed)
    batch = {k: jnp.asarray(v) for k, v in data.items()}
    jax_model = jax_build_model(jax_schema, jax_default_config(name, **overrides))
    rngs = {"params": jax.random.PRNGKey(seed), "dropout": jax.random.PRNGKey(1)}
    variables = nn.meta.unbox(jax.jit(lambda r, b: jax_model.init(r, b, train=False))(
        rngs, {k: v[:2] for k, v in batch.items()}))
    variables = _randomize(jax.tree_util.tree_map(np.asarray, dict(variables)),
                           np.random.default_rng(seed))
    want = jax.jit(lambda v, b: jax_model.apply(v, b, train=False))(variables, batch)
    model = _port(build_model(schema, default_config(name, **overrides), device="cpu"), variables)
    with torch.no_grad():
        got = model({k: torch.from_numpy(v) for k, v in data.items()})
    assert got["logits"].shape == (rows,) and got["logits"].dtype == torch.float32
    np.testing.assert_allclose(float(got["aux_loss"]), float(want["aux_loss"]), rtol=1e-4,
                               atol=1e-5)
    return np.asarray(want["logits"]), got["logits"].numpy()


def _sigmoid(x):
    return 1.0 / (1.0 + np.exp(-x.astype(np.float64)))


@pytest.mark.parametrize("width", ["tiny", "full"])
@pytest.mark.parametrize("name", NEW_MODELS)
def test_model_forward_matches_jax_f32(name, width):
    """Tiny: the tiny schema with ``TINY``'s narrow settings. Full:
    ``default_config`` on WECHAT_SCHEMA. BST and AutoInt run at f32 here."""
    overrides = {**(TINY[name] if width == "tiny" else {}), **F32}
    want, got = _models_both(name, overrides, width)
    np.testing.assert_allclose(got, want, **LOGIT_TOL)
    np.testing.assert_allclose(_sigmoid(got), _sigmoid(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("width", ["tiny", "full"])
@pytest.mark.parametrize("name", ["bst", "autoint"])
def test_model_forward_matches_jax_bf16_defaults(name, width):
    overrides = TINY[name] if width == "tiny" else {}
    assert default_config(name).transformer_dtype == "bfloat16"
    want, got = _models_both(name, overrides, width)
    assert np.all(np.isfinite(got))
    np.testing.assert_allclose(got, want, rtol=0, atol=BF16_BAR["logits"])
    np.testing.assert_allclose(_sigmoid(got), _sigmoid(want), rtol=0, atol=BF16_BAR["probs"])


def test_registry_holds_the_single_task_zoo():
    """All 18 models of the JAX registry: the 15 single-task models and the
    multi-task ones, which build too; an unknown name raises."""
    from rank_tpu.models.registry import MODEL_CLASSES as JAX_CLASSES
    from rank_tpu_torch.models import MULTI_TASK_MODELS

    assert sorted(MODEL_CLASSES) == sorted(JAX_CLASSES)
    assert len(MODEL_CLASSES) == 18 and set(NEW_MODELS) <= set(MODEL_CLASSES)
    assert MULTI_TASK_MODELS == {"esmm", "mmoe", "ple"} <= set(MODEL_CLASSES)
    for name in MULTI_TASK_MODELS:
        assert build_model(tiny_schema(), default_config(name), device="cpu").cfg.name == name
    with pytest.raises(ValueError, match="unknown model"):
        build_model(tiny_schema(), default_config("din").replace(name="nosuch"), device="cpu")


def test_new_models_raise_without_cuda(monkeypatch, tmp_path):
    """With no CUDA device the default device raises for every new model:
    ``build_model``, ``Predictor``, ``Trainer`` and the CLI run nothing on
    the CPU unless asked to."""
    from rank_tpu_torch import Predictor
    from rank_tpu_torch.cli import main
    from rank_tpu_torch.train import Trainer

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    schema = tiny_schema()
    for name in NEW_MODELS:
        cfg = default_config(name, **TINY[name])
        with pytest.raises(RuntimeError, match="CUDA"):
            build_model(schema, cfg)
        with pytest.raises(RuntimeError, match="CUDA"):
            Trainer(schema, cfg)
        state_dict = build_model(schema, cfg, device="cpu").state_dict()
        with pytest.raises(RuntimeError, match="CUDA"):
            Predictor(schema, cfg, state_dict=state_dict)
    with pytest.raises(RuntimeError, match="CUDA"):
        main(["--model=bst", "--synthetic=10", f"--model_dir={tmp_path}/m",
              f"--output_dir={tmp_path}/o"])
