"""The port's sequence ops (the low-precision softmaxes, DIEN's bilinear
attention, the BST block, the attentional GRU), DIEN's auxiliary loss and
the BST and DIEN CLI runs, held against the JAX package on the CPU.

Tolerances:
  * f32 forward values rtol = atol = 1e-5; gradients rtol 1e-4 / atol 1e-5;
  * the bf16 softmaxes: one bf16 rounding of weights in [0, 1], atol 2^-8;
  * the BST block at bf16 compute and score storage: atol 0.1 on LayerNorm
    outputs of up to about 6. bf16 keeps 8 bits of mantissa and the two
    sides round at different points (XLA rounds the products and partial
    sums of its fused reductions; torch sums each matmul in f32 and rounds
    its output). Measured on the CPU at T = 51, B = 64, 5 seeds and all
    three JAX formulations (``tests/torch_bf16_gap.py``): worst gap 0.058.
"""

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rank_tpu import ops as jops
from rank_tpu.features import tiny_schema as jax_tiny_schema
from rank_tpu.ops import attention as jattention
from rank_tpu.models import build_model as jax_build_model
from rank_tpu.models import default_config as jax_default_config
from rank_tpu_torch import WECHAT_SCHEMA, Predictor, build_model, default_config, tiny_schema
from rank_tpu_torch.cli import main
from rank_tpu_torch.data.loader import split_train_test
from rank_tpu_torch.data.synthetic import make_synthetic_dataset
from rank_tpu_torch.interop import state_dict_from_flax
from rank_tpu_torch.ops.attention import (BilinearAttention, length_mask, masked_softmax_lowp,
                                          softmax_lowp)
from rank_tpu_torch.ops.rnn import AttentionalGRU
from rank_tpu_torch.ops.transformer import BSTTransformerBlock

TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)
LENGTHS = np.array([0, 9, 1, 4, 9, 5], np.int32)  # T = 9: empty, full and ragged rows
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _randomize(tree, rng):
    """Random biases and LayerNorm scales, so both do real work."""
    out = {}
    for key, value in tree.items():
        if isinstance(value, dict):
            out[key] = _randomize(value, rng)
            continue
        value = np.asarray(value)
        if key == "scale":
            value = rng.normal(1.0, 0.5, value.shape)
        elif key.endswith("bias"):
            value = rng.normal(0.0, 0.5, value.shape)
        out[key] = np.asarray(value, np.float32)
    return out


def _jax_vars(module, *args, seed=0):
    variables = nn.meta.unbox(jax.jit(module.init)(jax.random.PRNGKey(seed), *args))
    return _randomize(jax.tree_util.tree_map(np.asarray, dict(variables)),
                      np.random.default_rng(seed))


def _port(module, variables):
    module.load_state_dict(state_dict_from_flax(module, variables))
    return module.eval()


def _to_np(x):
    return np.asarray(jnp.asarray(x, jnp.float32)) if isinstance(x, jax.Array) else \
        x.detach().float().numpy()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_low_precision_softmaxes_match_jax(dtype):
    """Storage in the scores' dtype; a fully masked row gives zeros."""
    jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(0)
    scores = (rng.normal(size=(6, 9)) * 3).astype(np.float32)
    mask = length_mask(torch.from_numpy(LENGTHS), 9).numpy()
    tol = TOL if dtype == "float32" else dict(rtol=0, atol=2.0 ** -8)
    for got, want in (
        (masked_softmax_lowp(torch.from_numpy(scores).to(tdt), torch.from_numpy(mask)),
         jattention.masked_softmax_lowp(jnp.asarray(scores, jdt), jnp.asarray(mask))),
        (softmax_lowp(torch.from_numpy(scores).to(tdt)),
         jattention.softmax_lowp(jnp.asarray(scores, jdt))),
    ):
        assert got.dtype == tdt
        np.testing.assert_allclose(_to_np(got), _to_np(want), **tol)
    assert not masked_softmax_lowp(torch.ones(1, 3, dtype=tdt), torch.zeros(1, 3, dtype=bool)).any()


def test_bilinear_attention_matches_jax():
    rng = np.random.default_rng(1)
    q = rng.normal(size=(6, 16)).astype(np.float32)
    keys = rng.normal(size=(6, 9, 8)).astype(np.float32)
    jmod = jops.BilinearAttention()
    args = (jnp.asarray(q), jnp.asarray(keys), jnp.asarray(LENGTHS))
    variables = _jax_vars(jmod, *args)
    mod = _port(BilinearAttention(16, 8), variables)
    with torch.no_grad():
        got = mod(torch.from_numpy(q), torch.from_numpy(keys), torch.from_numpy(LENGTHS)).numpy()
    np.testing.assert_allclose(got, np.asarray(jmod.apply(variables, *args)), **TOL)
    assert not got[0].any()  # zero-length row


@pytest.mark.parametrize("attn_impl", ["vpu", "vpu2", "einsum"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bst_block_matches_jax(dtype, attn_impl):
    """Every JAX formulation against the port's one; at bf16 the scores are
    stored in bf16 too (the BST defaults). Lengths include 0 and T."""
    rng = np.random.default_rng(2)
    x = rng.normal(size=(6, 9, 16)).astype(np.float32)
    valid = length_mask(torch.from_numpy(LENGTHS), 9)
    kwargs = dict(dropout_rate=0.0, compute_dtype=dtype, score_dtype=dtype, attn_impl=attn_impl)
    jmod = jops.BSTTransformerBlock(d_model=16, num_heads=2, max_len=9, **kwargs)
    args = (jnp.asarray(x), jnp.asarray(valid.numpy()))
    variables = _jax_vars(jmod, *args)
    want = np.asarray(jmod.apply(variables, *args), np.float32)
    mod = _port(BSTTransformerBlock(16, 2, 9, **kwargs), variables)
    with torch.no_grad():
        got = mod(torch.from_numpy(x), valid)
    assert got.dtype == torch.float32 and got.shape == (6, 9, 16)
    tol = TOL if dtype == "float32" else dict(rtol=0, atol=0.1)
    np.testing.assert_allclose(got.numpy(), want, **tol)


def test_bst_block_raises_on_unknown_attn_impl():
    with pytest.raises(ValueError, match="attn_impl"):
        BSTTransformerBlock(16, 2, 9, attn_impl="sdpa")
    with pytest.raises(ValueError, match="divisible"):
        BSTTransformerBlock(16, 3, 9)


@pytest.mark.parametrize("mode", ["gru", "agru", "augru"])
def test_attentional_gru_matches_jax(mode):
    """Outputs, the final state and every gradient; padded steps carry the
    state and output zeros (lengths 0, 1 and T among the rows)."""
    rng = np.random.default_rng(3)
    x = rng.normal(size=(6, 9, 5)).astype(np.float32)
    att = rng.uniform(size=(6, 9)).astype(np.float32)
    g_out = rng.normal(size=(6, 9, 4)).astype(np.float32)
    g_fin = rng.normal(size=(6, 4)).astype(np.float32)
    jmod = jops.AttentionalGRU(4, mode=mode, unroll=3)
    att_arg = None if mode == "gru" else jnp.asarray(att)
    variables = _jax_vars(jmod, jnp.asarray(x), jnp.asarray(LENGTHS), att_arg)

    def jax_loss(params, x, att):
        outs, final = jmod.apply({"params": params}, x, jnp.asarray(LENGTHS),
                                 None if mode == "gru" else att)
        return jnp.sum(outs * g_out) + jnp.sum(final * g_fin), (outs, final)

    (_, (want_outs, want_final)), jgrads = jax.value_and_grad(
        jax_loss, argnums=(0, 1, 2), has_aux=True)(variables["params"], jnp.asarray(x),
                                                    jnp.asarray(att))
    mod = _port(AttentionalGRU(5, 4, mode, unroll=3), variables)
    xt, at = (torch.from_numpy(a).requires_grad_() for a in (x, att))
    outs, final = mod(xt, torch.from_numpy(LENGTHS), None if mode == "gru" else at)
    np.testing.assert_allclose(outs.detach().numpy(), np.asarray(want_outs), **TOL)
    np.testing.assert_allclose(final.detach().numpy(), np.asarray(want_final), **TOL)
    assert not outs[0].any() and not outs[2, 1:].any() and not final[0].any()
    ((outs * torch.from_numpy(g_out)).sum() + (final * torch.from_numpy(g_fin)).sum()).backward()
    for name, p in mod.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(jgrads[0][name]), **GRAD_TOL,
                                   err_msg=name)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jgrads[1]), **GRAD_TOL)
    if mode != "gru":
        np.testing.assert_allclose(at.grad.numpy(), np.asarray(jgrads[2]), **GRAD_TOL)


@pytest.mark.parametrize("hidden", [8, 16])
def test_dien_aux_loss_matches_jax(hidden):
    """The auxiliary next-item loss with in-batch rolled negatives: with
    H = 8 the positives and negatives go through ``aux_proj``; with H = D =
    16 there is none. Compared in train mode, where the JAX trainer takes
    it."""
    overrides = dict(hidden_units=(16,), gru_hidden_dim=hidden, use_aux_loss=True,
                     dropout_rate=0.0)
    schema = tiny_schema()
    data = make_synthetic_dataset(schema, num_rows=24, seed=4)
    data["his_read_comment_7d_seq_length"][:3] = [0, 1, 10]
    batch = {k: jnp.asarray(v) for k, v in data.items()}
    jax_model = jax_build_model(jax_tiny_schema(), jax_default_config("dien", **overrides))
    rngs = {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)}
    variables = jax.tree_util.tree_map(np.asarray, dict(nn.meta.unbox(
        jax.jit(lambda r, b: jax_model.init(r, b, train=False))(rngs, batch))))
    want, _ = jax_model.apply(variables, batch, train=True, mutable=["batch_stats"])
    model = build_model(schema, default_config("dien", **overrides), device="cpu")
    model.load_state_dict(state_dict_from_flax(model, variables))
    assert hasattr(model, "aux_proj") == (hidden != 16)
    got = model.train()({k: torch.from_numpy(v) for k, v in data.items()})
    aux = got["aux_loss"].item()
    assert aux > 0
    np.testing.assert_allclose(aux, float(want["aux_loss"]), **TOL)
    np.testing.assert_allclose(got["logits"].detach().numpy(), np.asarray(want["logits"]),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("model", ["bst", "dien"])
def test_cli_trains_and_serves_sequence_model(model, tmp_path):
    """Full schema width (tower cut to 32-16), one epoch on the CPU; the
    exported predictions are ``Predictor(model_dir=...)``'s scores."""
    rows = 600
    assert main([f"--model={model}", f"--synthetic={rows}", "--batch_size=128", "--device=cpu",
                 "--hidden_units=32,16", f"--model_dir={tmp_path}/m",
                 f"--output_dir={tmp_path}/o"]) == 0
    assert (tmp_path / "m" / "best_model").exists()
    saved = np.loadtxt(tmp_path / "o" / "predictions.csv", delimiter=",", skiprows=1)
    _, eval_data = split_train_test(make_synthetic_dataset(WECHAT_SCHEMA, num_rows=rows), 0.15)
    pred = Predictor(WECHAT_SCHEMA, default_config(model, hidden_units=(32, 16)),
                     model_dir=str(tmp_path / "m"), device="cpu")
    got = pred(eval_data)["score"]
    assert got.shape == (len(saved),) and np.all(np.isfinite(got))
    np.testing.assert_allclose(got, saved[:, 1], rtol=1e-5, atol=1e-5)
