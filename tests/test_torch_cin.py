"""The port's CIN kernel path and xDeepFM (rank_tpu_torch) held against the JAX package.

The same numpy inputs, made from a seed, go through the JAX oracle
``_reference_t``/``_reference``, the Pallas CIN kernel in interpret mode,
the JAX ``CIN`` module and ``XDeepFM`` on one side, and the port's plain
versions and modules on the CPU on the other. Forward values agree to
rtol/atol 1e-5 (a CIN layer sums up to H*F products in another order),
model logits to 1e-4 and probabilities to 1e-5 (the bar of
tests/test_forward_parity.py), gradients to rtol 1e-4 / atol 1e-5. The
registered operators of both kernels (B1, B2) run here on CPU tensors, as
the plain forward and the operator's gradient; their CUDA forwards run only
on the card, where ``chip_smoke.py`` holds them against the plain versions.
"""

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rank_tpu.features import WECHAT_SCHEMA as JAX_WECHAT
from rank_tpu.features import tiny_schema as jax_tiny_schema
from rank_tpu.models import build_model as jax_build_model
from rank_tpu.models import default_config as jax_default_config
from rank_tpu.ops.cin import CIN as JaxCIN
from rank_tpu.ops.pallas import cin as ck
from rank_tpu.ops.pallas import din_attention as pk
from rank_tpu.serve import Predictor as JaxPredictor
from rank_tpu_torch import WECHAT_SCHEMA, Predictor, build_model, default_config, tiny_schema
from rank_tpu_torch.data.synthetic import make_synthetic_dataset
from rank_tpu_torch.interop import state_dict_from_flax
from rank_tpu_torch.ops.cin import CIN, xavier_uniform_
from rank_tpu_torch.ops.kernels import cin as tk
from rank_tpu_torch.ops.kernels import din_attention as dk

TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture(autouse=True)
def interpret_mode(monkeypatch):
    monkeypatch.setattr(ck, "_INTERPRET", True)
    monkeypatch.setattr(pk, "_INTERPRET", True)


def _layer_inputs(b=7, d=16, h=12, f=7, o=10, seed=0):
    """Transposed-layout inputs; B=7 is a multiple of no block."""
    rng = np.random.default_rng(seed)
    xk_t = rng.normal(size=(b, d, h)).astype(np.float32)
    x0_t = rng.normal(size=(b, d, f)).astype(np.float32)
    w = (rng.normal(size=(o, h, f)) * 0.1).astype(np.float32)
    return xk_t, x0_t, w


def _torch(*arrays):
    return tuple(torch.from_numpy(a) for a in arrays)


@pytest.mark.parametrize("b", [1, 7, 16])
@pytest.mark.parametrize("jax_fn", ["reference", "pallas_interpret"])
def test_plain_layer_matches_jax_transposed(jax_fn, b):
    inputs = _layer_inputs(b=b)
    fn = ck._reference_t if jax_fn == "reference" else ck.cin_layer_fused_t
    want = np.asarray(fn(*map(jnp.asarray, inputs)))
    got = tk.cin_layer_plain_t(*_torch(*inputs)).numpy()
    assert got.shape == (b, 16, 10)
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("jax_fn", ["reference", "pallas_interpret"])
def test_plain_layer_matches_jax_standard_layout(jax_fn):
    """The standard (B, H, D) layout through the transposes at the boundary."""
    xk_t, x0_t, w = _layer_inputs(b=7, seed=1)
    xk, x0 = xk_t.transpose(0, 2, 1).copy(), x0_t.transpose(0, 2, 1).copy()
    fn = ck._reference if jax_fn == "reference" else ck.cin_layer_fused
    want = np.asarray(fn(jnp.asarray(xk), jnp.asarray(x0), jnp.asarray(w)))  # (B, O, D)
    got_t = tk.cin_layer_plain_t(*_torch(xk.transpose(0, 2, 1).copy(),
                                         x0.transpose(0, 2, 1).copy(), w))
    np.testing.assert_allclose(got_t.transpose(1, 2).numpy(), want, **TOL)


def test_cin_layer_fn_gradients_match_jax():
    """B2's registered operator on CPU tensors (the plain forward and
    ``cin_layer_vjp``) against jax.grad through the Pallas kernel's
    custom_vjp (interpret mode)."""
    xk_t, x0_t, w = _layer_inputs(b=7, h=9, o=6, seed=2)
    g = np.random.default_rng(3).normal(size=(7, 16, 6)).astype(np.float32)

    def jax_loss(*args):
        return jnp.sum(ck.cin_layer_fused_t(*args) * g)

    want = jax.jit(jax.grad(jax_loss, argnums=(0, 1, 2)))(*map(jnp.asarray, (xk_t, x0_t, w)))
    leaves = [x.requires_grad_() for x in _torch(xk_t, x0_t, w)]
    out = tk.cin_layer_t(*leaves)
    (out * torch.from_numpy(g)).sum().backward()
    for leaf, ref in zip(leaves, want):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(ref), **GRAD_TOL)


def test_cpu_gradient_goes_through_the_plain_vjp():
    """On CPU tensors the operator's gradient is the plain vjp, and the
    backward kernels' counter does not move."""
    xk_t, x0_t, w = _torch(*_layer_inputs(b=7, h=9, o=6, seed=6))
    g = torch.from_numpy(np.random.default_rng(7).normal(size=(7, 16, 6)).astype(np.float32))
    want = tk.cin_layer_vjp_plain(xk_t, x0_t, w, g)
    before = tk.cin_layer_bwd_cuda_t.launches
    leaves = [x.clone().requires_grad_() for x in (xk_t, x0_t, w)]
    tk.cin_layer_t(*leaves).backward(g)
    for leaf, ref in zip(leaves, want):
        torch.testing.assert_close(leaf.grad, ref, rtol=0, atol=0)
    assert tk.cin_layer_bwd_cuda_t.launches == before


@pytest.mark.parametrize("fault", ["cpu", "bf16", "non_contiguous", "grad_shape"])
def test_backward_kernel_request_raises(fault):
    """The backward kernels' wrapper checks its inputs as the forward's
    does, ``grad_out`` among them; on the CPU it never computes."""
    xk_t, x0_t, w = _torch(*_layer_inputs(b=2))
    args = dict(xk_t=xk_t, x0_t=x0_t, w=w, grad_out=torch.zeros(2, 16, 10))
    error, match = ValueError, "CUDA device"
    if fault == "bf16":
        args["grad_out"] = args["grad_out"].bfloat16()
        error, match = TypeError, "float32"
    elif fault == "non_contiguous":
        args["x0_t"] = x0_t.transpose(0, 1).contiguous().transpose(0, 1)
        match = "contiguous"
    elif fault == "grad_shape":
        args["grad_out"] = torch.zeros(2, 16, 9)
        match = "grad_out"
    with pytest.raises(error, match=match):
        tk.cin_layer_bwd_cuda_t(**args)


@pytest.mark.parametrize("h, o", [(7, 128), (64, 128), (12, 10), (24, 5), (300, 130)])
def test_backward_weight_operand_matches_einsum(h, o):
    """``weight_operand_bwd`` lays w out as (h-chunk, f, o, h): the
    operand's product with g over o is the einsum's P_f = sum_o g w[o, :, f],
    and the padding past H and O is zero."""
    gen = torch.Generator().manual_seed(h)
    f, m = 3, 5
    w, g = torch.randn(o, h, f, generator=gen), torch.randn(m, o, generator=gen)
    wb = tk.weight_operand_bwd(w)
    hsw, op8 = tk.backward_h_chunk(h), -(-o // 8) * 8
    nhc = wb.shape[0]
    assert wb.shape == (nhc, f, op8, hsw) and hsw in (8, 16, 32, 64)
    assert nhc * hsw >= h > (nhc - 1) * hsw and (nhc == 1 or hsw == 64)
    flat = wb.permute(1, 2, 0, 3).reshape(f, op8, nhc * hsw)
    torch.testing.assert_close(flat[:, :o, :h], w.permute(2, 0, 1), rtol=0, atol=0)
    assert not flat[:, o:].any() and not flat[:, :, h:].any()
    g_pad = torch.cat([g, torch.zeros(m, op8 - o)], dim=1)
    got = torch.einsum("mo,fon->mfn", g_pad, flat)
    torch.testing.assert_close(got[..., :h], torch.einsum("mo,ohf->mfh", g, w), **TOL)


@pytest.mark.parametrize("use_softmax", [False, True])
def test_din_attention_fn_gradients_match_jax(use_softmax):
    """B1's registered operator on CPU tensors (the plain forward and
    ``din_attention_vjp``) against jax.grad through the Pallas kernel's
    custom_vjp (interpret mode); ``lengths`` gets no gradient."""
    rng = np.random.default_rng(4)
    b, t, d = 5, 12, 16
    q = rng.normal(size=(b, d)).astype(np.float32)
    k = rng.normal(size=(b, t, d)).astype(np.float32)
    lengths = np.array([0, t, 3, 7, 1], np.int32)
    shapes = [(4 * d, 64), (64,), (64, 32), (32,), (32, 1), (1,)]
    params = [(rng.normal(size=s) * 0.3).astype(np.float32) for s in shapes]
    g = rng.normal(size=(b, d)).astype(np.float32)

    def jax_loss(q, k, params):
        out = pk.din_attention_fused(q, k, jnp.asarray(lengths), params, use_softmax)
        return jnp.sum(out * g)

    jq, jk, jp = jax.jit(jax.grad(jax_loss, argnums=(0, 1, 2)))(
        jnp.asarray(q), jnp.asarray(k), tuple(map(jnp.asarray, params)))
    leaves = [x.requires_grad_() for x in _torch(q, k, *params)]
    out = dk.din_attention(leaves[0], leaves[1], torch.from_numpy(lengths), leaves[2:],
                           use_softmax)
    (out * torch.from_numpy(g)).sum().backward()
    for leaf, ref in zip(leaves, [jq, jk, *jp]):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(ref), **GRAD_TOL)


def _cin_variables(layer_sizes, x0, seed=0):
    jmod = JaxCIN(layer_sizes, backend="jnp")
    return nn.meta.unbox(jax.jit(jmod.init)(jax.random.PRNGKey(seed), jnp.asarray(x0)))


@pytest.mark.parametrize("backend", ["auto", "jnp"])
@pytest.mark.parametrize("jax_backend", ["jnp", "pallas_interpret"])
def test_cin_module_matches_jax(jax_backend, backend, monkeypatch):
    """(8, 6) split_half: layer 0 of 8 maps, 4 fed forward, 4 + 6 pooled.
    The JAX pallas backend's size threshold would send these shapes to its
    jnp path, so it is pointed at the fused kernel here."""
    if jax_backend == "pallas_interpret":
        monkeypatch.setattr(ck, "cin_layer_auto_t", ck.cin_layer_fused_t)
    x0 = np.random.default_rng(5).normal(size=(7, 7, 16)).astype(np.float32)
    variables = _cin_variables((8, 6), x0)
    jmod = JaxCIN((8, 6), backend="pallas" if jax_backend == "pallas_interpret" else "jnp")
    want = np.asarray(jax.jit(jmod.apply)(variables, jnp.asarray(x0)))

    mod = CIN(7, (8, 6), backend=backend)
    assert mod.out_features == want.shape[1] == 10
    mod.load_state_dict(state_dict_from_flax(mod, variables))
    with torch.no_grad():
        got = mod(torch.from_numpy(x0)).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_cin_weights_follow_flax_xavier():
    """flax's xavier_uniform on (O, H, F) counts fans along the last two
    axes, with O as the receptive field: the bound is sqrt(6 / (O*(H+F)))."""
    x0 = np.zeros((1, 7, 16), np.float32)
    variables = _cin_variables((128, 128), x0)
    mod = CIN(7, (128, 128), generator=torch.Generator().manual_seed(0))
    for i, (h, o) in enumerate(((7, 128), (64, 128))):
        w = getattr(mod, f"w_{i}").detach().numpy()
        ref = np.asarray(variables["params"][f"w_{i}"])
        assert w.shape == ref.shape == (o, h, 7)
        limit = np.sqrt(6.0 / (o * (h + 7)))
        for x in (w, ref):
            assert np.abs(x).max() <= limit
            assert np.abs(x).max() > 0.95 * limit
        assert abs(w.std() - ref.std()) < 0.05 * ref.std()
    t = xavier_uniform_(torch.empty(4, 3, 2), None)
    assert t.abs().max() <= np.sqrt(6.0 / (4 * 5))


def test_cin_raises_on_odd_split_and_unknown_backend():
    with pytest.raises(ValueError, match="even"):
        CIN(7, (7, 8))
    with pytest.raises(ValueError, match="backend"):
        CIN(7, (8, 8), backend="triton")


def test_kernel_request_on_cpu_raises():
    """The kernel is never swapped for the plain version on a CPU tensor:
    asking for it by name, or for the module's ``'pallas'`` backend,
    raises."""
    xk_t, x0_t, w = _torch(*_layer_inputs(b=2))
    with pytest.raises(ValueError, match="CUDA"):
        tk.cin_layer_cuda_t(xk_t, x0_t, w)
    mod = CIN(7, (8, 8), backend="pallas")
    with pytest.raises(ValueError, match="CUDA"):
        mod(torch.zeros(2, 7, 16))


def _randomize_stats(tree, rng):
    """Random non-trivial BatchNorm statistics and scales and random biases,
    so eval-mode BatchNorm does real work on both sides."""
    out = {}
    for key, value in tree.items():
        if isinstance(value, dict):
            out[key] = _randomize_stats(value, rng)
            continue
        value = np.asarray(value)
        if key == "var":
            value = rng.uniform(0.5, 2.0, value.shape)
        elif key == "scale":
            value = rng.normal(1.0, 0.5, value.shape)
        elif key in ("mean", "bias"):
            value = rng.normal(0.0, 0.5, value.shape)
        out[key] = np.asarray(value, np.float32)
    return out


def _xdeepfm_both(jax_schema, schema, overrides, rows, seed=0):
    data = make_synthetic_dataset(schema, num_rows=rows, seed=seed)
    jax_model = jax_build_model(jax_schema, jax_default_config("xdeepfm", **overrides))
    batch = {k: jnp.asarray(v[:2]) for k, v in data.items()}
    rngs = {"params": jax.random.PRNGKey(seed), "dropout": jax.random.PRNGKey(1)}
    variables = nn.meta.unbox(jax.jit(lambda r, b: jax_model.init(r, b, train=False))(rngs, batch))
    variables = _randomize_stats(jax.tree_util.tree_map(np.asarray, dict(variables)),
                                 np.random.default_rng(seed))
    cfg = default_config("xdeepfm", **overrides)
    model = build_model(schema, cfg, device="cpu")
    state_dict = state_dict_from_flax(model, variables)
    model.load_state_dict(state_dict)
    model.eval()
    return jax_model, variables, model, state_dict, data, cfg


@pytest.mark.parametrize("width", ["tiny", "full"])
def test_xdeepfm_forward_matches_jax(width):
    """Tiny: CIN (8, 8), tower 32-16, dim 8. Full: the default config on
    WECHAT_SCHEMA (dim 16, CIN (128, 128) split_half, tower 512-256-128)."""
    if width == "tiny":
        overrides = dict(hidden_units=(32, 16), embedding_dim=8, cin_layer_sizes=(8, 8))
        pair = (jax_tiny_schema(), tiny_schema())
    else:
        overrides, pair = {}, (JAX_WECHAT, WECHAT_SCHEMA)
    jax_model, variables, model, _, data, _ = _xdeepfm_both(*pair, overrides, rows=32)
    want = jax.jit(lambda v, b: jax_model.apply(v, b, train=False))(
        variables, {k: jnp.asarray(v) for k, v in data.items()})
    with torch.no_grad():
        got = model({k: torch.from_numpy(v) for k, v in data.items()})
    assert got["logits"].shape == (32,)
    np.testing.assert_allclose(got["logits"].numpy(), np.asarray(want["logits"]),
                               rtol=1e-4, atol=1e-4)
    assert float(got["aux_loss"]) == 0.0


def test_xdeepfm_predictor_matches_jax_predictor():
    overrides = dict(hidden_units=(32, 16), embedding_dim=8, cin_layer_sizes=(8, 8))
    _, variables, _, state_dict, data, cfg = _xdeepfm_both(
        jax_tiny_schema(), tiny_schema(), overrides, rows=40, seed=1)
    jax_pred = JaxPredictor(jax_tiny_schema(), jax_default_config("xdeepfm", **overrides),
                            variables=variables, min_bucket=16)
    pred = Predictor(tiny_schema(), cfg, state_dict=state_dict, min_bucket=16, device="cpu")
    for n in (1, 40):
        request = {k: v[:n] for k, v in data.items() if k != "labels"}
        got = pred(request)["score"]
        assert got.shape == (n,) and got.dtype == np.float32
        assert np.all(np.isfinite(got)) and np.all((got > 0) & (got < 1))
        np.testing.assert_allclose(got, jax_pred(request)["score"], rtol=1e-5, atol=1e-5)
