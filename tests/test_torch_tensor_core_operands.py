"""The operands and numerics of the port's tensor-core kernels (B1, B2), on the CPU.

The CUDA kernels run only on the card, where ``chip_smoke.py`` holds them
against their plain versions. What surrounds them is Python that the CPU
reaches: B2's weight operand (K ordered (f, h), H padded to 8, O to 4),
built by the wrapper. B1's kernel folds its first layer as it stages it;
the fold is written out here. Each is used in a plain torch forward that
follows the kernel's algebra and is held against the port's plain version
and the JAX package (``_reference_t`` / ``_reference``, the Pallas kernels
in interpret mode) at rtol = atol = 1e-5. A numpy emulation of TF32
rounding then shows why the kernels run three products a k-step (3xTF32):
one TF32 product misses the 1e-5 bar at layer 1's full width, and the
split meets it.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rank_tpu.ops.pallas import cin as ck
from rank_tpu.ops.pallas import din_attention as pk
from rank_tpu_torch.ops.attention import MASK_NEG
from rank_tpu_torch.ops.cin import xavier_uniform_
from rank_tpu_torch.ops.kernels import cin as tk
from rank_tpu_torch.ops.kernels import din_attention as dk

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True)
def interpret_mode(monkeypatch):
    monkeypatch.setattr(ck, "_INTERPRET", True)
    monkeypatch.setattr(pk, "_INTERPRET", True)


# -- B2: the CIN layer's GEMM operands ---------------------------------------

# (H, F, O): layer 0 and layer 1 of the default xDeepFM, and a shape whose
# H and O both need padding
CIN_SHAPES = {"layer0": (7, 7, 128), "layer1": (64, 7, 128), "padded": (12, 5, 10)}


def _cin_inputs(h, f, o, b=3, d=16, seed=0):
    rng = np.random.default_rng(seed)
    xk_t = rng.normal(size=(b, d, h)).astype(np.float32)
    x0_t = rng.normal(size=(b, d, f)).astype(np.float32)
    w = (rng.normal(size=(o, h, f)) * 0.1).astype(np.float32)
    return xk_t, x0_t, w


def _pair_operand(xk_t: torch.Tensor, x0_t: torch.Tensor) -> torch.Tensor:
    """The kernel's A operand, (B*D, F*Hp): column f*Hp + h holds
    xk[m, h] * x0[m, f], zero for h >= H."""
    b, d, h = xk_t.shape
    hp = tk.padded_h(h)
    xk_p = torch.nn.functional.pad(xk_t, (0, hp - h))
    return (x0_t[..., :, None] * xk_p[..., None, :]).reshape(b * d, -1)


@pytest.mark.parametrize("shape", list(CIN_SHAPES))
def test_cin_weight_operand_layout(shape):
    h, f, o = CIN_SHAPES[shape]
    w = torch.from_numpy(_cin_inputs(h, f, o)[2])
    wop = tk.weight_operand(w)
    hp, op = tk.padded_h(h), -(-o // 4) * 4
    assert hp % 8 == 0 and hp - h < 8 and op % 4 == 0
    assert wop.shape == (f * hp, op) and wop.is_contiguous()
    blocks = wop.reshape(f, hp, op)
    assert not blocks[:, h:, :].any() and not blocks[:, :, o:].any()
    for fi, hi, oi in ((0, 0, 0), (f - 1, h - 1, o - 1), (f // 2, h // 2, o // 3)):
        assert wop[fi * hp + hi, oi] == w[oi, hi, fi]


@pytest.mark.parametrize("jax_fn", ["reference", "pallas_interpret"])
@pytest.mark.parametrize("shape", list(CIN_SHAPES))
def test_cin_operand_gemm_matches_plain_and_jax(shape, jax_fn):
    """A (formed in (f, h) order) @ the weight operand, cut to O, is the
    layer: against the port's plain version and the JAX package."""
    h, f, o = CIN_SHAPES[shape]
    xk_np, x0_np, w_np = _cin_inputs(h, f, o, seed=1)
    xk_t, x0_t, w = map(torch.from_numpy, (xk_np, x0_np, w_np))
    b, d, _ = xk_t.shape
    got = (_pair_operand(xk_t, x0_t) @ tk.weight_operand(w))[:, :o].reshape(b, d, o)
    np.testing.assert_allclose(got.numpy(), tk.cin_layer_plain_t(xk_t, x0_t, w).numpy(), **TOL)
    fn = ck._reference_t if jax_fn == "reference" else ck.cin_layer_fused_t
    want = np.asarray(fn(jnp.asarray(xk_np), jnp.asarray(x0_np), jnp.asarray(w_np)))
    np.testing.assert_allclose(got.numpy(), want, **TOL)


# -- B1: the folded first layer ------------------------------------------------


def _din_inputs(d, b=9, t=50, seed=0):
    """Lengths 0 and T, and 1, 15, 16, 17 and 49 around the kernel's 16-row
    tiles."""
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, d)).astype(np.float32)
    k = rng.normal(size=(b, t, d)).astype(np.float32)
    lengths = np.array([0, t, 1, 15, 16, 17, 49, 3, 0][:b], np.int32)
    shapes = [(4 * d, 64), (64,), (64, 32), (32,), (32, 1), (1,)]
    params = tuple((rng.normal(size=s) * 0.3).astype(np.float32) for s in shapes)
    return q, k, lengths, params


def fold_first_layer(w1: torch.Tensor):
    """(4D, H1) -> (w1q (D, H1), w1kp (2D, H1)), as the kernel folds w1 when
    it stages it. w1 acts on [q, k, q-k, q*k]; with w1a..w1d its row blocks,
        [q, k, q-k, q*k] @ w1 = q @ (w1a + w1c) + [k | q*k] @ [w1b - w1c ; w1d]."""
    w1a, w1b, w1c, w1d = w1.split(w1.shape[0] // 4)
    return w1a + w1c, torch.cat([w1b - w1c, w1d])


def _folded_forward(q, k, lengths, params, use_softmax):
    """The kernel's algebra in torch: the folded first layer, then the
    reference's masking (MASK_NEG, then / sqrt(D); zero weight on masked
    positions; denominator clamped at 1e-12)."""
    w1, b1, w2, b2, w3, b3 = params
    w1q, w1kp = fold_first_layer(w1)
    _, t, d = k.shape
    cross = torch.cat([k, q[:, None, :] * k], dim=-1)  # (B, T, 2D) [k | q*k]
    h = torch.relu(cross @ w1kp + (q @ w1q + b1)[:, None, :])
    h = torch.relu(h @ w2 + b2)
    scores = h @ w3[:, 0] + b3
    valid = torch.arange(t)[None, :] < lengths[:, None]
    if use_softmax:
        z = torch.where(valid, scores, MASK_NEG) / math.sqrt(d)
        e = torch.where(valid, torch.exp(z - z.amax(dim=1, keepdim=True)), 0.0)
        weights = e / e.sum(dim=1, keepdim=True).clamp_min(1e-12)
    else:
        weights = torch.where(valid, scores, 0.0)
    return torch.einsum("bt,btd->bd", weights, k)


def test_fold_first_layer_shapes_and_blocks():
    w1 = torch.arange(4 * 16 * 64, dtype=torch.float32).reshape(64, 64)
    w1q, w1kp = fold_first_layer(w1)
    assert w1q.shape == (16, 64) and w1kp.shape == (32, 64)
    torch.testing.assert_close(w1q, w1[:16] + w1[32:48], rtol=0, atol=0)
    torch.testing.assert_close(w1kp[:16], w1[16:32] - w1[32:48], rtol=0, atol=0)
    torch.testing.assert_close(w1kp[16:], w1[48:], rtol=0, atol=0)


@pytest.mark.parametrize("use_softmax", [False, True])
@pytest.mark.parametrize("d", [8, 16])
def test_din_folded_forward_matches_plain_and_jax(d, use_softmax):
    q, k, lengths, params = _din_inputs(d, seed=d)
    tq, tk_, tl = map(torch.from_numpy, (q, k, lengths))
    tp = tuple(map(torch.from_numpy, params))
    got = _folded_forward(tq, tk_, tl, tp, use_softmax).numpy()
    assert not got[0].any() and not got[-1].any(), "zero-length rows pool to zeros"
    np.testing.assert_allclose(
        got, dk.din_attention_plain(tq, tk_, tl, tp, use_softmax).numpy(), **TOL)
    jargs = (jnp.asarray(q), jnp.asarray(k), jnp.asarray(lengths), tuple(map(jnp.asarray, params)))
    np.testing.assert_allclose(got, np.asarray(pk.din_attention_fused(*jargs, use_softmax)), **TOL)
    np.testing.assert_allclose(got, np.asarray(pk._reference(*jargs, use_softmax)), **TOL)


# -- TF32: why the kernels split -------------------------------------------------


def tf32(x: np.ndarray) -> np.ndarray:
    """``cvt.rna.tf32.f32``: round to 10 mantissa bits, to nearest with ties
    away from zero (sign-magnitude bits: add half of the dropped 13 bits'
    unit, then clear them)."""
    bits = np.ascontiguousarray(x, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def truncate_tf32(x: np.ndarray) -> np.ndarray:
    """What the tensor core reads of an f32 register given as TF32: its top
    19 bits."""
    bits = np.ascontiguousarray(x, np.float32).view(np.uint32)
    return (bits & np.uint32(0xFFFFE000)).view(np.float32)


def products(a: np.ndarray, b: np.ndarray):
    """(one TF32 product, 3xTF32) of a @ b as the kernels form them: TF32
    operands, exact products, f32 sums. hi is rounded (``tf32``); lo =
    x - hi goes to the tensor core as it is, which truncates it. 3xTF32
    adds the small terms lo*hi and hi*lo before the large hi*hi."""
    ah, bh = tf32(a), tf32(b)
    al, bl = truncate_tf32(a - ah), truncate_tf32(b - bh)
    return ah @ bh, (al @ bh + ah @ bl) + ah @ bh


def test_tf32_rounding_is_cvt_rna():
    one = np.float32(1.0)
    tie = np.float32(1 + 2.0**-11)  # exactly half a TF32 unit above 1
    assert tf32(np.array([tie]))[0] == np.float32(1 + 2.0**-10)
    assert tf32(np.array([-tie]))[0] == -np.float32(1 + 2.0**-10)
    assert tf32(np.array([np.float32(1 + 2.0**-12)]))[0] == one
    x = np.random.default_rng(0).normal(size=1000).astype(np.float32)
    hi = tf32(x)
    assert not np.any(hi.view(np.uint32) & 0x1FFF), "10 mantissa bits kept"
    assert np.all(np.abs(hi - x) <= np.abs(x) * 2.0**-11)
    lo = truncate_tf32(x - hi)
    assert np.all(np.abs(hi.astype(np.float64) + lo - x) <= np.abs(x) * 2.0**-21)


def test_3xtf32_meets_the_bar_where_tf32_does_not():
    """Layer 1 of the default xDeepFM at full width (H = 64, F = 7,
    O = 128, D = 16; B = 64), its inputs as the main path makes them:
    x0 of N(0, 1) embeddings, flax-xavier weights, xk the first half of
    layer 0's output. Against an f64 product of the same operands."""
    gen = torch.Generator().manual_seed(0)
    x0_t = torch.randn(64, 16, 7, generator=gen)
    w0 = xavier_uniform_(torch.empty(128, 7, 7), gen)
    xk_t = tk.cin_layer_plain_t(x0_t, x0_t, w0)[..., :64].contiguous()
    w1 = xavier_uniform_(torch.empty(128, 64, 7), gen)
    a = _pair_operand(xk_t, x0_t).numpy()
    b = tk.weight_operand(w1).numpy()
    exact = a.astype(np.float64) @ b.astype(np.float64)
    single, split = products(a, b)
    assert np.abs(exact).max() > 1.0
    np.testing.assert_allclose(split, exact, **TOL)
    assert np.abs(split - exact).max() < 5e-6
    assert not np.allclose(single, exact, **TOL)
    assert np.abs(single - exact).max() > 1e-4


# -- shapes the kernels do not take ------------------------------------------------


@pytest.mark.parametrize("d, hidden", [(12, (64, 32)), (128, (64, 32)),
                                       (16, (32, 16)), (16, (64, 64))])
def test_din_wrapper_raises_for_untaken_shapes(d, hidden):
    """Checked before the device, so that the CPU reaches them."""
    h1, h2 = hidden
    q, k = torch.zeros(2, d), torch.zeros(2, 5, d)
    lengths = torch.zeros(2, dtype=torch.int32)
    params = (torch.zeros(4 * d, h1), torch.zeros(h1), torch.zeros(h1, h2),
              torch.zeros(h2), torch.zeros(h2, 1), torch.zeros(1))
    with pytest.raises(ValueError, match="kernel takes"):
        dk.din_attention_cuda(q, k, lengths, params, True)


@pytest.mark.parametrize("h, f", [(tk.MAX_H + 1, 7), (64, tk.MAX_F + 1)])
def test_cin_wrapper_raises_for_untaken_shapes(h, f):
    xk_t, x0_t, w = torch.zeros(2, 16, h), torch.zeros(2, 16, f), torch.zeros(8, h, f)
    with pytest.raises(ValueError, match="kernel takes"):
        tk.cin_layer_cuda_t(xk_t, x0_t, w)
