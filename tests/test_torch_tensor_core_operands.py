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


# -- B1's generic kernel: zero-padded widths, chunks, tiles ----------------------

# (D, hidden widths): D outside the tensor-core instantiations (10 and 12
# pad to DP = 12, whose layer-1 k-step 1 straddles the [k | q*k] seam; 128
# does not pad), hidden widths that pad or not, and (136, 72), which runs
# layer 1 in three h1 chunks (64, 64, 8) and layer 2 in two passes (64, 8)
GENERIC_DIMS = (10, 12, 128)
GENERIC_HIDDEN = ((32, 16), (64, 64), (24, 12))
GENERIC_CHUNKED = (5, (136, 72))
GENERIC_TILE, GENERIC_CHUNK = 16, 64


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def generic_operands(params, d: int) -> dict:
    """The generic kernel's operands as it stages them: the first layer
    folded (``fold_first_layer``), D padded to DP (a multiple of 4), H1 and
    H2 to multiples of 8, zero outside the real block. w1kp is (2 DP, H1P):
    rows [0, D) act on k, rows [DP, DP + D) on q*k."""
    w1, b1, w2, b2, w3, _ = params
    h1, h2 = w2.shape
    dp, h1p, h2p = _round_up(d, 4), _round_up(h1, 8), _round_up(h2, 8)
    w1q, w1kp = fold_first_layer(w1)
    ops = {"w1kp": torch.zeros(2 * dp, h1p), "w1q": torch.zeros(dp, h1p),
           "b1": torch.zeros(h1p), "w2": torch.zeros(h1p, h2p), "b2": torch.zeros(h2p),
           "w3": torch.zeros(h2p)}
    ops["w1kp"][:d, :h1] = w1kp[:d]
    ops["w1kp"][dp:dp + d, :h1] = w1kp[d:]
    ops["w1q"][:d, :h1] = w1q
    ops["b1"][:h1] = b1
    ops["w2"][:h1, :h2] = w2
    ops["b2"][:h2] = b2
    ops["w3"][:h2] = w3[:, 0]
    return ops


def _generic_forward(q, k, lengths, params, use_softmax):
    """The generic kernel's algebra in torch, row by row: q and the keys
    zero-padded to DP; q @ w1q + b1 once a row; 16-step tiles of the valid
    keys; layer 1 in chunks of 64 h1 columns, each chunk's ReLU'd h1
    feeding layer 2 for the same rows of w2, layer 2 in passes of 64 h2
    columns, each adding its share of the score; the online softmax
    (running max and sum, the pooled sum rescaled a tile); the pooled sum
    of the real D columns in f64."""
    _, t, d = k.shape
    ops = generic_operands(params, d)
    dp = ops["w1q"].shape[0]
    h1p, h2p = ops["w2"].shape
    qp = torch.nn.functional.pad(q, (0, dp - d))
    kp = torch.nn.functional.pad(k, (0, dp - d))
    qh = qp @ ops["w1q"] + ops["b1"]
    b3 = params[5]
    sqrt_d = math.sqrt(d)
    out = torch.zeros(q.shape, dtype=torch.float64)
    for row in range(q.shape[0]):
        n = min(max(int(lengths[row]), 0), t)
        m, total = (MASK_NEG / sqrt_d if n < t else -math.inf), 0.0
        acc = torch.zeros(d, dtype=torch.float64)
        for t0 in range(0, n, GENERIC_TILE):
            kt = kp[row, t0:min(n, t0 + GENERIC_TILE)]
            a = torch.cat([kt, qp[row] * kt], dim=-1)  # (nv, 2 DP) [k | q*k]
            score = torch.zeros(len(kt))
            for c2 in range(0, h2p, GENERIC_CHUNK):
                cols2 = slice(c2, c2 + GENERIC_CHUNK)
                h2 = torch.zeros(len(kt), min(GENERIC_CHUNK, h2p - c2))
                for c1 in range(0, h1p, GENERIC_CHUNK):
                    cols1 = slice(c1, c1 + GENERIC_CHUNK)
                    h1 = torch.relu(a @ ops["w1kp"][:, cols1] + qh[row, cols1])
                    h2 = h2 + h1 @ ops["w2"][cols1, cols2]
                score = score + torch.relu(h2 + ops["b2"][cols2]) @ ops["w3"][cols2]
            score = score + b3
            if use_softmax:
                z = score / sqrt_d
                m_new = max(m, float(z.max()))
                scale = math.exp(m - m_new)
                w = torch.exp(z - m_new)
                total, m = total * scale + float(w.sum()), m_new
            else:
                scale, w = 1.0, score
            acc = acc * scale + (w @ kt[:, :d]).double()
        out[row] = acc / (max(total, 1e-12) if use_softmax else 1.0)
    return out.float()


def _generic_inputs(d, hidden, b=9, t=50, seed=0):
    """Lengths 0, 1, 15, 16, 17, 49 and T around the 16-step tiles;
    lecun-scaled weights with random biases."""
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, d)).astype(np.float32)
    k = rng.normal(size=(b, t, d)).astype(np.float32)
    lengths = np.array([0, t, 1, 15, 16, 17, 49, 32, 0][:b], np.int32)
    h1, h2 = hidden
    shapes = [(4 * d, h1), (h1,), (h1, h2), (h2,), (h2, 1), (1,)]
    params = tuple((rng.normal(size=s) * (s[0] ** -0.5 if len(s) == 2 else 0.3))
                   .astype(np.float32) for s in shapes)
    return q, k, lengths, params


@pytest.mark.parametrize("d, hidden", [(d, h) for d in GENERIC_DIMS for h in GENERIC_HIDDEN]
                         + [GENERIC_CHUNKED])
def test_generic_operands_are_zero_padded(d, hidden):
    """The padded operands hold the fold in their real block and zero
    elsewhere, and DP, H1P, H2P are the smallest multiples of 4, 8, 8."""
    params = tuple(map(torch.from_numpy, _generic_inputs(d, hidden, seed=d)[3]))
    ops = generic_operands(params, d)
    h1, h2 = hidden
    dp, h1p = ops["w1q"].shape
    h2p = ops["w2"].shape[1]
    assert (dp, h1p, h2p) == (_round_up(d, 4), _round_up(h1, 8), _round_up(h2, 8))
    assert dp - d < 4 and h1p - h1 < 8 and h2p - h2 < 8 and (2 * dp) % 8 == 0
    w1q, w1kp = fold_first_layer(params[0])
    exact = dict(rtol=0, atol=0)
    torch.testing.assert_close(ops["w1kp"][:d, :h1], w1kp[:d], **exact)
    torch.testing.assert_close(ops["w1kp"][dp:dp + d, :h1], w1kp[d:], **exact)
    torch.testing.assert_close(ops["w1q"][:d, :h1], w1q, **exact)
    torch.testing.assert_close(ops["w2"][:h1, :h2], params[2], **exact)
    zero_w1kp = ops["w1kp"].clone()
    zero_w1kp[:d, :h1] = 0
    zero_w1kp[dp:dp + d, :h1] = 0
    assert not zero_w1kp.any()
    assert not ops["w1q"][d:].any() and not ops["w1q"][:, h1:].any()
    assert not ops["w2"][h1:].any() and not ops["w2"][:, h2:].any()
    assert not ops["b1"][h1:].any() and not ops["b2"][h2:].any() and not ops["w3"][h2:].any()


@pytest.mark.parametrize("d, hidden", [(12, (24, 12)), GENERIC_CHUNKED])
def test_generic_padded_forward_equals_unpadded(d, hidden):
    """The padded operands give the unpadded layers exactly where it
    matters: each padded h1 column is relu(0) = 0 and each padded h2
    column scores 0, so the scores equal the folded forward's."""
    q, k, _, params = _generic_inputs(d, hidden, seed=d + 1)
    tq, tk_ = torch.from_numpy(q), torch.from_numpy(k)
    tp = tuple(map(torch.from_numpy, params))
    ops = generic_operands(tp, d)
    dp = ops["w1q"].shape[0]
    h1, h2 = hidden
    qp, kp = (torch.nn.functional.pad(x, (0, dp - d)) for x in (tq, tk_))
    a = torch.cat([kp, qp[:, None, :] * kp], dim=-1)
    h1_pad = torch.relu(a @ ops["w1kp"] + (qp @ ops["w1q"] + ops["b1"])[:, None, :])
    assert not h1_pad[..., h1:].any()
    h2_pad = torch.relu(h1_pad @ ops["w2"] + ops["b2"])
    assert not h2_pad[..., h2:].any()
    w1q, w1kp = fold_first_layer(tp[0])
    h1_ref = torch.relu(torch.cat([tk_, tq[:, None, :] * tk_], -1) @ w1kp
                        + (tq @ w1q + tp[1])[:, None, :])
    torch.testing.assert_close(h1_pad[..., :h1], h1_ref, **TOL)
    h2_ref = torch.relu(h1_ref @ tp[2] + tp[3])
    torch.testing.assert_close(h2_pad @ ops["w3"], (h2_ref @ tp[4])[..., 0], **TOL)


@pytest.mark.parametrize("use_softmax", [False, True])
@pytest.mark.parametrize("d, hidden", [(d, h) for d in GENERIC_DIMS for h in GENERIC_HIDDEN]
                         + [GENERIC_CHUNKED])
def test_generic_forward_matches_plain_and_jax(d, hidden, use_softmax):
    """The generic kernel's algebra against the port's plain version,
    rank_tpu's ``_reference`` and its Pallas kernel in interpret mode, at
    rtol = atol = 1e-5."""
    q, k, lengths, params = _generic_inputs(d, hidden, seed=d + sum(hidden))
    tq, tk_, tl = map(torch.from_numpy, (q, k, lengths))
    tp = tuple(map(torch.from_numpy, params))
    got = _generic_forward(tq, tk_, tl, tp, use_softmax).numpy()
    assert not got[0].any() and not got[-1].any(), "zero-length rows pool to zeros"
    np.testing.assert_allclose(
        got, dk.din_attention_plain(tq, tk_, tl, tp, use_softmax).numpy(), **TOL)
    jargs = (jnp.asarray(q), jnp.asarray(k), jnp.asarray(lengths), tuple(map(jnp.asarray, params)))
    np.testing.assert_allclose(got, np.asarray(pk._reference(*jargs, use_softmax)), **TOL)
    np.testing.assert_allclose(got, np.asarray(pk.din_attention_fused(*jargs, use_softmax)), **TOL)


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


# -- shapes the kernels once refused ------------------------------------------------


@pytest.mark.parametrize("d, hidden", [(12, (64, 32)), (128, (64, 32)),
                                       (16, (32, 16)), (16, (64, 64)),
                                       (10, (24, 12)), GENERIC_CHUNKED])
def test_din_wrapper_raises_for_untaken_shapes(d, hidden):
    """D outside {8, 16, 32, 64} and hidden widths other than (64, 32),
    which the wrapper once refused by shape, now pass its shape check and
    go to the generic kernel: on CPU tensors the only error is the device
    one, never a refusal of the shape."""
    h1, h2 = hidden
    q, k = torch.zeros(2, d), torch.zeros(2, 5, d)
    lengths = torch.zeros(2, dtype=torch.int32)
    params = (torch.zeros(4 * d, h1), torch.zeros(h1), torch.zeros(h1, h2),
              torch.zeros(h2), torch.zeros(h2, 1), torch.zeros(1))
    assert dk.kernel_for(d, h1, h2) == "din_attention_generic_fwd"
    with pytest.raises(ValueError, match="CUDA device") as err:
        dk.din_attention_cuda(q, k, lengths, params, True)
    assert "kernel takes" not in str(err.value)


@pytest.mark.parametrize("h, f", [(257, 7), (64, 65)])
def test_cin_wrapper_raises_for_untaken_shapes(h, f):
    """H > 256 and F > 64, which the wrapper once refused by shape, now pass
    its shape check: on CPU tensors the only error is the device one."""
    xk_t, x0_t, w = torch.zeros(2, 16, h), torch.zeros(2, 16, f), torch.zeros(8, h, f)
    with pytest.raises(ValueError, match="CUDA device") as err:
        tk.cin_layer_cuda_t(xk_t, x0_t, w)
    assert "kernel takes" not in str(err.value)
