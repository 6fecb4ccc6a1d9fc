"""The port's DIN attention (rank_tpu_torch) held against the JAX package's.

The same numpy inputs, made from a seed, go through the JAX oracle
``_reference``, the Pallas kernel in interpret mode and
``DINAttention(backend='jnp')`` on one side, and the port's plain version
and ``DINAttention`` on the CPU on the other, at rtol/atol 1e-5. The CUDA
kernel itself runs only on the card; ``chip_smoke.py`` holds it against
the plain version there.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rank_tpu.ops.attention import DINAttention as JaxDINAttention
from rank_tpu.ops.attention import length_mask as jax_length_mask
from rank_tpu.ops.attention import masked_softmax as jax_masked_softmax
from rank_tpu.ops.pallas import din_attention as pk
from rank_tpu_torch.ops.attention import DINAttention, length_mask, masked_softmax
from rank_tpu_torch.ops.kernels import din_attention as tk

TOL = dict(rtol=1e-5, atol=1e-5)
NAMES = ("w1", "b1", "w2", "b2", "w3", "b3")


@pytest.fixture(autouse=True)
def interpret_mode(monkeypatch):
    monkeypatch.setattr(pk, "_INTERPRET", True)


def _inputs(b=7, t=50, d=16, seed=0):
    """B=7 is a multiple of no block; row 0 is empty and row 1 full."""
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, d)).astype(np.float32)
    k = rng.normal(size=(b, t, d)).astype(np.float32)
    lengths = rng.integers(0, t + 1, size=b).astype(np.int32)
    lengths[0], lengths[1] = 0, t
    shapes = [(4 * d, 64), (64,), (64, 32), (32,), (32, 1), (1,)]
    params = tuple((rng.normal(size=s) * 0.3).astype(np.float32) for s in shapes)
    return q, k, lengths, params


def _jax(q, k, lengths, params):
    return jnp.asarray(q), jnp.asarray(k), jnp.asarray(lengths), tuple(map(jnp.asarray, params))


def _torch(q, k, lengths, params):
    return (torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(lengths),
            tuple(map(torch.from_numpy, params)))


@pytest.mark.parametrize("use_softmax", [False, True])
@pytest.mark.parametrize("jax_fn", ["reference", "pallas_interpret"])
def test_plain_matches_jax(jax_fn, use_softmax):
    inputs = _inputs()
    fn = pk._reference if jax_fn == "reference" else pk.din_attention_fused
    want = np.asarray(fn(*_jax(*inputs), use_softmax))
    got = tk.din_attention_plain(*_torch(*inputs), use_softmax).numpy()
    assert got.shape == (7, 16)
    np.testing.assert_allclose(got, want, **TOL)
    assert not np.any(got[0]), "a zero-length row pools to zeros"
    assert np.all(np.isfinite(got))


@pytest.mark.parametrize("use_softmax", [False, True])
@pytest.mark.parametrize("jax_backend", ["jnp", "pallas"])
@pytest.mark.parametrize("backend", ["auto", "jnp"])
def test_module_matches_jax_module(backend, jax_backend, use_softmax):
    q, k, lengths, params = _inputs(seed=1)
    jmod = JaxDINAttention(use_softmax=use_softmax, backend=jax_backend)
    variables = {"params": dict(zip(NAMES, map(jnp.asarray, params)))}
    want = np.asarray(jmod.apply(variables, *_jax(q, k, lengths, params)[:3]))

    mod = DINAttention(16, use_softmax=use_softmax, backend=backend)
    mod.load_state_dict(dict(zip(NAMES, map(torch.from_numpy, params))))
    with torch.no_grad():
        got = mod(*_torch(q, k, lengths, params)[:3]).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_masked_softmax_and_length_mask_match_jax():
    rng = np.random.default_rng(2)
    scores = rng.normal(size=(5, 9)).astype(np.float32) * 4
    lengths = np.array([0, 1, 4, 9, 12], np.int32)
    want_mask = np.asarray(jax_length_mask(jnp.asarray(lengths), 9))
    mask = length_mask(torch.from_numpy(lengths), 9)
    np.testing.assert_array_equal(mask.numpy(), want_mask)
    want = np.asarray(jax_masked_softmax(jnp.asarray(scores), jnp.asarray(want_mask)))
    got = masked_softmax(torch.from_numpy(scores), mask).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    assert not np.any(got[0]), "an all-masked row gets zero weights, not NaN"


def test_kernel_request_on_cpu_raises():
    """The kernel is never swapped for the plain version on a CPU tensor:
    asking for it by name raises."""
    q, k, lengths, params = _torch(*_inputs(b=3, t=5))
    with pytest.raises(ValueError, match="CUDA"):
        tk.din_attention_cuda(q, k, lengths, params, True)
    mod = DINAttention(16, use_softmax=True, backend="pallas")
    with pytest.raises(ValueError, match="CUDA"):
        mod(q, k, lengths)


def test_unknown_backend_raises():
    with pytest.raises(ValueError, match="backend"):
        DINAttention(16, backend="triton")


@pytest.mark.parametrize("op", ["din_attention", "cin_layer_t"])
def test_smoke_cpu_reference_computes_as_the_card(op):
    """``chip_smoke.card_arithmetic_on_cpu``, the CPU reference of the
    smoke's bf16 serving check: inside it the operators, as the modules
    reach them, give the plain version in f32 on the bf16 inputs, rounded
    to bf16 (what the CUDA implementations return), which differs from
    the plain version in bf16; on leaving it the operators are restored."""
    import chip_smoke
    from rank_tpu_torch.ops.cin import CIN
    from rank_tpu_torch.ops.kernels import cin as ck

    gen = torch.Generator().manual_seed(3)
    if op == "din_attention":
        q, k, lengths, params = _torch(*_inputs(b=5, t=20, d=128, seed=3))
        mod = DINAttention(128, use_softmax=True)
        mod.load_state_dict(dict(zip(NAMES, params)))
        args = (q.bfloat16(), k.bfloat16(), lengths)
        want = tk.din_attention_plain(args[0].float(), args[1].float(), lengths,
                                      [p.bfloat16().float() for p in params], True).bfloat16()
        mod = mod.bfloat16()
    else:
        mod = CIN(7, (16, 8), split_half=True, generator=gen).bfloat16()
        args = (torch.randn(5, 7, 12, generator=gen).bfloat16(),)
        x0_t = args[0].float().transpose(1, 2).contiguous()
        first = ck.cin_layer_plain_t(x0_t, x0_t, mod.w_0.float()).bfloat16()
        nxt, direct = torch.split(first, 8, dim=2)
        last = ck.cin_layer_plain_t(nxt.float(), x0_t, mod.w_1.float()).bfloat16()
        want = torch.cat([direct.sum(1), last.sum(1)], dim=-1)
    module = {"din_attention": tk, "cin_layer_t": ck}[op]
    operator = getattr(module, op)
    with torch.no_grad():
        plain = mod(*args)
        with chip_smoke.card_arithmetic_on_cpu():
            assert getattr(module, op) is not operator
            got = mod(*args)
        assert getattr(module, op) is operator
        again = mod(*args)
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    torch.testing.assert_close(again, plain, rtol=0, atol=0)
    assert not torch.equal(got, plain)
