"""The kernels' plain versions against the JAX ops at the shapes the CUDA
kernels once refused (fault C2), on the CPU.

B1 (DIN attention) took D in {8, 16, 32, 64}, hidden widths (64, 32) and
T up to what shared memory held (about 2,300 at D = 16); B2 (the CIN
layer) took H <= 256 and F <= 64. The JAX package takes every shape. The
port's kernels now do too, held against their plain versions on the card
by ``chip_smoke.py``; here the plain versions, and the registered
operators that run them on CPU tensors, are held against the JAX side at
those shapes: ``DINAttention(backend='jnp')`` and ``_reference_t``
(rank_tpu/ops/pallas/cin.py), at rtol = atol = 1e-5. The Pallas kernels
are not run in interpret mode at these shapes: at T = 3000 that would
cost minutes.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rank_tpu.ops.attention import DINAttention as JaxDINAttention
from rank_tpu.ops.pallas import cin as ck
from rank_tpu_torch.ops.attention import DINAttention
from rank_tpu_torch.ops.kernels import cin as tk
from rank_tpu_torch.ops.kernels import din_attention as dk

TOL = dict(rtol=1e-5, atol=1e-5)
NAMES = ("w1", "b1", "w2", "b2", "w3", "b3")

# (D, hidden widths, T): D outside the tensor-core instantiations, hidden
# widths other than (64, 32), and a history longer than shared memory held
DIN_SHAPES = {"D10": (10, (64, 32), 50), "D12": (12, (64, 32), 50), "D128": (128, (64, 32), 50),
              "hidden32x16": (16, (32, 16), 50), "hidden64x64": (16, (64, 64), 50),
              "T3000": (16, (64, 32), 3000)}
# (H, F, O): H past 256 and F past 64
CIN_SHAPES = {"H300": (300, 7, 24), "F80": (64, 80, 24)}


def _din_inputs(d, hidden, t, b=4, seed=0):
    """Row 0 empty, row 1 full, the rest of random length up to T."""
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, d)).astype(np.float32)
    k = rng.normal(size=(b, t, d)).astype(np.float32)
    lengths = rng.integers(1, t + 1, size=b).astype(np.int32)
    lengths[0], lengths[1] = 0, t
    h1, h2 = hidden
    shapes = [(4 * d, h1), (h1,), (h1, h2), (h2,), (h2, 1), (1,)]
    params = [(rng.normal(size=s) * (s[0] ** -0.5 if len(s) == 2 else 0.3)).astype(np.float32)
              for s in shapes]
    return q, k, lengths, params


@pytest.mark.parametrize("use_softmax", [False, True])
@pytest.mark.parametrize("shape", list(DIN_SHAPES))
def test_din_plain_and_operator_match_jax_past_former_limits(shape, use_softmax):
    d, hidden, t = DIN_SHAPES[shape]
    q, k, lengths, params = _din_inputs(d, hidden, t, seed=d + t)
    jmod = JaxDINAttention(hidden_units=hidden, use_softmax=use_softmax, backend="jnp")
    variables = {"params": dict(zip(NAMES, map(jnp.asarray, params)))}
    want = np.asarray(jmod.apply(variables, jnp.asarray(q), jnp.asarray(k), jnp.asarray(lengths)))

    tq, tk_, tl = torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(lengths)
    tp = tuple(map(torch.from_numpy, params))
    plain = dk.din_attention_plain(tq, tk_, tl, tp, use_softmax).numpy()
    np.testing.assert_allclose(plain, want, **TOL)
    mod = DINAttention(d, hidden_units=hidden, use_softmax=use_softmax, backend="auto")
    mod.load_state_dict(dict(zip(NAMES, tp)))
    with torch.no_grad():
        np.testing.assert_allclose(mod(tq, tk_, tl).numpy(), want, **TOL)
    assert not plain[0].any(), "a zero-length row pools to zeros"


@pytest.mark.parametrize("shape", list(CIN_SHAPES))
def test_cin_plain_and_operator_match_jax_past_former_limits(shape):
    h, f, o = CIN_SHAPES[shape]
    rng = np.random.default_rng(h + f)
    xk_t = rng.normal(size=(3, 16, h)).astype(np.float32)
    x0_t = rng.normal(size=(3, 16, f)).astype(np.float32)
    w = (rng.normal(size=(o, h, f)) / np.sqrt(h * f)).astype(np.float32)
    want = np.asarray(ck._reference_t(jnp.asarray(xk_t), jnp.asarray(x0_t), jnp.asarray(w)))
    args = tuple(map(torch.from_numpy, (xk_t, x0_t, w)))
    np.testing.assert_allclose(tk.cin_layer_plain_t(*args).numpy(), want, **TOL)
    with torch.no_grad():
        np.testing.assert_allclose(tk.cin_layer_t(*args).numpy(), want, **TOL)
    wop = tk.weight_operand(args[2])
    assert wop.shape == (f * tk.padded_h(h), -(-o // 4) * 4)


@pytest.mark.parametrize("shape", list(DIN_SHAPES))
def test_din_kernel_choice_is_by_shape(shape):
    """The tensor-core kernel at its instantiations, at any T; the generic
    kernel at every other D and hidden widths."""
    d, (h1, h2), _ = DIN_SHAPES[shape]
    tensor_core = d in (8, 16, 32, 64) and (h1, h2) == (64, 32)
    want = "din_attention_fwd" if tensor_core else "din_attention_generic_fwd"
    assert dk.kernel_for(d, h1, h2) == want


def test_din_wrapper_takes_long_histories():
    """T = 3000 passes the wrapper's checks: on CPU tensors only the device
    is refused."""
    q, k, lengths, params = _din_inputs(16, (64, 32), 3000, b=2)
    q, k, lengths = map(torch.from_numpy, (q, k, lengths))
    params = tuple(map(torch.from_numpy, params))
    with pytest.raises(ValueError, match="CUDA device"):
        dk.din_attention_cuda(q, k, lengths, params, True)
