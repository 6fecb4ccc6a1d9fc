"""B2's backward kernels on the card, held against the plain gradient.

``cin_layer_bwd_cuda_t`` (``csrc/cin.cu``: ``cin_layer_bwd``) against
``cin_layer_vjp_plain``, the recompute through the plain version that the
CPU keeps. Every test takes the ``card`` fixture and skips without a CUDA
card. The file imports no JAX; ``tests/conftest.py`` does, so on the card's
machine the file runs without it:

    python -m pytest --noconftest tests/test_torch_cin_backward.py -q
"""

import pytest
import torch

import chip_smoke
from rank_tpu_torch.ops.cin import CIN, xavier_uniform_
from rank_tpu_torch.ops.kernels import cin as ck

pytestmark = pytest.mark.card

# (H, F, O) beside the default xDeepFM's layers: the shapes past the
# forward's former limits (H > 256, F > 64), an O that is not a multiple of
# 4 (nor of 8), and O past one 128-wide panel of g in dz and one o tile in
# dw (130 and 300, neither a multiple of 8), with H and F padded.
SHAPES = {"h300": (300, 7, 128), "f80": (64, 80, 128), "o10": (12, 5, 10),
          "o130": (64, 7, 130), "o300": (12, 5, 300)}
# (B, layer): layers 0 and 1 of the cell at B = 1024 and 8192, and B = 1001
# and 7, whose B*D rows (16,016 and 112) are no multiple of a 128-row tile.
CASES = [(b, layer) for b in (1024, 8192, 1001) for layer in (0, 1)]
CASES += [(7, name) for name in SHAPES] + [(1024, name) for name in ("h300", "f80", "o130")]
CASES += [(1001, "o300")]


@pytest.fixture
def card():
    """The first CUDA device; skips the test where there is none (decided
    when the test runs, never while modules are imported)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def layer_inputs(b, layer, gen, device, d=16):
    """Inputs of one CIN layer and a gradient of its output, N(0,1) but the
    flax-xavier weights. Layers 0 and 1 are the default xDeepFM's: layer 0
    takes (x0, x0), layer 1 the first half of layer 0's output."""
    if layer in SHAPES:
        h, f, o = SHAPES[layer]
        xk, x0 = torch.randn(b, d, h, generator=gen), torch.randn(b, d, f, generator=gen)
        w = xavier_uniform_(torch.empty(o, h, f), gen)
    else:
        x0 = torch.randn(b, d, 7, generator=gen)
        w0 = xavier_uniform_(torch.empty(128, 7, 7), gen)
        xk, w = x0, w0
        if layer == 1:
            xk = ck.cin_layer_plain_t(x0, x0, w0)[..., :64].contiguous()
            w = xavier_uniform_(torch.empty(128, 64, 7), gen)
    g = torch.randn(b, d, w.shape[0], generator=gen)
    return tuple(x.to(device) for x in (xk, x0, w, g))


def assert_gradient_close(got, want, exact):
    """``chip_smoke.check_against_plain``'s rule for B2's gradient: within
    rtol = atol = 1e-5 of the plain gradient, else (dw sums B*D products an
    entry) within 1e-5 of the f64 one widened by the plain version's own
    error there."""
    chip_smoke.check_against_plain("cin_layer_bwd", got, want, exact, c2_shape=True)


@pytest.fixture
def plain_f32():
    before = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain gradient in full f32
    yield
    torch.backends.cuda.matmul.allow_tf32 = before


@pytest.mark.parametrize("b, layer", CASES)
def test_backward_kernel_matches_plain(b, layer, card, plain_f32):
    gen = torch.Generator().manual_seed(b)
    xk, x0, w, g = layer_inputs(b, layer, gen, card)
    got = ck.cin_layer_bwd_cuda_t(xk, x0, w, g)
    want = ck.cin_layer_vjp_plain(xk, x0, w, g)
    exact = ck.cin_layer_vjp_plain(xk.double(), x0.double(), w.double(), g.double())
    for a, p, e in zip(got, want, exact):
        assert a.shape == p.shape and a.dtype == torch.float32
        assert_gradient_close(a, p, e)


def test_backward_kernel_on_bf16_inputs(card, plain_f32):
    """bf16 inputs through the gradient give bf16 gradients: the kernels on
    the inputs cast to f32, each gradient rounded to bf16, so that they
    match the plain gradient of those f32 inputs to bf16 rounding."""
    gen = torch.Generator().manual_seed(3)
    for layer in (0, 1):
        xk, x0, w, g = (x.bfloat16() for x in layer_inputs(1024, layer, gen, card))
        got = ck.cin_layer_vjp(xk, x0, w, g)
        f32 = [x.float() for x in (xk, x0, w, g)]
        kernel = ck.cin_layer_bwd_cuda_t(*f32)
        want = ck.cin_layer_vjp_plain(*f32)
        exact = ck.cin_layer_vjp_plain(*(x.double() for x in f32))
        for a, k, p, e in zip(got, kernel, want, exact):
            assert a.dtype == torch.bfloat16
            assert torch.equal(a, k.bfloat16())
            assert_gradient_close(k, p, e)


def test_backward_kernel_is_deterministic(card):
    """No atomics: two calls on the same inputs give bit-identical gradients."""
    gen = torch.Generator().manual_seed(4)
    for layer in (0, 1, "h300"):
        inputs = layer_inputs(1001, layer, gen, card)
        first, second = ck.cin_layer_bwd_cuda_t(*inputs), ck.cin_layer_bwd_cuda_t(*inputs)
        assert all(torch.equal(a, b) for a, b in zip(first, second))


def test_backward_launches_once_a_layer(card):
    """One call of the backward kernels a layer a backward pass, through the
    registered operator and through the CIN module; none in a forward
    pass."""
    gen = torch.Generator().manual_seed(5)
    xk, x0, w, g = layer_inputs(64, 1, gen, card)
    leaves = [x.detach().requires_grad_() for x in (xk, x0, w)]
    before = ck.cin_layer_bwd_cuda_t.launches
    out = ck.cin_layer_t(*leaves)
    assert ck.cin_layer_bwd_cuda_t.launches == before
    out.backward(g)
    assert ck.cin_layer_bwd_cuda_t.launches == before + 1
    mod = CIN(7, (128, 128), generator=gen).to(card)
    before = ck.cin_layer_bwd_cuda_t.launches
    mod(torch.randn(32, 7, 16, generator=gen).to(card)).sum().backward()
    assert ck.cin_layer_bwd_cuda_t.launches == before + 2


def test_backward_wrapper_raises_on_card(card):
    gen = torch.Generator().manual_seed(6)
    xk, x0, w, g = layer_inputs(4, 1, gen, card)
    with pytest.raises(ValueError, match="CUDA device"):
        ck.cin_layer_bwd_cuda_t(xk, x0, w.cpu(), g)
    with pytest.raises(TypeError, match="float32"):
        ck.cin_layer_bwd_cuda_t(xk, x0, w, g.bfloat16())
    with pytest.raises(ValueError, match="contiguous"):
        ck.cin_layer_bwd_cuda_t(xk.transpose(0, 1), x0.transpose(0, 1), w,
                                g.transpose(0, 1))
