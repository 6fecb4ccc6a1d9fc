"""DIEN's recurrences as sequence kernels (``rank_tpu_torch/ops/rnn.py``:
``gru_sequence``, ``GRUSequence``; ``ops/kernels/gru_sequence.py``).

On the CPU: the kernels' algorithm in plain torch (the projection of x for
every step at once, the recurrence, the written-out backward) against
autograd of ``AttentionalGRU._loop``, in f64, for gru, agru and augru at
lengths 0, 1 and T, D unlike H and H of 16, 36 and 13; the wrappers'
refusals; the registered operators (``opcheck``, their FLOP count, an
exported trace that holds them); lengths past T; and that
``AttentionalGRU`` on CPU tensors still runs its loop.

On the card (tests marked ``card``; each takes the ``card`` fixture and
skips without a CUDA card): the kernels against their plain versions and
against ``_loop``, forward and every gradient, at DIEN's (1024, 50, 36, 36),
the odd shapes and the widths whose U stays in global memory (H = 129 and
512); equal bits from two backward calls; lengths past T; H = 513 refused;
a refused launch; a DIEN artifact exported on the card, which launches the
kernels; the launch counts of an eager and of a graphed DIEN train step. The file imports no JAX; ``tests/conftest.py`` does, so on
the card's machine it runs without it:

    python -m pytest --noconftest tests/test_torch_gru_sequence.py -q
"""

import numpy as np
import pytest
import torch

from rank_tpu_torch import (Predictor, build_model, default_config, export_serving_artifact,
                            load_serving_artifact, tiny_schema)
from rank_tpu_torch.data.synthetic import make_synthetic_dataset
from rank_tpu_torch.ops import rnn
from rank_tpu_torch.ops.kernels import gru_sequence as gk
from rank_tpu_torch.ops.rnn import AttentionalGRU, GRUSequence, gru_sequence
from rank_tpu_torch.train import TrainConfig, Trainer

MODES = ("gru", "agru", "augru")
# (D, H): D = H at DIEN's width and beside it D unlike H, H of 16, 36 and
# an odd width
WIDTHS = [(5, 16), (36, 36), (20, 36), (8, 13)]


@pytest.fixture
def card():
    """The first CUDA device; skips the test where there is none (decided
    when the test runs, never while modules are imported)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _cell(d, h, mode, device="cpu", dtype=torch.float64):
    cell = AttentionalGRU(d, h, mode, generator=torch.Generator().manual_seed(3))
    with torch.no_grad():  # biases off zero, so that their gradients are tested
        cell.gates_bias.uniform_(-0.5, 0.5, generator=torch.Generator().manual_seed(4))
        cell.candidate_bias.uniform_(-0.5, 0.5, generator=torch.Generator().manual_seed(5))
    return cell.to(device=device, dtype=dtype)


def _inputs(b, t, d, mode, device="cpu", dtype=torch.float64, seed=7):
    """x (B, T, D), lengths with 0, 1 and T among them, att (B, T) for agru
    and augru, all from one numpy generator."""
    rng = np.random.default_rng(seed)
    x = torch.tensor(rng.standard_normal((b, t, d)), dtype=dtype, device=device)
    lengths = rng.integers(0, t + 1, size=b)
    lengths[:3] = (0, 1, t)
    lengths = torch.tensor(lengths, dtype=torch.int32, device=device)
    att = (torch.tensor(rng.uniform(0, 1, (b, t)), dtype=dtype, device=device)
           if mode != "gru" else None)
    return x, lengths, att


def _weights(outs):
    return torch.linspace(-1.0, 1.0, outs.numel(), dtype=outs.dtype,
                          device=outs.device).view_as(outs)


def _run(fn, cell, x, lengths, att):
    """Outputs, final state and every gradient (x, att, the four parameters)
    of a weighted sum of both, through ``fn(cell, x, lengths, att)``."""
    leaves = [x.detach().clone().requires_grad_(True)]
    if att is not None:
        leaves.append(att.detach().clone().requires_grad_(True))
    for p in cell.parameters():
        p.grad = None
    outs, h = fn(cell, leaves[0], lengths, leaves[1] if att is not None else None)
    ((outs * _weights(outs)).sum() + h.square().sum()).backward()
    return [outs.detach(), h.detach()] + [t.grad for t in leaves + list(cell.parameters())]


def _loop(cell, x, lengths, att):
    return cell._loop(x, lengths, att)


def _sequence(cell, x, lengths, att):
    return GRUSequence.apply(cell.mode, x, lengths, att, cell.gates_kernel, cell.gates_bias,
                             cell.candidate_kernel, cell.candidate_bias)


@pytest.mark.parametrize("d,h", WIDTHS)
@pytest.mark.parametrize("mode", MODES)
def test_the_algorithm_computes_what_autograd_of_the_loop_computes(mode, d, h):
    """f64 on the CPU: the two differ only in the order of sums, so they
    agree to 1e-12."""
    cell = _cell(d, h, mode)
    x, lengths, att = _inputs(6, 7, d, mode)
    want, got = _run(_loop, cell, x, lengths, att), _run(_sequence, cell, x, lengths, att)
    assert len(got) == len(want) == 7 + (mode != "gru")
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-12, atol=1e-12)
    if mode == "agru":  # att replaces u: the update gate's columns learn nothing
        assert not got[-4][:, :h].any() and not got[-3][:h].any()


@pytest.mark.parametrize("mode", MODES)
def test_padded_steps_are_zero_and_carry_the_state(mode):
    """What the plain kernels write: zeros past a row's length in every
    output and saved buffer and in the gradients; the final state is the
    state at step length - 1; a row of length 0 ends at zero."""
    d, h = 5, 16
    cell = _cell(d, h, mode)
    x, lengths, att = _inputs(6, 7, d, mode)
    proj, _ = rnn._project(x, cell.gates_kernel, cell.gates_bias, cell.candidate_kernel,
                           cell.candidate_bias)
    ug, uc = cell.gates_kernel[d:], cell.candidate_kernel[d:]
    with torch.no_grad():
        outs, h_final, saved = gk.gru_seq_fwd_plain(proj, lengths, att, ug, uc, mode, True)
        d_pre, d_att = gk.gru_seq_bwd_plain(*saved[:2], lengths, att, ug, uc,
                                            torch.ones_like(outs), torch.ones_like(h_final), mode)
    pad = torch.arange(7)[None, :] >= lengths[:, None]
    for buf in (outs, *saved, d_pre) + ((d_att[..., None],) if d_att is not None else ()):
        assert not buf[pad].any()
    last = (lengths.long() - 1).clamp_min(0)
    torch.testing.assert_close(h_final[lengths > 0], outs[torch.arange(6), last][lengths > 0])
    assert not h_final[lengths == 0].any()


@pytest.mark.parametrize("b,t", [(3, 5), (600, 1), (1024, 1), (7, 300)])
def test_the_weight_gradient_sums_chunks_and_a_tail(b, t):
    """``_weight_grad`` over B*T rows under one chunk, a chunk and a tail,
    a whole number of chunks, and several chunks and a tail, with g a column
    slice as the backward hands it: a^T g to f64 rounding."""
    gen = torch.Generator().manual_seed(b * t)
    a = torch.randn(b, t, 6, dtype=torch.float64, generator=gen)
    g = torch.randn(b, t, 9, dtype=torch.float64, generator=gen)[..., 2:6]
    out = torch.empty(8, 4, dtype=torch.float64)[2:]
    rnn._weight_grad(a, g, out)
    torch.testing.assert_close(out, a.reshape(-1, 6).t() @ g.reshape(-1, 4), rtol=1e-12,
                               atol=1e-12)


@pytest.mark.parametrize("mode", MODES)
def test_a_forward_without_gradients_saves_nothing_and_agrees(mode):
    d, h = 20, 36
    cell = _cell(d, h, mode)
    x, lengths, att = _inputs(6, 7, d, mode)
    with torch.no_grad():
        free = gru_sequence(mode, x, lengths, att, *cell.parameters())
    graded = gru_sequence(mode, x.requires_grad_(), lengths, att, *cell.parameters())
    assert graded[0].grad_fn is not None and free[0].grad_fn is None
    for a, b in zip(free, graded):
        assert torch.equal(a, b.detach())


def test_the_module_on_cpu_tensors_runs_the_loop_and_no_kernel(monkeypatch):
    """A DIEN train step on the CPU: both recurrences through ``_loop``,
    forward and backward; neither kernel's count moves."""
    calls = []
    real = AttentionalGRU._loop

    def spy(self, *args):
        calls.append(self.mode)
        return real(self, *args)

    monkeypatch.setattr(AttentionalGRU, "_loop", spy)
    before = (gk.gru_seq_cuda.launches, gk.gru_seq_bwd_cuda.launches)
    trainer = Trainer(tiny_schema(), default_config("dien", hidden_units=(16, 8)),
                      TrainConfig(log_every=0, batch_size=32), device="cpu")
    data = make_synthetic_dataset(tiny_schema(), num_rows=32, seed=1)
    data["_valid"] = np.ones(32, np.float32)
    state = trainer.init_state()
    trainer.train_step(state, trainer.meters_init(), trainer.to_device(data))
    assert calls == ["gru", "augru"]
    assert all(p.grad is None or torch.isfinite(p.grad).all()
               for p in state["model"].parameters())
    assert (gk.gru_seq_cuda.launches, gk.gru_seq_bwd_cuda.launches) == before


REFUSALS = {"cpu": (ValueError, "one CUDA device"), "float64": (TypeError, "proj is torch.float64"),
            "h513": (ValueError, "H = 513"), "mode": (ValueError, "unknown mode"),
            "att": (ValueError, "agru and augru take"),
            "lengths": (TypeError, "lengths is torch.int64")}


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_the_kernel_wrappers_refuse_what_the_kernels_cannot_take(case):
    """Each refusal comes before the library is built or loaded, and the
    device is checked last, so each shows on CPU tensors."""
    b, t, h = 4, 5, 513 if case == "h513" else 8
    dtype = torch.float64 if case == "float64" else torch.float32
    proj, ug, uc = torch.zeros(b, t, 3 * h, dtype=dtype), torch.zeros(h, 2 * h), torch.zeros(h, h)
    lengths = torch.zeros(b, dtype=torch.int64 if case == "lengths" else torch.int32)
    mode = "lstm" if case == "mode" else "augru"
    att = None if case == "att" else torch.zeros(b, t)
    error, message = REFUSALS[case]
    with pytest.raises(error, match=message):
        gk.gru_seq_cuda(proj, lengths, att, ug, uc, mode, save=True)
    with pytest.raises(error, match=message.replace("proj", "gates")):
        gk.gru_seq_bwd_cuda(proj, proj[..., :h].contiguous(), lengths, att, ug, uc, None, None,
                            mode)


def _op_args(mode, b=4, t=5, h=6, seed=11):
    """Arguments of both operators on CPU f64 tensors: proj, lengths (0, 1
    and T among them), att, U_g, U_c; the forward's saved buffers and two
    upstream gradients."""
    gen = torch.Generator().manual_seed(seed)
    rand = lambda *shape: torch.randn(*shape, dtype=torch.float64, generator=gen)  # noqa: E731
    proj, ug, uc = rand(b, t, 3 * h), rand(h, 2 * h), rand(h, h)
    lengths = torch.tensor([0, 1, t, 3][:b], dtype=torch.int32)
    att = torch.rand(b, t, dtype=torch.float64, generator=gen) if mode != "gru" else None
    _, _, saved = gk.gru_seq_fwd_plain(proj, lengths, att, ug, uc, mode, True)
    return proj, lengths, att, ug, uc, saved, rand(b, t, h), rand(b, h)


@pytest.mark.parametrize("mode", MODES)
def test_the_operators_pass_opcheck(mode):
    """Schema, fake implementation (the shapes ``torch.export`` and
    ``torch.compile`` trace with) and dispatch of both operators on CPU
    tensors, with and without the saved buffers and upstream gradients."""
    proj, lengths, att, ug, uc, saved, d_outs, d_h = _op_args(mode)
    for save in (True, False):
        torch.library.opcheck(torch.ops.rank_tpu_torch.gru_seq_fwd,
                              (proj, lengths, att, ug, uc, mode, save))
    for grads in ((d_outs, d_h), (None, d_h), (d_outs, None)):
        torch.library.opcheck(torch.ops.rank_tpu_torch.gru_seq_bwd,
                              (*saved[:2], lengths, att, ug, uc, *grads, mode))


@pytest.mark.parametrize("mode", MODES)
def test_the_operators_give_their_plain_versions(mode):
    """On CPU tensors each operator returns its plain version's tensors,
    with empty ones where the call gives none."""
    proj, lengths, att, ug, uc, saved, d_outs, d_h = _op_args(mode)
    outs, h_final, *kept = torch.ops.rank_tpu_torch.gru_seq_fwd(proj, lengths, att, ug, uc, mode,
                                                                True)
    want = gk.gru_seq_fwd_plain(proj, lengths, att, ug, uc, mode, True)
    assert all(torch.equal(a, b) for a, b in zip((outs, h_final, *kept), (*want[:2], *want[2])))
    free = torch.ops.rank_tpu_torch.gru_seq_fwd(proj, lengths, att, ug, uc, mode, False)
    assert [x.numel() for x in free[2:]] == [0, 0, 0] and torch.equal(free[0], outs)
    d_pre, d_att = torch.ops.rank_tpu_torch.gru_seq_bwd(*saved[:2], lengths, att, ug, uc, d_outs,
                                                        d_h, mode)
    want_pre, want_att = gk.gru_seq_bwd_plain(*saved[:2], lengths, att, ug, uc, d_outs, d_h, mode)
    assert torch.equal(d_pre, want_pre)
    assert d_att.numel() == 0 if mode == "gru" else torch.equal(d_att, want_att)


def test_the_operators_count_their_recurrent_products():
    """``FlopCounterMode`` counts 6 B T H^2 a direction, as many as the
    loop's ``addmm`` make over h (the projection's products count apart)."""
    from torch.utils.flop_counter import FlopCounterMode

    b, t, h = 4, 5, 6
    proj, lengths, att, ug, uc, saved, d_outs, d_h = _op_args("augru", b, t, h)
    with FlopCounterMode(display=False) as counter:
        torch.ops.rank_tpu_torch.gru_seq_fwd(proj, lengths, att, ug, uc, "augru", False)
        torch.ops.rank_tpu_torch.gru_seq_bwd(*saved[:2], lengths, att, ug, uc, d_outs, d_h,
                                             "augru")
    assert counter.get_total_flops() == 2 * 6 * b * t * h * h


class _Recurrence(torch.nn.Module):
    def __init__(self, cell):
        super().__init__()
        self.cell = cell

    def forward(self, x, lengths, att):
        cell = self.cell
        return gru_sequence(cell.mode, x, lengths, att, cell.gates_kernel, cell.gates_bias,
                            cell.candidate_kernel, cell.candidate_bias)


def test_an_exported_sequence_holds_the_operator():
    """``torch.export`` of ``gru_sequence`` traces the forward operator as
    one node (its fake implementation), and the program computes what the
    eager call computes."""
    cell = _cell(5, 16, "augru", dtype=torch.float32)
    x, lengths, att = _inputs(6, 7, 5, "augru", dtype=torch.float32)
    module = _Recurrence(cell).eval()
    with torch.no_grad():
        program = torch.export.export(module, (x, lengths, att), strict=False)
        want = module(x, lengths, att)
    targets = [str(n.target) for n in program.graph.nodes if n.op == "call_function"]
    assert targets.count("rank_tpu_torch.gru_seq_fwd.default") == 1
    for a, b in zip(program.module()(x, lengths, att), want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("mode", MODES)
def test_a_length_past_t_counts_as_t(mode):
    """The plain versions (and the loop) read a length past T as T."""
    proj, lengths, att, ug, uc, _, d_outs, d_h = _op_args(mode)
    longer = lengths.clone()
    longer[lengths == lengths.max()] += 4
    outs = [gk.gru_seq_fwd_plain(proj, n, att, ug, uc, mode, True) for n in (lengths, longer)]
    assert all(torch.equal(a, b) for a, b in zip((*outs[0][:2], *outs[0][2]),
                                                 (*outs[1][:2], *outs[1][2])))
    grads = [gk.gru_seq_bwd_plain(*outs[0][2][:2], n, att, ug, uc, d_outs, d_h, mode)
             for n in (lengths, longer)]
    assert torch.equal(grads[0][0], grads[1][0])


# -- on the card ------------------------------------------------------------


def _errors(got, want, exact):
    """Largest |got - want| and |got - exact|, |want - exact| of each tensor."""
    return [((g - w).abs().max().item(), (g - e).abs().max().item(), (w - e).abs().max().item())
            for g, w, e in zip(got, want, exact)]


# DIEN's cell; odd widths and batches; the widest H whose U fits shared
# memory, in a few rows and at DIEN's batch (blocks of 512 threads); the
# narrowest and the widest H whose U stays in global memory (8 rows a
# thread, blocks of 2H threads)
CARD_SHAPES = [(1024, 50, 36, 36), (7, 5, 5, 16), (33, 9, 20, 36), (9, 11, 8, 13),
               (5, 4, 16, 128), (1024, 6, 36, 128), (16, 6, 8, 129), (11, 4, 16, 512)]


@pytest.mark.card
@pytest.mark.parametrize("b,t,d,h", CARD_SHAPES)
@pytest.mark.parametrize("mode", MODES)
def test_the_kernels_compute_what_the_loop_computes(mode, b, t, d, h, card):
    """Outputs, final state and the gradients of x, att and the four
    parameters through the kernels, against autograd of ``_loop`` in f32,
    both against ``_loop`` in f64. The kernels sum in another order than the
    loop (a step's products, then the projection's products outside), so
    bits differ; each error against f64 stays within 4x the f32 loop's own
    (floored at 1e-6 of the tensor's largest entry, a few f32 ulps), and the
    kernels stay within 1e-5 of the largest entry of the loop's."""
    cell = _cell(d, h, mode, card, torch.float32)
    x, lengths, att = _inputs(b, t, d, mode, card, torch.float32)
    launches = gk.gru_seq_cuda.launches, gk.gru_seq_bwd_cuda.launches
    got = _run(lambda c, *a: c._recurrence(*a), cell, x, lengths, att)
    assert (gk.gru_seq_cuda.launches, gk.gru_seq_bwd_cuda.launches) == (
        launches[0] + 1, launches[1] + 1)
    want = _run(_loop, cell, x, lengths, att)
    cell64 = _cell(d, h, mode, card, torch.float64)
    exact = _run(_loop, cell64, x.double(), lengths, None if att is None else att.double())
    for i, ((vs_loop, err, loop_err), w, e) in enumerate(zip(_errors(got, want, exact), want,
                                                             exact)):
        scale = e.abs().max().item()
        print(f"{mode} {(b, t, d, h)} tensor {i}: vs loop {vs_loop:.3g}, vs f64 {err:.3g}, "
              f"loop vs f64 {loop_err:.3g}, largest {scale:.3g}")
        assert err <= max(4 * loop_err, 1e-6 * scale), (i, err, loop_err, scale)
        assert vs_loop <= 1e-5 * max(scale, 1e-30), (i, vs_loop, scale)


@pytest.mark.card
@pytest.mark.parametrize("mode", MODES)
def test_the_kernels_compute_what_their_plain_versions_compute(mode, card):
    """``gru_seq_cuda`` and ``gru_seq_bwd_cuda`` against
    ``gru_seq_fwd_plain`` and ``gru_seq_bwd_plain`` on the same f32 inputs
    at DIEN's shape: each buffer within 1e-5 of its largest entry (sums in
    another order: the plain version's matmuls against the kernels' FMAs in
    k order), padded steps exactly zero in both."""
    b, t, d, h = 1024, 50, 36, 36
    cell = _cell(d, h, mode, card, torch.float32)
    x, lengths, att = _inputs(b, t, d, mode, card, torch.float32)
    with torch.no_grad():
        proj, _ = rnn._project(x, cell.gates_kernel, cell.gates_bias, cell.candidate_kernel,
                               cell.candidate_bias)
        ug, uc = cell.gates_kernel[d:].contiguous(), cell.candidate_kernel[d:].contiguous()
        d_outs = torch.randn(b, t, h, device=card, generator=torch.Generator(card).manual_seed(1))
        d_h = torch.randn(b, h, device=card, generator=torch.Generator(card).manual_seed(2))
        fwd = [gk.gru_seq_cuda(proj, lengths, att, ug, uc, mode, True),
               gk.gru_seq_fwd_plain(proj, lengths, att, ug, uc, mode, True)]
        bwd = [fn(*saved[:2], lengths, att, ug, uc, d_outs, d_h, mode)
               for fn, (_, _, saved) in zip((gk.gru_seq_bwd_cuda, gk.gru_seq_bwd_plain), fwd)]
    pad = torch.arange(t, device=card)[None, :] >= lengths[:, None]
    (outs_k, h_k, saved_k), (outs_p, h_p, saved_p) = fwd
    pairs = [(outs_k, outs_p), (h_k, h_p), *zip(saved_k, saved_p),
             *((a, b) for a, b in zip(*bwd) if a is not None)]
    for got, want in pairs:
        torch.testing.assert_close(got, want, rtol=0, atol=1e-5 * want.abs().max().item())
        if got.dim() == 3 or got.shape == pad.shape:
            assert not got[pad].any()


@pytest.mark.card
@pytest.mark.parametrize("mode", ["gru", "augru"])
def test_two_backward_calls_give_equal_bits(mode, card):
    cell = _cell(36, 36, mode, card, torch.float32)
    x, lengths, att = _inputs(1024, 50, 36, mode, card, torch.float32)
    first = _run(lambda c, *a: c._recurrence(*a), cell, x, lengths, att)
    second = _run(lambda c, *a: c._recurrence(*a), cell, x, lengths, att)
    assert all(torch.equal(a, b) for a, b in zip(first, second))


@pytest.mark.card
def test_a_width_past_the_kernels_raises(card):
    """H = 513, past the widest block of 2H threads: the module raises on
    the card and launches nothing."""
    cell = _cell(8, 513, "augru", card, torch.float32)
    x, lengths, att = _inputs(4, 3, 8, "augru", card, torch.float32)
    before = _counts()
    with pytest.raises(ValueError, match="H = 513"):
        cell(x, lengths, att)
    assert _counts() == before


@pytest.mark.card
@pytest.mark.parametrize("h", [36, 129])
@pytest.mark.parametrize("mode", MODES)
def test_a_length_past_t_on_the_card_counts_as_t(mode, h, card):
    """Lengths past T (the last row's among them, whose steps would end the
    allocation) give the bits that lengths clamped to T give, forward and
    backward, with U in shared memory (H = 36) and in global memory."""
    b, t, d = 33, 9, 8
    cell = _cell(d, h, mode, card, torch.float32)
    x, lengths, att = _inputs(b, t, d, mode, card, torch.float32)
    longer = lengths.clone()
    longer[lengths == t] += 5
    longer[-1] = t + 1
    clamped = longer.clamp(max=t)
    runs = [_run(lambda c, *a: c._recurrence(*a), cell, x, n, att) for n in (longer, clamped)]
    assert all(torch.equal(a, b) for a, b in zip(*runs))


@pytest.mark.card
def test_a_refused_launch_raises(card, monkeypatch):
    """H = 513 past the wrapper's own check (its limit raised for the test):
    the C entry refuses the launch, the wrapper raises and counts nothing."""
    monkeypatch.setattr(gk, "MAX_HIDDEN", 1024)
    h = 513
    proj = torch.zeros(8, 3, 3 * h, device=card)
    lengths = torch.full((8,), 3, dtype=torch.int32, device=card)
    ug, uc = torch.zeros(h, 2 * h, device=card), torch.zeros(h, h, device=card)
    before = gk.gru_seq_cuda.launches, gk.gru_seq_bwd_cuda.launches
    with pytest.raises(RuntimeError, match="gru_seq_fwd launch failed"):
        gk.gru_seq_cuda(proj, lengths, None, ug, uc, "gru", True)
    with pytest.raises(RuntimeError, match="gru_seq_bwd launch failed"):
        gk.gru_seq_bwd_cuda(proj, proj[..., :h].contiguous(), lengths, None, ug, uc, None, None,
                            "gru")
    assert (gk.gru_seq_cuda.launches, gk.gru_seq_bwd_cuda.launches) == before


@pytest.mark.card
def test_a_dien_artifact_traced_on_the_card_holds_the_kernels(card, tmp_path):
    """``torch.export`` traces each recurrence as one ``gru_seq_fwd`` node
    (its fake implementation: the trace launches nothing); the loaded
    artifact launches the forward kernel once a recurrence and serves what
    the Predictor serves, to 1e-5 (the program's own order of the
    projection's sums may differ)."""
    cfg = default_config("dien", hidden_units=(16, 8))
    state = build_model(tiny_schema(), cfg, device="cpu",
                        generator=torch.Generator().manual_seed(3)).state_dict()
    pred = Predictor(tiny_schema(), cfg, state_dict=state, min_bucket=16, device=card)
    path = str(tmp_path / "dien.pt2")
    before = gk.gru_seq_cuda.launches
    export_serving_artifact(pred, path, batch_size=16)
    assert gk.gru_seq_cuda.launches == before
    request = {k: v for k, v in make_synthetic_dataset(tiny_schema(), num_rows=16, seed=4).items()
               if k != "labels"}
    want = pred(request)
    assert gk.gru_seq_cuda.launches == before + 2
    targets = [str(n.target) for n in torch.export.load(path).graph.nodes
               if n.op == "call_function"]
    assert targets.count("rank_tpu_torch.gru_seq_fwd.default") == 2
    got = load_serving_artifact(path, device=card)(request)
    assert gk.gru_seq_cuda.launches == before + 4
    for head in want:
        np.testing.assert_allclose(got[head], want[head], rtol=0, atol=1e-5)


def _dien_trainer(graphed: bool, device):
    cfg = default_config("dien", hidden_units=(16, 8), cuda_graphs=graphed)
    trainer = Trainer(tiny_schema(), cfg,
                      TrainConfig(log_every=0, batch_size=32, matmul_precision="float32"),
                      device=device)
    return trainer, trainer.init_state(), trainer.meters_init()


def _dien_batch(trainer, seed):
    data = make_synthetic_dataset(tiny_schema(), num_rows=32, seed=seed)
    data["_valid"] = np.ones(32, np.float32)
    return trainer.to_device(data)


def _counts():
    return gk.gru_seq_cuda.launches, gk.gru_seq_bwd_cuda.launches


@pytest.mark.card
def test_an_eager_dien_step_launches_each_kernel_once_a_recurrence(card):
    trainer, state, meters = _dien_trainer(False, card)
    for seed in (1, 2):
        before = _counts()
        trainer.train_step(state, meters, _dien_batch(trainer, seed))
        assert _counts() == (before[0] + 2, before[1] + 2)


@pytest.mark.card
def test_a_graphed_dien_step_moves_the_counts_only_at_capture(card):
    """With ``cuda_graphs`` the first step captures (the kernels launch in
    the capture's warm-up and in the capture); a replay runs no Python, so
    the second step moves neither count."""
    trainer, state, meters = _dien_trainer(True, card)
    before = _counts()
    trainer.train_step(state, meters, _dien_batch(trainer, 1))
    captured = _counts()
    assert captured[0] > before[0] and captured[1] > before[1]
    trainer.train_step(state, meters, _dien_batch(trainer, 2))
    assert _counts() == captured
