"""The port's measurement tools (rank_tpu_torch/utils, the Trainer's
``matmul_precision`` and ``profile_dir``, ``StagedRunner.step_memory_analysis``)
held against the JAX package and against hand counts, on the CPU:

  * ``roofline`` against ``rank_tpu.utils.roofline.roofline`` with the
    v5e peaks patched into the port's constants: equal on every JAX key
    (the port's ``"compute"`` for JAX's ``"mxu"``);
  * the FLOP formulas of the two kernels' operators against
    ``FlopCounterMode`` on their plain versions, and 0 without them; a DCN
    step's product FLOPs against ``scripts/mfu_roofline.py:dcn_hand_count``;
  * ``op_bytes``: exact hand counts of single ops and one Adam step, and
    the buckets of a DCN step;
  * measured steps leave the state bit-identical;
  * ``matmul_precision``: scoped to each step, restored after it (also when
    it raises), train-step parity with JAX under ``float32`` and
    ``highest`` at the usual bars, and DIN under ``bfloat16`` at a bf16 bar;
  * the CLI with ``--profile_dir`` and ``--matmul_precision``.
"""

import importlib.util
import json
import os
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch.utils import flop_counter
from torch.utils.flop_counter import FlopCounterMode

from rank_tpu.features import WECHAT_SCHEMA as JAX_WECHAT
from rank_tpu.models import default_config as jax_default_config
from rank_tpu.utils import roofline as jax_roofline
from rank_tpu_torch import WECHAT_SCHEMA, build_model, default_config, tiny_schema
from rank_tpu_torch.cli import main
from rank_tpu_torch.data.synthetic import make_synthetic_dataset
from rank_tpu_torch.ops.kernels import cin as cin_kernels
from rank_tpu_torch.ops.kernels import din_attention as din_kernels
from rank_tpu_torch.train import TrainConfig, Trainer
from rank_tpu_torch.train.staged import StagedRunner
from rank_tpu_torch.utils import op_bytes, roofline
from test_torch_train import PARITY_OVERRIDES, bn_fed_bias_noise, check_train_step_parity

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True)
def keep_matmul_precision():
    """torch's float32 matmul precision is process-wide: a setting left
    behind would loosen every later test on this worker."""
    before = torch.get_float32_matmul_precision()
    yield
    torch.set_float32_matmul_precision(before)


def _batch(trainer, schema, rows: int, seed: int = 3):
    data = make_synthetic_dataset(schema, num_rows=rows, seed=seed)
    data["_valid"] = np.ones(rows, np.float32)
    return trainer.to_device(data)


# -- roofline -------------------------------------------------------------------

@pytest.mark.parametrize("flops, nbytes, eps", [
    (2.0e6, 3.0e5, 9.0e4),  # HBM-bound at v5e's ratio
    (5.0e8, 1.0e3, 1.0e4),  # compute-bound
    (1.0e6, 4.157e3, 2.5e5),  # near the ridge
    (0.0, 1.0e4, 1.0e5),  # no products
])
def test_roofline_matches_jax(monkeypatch, flops, nbytes, eps):
    monkeypatch.setattr(roofline, "H100_PEAK_F32_FLOPS", jax_roofline.V5E_PEAK_FLOPS)
    monkeypatch.setattr(roofline, "H100_PEAK_HBM", jax_roofline.V5E_PEAK_HBM)
    got = roofline.roofline(flops, nbytes, eps)
    want = jax_roofline.roofline(flops, nbytes, eps)
    assert got.pop("peak_tflops") == jax_roofline.V5E_PEAK_FLOPS / 1e12
    assert got.pop("bound") == {"mxu": "compute", "hbm": "hbm"}[want.pop("bound")]
    assert got == want


def test_peak_follows_matmul_precision():
    assert roofline.peak_flops(None) == roofline.peak_flops("float32") == \
        roofline.peak_flops("highest") == roofline.H100_PEAK_F32_FLOPS == 67e12
    assert roofline.peak_flops("bfloat16") == roofline.H100_PEAK_TF32_FLOPS == 495e12
    assert roofline.roofline(1e6, 1e3, 1e5, "bfloat16")["peak_tflops"] == 495.0
    with pytest.raises(ValueError, match="matmul_precision"):
        roofline.peak_flops("fp8")


# -- FLOP formulas ----------------------------------------------------------------

def _flops(fn, *args) -> int:
    with FlopCounterMode(display=False) as counter:
        fn(*args)
    return counter.get_total_flops()


def _cin_inputs(b, d, h, f, o, seed=0):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(b, d, h, generator=g), torch.randn(b, d, f, generator=g),
            torch.randn(o, h, f, generator=g))


def _din_inputs(b, t, d, hidden, seed=0):
    g = torch.Generator().manual_seed(seed)
    h1, h2 = hidden
    params = tuple(torch.randn(s, generator=g) for s in ((4 * d, h1), (h1,), (h1, h2), (h2,),
                                                          (h2, 1), (1,)))
    lengths = torch.randint(0, t + 1, (b,), generator=g, dtype=torch.int32)
    return torch.randn(b, d, generator=g), torch.randn(b, t, d, generator=g), lengths, params


@pytest.mark.parametrize("b, d, h, f, o", [(8, 4, 6, 5, 10), (16, 16, 7, 7, 128),
                                           (5, 3, 12, 9, 4)])
def test_cin_flop_formula_matches_plain(b, d, h, f, o):
    xk, x0, w = _cin_inputs(b, d, h, f, o)
    want = _flops(cin_kernels.cin_layer_plain_t, xk, x0, w)
    assert want == 2 * b * d * h * f * o
    assert _flops(cin_kernels.cin_layer_t, xk, x0, w) == want


@pytest.mark.parametrize("b, t, d, hidden", [(4, 50, 16, (64, 32)), (3, 7, 12, (64, 32)),
                                             (5, 9, 16, (32, 16))])
def test_din_flop_formula_matches_plain(b, t, d, hidden):
    q, k, lengths, params = _din_inputs(b, t, d, hidden)
    want = _flops(din_kernels.din_attention_plain, q, k, lengths, params, True)
    h1, h2 = hidden
    assert want == 2 * b * t * (4 * d * h1 + h1 * h2 + h2) + 2 * b * t * d
    assert _flops(din_kernels.din_attention, q, k, lengths, params, True) == want


@pytest.mark.parametrize("op", ["cin_layer_t", "din_attention"])
def test_operators_count_nothing_without_their_formula(monkeypatch, op):
    monkeypatch.delitem(flop_counter.flop_registry, getattr(torch.ops.rank_tpu_torch, op))
    if op == "cin_layer_t":
        assert _flops(cin_kernels.cin_layer_t, *_cin_inputs(8, 4, 6, 5, 10)) == 0
    else:
        q, k, lengths, params = _din_inputs(4, 50, 16, (64, 32))
        assert _flops(din_kernels.din_attention, q, k, lengths, params, True) == 0


def _dcn_hand_count():
    spec = importlib.util.spec_from_file_location("mfu_roofline",
                                                  ROOT / "scripts" / "mfu_roofline.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.dcn_hand_count


def test_dcn_step_products_match_hand_count():
    """The product FLOPs of a full-width DCN step against the matmul part
    of the JAX package's hand count: the tower and output products three
    times (forward, input and weight gradients) and 3 x 2 B d0 a cross
    layer. The rest of the hand count (the cross layers' elementwise work
    and Adam's 19 FLOPs a parameter) is what the port's counter leaves out."""
    b = 64
    cfg = default_config("dcn")
    trainer = Trainer(WECHAT_SCHEMA, cfg, TrainConfig(log_every=0), device="cpu")
    state = trainer.init_state()
    costs = roofline.step_costs(trainer, state, _batch(trainer, WECHAT_SCHEMA, b))

    from rank_tpu.models.base import TOWER_FIELDS

    d0 = WECHAT_SCHEMA.num_dense + sum(
        WECHAT_SCHEMA.categorical_feature(f).emb_dim for f in TOWER_FIELDS)
    widths = [d0, *cfg.hidden_units]
    mm_fwd = sum(2 * b * m * n for m, n in zip(widths[:-1], widths[1:]))
    mm_fwd += 2 * b * (d0 + cfg.hidden_units[-1])
    products = 3 * mm_fwd + 3 * 2 * b * d0 * cfg.num_cross_layers
    params = sum(p.numel() for p in state["model"].parameters())
    hand = _dcn_hand_count()(JAX_WECHAT, jax_default_config("dcn"), b)
    assert hand["flops"] == products + 3 * 4 * b * d0 * cfg.num_cross_layers + 19 * params
    assert costs["flops"] == pytest.approx(products, rel=0.01), (
        f"the port counts {costs['flops'] - products:+.0f} product FLOPs beyond the hand count")


# -- op_bytes: hand counts --------------------------------------------------------

def test_bytes_of_linear_forward():
    x, lin = torch.randn(8, 5), torch.nn.Linear(5, 3)
    rows = op_bytes.attribute_bytes(lin, x)
    assert [r[1] for r in rows] == ["aten.addmm"]
    assert rows[0][0] == 4 * (8 * 3 + 3 + 8 * 5 + 5 * 3)  # out, bias, x, W (W.t() is a view)


def test_bytes_of_gather():
    table, ids = torch.randn(1000, 16), torch.randint(0, 1000, (32, 7))
    rows = op_bytes.attribute_bytes(F.embedding, ids, table)
    assert [(r[0], r[1]) for r in rows] == [(2 * 4 * 32 * 7 * 16 + 8 * 32 * 7, "aten.embedding")]


def test_bytes_of_embedding_dense_backward():
    """The whole table-sized gradient it writes, and its reads."""
    table = torch.randn(1000, 16, requires_grad=True)
    ids = torch.randint(0, 1000, (32,))
    out = F.embedding(ids, table)
    rows = op_bytes.attribute_bytes(out.backward, torch.ones(32, 16))
    (row,) = [r for r in rows if r[1] == "aten.embedding_dense_backward"]
    assert row[0] == 4 * 1000 * 16 + 4 * 32 * 16 + 8 * 32
    assert row[3] == "backward"


def test_views_are_free():
    x = torch.randn(4, 6)

    def views():
        x.view(6, 4).t().unsqueeze(0).expand(3, 4, 6).permute(0, 2, 1)[1].transpose(0, 1) \
            .squeeze().detach()[:, 1:].select(1, 0)

    assert op_bytes.attribute_bytes(views) == []


def test_bytes_of_cin_operator():
    b, d, h, f, o = 8, 4, 6, 5, 10
    rows = op_bytes.attribute_bytes(cin_kernels.cin_layer_t, *_cin_inputs(b, d, h, f, o))
    assert [(r[0], r[1]) for r in rows] == [
        (4 * (b * d * h + b * d * f + o * h * f + b * d * o), "rank_tpu_torch.cin_layer_t")]


def test_bytes_of_one_adam_step():
    """torch.optim.Adam's first step on one (N,) parameter, op by op (the
    single-tensor update, as on the CPU)."""
    n = 1000
    p = torch.nn.Parameter(torch.randn(n))
    p.grad = torch.randn(n)
    opt = torch.optim.Adam([p], lr=0.01)
    rows = op_bytes.attribute_bytes(opt.step)
    t = 4 * n  # one (N,) f32 tensor
    want = [
        ("aten.zeros_like", t), ("aten.zeros_like", t),  # the moments, written
        ("aten.add_", 4 + 4),  # step += 1 (a 0-dim tensor, read and written)
        ("aten.lerp_", 3 * t),  # m <- lerp(m, g): read m, g; write m
        ("aten.mul_", 2 * t),  # v *= beta2
        ("aten.addcmul_", 4 * t),  # v += (1 - beta2) g g: read v, g, g; write v
        ("aten._local_scalar_dense", 4),  # step.item()
        ("aten.sqrt", 2 * t),
        ("aten.div", 2 * t),  # / sqrt(bias correction 2)
        ("aten.add_", 2 * t),  # + eps
        ("aten.addcdiv_", 4 * t),  # p -= lr' m / denom: read p, m, denom; write p
    ]
    assert [(r[1], r[0]) for r in rows] == want
    assert {r[3] for r in rows} == {"optimizer"}


def test_dcn_step_buckets():
    trainer = Trainer(tiny_schema(), default_config("dcn"), TrainConfig(log_every=0), device="cpu")
    state = trainer.init_state()
    batch = _batch(trainer, tiny_schema(), 32)
    rows = op_bytes.step_rows(trainer, state, batch)
    labels = dict(op_bytes.grouped(rows, top=len(rows)))
    assert {"matmul_fwd", "matmul_bwd", "embedding_gather", "embedding_scatter_grad",
            "optimizer_update"} <= set(labels)
    assert op_bytes.real_step_bytes(trainer, state, batch) == sum(labels.values())


# -- measured steps leave the state as it was --------------------------------------

def _state_bytes(state):
    tree = {"model": state["model"].state_dict(), "optimizer": state["optimizer"].state_dict(),
            "step": state["step"], "rng": torch.get_rng_state()}
    if "mtl" in state:
        tree["mtl"] = state["mtl"]
    if "pcgrad_generator" in state:
        tree["pcgrad"] = state["pcgrad_generator"].get_state()
    out = {}
    for path, leaf in torch.utils._pytree.tree_flatten_with_path(tree)[0]:
        out[torch.utils._pytree.keystr(path)] = (
            leaf.detach().clone().numpy().tobytes() if torch.is_tensor(leaf) else leaf)
    return out


@pytest.mark.parametrize("name, overrides", [
    ("xdeepfm", dict(dropout_rate=0.3)),  # dropout draws from torch's generator
    ("mmoe", dict(task_weighting="gradnorm")),
    ("mmoe", dict(task_weighting="pcgrad")),
])
def test_measured_steps_leave_state_unchanged(name, overrides):
    """``step_costs``, ``step_rows`` and ``step_memory_analysis`` after a
    real step (so that Adam has moments): the model, the optimizer, the
    step, GradNorm's and PCGrad's state and the generators bit-identical.
    ``step_memory_analysis`` returns None on a CPU trainer."""
    schema = tiny_schema()
    trainer = Trainer(schema, default_config(name, **overrides), TrainConfig(log_every=0),
                      device="cpu")
    state = trainer.init_state()
    batch = _batch(trainer, schema, 32)
    trainer.train_step(state, trainer.meters_init(), batch)
    before = _state_bytes(state)
    costs = roofline.step_costs(trainer, state, batch)
    assert costs["flops"] > 0 and costs["bytes"] > 0
    op_bytes.step_rows(trainer, state, batch)
    runner = StagedRunner(trainer, make_synthetic_dataset(schema, num_rows=40, seed=1),
                          make_synthetic_dataset(schema, num_rows=20, seed=2), 16)
    assert runner.step_memory_analysis(state) is None
    assert _state_bytes(state) == before


# -- matmul_precision -----------------------------------------------------------------

def _din_trainer(precision):
    return Trainer(tiny_schema(), default_config("din", **PARITY_OVERRIDES["din"]),
                   TrainConfig(log_every=0, matmul_precision=precision), device="cpu")


@pytest.mark.parametrize("precision, inside", [("bfloat16", "medium"), ("float32", "highest"),
                                               ("highest", "highest"), (None, "high")])
def test_precision_is_scoped_to_the_step(precision, inside):
    """Inside the step the setting is the mapped one (None leaves the
    caller's, here 'high'); after it the caller's is back."""
    torch.set_float32_matmul_precision("high")
    trainer = _din_trainer(precision)
    state = trainer.init_state()
    seen = []
    loss_fn = trainer.loss_fn

    def spy(out, batch):
        seen.append(torch.get_float32_matmul_precision())
        return loss_fn(out, batch)

    trainer.loss_fn = spy
    trainer.train_step(state, trainer.meters_init(), _batch(trainer, tiny_schema(), 16))
    assert seen == [inside]
    assert torch.get_float32_matmul_precision() == "high"


def test_precision_restored_when_the_step_raises():
    torch.set_float32_matmul_precision("high")
    trainer = _din_trainer("bfloat16")
    state = trainer.init_state()

    def broken(out, batch):
        raise FloatingPointError("a failing step")

    trainer.loss_fn = broken
    with pytest.raises(FloatingPointError, match="failing step"):
        trainer.train_step(state, trainer.meters_init(), _batch(trainer, tiny_schema(), 16))
    assert torch.get_float32_matmul_precision() == "high"


def test_bad_precision_raises():
    with pytest.raises(ValueError, match="matmul_precision"):
        _din_trainer("float16")


@pytest.mark.parametrize("name", ["xdeepfm", "din"])
@pytest.mark.parametrize("precision", ["float32", "highest"])
def test_train_step_parity_under_precision(name, precision):
    """``check_train_step_parity`` with the precision set on both sides, at
    the bars of ``test_torch_train.py::test_train_step_parity``."""
    lr = 0.005
    noise = bn_fed_bias_noise("dnn", 2, lr) if name == "xdeepfm" else {"attention.b3": 3 * lr}
    check_train_step_parity(name, PARITY_OVERRIDES[name], noise, lr,
                            train_overrides={"matmul_precision": precision})
    assert torch.get_float32_matmul_precision() == "highest"


def test_din_bf16_step_against_jax():
    """DIN under ``bfloat16`` against JAX's CPU run under the same setting.
    JAX on the CPU ignores the setting (its products stay f32), while the
    port's run as torch's 'medium', which on a CPU with AMX-bf16 takes the
    products' inputs to bf16 (8-bit mantissa, unit roundoff 2^-9 = 2e-3).
    So the bars are bf16's: the losses and step-1 gradients to rtol 4e-3
    (two units) and atol 2e-3 (two units of the loss's scale, about 1);
    the parameters after 3 steps to atol 2 * 3 * lr, the furthest Adam's
    steps of about lr can carry a parameter whose gradient changed sign."""
    lr = 0.005
    model = build_model(tiny_schema(), default_config("din", **PARITY_OVERRIDES["din"]),
                        device="cpu")
    noise = {name: 2 * 3 * lr for name, _ in model.named_parameters()}
    check_train_step_parity("din", PARITY_OVERRIDES["din"], noise, lr,
                            train_overrides={"matmul_precision": "bfloat16"},
                            tol=dict(rtol=4e-3, atol=2e-3))


# -- the CLI -------------------------------------------------------------------------

def _cli(tmp_path, *extra):
    return main(["--synthetic=1500", "--batch_size=256", "--device=cpu", "--hidden_units=32,16",
                 f"--model_dir={tmp_path}/m", f"--output_dir={tmp_path}/o", *extra])


def test_cli_profile_dir_traces_epoch_one(tmp_path, capsys):
    """A 2-epoch DIN run writes one chrome trace (epoch 1's), prints JAX's
    line, and the trace holds B1's operator."""
    trace_dir = tmp_path / "trace"
    assert _cli(tmp_path, "--model=din", "--num_epochs=2", f"--profile_dir={trace_dir}") == 0
    assert os.listdir(trace_dir) == ["trace_rank0.json"]
    out = capsys.readouterr().out
    assert out.count(f"profile trace written to {trace_dir}") == 1
    with open(trace_dir / "trace_rank0.json") as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "rank_tpu_torch::din_attention" for e in events)


def test_cli_matmul_precision_on_the_synthetic_path(tmp_path):
    assert _cli(tmp_path, "--model=xdeepfm", "--matmul_precision=bfloat16") == 0
    assert torch.get_float32_matmul_precision() == "highest"
    history = [json.loads(line) for line in open(tmp_path / "o" / "metrics_history.jsonl")]
    assert np.isfinite(history[0]["train_loss"]) and 0 <= history[0]["eval_auc"] <= 1
