"""The port's serving extras (rank_tpu_torch/serve.py), on the CPU:
``Predictor(weights_dtype=...)``, ``export_serving_artifact`` and
``load_serving_artifact``, and the kernels as registered operators.

  * bf16 weights: floating parameters cast, buffers kept, with the key
    split of the JAX package's ``params`` and ``batch_stats``; every model
    tracks its f32 Predictor to 2e-2 (the bar of tests/test_serve.py); and
    dcn, din, xdeepfm and mmoe track the JAX package's bf16 Predictor on
    the same weights to ``BF16_VS_JAX_ATOL``.
  * artifacts: a round trip reproduces the Predictor to rtol 1e-6 /
    atol 1e-7 (tests/test_serve.py), and the graphs of DIN and xDeepFM
    hold the registered B1 and B2 operators.
"""

import flax.linen as nn
import jax
import numpy as np
import pytest
import torch

from rank_tpu.features import tiny_schema as jax_tiny_schema
from rank_tpu.models import build_model as jax_build_model
from rank_tpu.models import default_config as jax_default_config
from rank_tpu.serve import Predictor as JaxPredictor
import rank_tpu_torch
from rank_tpu_torch import Predictor, build_model, default_config, tiny_schema
from rank_tpu_torch import export_serving_artifact, load_serving_artifact
from rank_tpu_torch.data.synthetic import make_synthetic_dataset
from rank_tpu_torch.interop import _flax_source, state_dict_from_flax
from rank_tpu_torch.models.registry import DEFAULT_CONFIGS
from rank_tpu_torch.ops.attention import DINAttention
from rank_tpu_torch.ops.cin import CIN
from rank_tpu_torch.ops.fm import pair_index_tensors
from rank_tpu_torch.ops.kernels import cin as ck
from rank_tpu_torch.ops.kernels import din_attention as dk
from test_torch_din_serve import _jax_variables

SCHEMA = tiny_schema()
# N(0, 0.1) tables: at the N(0, 1) default the FM family's pair sums and
# AutoInt's unscaled bf16 attention scores reach magnitudes where one bf16
# ulp of an input moves a probability far. JAX's own bf16 Predictor is
# then 0.032 (fwfm) and 0.300 (autoint) from its f32 one, and the port's
# 0.035 and 0.300 on the same weights (5 seeds): the port rounds where JAX
# does. At the port's own N(0, 1) init the gap is 0.056 (fwfm) and 0.18
# (autoint); at N(0, 0.1) it is below 0.01 for every model (3 seeds).
# All from ``python tests/torch_bf16_gap.py serving``.
NARROW = dict(hidden_units=(16, 8), embedding_init="normal_small")
BF16_VS_F32_ATOL = 2e-2
# The port's bf16 Predictor against JAX's on the same weights: both round
# to bf16 at the same places, in other orders; the largest gap is 2.9e-3
# (xdeepfm, 5 seeds, ``python tests/torch_bf16_gap.py serving``), held at
# 1e-2.
BF16_VS_JAX_ATOL = 1e-2
EXPORT_TOL = dict(rtol=1e-6, atol=1e-7)


def _request(rows=64, seed=1):
    return {k: v for k, v in make_synthetic_dataset(SCHEMA, num_rows=rows, seed=seed).items()
            if k != "labels"}


def _state_dict(cfg, seed=0):
    return build_model(SCHEMA, cfg, device="cpu",
                       generator=torch.Generator().manual_seed(seed)).state_dict()


@pytest.mark.parametrize("name", sorted(DEFAULT_CONFIGS))
def test_bf16_predictor_tracks_f32(name):
    cfg = default_config(name, **NARROW)
    state_dict = _state_dict(cfg)
    request = _request(256)
    f32 = Predictor(SCHEMA, cfg, state_dict=state_dict, min_bucket=64, device="cpu")
    bf16 = Predictor(SCHEMA, cfg, state_dict=state_dict, min_bucket=64, device="cpu",
                     weights_dtype="bfloat16")
    want, got = f32(request), bf16(request)
    assert sorted(got) == sorted(want)
    for head in want:
        assert got[head].dtype == np.float32 and np.isfinite(got[head]).all()
        np.testing.assert_allclose(got[head], want[head], rtol=0, atol=BF16_VS_F32_ATOL)


@pytest.mark.parametrize("name, overrides", [
    ("din", {}), ("dcn", dict(cross_frozen_random=True)), ("mmoe", dict(task_weighting="uncertainty")),
    ("xdeepfm", {}), ("autoint", {}), ("bst", {}),
])
def test_bf16_casts_jax_params_not_batch_stats(name, overrides):
    """The port's parameters are the image of the JAX ``params`` collection
    under ``state_dict_from_flax``, its buffers that of ``batch_stats`` (and
    ``num_batches_tracked``, which flax lacks): Dice alphas, the uncertainty
    ``task_log_var_*`` and DCN's frozen-random cross weights are params on
    both sides. The bf16 Predictor casts exactly the parameters."""
    cfg = default_config(name, hidden_units=(16, 8), **overrides)
    jax_model = jax_build_model(jax_tiny_schema(), jax_default_config(name, hidden_units=(16, 8),
                                                                      **overrides))
    batch = {k: v[:2] for k, v in make_synthetic_dataset(SCHEMA, num_rows=2).items()}
    rngs = {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)}
    shapes = nn.meta.unbox(jax.eval_shape(lambda: jax_model.init(rngs, batch, train=False)))
    collections = {path: collection for collection, tree in shapes.items()
                   for path in _paths(tree, (collection,))}
    pred = Predictor(SCHEMA, cfg, state_dict=_state_dict(cfg), device="cpu",
                     weights_dtype="bfloat16")
    model = pred.model
    params = dict(model.named_parameters())
    buffers = dict(model.named_buffers())
    assert set(params) | set(buffers) == set(model.state_dict())
    mapped = set()
    for key in model.state_dict():
        module_path, _, leaf = key.rpartition(".")
        scope = tuple(module_path.split(".")) if module_path else ()
        source = _flax_source(model.get_submodule(module_path), scope, leaf)
        if source is None:
            assert key in buffers and leaf == "num_batches_tracked", key
            continue
        path = source[0]
        mapped.add(path)
        assert collections[path] == ("params" if key in params else "batch_stats"), key
    assert mapped == set(collections)
    for key, p in params.items():
        assert p.dtype == torch.bfloat16, key
    for key, b in buffers.items():
        assert b.dtype in (torch.float32, torch.int64), key
    assert any(k.endswith("running_var") for k in buffers) == ("batch_stats" in shapes)


def _paths(tree, prefix):
    for key, value in tree.items():
        if isinstance(value, dict):
            yield from _paths(value, prefix + (key,))
        else:
            yield prefix + (key,)


@pytest.mark.parametrize("name", ["dcn", "din", "xdeepfm", "mmoe"])
def test_bf16_predictor_matches_jax_bf16_predictor(name):
    """The same f32 weights carried across, both sides cast to bf16. Then
    the JAX bf16 Predictor's own (bf16) variables carried across give the
    same port Predictor exactly: bf16 leaves convert without loss."""
    request = _request(64, seed=2)
    jax_model = jax_build_model(jax_tiny_schema(), jax_default_config(name, hidden_units=(16, 8)))
    variables = _jax_variables(jax_model, make_synthetic_dataset(SCHEMA, num_rows=2))
    jax_pred = JaxPredictor(jax_tiny_schema(), jax_default_config(name, hidden_units=(16, 8)),
                            variables=variables, min_bucket=64, weights_dtype="bfloat16")
    cfg = default_config(name, hidden_units=(16, 8))
    model = build_model(SCHEMA, cfg, device="cpu")
    pred = Predictor(SCHEMA, cfg, state_dict=state_dict_from_flax(model, variables),
                     min_bucket=64, device="cpu", weights_dtype="bfloat16")
    want = jax_pred(request)
    got = pred(request)
    assert sorted(got) == sorted(want)
    for head in want:
        assert np.isfinite(got[head]).all()
        np.testing.assert_allclose(got[head], np.asarray(want[head], np.float32), rtol=0,
                                   atol=BF16_VS_JAX_ATOL)
    carried = state_dict_from_flax(model, jax_pred.variables)
    assert any(t.dtype == torch.bfloat16 for t in carried.values())
    again = Predictor(SCHEMA, cfg, state_dict=carried, min_bucket=64, device="cpu",
                      weights_dtype="bfloat16")(request)
    for head in got:
        np.testing.assert_array_equal(again[head], got[head])


def _op_targets(path):
    program = torch.export.load(path)
    return {str(node.target) for node in program.graph.nodes if node.op == "call_function"}


@pytest.mark.parametrize("name, weights_dtype, op", [
    ("dcn", None, None),
    ("din", None, "rank_tpu_torch.din_attention.default"),
    ("xdeepfm", None, "rank_tpu_torch.cin_layer_t.default"),
    ("esmm", None, None),
    ("dien", None, None),
    ("din", "bfloat16", "rank_tpu_torch.din_attention.default"),
])
def test_export_round_trip(tmp_path, name, weights_dtype, op):
    """A fixed batch of 16 rows; labels left out of the request (fed
    zeros). DIN's and xDeepFM's programs name the registered kernels."""
    overrides = dict(cin_layer_sizes=(8, 6)) if name == "xdeepfm" else {}
    cfg = default_config(name, hidden_units=(16, 8), **overrides)
    pred = Predictor(SCHEMA, cfg, state_dict=_state_dict(cfg, seed=3), min_bucket=16,
                     device="cpu", weights_dtype=weights_dtype)
    path = str(tmp_path / f"{name}.pt2")
    export_serving_artifact(pred, path, batch_size=16)
    request = _request(16, seed=4)
    want = pred(request)
    got = load_serving_artifact(path, device="cpu")(request)
    assert sorted(got) == sorted(want)
    for head in want:
        assert got[head].shape == (16,) and got[head].dtype == np.float32
        np.testing.assert_allclose(got[head], want[head], **EXPORT_TOL)
    targets = _op_targets(path)
    kernels = {t for t in targets if t.startswith("rank_tpu_torch.")}
    assert kernels == ({op} if op else set()), targets


def test_artifact_refuses_other_batch_sizes(tmp_path):
    cfg = default_config("dcn", hidden_units=(8,))
    pred = Predictor(SCHEMA, cfg, state_dict=_state_dict(cfg), device="cpu")
    path = str(tmp_path / "dcn.pt2")
    export_serving_artifact(pred, path, batch_size=8)
    with pytest.raises(ValueError, match="takes"):
        load_serving_artifact(path, device="cpu")(_request(9))


def test_entry_points_raise_without_cuda(tmp_path, monkeypatch):
    """Like the port's other entry points: the default device is the card,
    and with no CUDA device they raise unless the caller asks for the CPU."""
    cfg = default_config("dcn", hidden_units=(8,))
    state_dict = _state_dict(cfg)
    path = str(tmp_path / "dcn.pt2")
    export_serving_artifact(Predictor(SCHEMA, cfg, state_dict=state_dict, device="cpu"), path,
                            batch_size=8)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        Predictor(SCHEMA, cfg, state_dict=state_dict, weights_dtype="bfloat16")
    with pytest.raises(RuntimeError, match="CUDA"):
        load_serving_artifact(path)
    Predictor(SCHEMA, cfg, state_dict=state_dict, weights_dtype="bfloat16", device="cpu")
    load_serving_artifact(path, device="cpu")
    with pytest.raises(ValueError, match="weights_dtype"):
        Predictor(SCHEMA, cfg, state_dict=state_dict, weights_dtype="float16", device="cpu")


def _din_args(dtype, use_softmax, d=4, hidden=(6, 3), seed=0):
    gen = torch.Generator().manual_seed(seed)
    b, t = 3, 5
    shapes = [(b, d), (b, t, d), (4 * d, hidden[0]), (hidden[0],), hidden, (hidden[1],),
              (hidden[1], 1), (1,)]
    q, k, *params = [torch.randn(s, generator=gen).mul(0.5).to(dtype).requires_grad_()
                     for s in shapes]
    return (q, k, torch.tensor([0, t, 2], dtype=torch.int32), *params, use_softmax)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("use_softmax", [False, True])
def test_din_attention_operator_opcheck(dtype, use_softmax):
    result = torch.library.opcheck(torch.ops.rank_tpu_torch.din_attention.default,
                                   _din_args(dtype, use_softmax))
    assert set(result.values()) == {"SUCCESS"}, result


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cin_layer_operator_opcheck(dtype):
    gen = torch.Generator().manual_seed(1)
    args = [torch.randn(s, generator=gen).to(dtype).requires_grad_()
            for s in ((2, 3, 5), (2, 3, 4), (6, 5, 4))]
    result = torch.library.opcheck(torch.ops.rank_tpu_torch.cin_layer_t.default, args)
    assert set(result.values()) == {"SUCCESS"}, result


def test_operators_are_the_plain_versions_on_the_cpu():
    """On CPU tensors the operators compute the plain versions, in the
    inputs' dtype (bf16 arithmetic, as JAX's under bf16 weights); the
    modules' ``'pallas'`` backend refuses them."""
    for dtype in (torch.float32, torch.bfloat16):
        q, k, lengths, *params, use_softmax = _din_args(dtype, True)
        with torch.no_grad():
            got = dk.din_attention(q, k, lengths, params, use_softmax)
            want = dk.din_attention_plain(q, k, lengths, params, use_softmax)
        assert got.dtype == dtype
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    xk, x0, w = torch.randn(2, 3, 5), torch.randn(2, 3, 4), torch.randn(6, 5, 4).bfloat16()
    assert ck.cin_layer_t(xk, x0, w).dtype == torch.float32  # bf16 weights promote to f32
    with pytest.raises(ValueError, match="CUDA"):
        CIN(4, (6,), backend="pallas")(x0.transpose(1, 2))
    with pytest.raises(ValueError, match="CUDA"):
        DINAttention(k.shape[2], use_softmax=True, backend="pallas")(q, k, lengths)


def test_training_after_serving_in_one_process():
    """Serving caches FiBiNet's pair indices under inference mode; a train
    step of the same model afterwards must still save them for backward."""
    cfg = default_config("fibinet", hidden_units=(8,), embedding_dim=4, dropout_rate=0.0)
    state_dict = _state_dict(cfg)
    pair_index_tensors.cache_clear()
    Predictor(SCHEMA, cfg, state_dict=state_dict, min_bucket=16, device="cpu")(_request(16))
    model = build_model(SCHEMA, cfg, device="cpu")
    model.load_state_dict(state_dict)
    batch = {k: torch.as_tensor(v) for k, v in make_synthetic_dataset(SCHEMA, num_rows=16).items()}
    model.train()
    out = model(batch)
    out["logits"].sum().backward()
    assert all(p.grad is not None for p in model.bilinear_raw.parameters())


def test_package_root_exports_serving_functions():
    assert rank_tpu_torch.export_serving_artifact is export_serving_artifact
    assert rank_tpu_torch.load_serving_artifact is load_serving_artifact
    assert {"export_serving_artifact", "load_serving_artifact"} <= set(rank_tpu_torch.__all__)
