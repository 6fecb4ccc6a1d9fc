"""Warm-start from the original repo's ``best_model.pth``
(``rank_tpu_torch.interop.import_reference_checkpoint``) held against the
JAX package's import of the same file.

The original checkpoints are not in this repository, so each test writes a
``.pth`` in ``tmp_path`` with the original's keys (``embeddings.<f>.weight``,
``dnn.{0,2,4}.*``, ``output_layer.*``) and random tensors from a seed. JAX's
import lands them in flax params, carried across with
``state_dict_from_flax``; the port's lands them in the torch state dict.
The two must be equal tensor for tensor, and raise in the same cases.
"""

import flax.linen as nn
import jax
import numpy as np
import pytest
import torch

from rank_tpu.features import tiny_schema as jax_tiny_schema
from rank_tpu.interop import import_reference_checkpoint as jax_import
from rank_tpu.interop import reference_mapping as jax_reference_mapping
from rank_tpu.models import build_model as jax_build_model
from rank_tpu.models import default_config as jax_default_config
from rank_tpu_torch import WECHAT_SCHEMA, build_model, default_config, tiny_schema
from rank_tpu_torch.cli import main
from rank_tpu_torch.data.synthetic import make_synthetic_dataset
from rank_tpu_torch.interop import (REFERENCE_FIELDS, import_reference_checkpoint,
                                    reference_mapping, state_dict_from_flax)

MODELS = ("dcn", "deepcrossing")


def _jax_variables(name):
    model = jax_build_model(jax_tiny_schema(), jax_default_config(name))
    batch = make_synthetic_dataset(tiny_schema(), num_rows=2, seed=0)
    variables = nn.meta.unbox(jax.jit(lambda r, b: model.init(r, b, train=False))(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)}, batch))
    return jax.tree_util.tree_map(np.asarray, dict(variables))


def _write_reference(path, shapes, seed=0):
    """A ``.pth`` of random tensors under the original repo's keys."""
    rng = np.random.default_rng(seed)
    sd = {k: torch.from_numpy(rng.normal(size=s).astype(np.float32)) for k, s in shapes.items()}
    torch.save(sd, path)
    return sd


def _reference_shapes(name, params):
    """The original's tensor shapes, from the flax params JAX's mapping names
    (torch (out, in) for a transposed kernel)."""
    shapes = {}
    for ref_key, (path, transpose) in jax_reference_mapping(name).items():
        node = params
        for key in path:
            node = node[key]
        shapes[ref_key] = node.shape[::-1] if transpose else node.shape
    return shapes


@pytest.fixture(params=MODELS)
def case(request, tmp_path):
    """(model name, JAX variables, the port's model carrying them, the .pth path)."""
    name = request.param
    variables = _jax_variables(name)
    model = build_model(tiny_schema(), default_config(name), device="cpu")
    model.load_state_dict(state_dict_from_flax(model, variables))
    path = str(tmp_path / "best_model.pth")
    _write_reference(path, _reference_shapes(name, variables["params"]))
    return name, variables, model, path


def test_import_lands_every_tensor_where_jax_does(case):
    name, variables, model, path = case
    new_params, jax_report = jax_import(path, name, variables["params"])
    want = state_dict_from_flax(model, {**variables, "params": new_params})
    before = model.state_dict()
    got, report = import_reference_checkpoint(path, name, before)
    assert sorted(report) == sorted(jax_report) == sorted(reference_mapping(name))
    assert len(report) == {"dcn": 14, "deepcrossing": 8}[name]
    assert sorted(got) == sorted(want)
    for key, value in got.items():
        np.testing.assert_array_equal(value.numpy(), want[key].numpy(), err_msg=key)
    sd = torch.load(path, weights_only=True)
    for ref_key, key in report.items():
        assert torch.equal(got[key], sd[ref_key])
    # layers the original never saved keep their fresh values; the model is untouched
    untouched = set(got) - set(report.values())
    assert any(k.startswith("cross.") or k.startswith("residual.") for k in untouched)
    for key in untouched:
        assert torch.equal(got[key], before[key])
    assert torch.equal(model.state_dict()["output.weight"], before["output.weight"])
    model.load_state_dict(got)
    assert torch.equal(model.state_dict()["output.weight"], sd["output_layer.weight"])


def test_mapping_matches_jax():
    for name in MODELS:
        assert sorted(reference_mapping(name)) == sorted(jax_reference_mapping(name))
    assert {k.split(".")[1] for k in reference_mapping("dcn") if k.startswith("embeddings.")} \
        == set(REFERENCE_FIELDS)


def test_row_deficit_raises_as_jax(case, tmp_path):
    """A table with a row fewer than the model's (a checkpoint built against
    a smaller vocabulary): both raise, JAX without ``table_padding``."""
    name, variables, model, path = case
    sd = torch.load(path, weights_only=True)
    sd["embeddings.userid.weight"] = sd["embeddings.userid.weight"][:-1]
    bad = str(tmp_path / "smaller_vocab.pth")
    torch.save(sd, bad)
    with pytest.raises(ValueError, match="shape mismatch"):
        jax_import(bad, name, variables["params"])
    with pytest.raises(ValueError, match="shape mismatch at tables.table_userid.weight"):
        import_reference_checkpoint(bad, name, model.state_dict())


def test_unknown_tensor_raises_as_jax(case, tmp_path):
    name, variables, model, path = case
    sd = torch.load(path, weights_only=True)
    sd["mystery.weight"] = torch.zeros(3)
    bad = str(tmp_path / "bad.pth")
    torch.save(sd, bad)
    with pytest.raises(ValueError, match="no flax home"):
        jax_import(bad, name, variables["params"])
    with pytest.raises(ValueError, match=r"no home in the model: \['mystery.weight'\]"):
        import_reference_checkpoint(bad, name, model.state_dict())


@pytest.mark.parametrize("name", ["bst", "din", "xdeepfm"])
def test_other_models_raise_as_jax(name, tmp_path):
    torch.save({}, tmp_path / "empty.pth")
    with pytest.raises(ValueError, match="dcn and deepcrossing"):
        jax_reference_mapping(name)
    with pytest.raises(ValueError, match="dcn and deepcrossing"):
        reference_mapping(name)
    with pytest.raises(ValueError, match="dcn and deepcrossing"):
        main([f"--model={name}", "--synthetic=100", "--device=cpu",
              f"--init_from_reference={tmp_path}/empty.pth", f"--model_dir={tmp_path}/m",
              f"--output_dir={tmp_path}/o"])


def test_cli_warm_starts_and_trains(tmp_path, capsys):
    """``--init_from_reference`` on the CPU at full width (default DCN):
    the CLI prints the JAX CLI's line, trains, and the saved best model's
    imported tables sit within a few Adam steps of the checkpoint's, where
    the cross weights keep the trainer's fresh init up to those steps."""
    model = build_model(WECHAT_SCHEMA, default_config("dcn"), device="cpu",
                        generator=torch.Generator().manual_seed(42))
    shapes = {ref: tuple(model.state_dict()[key].shape)
              for ref, key in reference_mapping("dcn").items()}
    path = str(tmp_path / "best_model.pth")
    sd = _write_reference(path, shapes, seed=1)
    rc = main(["--model=dcn", "--synthetic=1500", "--batch_size=256", "--device=cpu",
               f"--init_from_reference={path}", f"--model_dir={tmp_path}/m",
               f"--output_dir={tmp_path}/o"])
    assert rc == 0
    out = capsys.readouterr().out
    assert f"warm-started 14 tensors from {path}" in out
    assert "Predictions saved to" in out
    trained = torch.load(tmp_path / "m" / "best_model", weights_only=True)
    steps, lr = 5, 0.005  # 1275 train rows at batch 256; Adam moves each entry <= ~lr a step
    for ref_key in ("embeddings.userid.weight", "dnn.0.weight", "output_layer.weight"):
        key = reference_mapping("dcn")[ref_key]
        assert (trained[key] - sd[ref_key]).abs().max() <= 2 * steps * lr, key
    fresh = model.state_dict()["cross.w_0"]
    assert (trained["cross.w_0"] - fresh).abs().max() <= 2 * steps * lr
