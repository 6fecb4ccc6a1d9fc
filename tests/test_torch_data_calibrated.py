"""The port's calibrated log and dataset (``rank_tpu_torch.data.calibrated``)
held against the JAX package's at the scale of ``tests/test_calibrated.py``
(0.02): the same seed writes byte-identical CSVs with equal stats, and the
dataset built over them through each side's ETL has equal arrays and
vocabulary sizes. Each side writes into its own ``tmp_path`` directory.
"""

import inspect

import numpy as np
import pytest

from rank_tpu.data import calibrated as jax_calibrated
from rank_tpu_torch.data import calibrated
from test_torch_data_etl import assert_same_arrays, vocab_sizes

SCALE = 0.02


def test_calibrated_log_matches_jax(tmp_path):
    cfg = dict(scale=SCALE, seed=3)
    want = jax_calibrated.make_calibrated_log(str(tmp_path / "jax"),
                                              jax_calibrated.CalibratedLogConfig(**cfg))
    got = calibrated.make_calibrated_log(str(tmp_path / "port"),
                                         calibrated.CalibratedLogConfig(**cfg))
    assert got == want
    assert want["rows"] > 100_000 * SCALE
    for name in ("user_action.csv", "feed_info.csv"):
        assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes()


@pytest.fixture(scope="module")
def datasets(tmp_path_factory):
    kwargs = dict(scale=SCALE, seed=4)
    want = jax_calibrated.make_calibrated_dataset(
        cache_dir=str(tmp_path_factory.mktemp("jax_cal")), **kwargs)
    got = calibrated.make_calibrated_dataset(
        cache_dir=str(tmp_path_factory.mktemp("port_cal")), **kwargs)
    return got, want


@pytest.mark.parametrize("split", [0, 1])
def test_calibrated_dataset_arrays_match_jax(datasets, split):
    got, want = datasets
    assert want[split]["labels"].shape[0] > 1000
    lengths = want[split]["his_read_comment_7d_seq_length"]
    assert (lengths == 0).any() and (lengths == 50).any()  # the skew B1 sees
    assert_same_arrays(got[split], want[split])


def test_calibrated_dataset_schema_matches_jax(datasets):
    (*_, schema), (*_, jax_schema) = datasets
    assert vocab_sizes(schema) == vocab_sizes(jax_schema)
    assert [f.emb_dim for f in schema.categorical] == [f.emb_dim for f in jax_schema.categorical]
    assert vocab_sizes(schema)["feedid"] < 106_445  # sized from the files, not WECHAT_SCHEMA


def test_default_cache_dir_is_the_ports_own(tmp_path, monkeypatch):
    """The port never reads a log the JAX package cached: its default
    directory is its own, under ``TMPDIR``."""
    import tempfile

    jax_default = inspect.signature(jax_calibrated.make_calibrated_dataset).parameters[
        "cache_dir"].default
    assert calibrated.default_cache_dir() != jax_default
    assert inspect.signature(calibrated.make_calibrated_dataset).parameters[
        "cache_dir"].default is None
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    assert calibrated.default_cache_dir() == str(tmp_path / "rank_tpu_torch_calibrated")
    np.testing.assert_equal(calibrated.ACTION_RATES, jax_calibrated.ACTION_RATES)
