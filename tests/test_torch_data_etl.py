"""The port's ETLs (``rank_tpu_torch.data.etl``, ``.douban``) held against
the JAX package's on the miniature datasets of ``tests/test_etl.py``.

Each side runs from the same CSVs into its own directory. Vocabulary files
must be byte-identical; feature pickles and parquet frames equal
(``assert_frame_equal``: a parquet file's metadata may name its writer);
the ``.npz`` arrays equal in keys, dtype, shape and values (a compressed
npz holds zip timestamps, so the files' bytes may differ). Then the slice
as a whole: the JAX ETL's files, loaded through each CLI's ``_load_split``
with the vocabulary-sized schema, train small-width xDeepFM and DIN to the
same logits and the same parameters after 3 Adam steps.
"""

import os

import jax
import jax.numpy as jnp
import flax.linen as nn
import numpy as np
import pandas as pd
import pytest
import torch

from rank_tpu.cli import _load_split as jax_load_split
from rank_tpu.data.douban import CATEGORY_COLUMNS as JAX_DOUBAN_COLUMNS
from rank_tpu.data.douban import DoubanETL as JaxDoubanETL
from rank_tpu.data.etl import WeChatETL as JaxWeChatETL
from rank_tpu.features import WECHAT_SCHEMA as JAX_WECHAT
from rank_tpu.features import schema_from_vocab_dir as jax_schema_from_vocab_dir
from rank_tpu.models import build_model as jax_build_model
from rank_tpu.models import default_config as jax_default_config
from rank_tpu_torch import WECHAT_SCHEMA, build_model, default_config
from rank_tpu_torch.cli import _load_split
from rank_tpu_torch.data.douban import CATEGORY_COLUMNS, DoubanETL
from rank_tpu_torch.data.etl import WeChatETL
from rank_tpu_torch.features import schema_from_vocab_dir
from rank_tpu_torch.interop import state_dict_from_flax
from test_torch_train import PARITY_OVERRIDES, bn_fed_bias_noise, check_train_step_parity

SPLITS = ("train", "test")
FEATURE_PICKLES = ("user_agg_features.pkl", "user_seq_features.pkl",
                   "feed_agg_features.pkl", "cross_agg_features.pkl")


def write_wechat_csvs(d) -> None:
    """``user_action.csv`` and ``feed_info.csv`` of ``tests/test_etl.py``'s
    ``etl_dir`` fixture: users 1-3, feeds 10-13, days 1..14, seed 0."""
    rng = np.random.default_rng(0)
    rows = []
    for day in range(1, 15):
        for u in (1, 2, 3):
            for f in (10, 11, 12, 13):
                if rng.random() < 0.6:
                    rows.append(
                        dict(
                            userid=u, feedid=f, date_=day, device=rng.integers(1, 3),
                            read_comment=int(rng.random() < 0.5),
                            like=int(rng.random() < 0.3),
                            click_avatar=int(rng.random() < 0.2),
                            forward=0, comment=0, follow=0,
                            favorite=int(rng.random() < 0.1),
                            play=1000, stay=2000,
                        )
                    )
    for day in (2, 5, 9):
        rows.append(
            dict(userid=1, feedid=10, date_=day, device=1, read_comment=1,
                 like=0, click_avatar=0, forward=0, comment=0, follow=0,
                 favorite=0, play=1, stay=1)
        )
    pd.DataFrame(rows).to_csv(os.path.join(d, "user_action.csv"), index=False)
    pd.DataFrame(
        dict(
            feedid=[10, 11, 12, 13],
            authorid=[100, 100, 101, 102],
            videoplayseconds=[30, 60, 15, 45],
            bgm_song_id=[7, None, 8, None],
            bgm_singer_id=[70, None, 80, None],
            manual_tag_list=["1;2", "2", None, "3;1"],
        )
    ).to_csv(os.path.join(d, "feed_info.csv"), index=False)


def write_douban_csvs(d) -> None:
    """``ratings.csv`` and ``movies.csv`` of ``tests/test_etl.py``'s
    ``douban_dir`` fixture: 6 users, 40 ratings each, 14 movies, seed 0."""
    rng = np.random.default_rng(0)
    rows = []
    for u in [f"u{i}" for i in range(6)]:
        t = pd.Timestamp("2018-06-01")
        for _ in range(40):
            t = t + pd.Timedelta(days=int(rng.integers(3, 20)))
            rows.append(dict(USER_MD5=u, MOVIE_ID=int(rng.integers(1, 15)),
                             RATING=float(rng.integers(1, 6)), RATING_TIME=t))
    pd.DataFrame(rows).to_csv(os.path.join(d, "ratings.csv"), index=False)
    pd.DataFrame(
        dict(
            MOVIE_ID=list(range(1, 15)),
            GENRES=["动作/喜剧"] * 14,
            ACTOR_IDS=["a1|a2"] * 14,
            DIRECTOR_IDS=["d1|d2"] * 14,
            LANGUAGES=["汉语 / 英语"] * 14,
            REGIONS=["中国 / 美国"] * 14,
            YEAR=[2000 + i % 3 for i in range(14)],
        )
    ).to_csv(os.path.join(d, "movies.csv"), index=False)


@pytest.fixture(scope="module")
def wechat(tmp_path_factory):
    """(CSV dir, JAX ETL's out dir, the port ETL's out dir)."""
    csvs = tmp_path_factory.mktemp("wechat_csv")
    write_wechat_csvs(csvs)
    jax_out, port_out = tmp_path_factory.mktemp("jax_etl"), tmp_path_factory.mktemp("port_etl")
    JaxWeChatETL(str(csvs), str(jax_out)).run()
    WeChatETL(str(csvs), str(port_out)).run()
    return csvs, jax_out, port_out


def assert_same_arrays(got: dict, want: dict) -> None:
    assert sorted(got) == sorted(want)
    for key, value in want.items():
        assert got[key].dtype == value.dtype, key
        np.testing.assert_array_equal(got[key], value, err_msg=key)


def vocab_sizes(schema) -> dict:
    return {f.name: f.vocab_size for f in (*schema.categorical, *schema.sequence)}


def npz_arrays(path) -> dict:
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def test_wechat_vocabulary_files_byte_identical(wechat):
    _, jax_out, port_out = wechat
    names = sorted(os.listdir(jax_out / "vocabulary"))
    assert "feedid.txt" in names and "VOCAB_FILE_ALREADY" in names
    assert sorted(os.listdir(port_out / "vocabulary")) == names
    for name in names:
        assert (port_out / "vocabulary" / name).read_bytes() == \
            (jax_out / "vocabulary" / name).read_bytes(), name


@pytest.mark.parametrize("name", FEATURE_PICKLES)
def test_wechat_feature_pickles_equal(wechat, name):
    _, jax_out, port_out = wechat
    want = pd.read_pickle(jax_out / "features" / name)
    assert len(want) > 0
    pd.testing.assert_frame_equal(pd.read_pickle(port_out / "features" / name), want)


@pytest.mark.parametrize("split", SPLITS)
def test_wechat_parquet_frames_equal(wechat, split):
    _, jax_out, port_out = wechat
    want = pd.read_parquet(jax_out / "dataframe" / f"{split}.parquet")
    assert len(want) > 0
    pd.testing.assert_frame_equal(
        pd.read_parquet(port_out / "dataframe" / f"{split}.parquet"), want)


@pytest.mark.parametrize("split", SPLITS)
def test_wechat_npz_arrays_equal(wechat, split):
    _, jax_out, port_out = wechat
    want = npz_arrays(jax_out / "arrays" / f"{split}.npz")
    assert want["labels"].shape[1] == 7 and want["his_read_comment_7d_seq"].shape[1] == 50
    assert_same_arrays(npz_arrays(port_out / "arrays" / f"{split}.npz"), want)


def test_wechat_rerun_is_idempotent(wechat):
    """The sentinels make a second run a no-op, on the port as on JAX."""
    csvs, _, port_out = wechat
    paths = [port_out / "dataframe" / "train.parquet", port_out / "arrays" / "train.npz",
             port_out / "vocabulary" / "feedid.txt", port_out / "features" / FEATURE_PICKLES[0]]
    before = [os.path.getmtime(p) for p in paths]
    WeChatETL(str(csvs), str(port_out)).run()
    assert [os.path.getmtime(p) for p in paths] == before


def test_wechat_etl_runs_as_a_module(wechat, tmp_path):
    """``python -m rank_tpu_torch.data.etl`` writes what ``WeChatETL.run`` does."""
    import subprocess
    import sys

    csvs, jax_out, _ = wechat
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {**os.environ, "PYTHONPATH": os.pathsep.join([root, os.environ.get("PYTHONPATH", "")])}
    subprocess.run([sys.executable, "-m", "rank_tpu_torch.data.etl", f"--dataset_dir={csvs}",
                    f"--out_path={tmp_path}"], check=True, env=env, timeout=120)
    assert_same_arrays(npz_arrays(tmp_path / "arrays" / "test.npz"),
                       npz_arrays(jax_out / "arrays" / "test.npz"))


@pytest.fixture(scope="module")
def douban(tmp_path_factory):
    csvs = tmp_path_factory.mktemp("douban_csv")
    write_douban_csvs(csvs)
    jax_out, port_out = tmp_path_factory.mktemp("jax_douban"), tmp_path_factory.mktemp("port_douban")
    JaxDoubanETL(str(csvs), str(jax_out)).run()
    DoubanETL(str(csvs), str(port_out)).run()
    return jax_out, port_out


def test_douban_vocabulary_files_byte_identical(douban):
    jax_out, port_out = douban
    assert CATEGORY_COLUMNS == JAX_DOUBAN_COLUMNS
    for col in CATEGORY_COLUMNS:
        assert (port_out / f"{col}.txt").read_bytes() == (jax_out / f"{col}.txt").read_bytes(), col
    assert (jax_out / "GENRES.txt").read_text(encoding="utf-8").split() == ["动作", "喜剧"]


@pytest.mark.parametrize("split", SPLITS)
def test_douban_parquet_frames_equal(douban, split):
    jax_out, port_out = douban
    want = pd.read_parquet(jax_out / f"{split}.parquet")
    assert len(want) > 0 and "HISTORY_MOVIES" in want.columns
    pd.testing.assert_frame_equal(pd.read_parquet(port_out / f"{split}.parquet"), want)


# -- the slice as a whole ---------------------------------------------------------


@pytest.mark.parametrize("fmt", ["npz", "parquet"])
def test_load_split_matches_jax(wechat, fmt):
    """Each CLI's ``_load_split`` of the JAX ETL's files, with its own
    vocabulary-sized schema: the same arrays, and the same schema."""
    _, jax_out, _ = wechat
    vocab = str(jax_out / "vocabulary")
    schema = schema_from_vocab_dir(WECHAT_SCHEMA, vocab)
    jax_schema = jax_schema_from_vocab_dir(JAX_WECHAT, vocab)
    assert vocab_sizes(schema) == vocab_sizes(jax_schema)
    assert vocab_sizes(schema)["feedid"] == 5  # 4 feeds + the OOV row
    sub = "arrays" if fmt == "npz" else "dataframe"
    for split in SPLITS:
        path = str(jax_out / sub / f"{split}.{fmt}")
        assert_same_arrays(_load_split(path, schema, vocab), jax_load_split(path, jax_schema, vocab))


@pytest.mark.parametrize("name", ["xdeepfm", "din"])
def test_etl_files_train_as_jax(wechat, name):
    """Small-width xDeepFM and DIN on the JAX ETL's train split, loaded by
    each side's ``_load_split`` at the vocabulary-sized schema, from the
    same weights: logits within 1e-4, then ``check_train_step_parity``
    (loss and every gradient at step 1, every parameter after 3 Adam steps,
    rtol 1e-4 / atol 1e-5) over 3 batches of 8 rows (the split has about
    40)."""
    _, jax_out, _ = wechat
    vocab = str(jax_out / "vocabulary")
    schema = schema_from_vocab_dir(WECHAT_SCHEMA, vocab)
    jax_schema = jax_schema_from_vocab_dir(JAX_WECHAT, vocab)
    path = str(jax_out / "arrays" / "train.npz")
    data = _load_split(path, schema, vocab)
    assert_same_arrays(data, jax_load_split(path, jax_schema, vocab))
    assert data["labels"].shape[0] >= 24

    overrides = PARITY_OVERRIDES[name]
    batch = {k: v[:8] for k, v in data.items()}
    jax_model = jax_build_model(jax_schema, jax_default_config(name, **overrides))
    variables = nn.meta.unbox(jax.jit(lambda r, b: jax_model.init(r, b, train=False))(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
        {k: jnp.asarray(v) for k, v in batch.items()}))
    variables = jax.tree_util.tree_map(np.asarray, dict(variables))
    want = jax_model.apply(variables, {k: jnp.asarray(v) for k, v in batch.items()}, train=False)
    model = build_model(schema, default_config(name, **overrides), device="cpu")
    model.load_state_dict(state_dict_from_flax(model, variables))
    model.eval()
    with torch.no_grad():
        got = model({k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(got["logits"].numpy(), np.asarray(want["logits"]),
                               rtol=1e-4, atol=1e-4)

    lr = 0.005
    noise = bn_fed_bias_noise("dnn", 2, lr) if name == "xdeepfm" else {"attention.b3": 3 * lr}
    check_train_step_parity(name, overrides, noise, lr,
                            schemas=(schema, jax_schema), data=data, batch_size=8)
