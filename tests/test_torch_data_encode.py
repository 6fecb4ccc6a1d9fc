"""The port's host data plane and encoder (``rank_tpu_torch.native``,
``rank_tpu_torch.data.encode``) held against the JAX package's, and the
port's CLI on files, on the CPU.

The native library must give the JAX library's ids and rows bit for bit,
and so must the numpy paths the dispatchers take where it refuses (a
token holding a newline, a non-contiguous array, negative indices). The
CLI cases run the port's ``main`` on the WeChat ETL's files (made by the
JAX ETL from ``tests/test_etl.py``'s miniature dataset) and on
``--synthetic_calibrated``.
"""

import os
import subprocess
import sys

import numpy as np
import pandas as pd
import pytest
import torch

from rank_tpu import native as jax_native
from rank_tpu.data import encode as JE
from rank_tpu.data.etl import WeChatETL as JaxWeChatETL
from rank_tpu.features import WECHAT_SCHEMA as JAX_WECHAT
from rank_tpu.features import schema_from_vocab_dir as jax_schema_from_vocab_dir
from rank_tpu_torch import WECHAT_SCHEMA, Predictor, default_config
from rank_tpu_torch import native
from rank_tpu_torch.cli import main
from rank_tpu_torch.data import encode as E
from rank_tpu_torch.features import schema_from_vocab_dir, vocab_index
from test_torch_data_etl import assert_same_arrays, write_wechat_csvs

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def vocab():
    tokens = [f"feedid_{i}" for i in range(500)] + ["uni_日本語", "space token"]
    return tokens, vocab_index(tokens)


def _rand_rows(rng, tokens, n, p_oov=0.2, p_missing=0.1):
    rows = []
    for _ in range(n):
        u = rng.random()
        if u < p_missing:
            rows.append(rng.choice([None, float("nan"), 3.5]))
        elif u < p_missing + p_oov:
            rows.append("oov_" + str(rng.integers(1 << 20)))
        else:
            rows.append(tokens[rng.integers(len(tokens))])
    return rows


def test_native_library_builds():
    """The port's library compiles from ``native/src`` and loads, as the JAX one does."""
    assert jax_native.available()
    assert native.available()
    assert native._LIB_PATH != jax_native._LIB_PATH


def test_vocab_size_and_ids(vocab):
    tokens, _ = vocab
    nv, jv = native.Vocab(tokens), jax_native.Vocab(tokens)
    assert nv.size == jv.size == len(tokens)
    np.testing.assert_array_equal(nv.encode_tokens(tokens), np.arange(1, len(tokens) + 1))


def test_encode_tokens_matches_jax(vocab):
    tokens, index = vocab
    rows = _rand_rows(np.random.default_rng(0), tokens, 4000)
    want = jax_native.Vocab(tokens).encode_tokens(rows)
    np.testing.assert_array_equal(native.Vocab(tokens).encode_tokens(rows), want)
    np.testing.assert_array_equal(E._encode_tokens(rows, index), want)
    np.testing.assert_array_equal(want, JE._encode_tokens(rows, index))


def test_newline_desync(vocab):
    """A value holding a newline: the library raises on both sides, and the
    dispatcher falls back to numpy, as JAX's does; a vocabulary token
    holding one gets no native vocab at all."""
    tokens, index = vocab
    for lib in (native, jax_native):
        with pytest.raises(ValueError, match="desync"):
            lib.Vocab(tokens).encode_tokens(["a\nb", "c"])
        with pytest.raises(ValueError, match="desync"):
            lib.Vocab(tokens).encode_seq([f"{tokens[0]}\n{tokens[1]}", ""], 5)
    rows = [tokens[3], f"{tokens[1]}\n{tokens[2]}", None]
    got = E._encode_tokens(rows, index, E._native_vocab(index))
    np.testing.assert_array_equal(got, JE._encode_tokens(rows, index, JE._native_vocab(index)))
    np.testing.assert_array_equal(got, [4, 0, 0])
    seq_rows = [f"{tokens[0]},{tokens[5]}\nx", tokens[7]]
    got_ids, got_len = E._encode_seq(seq_rows, index, 4, E._native_vocab(index))
    want_ids, want_len = JE._encode_seq(seq_rows, index, 4, JE._native_vocab(index))
    np.testing.assert_array_equal(got_ids, want_ids)
    np.testing.assert_array_equal(got_len, want_len)
    bad = vocab_index(["a", "b\nc"])
    assert E._native_vocab(bad) is None and JE._native_vocab(bad) is None


@pytest.mark.parametrize("max_len", [1, 5, 50])
def test_encode_seq_matches_jax(vocab, max_len):
    tokens, index = vocab
    rng = np.random.default_rng(max_len)
    rows = []
    for _ in range(2000):
        if rng.random() < 0.1:
            rows.append(rng.choice([None, float("nan"), ""]))
            continue
        n_tok = int(rng.integers(0, 2 * max_len + 3))
        rows.append(",".join(
            tokens[rng.integers(len(tokens))] if rng.random() > 0.15
            else ("oov" if rng.random() > 0.5 else "")
            for _ in range(n_tok)))
    want_ids, want_len = jax_native.Vocab(tokens).encode_seq(rows, max_len)
    for got_ids, got_len in (native.Vocab(tokens).encode_seq(rows, max_len),
                             E._encode_seq(rows, index, max_len)):
        np.testing.assert_array_equal(got_len, want_len)
        np.testing.assert_array_equal(got_ids, want_ids)


def test_encode_seq_list_rows_and_empty_tokens(vocab):
    """list rows (pre-split ETL intermediates), an unrepresentable row (the
    numpy fallback), trailing commas and empty tokens: the dispatcher with
    the native vocab, without it, and JAX's give the same ids."""
    tokens, index = vocab
    rows = [[tokens[0], tokens[1], tokens[2]], [], [tokens[3]] * 60, [""], None,
            ",".join([tokens[5], tokens[6]]), f"{tokens[0]},", f",{tokens[1]}", ",,"]
    want_ids, want_len = JE._encode_seq(rows, index, 50, JE._native_vocab(index))
    for nvocab in (E._native_vocab(index), None):
        got_ids, got_len = E._encode_seq(rows, index, 50, nvocab)
        np.testing.assert_array_equal(got_len, want_len)
        np.testing.assert_array_equal(got_ids, want_ids)


@pytest.mark.parametrize(
    "shape,dtype",
    [((1000,), np.float32), ((1000, 16), np.float32), ((1000, 50), np.int32),
     ((1000, 7), np.float64), ((5, 3, 4), np.int8)],
)
def test_take_rows_matches_jax(shape, dtype):
    rng = np.random.default_rng(1)
    arr = (rng.random(shape) * 100).astype(dtype)
    idx = rng.integers(0, shape[0], size=257)  # with repeats
    got = native.take_rows(arr, idx)
    assert got.dtype == arr.dtype
    np.testing.assert_array_equal(got, jax_native.take_rows(arr, idx))
    np.testing.assert_array_equal(got, arr[idx])


@pytest.mark.parametrize("case", ["noncontiguous", "negative", "empty_rows"])
def test_take_rows_numpy_cases(case):
    """Where JAX takes numpy on purpose, the port does too."""
    if case == "noncontiguous":
        arr, idx = np.arange(100, dtype=np.float32).reshape(10, 10).T, np.array([3, 1, 2])
    elif case == "negative":
        arr, idx = np.arange(20, dtype=np.int64).reshape(10, 2), np.array([-1, 0, -10])
    else:
        arr, idx = np.zeros((4, 0), np.float32), np.array([0, 3])
    got = native.take_rows(arr, idx)
    np.testing.assert_array_equal(got, jax_native.take_rows(arr, idx))
    np.testing.assert_array_equal(got, arr[idx])
    with pytest.raises(IndexError):
        native.take_rows(np.arange(6).reshape(3, 2), np.array([3]))


def _write_vocab(vocab_dir, sizes):
    vocab_dir.mkdir()
    vocabs = {}
    for name, n in sizes.items():
        vocabs[name] = [f"{name}_{i}" for i in range(n)]
        (vocab_dir / f"{name}.txt").write_text("\n".join(vocabs[name]) + "\n")
    return vocabs


def test_encode_dataframe_matches_jax(tmp_path, monkeypatch):
    """A seeded frame with missing values, OOV ids and sequences longer than
    max_len: the port's arrays equal JAX's, with its native plane and
    without it."""
    rng = np.random.default_rng(7)
    sizes = {"userid": 50, "feedid": 200, "device": 2, "authorid": 30,
             "bgm_song_id": 40, "bgm_singer_id": 35, "manual_tag_id": 20}
    vocabs = _write_vocab(tmp_path / "vocabulary", sizes)
    vocab_dir = str(tmp_path / "vocabulary")
    schema = schema_from_vocab_dir(WECHAT_SCHEMA, vocab_dir)
    jax_schema = jax_schema_from_vocab_dir(JAX_WECHAT, vocab_dir)
    assert E.load_vocab_indices(schema, vocab_dir) == JE.load_vocab_indices(jax_schema, vocab_dir)

    n = 500
    df = pd.DataFrame()
    for f in schema.dense:
        df[f.name] = np.where(rng.random(n) < 0.1, np.nan, rng.random(n)).astype(np.float32)
    for f in schema.categorical:
        if f.name == "manual_tag_list":
            continue
        pool = vocabs[f.vocab_file.split(".")[0]] + ["oov_token"]
        df[f.name] = [pool[rng.integers(len(pool))] if rng.random() > 0.1 else None
                      for _ in range(n)]
    df["manual_tag_list"] = [
        ",".join(vocabs["manual_tag_id"][rng.integers(20)] for _ in range(rng.integers(0, 5)))
        for _ in range(n)]
    df["his_read_comment_7d_seq"] = [
        ",".join(vocabs["feedid"][rng.integers(200)] for _ in range(rng.integers(0, 60)))
        for _ in range(n)]
    for name in schema.labels[:-1]:  # the last label column missing: zeros
        df[name] = rng.integers(0, 2, n).astype(np.float32)

    want = JE.encode_dataframe(df, jax_schema, vocab_dir)
    assert want["his_read_comment_7d_seq_length"].max() == 50
    assert_same_arrays(E.encode_dataframe(df, schema, vocab_dir), want)
    monkeypatch.setattr(native, "available", lambda: False)
    assert_same_arrays(E.encode_dataframe(df, schema, vocab_dir), want)


def test_npz_round_trip_with_jax(tmp_path):
    """``load_npz`` reads what JAX's ``save_npz`` wrote, and the other way round."""
    rng = np.random.default_rng(3)
    data = {"dense": rng.random((9, 16)).astype(np.float32),
            "userid": rng.integers(0, 50, 9).astype(np.int32),
            "his_read_comment_7d_seq": rng.integers(0, 9, (9, 50)).astype(np.int32),
            "labels": rng.integers(0, 2, (9, 7)).astype(np.float32)}
    JE.save_npz(str(tmp_path / "jax.npz"), data)
    assert_same_arrays(E.load_npz(str(tmp_path / "jax.npz")), data)
    E.save_npz(str(tmp_path / "port.npz"), data)
    assert_same_arrays(JE.load_npz(str(tmp_path / "port.npz")), data)


# -- the CLI on files ----------------------------------------------------------------


@pytest.fixture(scope="module")
def etl_out(tmp_path_factory):
    """The JAX ETL's output of the miniature WeChat dataset."""
    csvs = tmp_path_factory.mktemp("wechat_csv")
    write_wechat_csvs(csvs)
    out = tmp_path_factory.mktemp("wechat_etl")
    JaxWeChatETL(str(csvs), str(out)).run()
    return out


def _file_flags(etl_out, fmt):
    sub = "arrays" if fmt == "npz" else "dataframe"
    return [f"--train_data={etl_out}/{sub}/train.{fmt}", f"--eval_data={etl_out}/{sub}/test.{fmt}",
            f"--vocabulary_dir={etl_out}/vocabulary"]


def _read_predictions(output_dir):
    return pd.read_csv(os.path.join(output_dir, "predictions.csv"))


def test_cli_missing_vocabulary_exits_2(etl_out, tmp_path, capsys):
    """A vocabulary dir without some of the schema's files: exit 2, the
    missing names printed, nothing trained."""
    vocab = tmp_path / "vocabulary"
    vocab.mkdir()
    for name in ("userid", "feedid", "device"):
        (vocab / f"{name}.txt").write_bytes((etl_out / "vocabulary" / f"{name}.txt").read_bytes())
    flags = _file_flags(etl_out, "npz")[:2] + [f"--vocabulary_dir={vocab}"]
    rc = main(["--model=xdeepfm", "--device=cpu", f"--model_dir={tmp_path}/m",
               f"--output_dir={tmp_path}/o", *flags])
    assert rc == 2
    err = capsys.readouterr().err
    assert "vocabulary files missing" in err
    for name in ("authorid.txt", "bgm_song_id.txt", "bgm_singer_id.txt", "manual_tag_id.txt"):
        assert name in err
    assert "userid.txt" not in err
    assert not (tmp_path / "m").exists()


@pytest.mark.parametrize("model", ["xdeepfm", "din"])
def test_cli_trains_from_npz_and_parquet(etl_out, tmp_path, model):
    """The port's CLI trains and exports from the ETL's npz arrays and from
    its parquet frames (encoded on the fly): the two give the same
    predictions, one row for each test-day row, and ``Predictor`` at the
    vocabulary-sized schema serves the saved best model to those scores.
    DIN runs the streaming loader (``--device_resident=false``)."""
    extra = ["--device_resident=false"] if model == "din" else []
    preds = {}
    for fmt in ("npz", "parquet"):
        rc = main([f"--model={model}", "--device=cpu", "--hidden_units=32,16", "--batch_size=16",
                   "--num_epochs=2", f"--model_dir={tmp_path}/{fmt}/m",
                   f"--output_dir={tmp_path}/{fmt}/o", *_file_flags(etl_out, fmt), *extra])
        assert rc == 0
        preds[fmt] = _read_predictions(tmp_path / fmt / "o")
    test = E.load_npz(str(etl_out / "arrays" / "test.npz"))
    assert len(preds["npz"]) == len(test["labels"]) > 0
    pd.testing.assert_frame_equal(preds["parquet"], preds["npz"])
    np.testing.assert_array_equal(preds["npz"].iloc[:, 0], test["labels"][:, 0])

    schema = schema_from_vocab_dir(WECHAT_SCHEMA, str(etl_out / "vocabulary"))
    pred = Predictor(schema, default_config(model, hidden_units=(32, 16)),
                     model_dir=str(tmp_path / "npz" / "m"), device="cpu")
    np.testing.assert_allclose(pred(test)["score"], preds["npz"].iloc[:, 1], rtol=1e-5, atol=1e-5)


def test_cli_synthetic_calibrated_wins_over_synthetic(tmp_path, monkeypatch):
    """``--synthetic_calibrated`` and ``--synthetic`` together train on the
    calibrated log (the JAX CLI's order), made in the port's default cache
    directory under ``TMPDIR``: the predictions cover its test day."""
    import tempfile

    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    rc = main(["--model=xdeepfm", "--device=cpu", "--hidden_units=32,16", "--batch_size=4096",
               "--synthetic=1000", "--synthetic_calibrated=0.01", f"--model_dir={tmp_path}/m",
               f"--output_dir={tmp_path}/o"])
    assert rc == 0
    cache = tmp_path / "rank_tpu_torch_calibrated"
    (tag,) = os.listdir(cache)
    test = E.load_npz(str(cache / tag / "etl" / "arrays" / "test.npz"))
    preds = _read_predictions(tmp_path / "o")
    assert len(preds) == len(test["labels"]) > 1000 * 0.15
    np.testing.assert_array_equal(preds.iloc[:, 0], test["labels"][:, 0])


@pytest.mark.parametrize("flag", ["--profile_dir", "--matmul_precision=bfloat16"])
def test_cli_file_run_takes_measurement_flags(etl_out, tmp_path, capsys, flag):
    """The file path trains with each measurement flag: ``--profile_dir``
    writes epoch 1's trace, ``--matmul_precision`` leaves the process's
    setting as it found it."""
    if flag == "--profile_dir":
        flag = f"--profile_dir={tmp_path}/trace"
    before = torch.get_float32_matmul_precision()
    assert main(["--model=din", "--device=cpu", "--hidden_units=32,16", "--batch_size=16",
                 f"--model_dir={tmp_path}/m", f"--output_dir={tmp_path}/o",
                 *_file_flags(etl_out, "parquet"), flag]) == 0
    assert torch.get_float32_matmul_precision() == before
    assert os.path.exists(tmp_path / "o" / "predictions.csv")
    if "profile_dir" in flag:
        assert os.listdir(tmp_path / "trace") == ["trace_rank0.json"]
        assert f"profile trace written to {tmp_path}/trace" in capsys.readouterr().out


def test_npz_path_needs_no_pandas(etl_out, tmp_path):
    """With pandas unimportable, the CLI still checks the vocabulary and
    trains from npz files: neither ``data/encode.py`` nor the npz branch
    of ``_load_split`` imports it."""
    code = (
        "import sys; sys.modules['pandas'] = None\n"
        "from rank_tpu_torch.cli import main\n"
        f"sys.exit(main({['--model=xdeepfm', '--device=cpu', '--hidden_units=8', '--batch_size=16', f'--model_dir={tmp_path}/m', f'--output_dir={tmp_path}/o', *_file_flags(etl_out, 'npz')]!r}))\n"
    )
    env = {**os.environ, "PYTHONPATH": os.pathsep.join([ROOT, os.environ.get("PYTHONPATH", "")])}
    done = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT, capture_output=True,
                          text=True, timeout=300)
    assert done.returncode == 0, done.stderr[-2000:]
    assert "Predictions saved to" in done.stdout
