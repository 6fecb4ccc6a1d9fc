"""Offline ETL for the WeChat Channels competition dataset (the port's
copy of ``rank_tpu/data/etl.py``; the tests hold the two to the same
files).

    python -m rank_tpu_torch.data.etl --dataset_dir=<csvs> --out_path=<out>

Reproduces the semantics of ``dataset/wechat_algo_data1/DataGenerator.py``
(steps 1-6, lines 63-467) as a vectorised, reproducible host job:

  1. load ``user_action.csv`` + ``feed_info.csv``          (:135-145)
  2. prefix-encode ids (``userid_8`` etc.)                 (:147-166)
  3. vocabulary txt files, first-occurrence order          (:168-222)
  4. 7-day sliding-window features for date_ 8..14         (:225-340):
     user action sums, user read_comment feedid sequence (last 50),
     item action sums, user-x-author read_comment sum (>0 rows only)
  5. join into the sample table, log1p dense, join seqs,
     split train (date_ 8-13) / test (date_ 14) parquet    (:342-379)
  6. array dump: encoded .npz per split (replaces the torch
     ``dataset.pt``/``vocab_dict.pkl`` dump, :381-467, with the
     loader-ready layout used by every model)

Differences (documented):
  * vectorised groupbys instead of iterrows loops — same outputs, ~10x
    faster on the 70M-row action log;
  * the array dump uses the dedicated-OOV-row encoding (see
    data/encode.py) rather than the reference's OOV/first-token collision;
  * idempotency sentinels keep the reference's names (:174,233,345,384).
"""

from __future__ import annotations

import os
from typing import List

import numpy as np
import pandas as pd

from ..features import WECHAT_SCHEMA, schema_from_vocab_dir
from .encode import encode_dataframe, save_npz

ACTION_COLUMNS = [
    "read_comment", "like", "click_avatar", "forward", "comment",
    "follow", "favorite",
]
END_DAY = 14


class WeChatETL:
    def __init__(self, dataset_dir: str = "./", out_path: str = "./"):
        self.dataset_dir = dataset_dir
        self.out_path = out_path
        self.vocab_dir = os.path.join(out_path, "vocabulary")
        self.features_dir = os.path.join(out_path, "features")
        self.dataframe_dir = os.path.join(out_path, "dataframe")
        self.array_dir = os.path.join(out_path, "arrays")
        for p in (self.vocab_dir, self.features_dir, self.dataframe_dir, self.array_dir):
            os.makedirs(p, exist_ok=True)

    # -- pipeline ---------------------------------------------------------

    def run(self) -> None:
        if not self._done(self.dataframe_dir, "DATAFRAME_ALREADY"):
            self._load()
            self._preprocess()
        self.generate_vocabulary()
        self.generate_features()
        self.generate_dataframe()
        self.generate_arrays()

    @staticmethod
    def _done(d: str, sentinel: str) -> bool:
        return os.path.exists(os.path.join(d, sentinel))

    @staticmethod
    def _mark(d: str, sentinel: str) -> None:
        with open(os.path.join(d, sentinel), "w"):
            pass

    # -- steps 1-2 --------------------------------------------------------

    def _load(self) -> None:
        self.user_action = pd.read_csv(
            os.path.join(self.dataset_dir, "user_action.csv")
        )
        self.feed_info = pd.read_csv(
            os.path.join(self.dataset_dir, "feed_info.csv"),
            usecols=[
                "feedid", "authorid", "videoplayseconds",
                "bgm_song_id", "bgm_singer_id", "manual_tag_list",
            ],
        )

    def _preprocess(self) -> None:
        fi = self.feed_info
        fi["feedid"] = "feedid_" + fi["feedid"].astype(str)
        fi["authorid"] = "authorid_" + fi["authorid"].astype(str)
        # nullable ints: keep NaN, prefix the rest (DataGenerator.py:153-160)
        for col in ("bgm_song_id", "bgm_singer_id"):
            vals = fi[col].astype("Int64")
            fi[col] = np.where(
                vals.isna(), np.nan, col + "_" + vals.astype(str)
            )
        fi["manual_tag_list"] = fi["manual_tag_list"].apply(
            lambda s: ["manual_tag_id_" + t for t in s.split(";")]
            if isinstance(s, str) and s
            else np.nan
        )
        ua = self.user_action
        ua["userid"] = "userid_" + ua["userid"].astype(str)
        ua["feedid"] = "feedid_" + ua["feedid"].astype(str)
        ua["device"] = "device_" + ua["device"].astype(str)

    # -- step 3: vocabularies --------------------------------------------

    def generate_vocabulary(self) -> None:
        if self._done(self.vocab_dir, "VOCAB_FILE_ALREADY"):
            return
        scope = self.user_action[self.user_action["date_"].between(8, END_DAY)]

        def first_occurrence(series) -> List[str]:
            return list(dict.fromkeys(x for x in series if isinstance(x, str)))

        vocabs = {
            "userid": first_occurrence(scope["userid"]),
            "device": first_occurrence(scope["device"]),
            "feedid": first_occurrence(self.feed_info["feedid"]),
            "authorid": first_occurrence(self.feed_info["authorid"]),
            "bgm_song_id": first_occurrence(self.feed_info["bgm_song_id"]),
            "bgm_singer_id": first_occurrence(self.feed_info["bgm_singer_id"]),
        }
        tags: List[str] = []
        seen = set()
        for tag_list in self.feed_info["manual_tag_list"]:
            if isinstance(tag_list, list):
                for t in tag_list:
                    if t not in seen:
                        seen.add(t)
                        tags.append(t)
        vocabs["manual_tag_id"] = tags
        for name, tokens in vocabs.items():
            with open(os.path.join(self.vocab_dir, name + ".txt"), "w") as f:
                for tok in tokens:
                    f.write(tok + "\n")
        self._mark(self.vocab_dir, "VOCAB_FILE_ALREADY")

    # -- step 4: windowed features ---------------------------------------

    def generate_features(self, start_day: int = 1, window: int = 7) -> None:
        if self._done(self.features_dir, "FEATURES_PKL_ALREADY"):
            return
        ua = self.user_action

        def windows():
            return range(start_day, END_DAY - window + 1)

        # user action sums over the window (DataGenerator.py:240-260)
        frames = []
        for start in windows():
            w = ua[(ua["date_"] >= start) & (ua["date_"] < start + window)]
            agg = w.groupby("userid")[ACTION_COLUMNS].sum().reset_index()
            agg.columns = ["userid"] + [
                f"u_{c}_7d_sum" for c in ACTION_COLUMNS
            ]
            agg["date_"] = start + window
            frames.append(agg)
        pd.concat(frames, ignore_index=True).to_pickle(
            os.path.join(self.features_dir, "user_agg_features.pkl")
        )

        # user read_comment feedid sequence, last 50 (:263-279)
        frames = []
        for start in windows():
            w = ua[
                (ua["date_"] >= start)
                & (ua["date_"] < start + window)
                & (ua["read_comment"] == 1)
            ]
            seq = (
                w.groupby("userid")["feedid"]
                .agg(lambda s: list(s)[-50:])
                .reset_index()
                .rename(columns={"feedid": "his_read_comment_7d_seq"})
            )
            seq["date_"] = start + window
            frames.append(seq)
        pd.concat(frames, ignore_index=True).to_pickle(
            os.path.join(self.features_dir, "user_seq_features.pkl")
        )

        # item action sums (:284-305)
        frames = []
        for start in windows():
            w = ua[(ua["date_"] >= start) & (ua["date_"] < start + window)]
            agg = w.groupby("feedid")[ACTION_COLUMNS].sum().reset_index()
            agg.columns = ["feedid"] + [
                f"i_{c}_7d_sum" for c in ACTION_COLUMNS
            ]
            agg["date_"] = start + window
            frames.append(agg)
        pd.concat(frames, ignore_index=True).to_pickle(
            os.path.join(self.features_dir, "feed_agg_features.pkl")
        )

        # user x author read_comment sum, positive rows only (:306-337)
        cross_base = ua[["userid", "feedid", "date_", "read_comment"]].merge(
            self.feed_info[["feedid", "authorid"]], on="feedid", how="left"
        )[["userid", "authorid", "date_", "read_comment"]]
        frames = []
        for start in windows():
            w = cross_base[
                (cross_base["date_"] >= start)
                & (cross_base["date_"] < start + window)
            ]
            agg = (
                w.groupby(["userid", "authorid"])["read_comment"]
                .sum()
                .reset_index()
                .rename(
                    columns={"read_comment": "c_user_author_read_comment_7d_sum"}
                )
            )
            agg = agg[agg["c_user_author_read_comment_7d_sum"] > 0]
            agg["date_"] = start + window
            frames.append(agg)
        pd.concat(frames, ignore_index=True).to_pickle(
            os.path.join(self.features_dir, "cross_agg_features.pkl")
        )
        self._mark(self.features_dir, "FEATURES_PKL_ALREADY")

    # -- step 5: sample table --------------------------------------------

    def generate_dataframe(self) -> None:
        if self._done(self.dataframe_dir, "DATAFRAME_ALREADY"):
            return
        ua = self.user_action[self.user_action["date_"].between(8, END_DAY)]
        load = lambda n: pd.read_pickle(os.path.join(self.features_dir, n))
        ua = ua.merge(self.feed_info, on="feedid", how="left")
        ua = ua.merge(load("user_agg_features.pkl"), on=["userid", "date_"], how="left")
        ua = ua.merge(load("user_seq_features.pkl"), on=["userid", "date_"], how="left")
        ua = ua.merge(load("feed_agg_features.pkl"), on=["feedid", "date_"], how="left")
        ua = ua.merge(
            load("cross_agg_features.pkl"),
            on=["userid", "authorid", "date_"],
            how="left",
        )
        for col in WECHAT_SCHEMA.dense_names:
            ua[col] = np.log1p(ua[col].fillna(0))  # DataGenerator.py:361-363
        for col in ("his_read_comment_7d_seq", "manual_tag_list"):
            ua[col] = ua[col].apply(
                lambda x: ",".join(x)
                if isinstance(x, (list, np.ndarray))
                else (str(x) if pd.notna(x) else "")
            )
        train = ua[ua["date_"].between(8, 13)]
        test = ua[ua["date_"] == END_DAY]
        train.to_parquet(os.path.join(self.dataframe_dir, "train.parquet"))
        test.to_parquet(os.path.join(self.dataframe_dir, "test.parquet"))
        self._mark(self.dataframe_dir, "DATAFRAME_ALREADY")

    # -- step 6: array dump ----------------------------------------------

    def generate_arrays(self) -> None:
        if self._done(self.array_dir, "ARRAYS_ALREADY"):
            return
        schema = schema_from_vocab_dir(WECHAT_SCHEMA, self.vocab_dir)
        for split in ("train", "test"):
            df = pd.read_parquet(
                os.path.join(self.dataframe_dir, f"{split}.parquet")
            )
            arrays = encode_dataframe(df, schema, self.vocab_dir)
            save_npz(os.path.join(self.array_dir, f"{split}.npz"), arrays)
        self._mark(self.array_dir, "ARRAYS_ALREADY")


if __name__ == "__main__":
    import argparse

    p = argparse.ArgumentParser()
    p.add_argument("--dataset_dir", default="./")
    p.add_argument("--out_path", default="./")
    a = p.parse_args()
    WeChatETL(a.dataset_dir, a.out_path).run()
