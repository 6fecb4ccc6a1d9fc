"""Feature schema registry (the port's own copy of ``rank_tpu/features.py``).

The module needs nothing of JAX, but ``import rank_tpu.features`` runs
``rank_tpu/__init__.py``, which imports flax; so the port keeps this copy
and the tests hold the two equal.

Replaces the reference's eight hand-copied feature-column lists (e.g.
``algorithm/AFM/afm.py:121-156`` ``create_feature_columns``, the hardcoded
``dense_features`` / ``category_features`` lists in
``algorithm/DIN/din.py:104-119`` and friends) with a single declarative
schema shared by the ETL, the input pipeline, the embedding collection and
every model.

Conventions preserved from the reference:
  * every categorical vocabulary gets one extra row at index 0 for
    out-of-vocabulary tokens (``algorithm/DeepFM/deepfm.py:80-86``,
    ``algorithm/DIN/din.py:140-143``): vocab token at file line ``i`` maps
    to embedding row ``i + 1``; unknown tokens map to row 0.
  * per-field embedding dims follow the convention shared by the
    full-feature reference models (``din.py:251-260``, ``dcn.py:130-137``):
    userid 16, feedid 16, device 2, authorid 4, bgm_song_id 4,
    bgm_singer_id 4, manual_tag 4.
  * behaviour sequences are capped at length 50
    (``dataset/wechat_algo_data1/DataGenerator.py:273-275``) and padded to a
    fixed length with an explicit length field (TPU-friendly static shapes).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, Mapping, Optional, Sequence, Tuple


@dataclasses.dataclass(frozen=True)
class DenseFeature:
    """A float feature (already log1p-transformed by the ETL,
    ``DataGenerator.py:361-363``)."""

    name: str


@dataclasses.dataclass(frozen=True)
class CategoricalFeature:
    """A single-valued categorical feature backed by a vocabulary file.

    ``vocab_size`` INCLUDES the OOV slot at row 0 (reference ``+ 1``
    convention, ``deepfm.py:80-86``).
    """

    name: str
    vocab_size: int
    emb_dim: int
    # vocabulary file stem when it differs from the feature name
    # (manual_tag_list -> manual_tag_id.txt; afm.py:140-142).
    vocab_name: Optional[str] = None
    # another categorical feature whose embedding table this one shares
    # (DIN shares the target/ sequence feedid table; din.py:258-259).
    shares_table_with: Optional[str] = None

    @property
    def vocab_file(self) -> str:
        return (self.vocab_name or self.name) + ".txt"


@dataclasses.dataclass(frozen=True)
class SequenceFeature:
    """A padded, fixed-length id sequence with an explicit length field."""

    name: str
    vocab_size: int
    emb_dim: int
    max_len: int
    vocab_name: Optional[str] = None
    shares_table_with: Optional[str] = None

    @property
    def vocab_file(self) -> str:
        return (self.vocab_name or self.name) + ".txt"

    @property
    def length_name(self) -> str:
        return self.name + "_length"


@dataclasses.dataclass(frozen=True)
class FeatureSchema:
    """The full feature universe of a dataset.

    Models select a subset via their configs; the batch produced by the
    loader always carries every feature so one materialised dataset serves
    all 16 models.
    """

    dense: Tuple[DenseFeature, ...]
    categorical: Tuple[CategoricalFeature, ...]
    sequence: Tuple[SequenceFeature, ...]
    labels: Tuple[str, ...]

    @property
    def dense_names(self) -> List[str]:
        return [f.name for f in self.dense]

    @property
    def categorical_names(self) -> List[str]:
        return [f.name for f in self.categorical]

    @property
    def sequence_names(self) -> List[str]:
        return [f.name for f in self.sequence]

    @property
    def num_dense(self) -> int:
        return len(self.dense)

    def categorical_feature(self, name: str) -> CategoricalFeature:
        for f in self.categorical:
            if f.name == name:
                return f
        raise KeyError(f"no categorical feature named {name!r}")

    def sequence_feature(self, name: str) -> SequenceFeature:
        for f in self.sequence:
            if f.name == name:
                return f
        raise KeyError(f"no sequence feature named {name!r}")

    def with_vocab_sizes(self, sizes: Mapping[str, int]) -> "FeatureSchema":
        """Return a copy with vocab sizes replaced (sizes include OOV row)."""
        cats = tuple(
            dataclasses.replace(f, vocab_size=sizes.get(f.name, f.vocab_size))
            for f in self.categorical
        )
        seqs = tuple(
            dataclasses.replace(f, vocab_size=sizes.get(f.name, f.vocab_size))
            for f in self.sequence
        )
        return dataclasses.replace(self, categorical=cats, sequence=seqs)

    def padded_for_table_sharding(
        self, multiple: int, min_rows: int = 0
    ) -> Tuple["FeatureSchema", Dict[str, Tuple[int, int]]]:
        """Round vocab sizes up to a multiple of the table-mesh axis.

        The real WeChat vocab sizes (+1 OOV row) are ODD for exactly the
        tables that motivate row-sharding — feedid 106,445, userid 19,627,
        bgm_singer_id 17,501 — so without padding a 2-way table axis would
        silently replicate them (the GSPMD row-sharding picker requires
        divisibility). Extra rows correspond to no real id: the encoders
        never emit them, so they are gradient-dead and unreachable.

        Tables below ``min_rows`` are left alone (they stay replicated
        anyway). Returns (new_schema, {name: (old_rows, new_rows)}).
        """
        if multiple <= 1:
            return self, {}
        sizes: Dict[str, int] = {}
        report: Dict[str, Tuple[int, int]] = {}
        for f in list(self.categorical) + list(self.sequence):
            v = f.vocab_size
            if v >= min_rows and v % multiple:
                vp = ((v + multiple - 1) // multiple) * multiple
                sizes[f.name] = vp
                report[f.name] = (v, vp)
        return self.with_vocab_sizes(sizes), report

    def scaled(self, factor: float) -> "FeatureSchema":
        """Schema with vocab sizes scaled down — for tests/synthetic data."""
        cats = tuple(
            dataclasses.replace(f, vocab_size=max(4, int(f.vocab_size * factor)))
            for f in self.categorical
        )
        seqs = tuple(
            dataclasses.replace(f, vocab_size=max(4, int(f.vocab_size * factor)))
            for f in self.sequence
        )
        return dataclasses.replace(self, categorical=cats, sequence=seqs)


# ---------------------------------------------------------------------------
# WeChat Channels competition dataset (wechat_algo_data1)
# ---------------------------------------------------------------------------

# 16 dense features, order matches DataGenerator.py:72-89.
WECHAT_DENSE = (
    "videoplayseconds",
    "u_read_comment_7d_sum",
    "u_like_7d_sum",
    "u_click_avatar_7d_sum",
    "u_forward_7d_sum",
    "u_comment_7d_sum",
    "u_follow_7d_sum",
    "u_favorite_7d_sum",
    "i_read_comment_7d_sum",
    "i_like_7d_sum",
    "i_click_avatar_7d_sum",
    "i_forward_7d_sum",
    "i_comment_7d_sum",
    "i_follow_7d_sum",
    "i_favorite_7d_sum",
    "c_user_author_read_comment_7d_sum",
)

# 7 action labels, order matches DataGenerator.py:99-107.
WECHAT_LABELS = (
    "read_comment",
    "comment",
    "like",
    "click_avatar",
    "forward",
    "follow",
    "favorite",
)

# Checked-in vocabulary sizes (`wc -l` over dataset/wechat_algo_data1/
# vocabulary/*.txt), +1 OOV row each.
_WECHAT_VOCAB_ROWS = {
    "userid": 19_626,
    "feedid": 106_444,
    "device": 2,
    "authorid": 18_789,
    "bgm_song_id": 25_159,
    "bgm_singer_id": 17_500,
    "manual_tag_list": 350,
}

MAX_HIST_LEN = 50  # DataGenerator.py:273-275
MAX_TAGS = 14      # longest manual_tag_list in feed_info

WECHAT_SCHEMA = FeatureSchema(
    dense=tuple(DenseFeature(n) for n in WECHAT_DENSE),
    categorical=(
        CategoricalFeature("userid", _WECHAT_VOCAB_ROWS["userid"] + 1, 16),
        CategoricalFeature("feedid", _WECHAT_VOCAB_ROWS["feedid"] + 1, 16),
        CategoricalFeature("device", _WECHAT_VOCAB_ROWS["device"] + 1, 2),
        CategoricalFeature("authorid", _WECHAT_VOCAB_ROWS["authorid"] + 1, 4),
        CategoricalFeature("bgm_song_id", _WECHAT_VOCAB_ROWS["bgm_song_id"] + 1, 4),
        CategoricalFeature("bgm_singer_id", _WECHAT_VOCAB_ROWS["bgm_singer_id"] + 1, 4),
        CategoricalFeature(
            "manual_tag_list",
            _WECHAT_VOCAB_ROWS["manual_tag_list"] + 1,
            4,
            vocab_name="manual_tag_id",
        ),
    ),
    sequence=(
        SequenceFeature(
            "his_read_comment_7d_seq",
            _WECHAT_VOCAB_ROWS["feedid"] + 1,
            16,
            MAX_HIST_LEN,
            vocab_name="feedid",
            shares_table_with="feedid",
        ),
        SequenceFeature(
            "manual_tag_seq",
            _WECHAT_VOCAB_ROWS["manual_tag_list"] + 1,
            4,
            MAX_TAGS,
            vocab_name="manual_tag_id",
            shares_table_with="manual_tag_list",
        ),
    ),
    labels=WECHAT_LABELS,
)


def tiny_schema(vocab: int = 64, hist_len: int = 10) -> FeatureSchema:
    """A miniature WeChat-shaped schema for unit tests."""
    s = WECHAT_SCHEMA
    cats = tuple(
        dataclasses.replace(f, vocab_size=2 + 1 if f.name == "device" else vocab)
        for f in s.categorical
    )
    seqs = tuple(
        dataclasses.replace(f, vocab_size=vocab, max_len=hist_len)
        for f in s.sequence
    )
    return dataclasses.replace(s, categorical=cats, sequence=seqs)


# ---------------------------------------------------------------------------
# Vocabulary files
# ---------------------------------------------------------------------------

def load_vocabulary(path: str) -> List[str]:
    """Read a one-token-per-line vocabulary file (deepfm.py:46-51)."""
    if not os.path.exists(path):
        return []
    with open(path, "r") as f:
        return [line.strip() for line in f if line.strip()]


def vocab_index(tokens: Sequence[str]) -> Dict[str, int]:
    """token -> embedding row, with row 0 reserved for OOV."""
    return {tok: i + 1 for i, tok in enumerate(tokens)}


def schema_from_vocab_dir(base: FeatureSchema, vocab_dir: str) -> FeatureSchema:
    """Resize a schema's vocabularies from the files in ``vocab_dir``."""
    sizes: Dict[str, int] = {}
    for f in list(base.categorical) + list(base.sequence):
        tokens = load_vocabulary(os.path.join(vocab_dir, f.vocab_file))
        if tokens:
            sizes[f.name] = len(tokens) + 1
    return base.with_vocab_sizes(sizes)
