"""The generator: the same seed gives the same inputs; every seed the same
sizes, lengths and arrival gaps in another order; ids in their tables."""

import numpy as np
import torch

from port_bench import traffic as T
from port_bench.tests import tiny


def _catalog(seed, vocab=500):
    layout = T.Layout.from_config(tiny.config("din-wechat", vocab=vocab))
    return T.Catalog(layout, 1.1, torch.Generator().manual_seed(seed))


def test_rows_repeat_from_the_seed_and_differ_between_seeds():
    a = T.train_rows(_catalog(7), 2000)
    b = T.train_rows(_catalog(7), 2000)
    c = T.train_rows(_catalog(8), 2000)
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k
    assert not torch.equal(a["feedid"], c["feedid"])


def test_rows_hold_the_loader_layout_within_the_tables():
    cat = _catalog(3)
    rows = T.train_rows(cat, 3000)
    lay = cat.layout
    assert rows["dense"].shape == (3000, lay.dense) and rows["dense"].dtype == torch.float32
    assert rows["labels"].shape == (3000, len(lay.labels))
    for name in ("userid", "feedid", "device", "authorid", "bgm_song_id", "bgm_singer_id",
                 "manual_tag_list"):
        assert rows[name].dtype == torch.int32
        assert 0 <= int(rows[name].min()) and int(rows[name].max()) < lay.rows(name), name
    hist, n = rows[lay.history], rows[lay.history + "_length"]
    steps = torch.arange(lay.history_len)[None, :]
    assert bool(((hist > 0) == (steps < n[:, None])).all())  # ids exactly where valid
    tags, nt = rows[lay.tags], rows[lay.tags + "_length"]
    assert bool(((tags > 0) == (torch.arange(lay.tags_len)[None, :] < nt[:, None])).all())
    assert torch.equal(rows["manual_tag_list"], tags[:, 0])


def test_every_seed_trains_the_same_history_lengths():
    a = T.train_rows(_catalog(1), 5100)
    b = T.train_rows(_catalog(2), 5100)
    key = _catalog(1).layout.history + "_length"
    assert torch.equal(torch.sort(a[key]).values, torch.sort(b[key]).values)
    assert not torch.equal(a[key], b[key])


def test_feed_ids_are_skewed_by_zipf():
    cat = _catalog(5, vocab=2000)
    counts = torch.bincount(cat.feeds(200_000), minlength=2000)[1:].sort(descending=True).values
    assert counts[0] > 50 * max(int(counts[1000]), 1)
    assert int(counts.sum()) == 200_000


def test_requests_share_sizes_and_gaps_across_seeds():
    a = T.requests(_catalog(1), 200, 100.0, 16, 4096)
    b = T.requests(_catalog(2), 200, 100.0, 16, 4096)
    size_a, size_b = np.diff(a.offsets), np.diff(b.offsets)
    assert sorted(size_a) == sorted(size_b) and not np.array_equal(size_a, size_b)
    assert np.allclose(np.sort(np.diff(a.due, prepend=0)), np.sort(np.diff(b.due, prepend=0)))
    assert size_a.min() >= 16 and size_a.max() <= 4096
    assert np.mean(size_a <= 256) == 0.5  # half fall in the 256 bucket
    assert abs(a.due[-1] - 2.0) < 0.1     # 200 requests at 100/s span about 2 s


def test_a_request_holds_one_user_and_history_on_every_row():
    r = T.requests(_catalog(4), 30, 50.0, 4, 64)
    lay = _catalog(4).layout
    for i in range(len(r)):
        b = r.batch(i)
        assert b["userid"].shape[0] == r.rows(i)
        assert len(set(b["userid"].tolist())) == 1
        assert (b[lay.history] == b[lay.history][0]).all()
        assert (b[lay.history + "_length"] == r.history_len[i]).all()
        assert "labels" not in b


def test_derived_seeds_take_large_seeds():
    s = T.derived_seeds(2**33 + 5, 4)
    assert len(set(s)) == 4 and all(0 <= x < 2**62 for x in s)
    assert s == T.derived_seeds(2**33 + 5, 4)
