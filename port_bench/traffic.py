"""The one generator of the benchmark's inputs, read from a traffic mix's
parameters and a configuration's schema, and drawn on the device from a
seed.

Rows have the layout of the port's loader (``rank_tpu_torch/data/synthetic.py``):
16 dense features, the categorical ids, a history of feed ids with its
length, a tag sequence with its length, and 7 labels drawn from latent user
and feed factors. Unlike that module, which draws every id uniformly on the
host, this one draws:

  * feed ids (the target and the history) from Zipf(``feed_zipf_alpha``)
    over a seeded ranking of the feed vocabulary; each feed's author, song,
    singer and tags are fixed by a seeded map (``Catalog``);
  * users uniformly, each with a fixed device;
  * history lengths from a balanced set over 0..max_len in a seeded order,
    so every seed trains and serves the same number of valid timesteps.

Serving requests (``requests``) hold one user's features and history on
every row and a set of candidate feeds. Their sizes and arrival gaps are the
same set for every seed, in a seeded order: sizes at the quantiles of a
log-uniform law, gaps at the quantiles of an exponential law.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Tuple

import numpy as np
import torch

LATENT = 8
CHUNK_ROWS = 1 << 20  # rows drawn per call while making history ids


def derived_seeds(seed: int, n: int) -> List[int]:
    """``n`` independent 62-bit seeds from one run seed of any size."""
    state = np.random.SeedSequence(int(seed)).generate_state(2 * n, dtype=np.uint32)
    return [(int(state[2 * i]) << 30) ^ int(state[2 * i + 1]) for i in range(n)]


@dataclasses.dataclass(frozen=True)
class Layout:
    """What a configuration's ``schema`` says of the rows: table rows (the
    OOV row 0 included) and widths, and the two sequence features."""

    dense: int
    labels: Tuple[str, ...]
    tables: Dict[str, Tuple[int, int]]
    history: str
    history_table: str
    history_len: int
    tags: str
    tags_table: str
    tags_len: int

    @classmethod
    def from_config(cls, config: dict) -> "Layout":
        s = config["schema"]
        (hist, h), (tags, t) = s["sequence"].items()
        return cls(dense=s["dense"], labels=tuple(s["labels"]),
                   tables={k: tuple(v) for k, v in s["categorical"].items()},
                   history=hist, history_table=h["table"], history_len=h["max_len"],
                   tags=tags, tags_table=t["table"], tags_len=t["max_len"])

    def rows(self, table: str) -> int:
        return self.tables[table][0]


class Catalog:
    """The seeded world rows are drawn from: a Zipf law over a ranking of the
    feeds, each feed's author, song, singer and tags, each user's device,
    and the latent factors behind labels and dense features."""

    def __init__(self, layout: Layout, zipf_alpha: float, gen: torch.Generator):
        dev = gen.device
        self.layout = layout
        self.gen = gen
        feeds = layout.rows("feedid")
        self.rank_to_feed = torch.randperm(feeds - 1, generator=gen, device=dev) + 1
        pmf = torch.arange(1, feeds, dtype=torch.float64, device=dev).pow(-zipf_alpha)
        self.cdf = torch.cumsum(pmf, 0) / pmf.sum()

        def per(n: int, table: str) -> torch.Tensor:
            ids = torch.randint(1, layout.rows(table), (n,), generator=gen, device=dev)
            ids[0] = 0  # row 0 (OOV) maps to OOV
            return ids

        self.author = per(feeds, "authorid")
        self.song = per(feeds, "bgm_song_id")
        self.singer = per(feeds, "bgm_singer_id")
        self.device_of_user = per(layout.rows("userid"), "device")
        n_tags = torch.randint(1, layout.tags_len + 1, (feeds,), generator=gen, device=dev)
        tags = torch.randint(1, layout.rows(layout.tags_table), (feeds, layout.tags_len),
                             generator=gen, device=dev)
        keep = torch.arange(layout.tags_len, device=dev)[None, :] < n_tags[:, None]
        self.tags = torch.where(keep, tags, 0)
        self.n_tags = n_tags
        self.n_tags[0] = 0
        self.tags[0] = 0
        self.user_f = torch.randn(layout.rows("userid"), LATENT, generator=gen, device=dev)
        self.feed_f = torch.randn(feeds, LATENT, generator=gen, device=dev)
        self.label_w = torch.randn(LATENT, len(layout.labels), generator=gen, device=dev)

    def feeds(self, n: int) -> torch.Tensor:
        """``n`` feed ids drawn from the Zipf law."""
        u = torch.rand(n, generator=self.gen, device=self.gen.device, dtype=torch.float64)
        rank = torch.searchsorted(self.cdf, u).clamp_(max=self.cdf.numel() - 1)
        return self.rank_to_feed[rank]

    def users(self, n: int) -> torch.Tensor:
        return torch.randint(1, self.layout.rows("userid"), (n,), generator=self.gen,
                             device=self.gen.device)

    def histories(self, lengths: torch.Tensor) -> torch.Tensor:
        """(n, max_len) Zipf feed ids, zero past each row's length."""
        t = self.layout.history_len
        out = torch.empty((lengths.numel(), t), dtype=torch.int32, device=lengths.device)
        steps = torch.arange(t, device=lengths.device)[None, :]
        for a in range(0, lengths.numel(), CHUNK_ROWS):
            n = min(CHUNK_ROWS, lengths.numel() - a)
            ids = self.feeds(n * t).view(n, t)
            out[a:a + n] = torch.where(steps < lengths[a:a + n, None], ids, 0)
        return out

    def rows(self, users: torch.Tensor, feeds: torch.Tensor, hist: torch.Tensor,
             lengths: torch.Tensor, labels: bool = True) -> Dict[str, torch.Tensor]:
        """The loader's columns for rows of (user, candidate feed, history)."""
        lay, gen, n = self.layout, self.gen, users.numel()
        uf, ff = self.user_f[users], self.feed_f[feeds]
        affinity = (uf * ff).sum(-1)
        out: Dict[str, torch.Tensor] = {}
        noise = torch.randn(n, lay.dense, generator=gen, device=gen.device)
        rate = torch.exp(0.6 * affinity[:, None] + 0.3 * noise)
        out["dense"] = torch.log1p(torch.poisson(rate, generator=gen))
        i32 = lambda x: x.to(torch.int32)  # noqa: E731
        out["userid"] = i32(users)
        out["feedid"] = i32(feeds)
        out["device"] = i32(self.device_of_user[users])
        out["authorid"] = i32(self.author[feeds])
        out["bgm_song_id"] = i32(self.song[feeds])
        out["bgm_singer_id"] = i32(self.singer[feeds])
        out["manual_tag_list"] = i32(self.tags[feeds, 0])
        out[lay.history] = i32(hist)
        out[lay.history + "_length"] = i32(lengths)
        out[lay.tags] = i32(self.tags[feeds])
        out[lay.tags + "_length"] = i32(self.n_tags[feeds])
        if labels:
            logit = (uf + ff) @ self.label_w / math.sqrt(2 * LATENT) + 0.5 * affinity[:, None]
            bias = torch.linspace(-2.5, -3.5, len(lay.labels), device=gen.device)
            prob = torch.sigmoid(logit + bias)
            out["labels"] = (torch.rand(prob.shape, generator=gen, device=gen.device)
                             < prob).float()
        return out


def balanced(n: int, top: int, gen: torch.Generator) -> torch.Tensor:
    """0..top, each equally often (``i mod (top + 1)``), in a seeded order."""
    perm = torch.randperm(n, generator=gen, device=gen.device)
    return torch.arange(n, device=gen.device)[perm] % (top + 1)


def train_rows(catalog: Catalog, n: int) -> Dict[str, torch.Tensor]:
    """``n`` training rows on the device."""
    lengths = balanced(n, catalog.layout.history_len, catalog.gen)
    return catalog.rows(catalog.users(n), catalog.feeds(n), catalog.histories(lengths), lengths)


def log_uniform_sizes(n: int, lo: int, hi: int) -> np.ndarray:
    """``n`` sizes at the mid quantiles of a log-uniform law on [lo, hi]."""
    q = (np.arange(n) + 0.5) / n
    return np.rint(lo * (hi / lo) ** q).astype(np.int64)


def exponential_gaps(n: int, rate: float) -> np.ndarray:
    """``n`` gaps, seconds, at the mid quantiles of Exp(rate)."""
    q = (np.arange(n) + 0.5) / n
    return -np.log1p(-q) / rate


@dataclasses.dataclass
class Requests:
    """Requests as a client sends them: host numpy columns, request i being
    rows ``offsets[i]:offsets[i + 1]``, due ``due[i]`` seconds after the
    window opens; ``history_len[i]`` is its user's history length."""

    columns: Dict[str, np.ndarray]
    offsets: np.ndarray
    due: np.ndarray
    history_len: np.ndarray

    def __len__(self) -> int:
        return len(self.due)

    def batch(self, i: int) -> Dict[str, np.ndarray]:
        a, b = self.offsets[i], self.offsets[i + 1]
        return {k: v[a:b] for k, v in self.columns.items()}

    def rows(self, i: int) -> int:
        return int(self.offsets[i + 1] - self.offsets[i])


def requests(catalog: Catalog, n: int, rate: float, lo: int, hi: int) -> Requests:
    """``n`` requests of one user each, with log-uniform candidate counts in
    [lo, hi] and Poisson arrivals at ``rate`` a second."""
    gen, dev = catalog.gen, catalog.gen.device
    order = torch.randperm(n, generator=gen, device=dev).cpu().numpy()
    sizes = log_uniform_sizes(n, lo, hi)[order]
    gaps = exponential_gaps(n, rate)[torch.randperm(n, generator=gen, device=dev).cpu().numpy()]
    lengths = balanced(n, catalog.layout.history_len, gen)
    users, hist = catalog.users(n), catalog.histories(lengths)
    of_row = torch.repeat_interleave(torch.arange(n, device=dev),
                                     torch.as_tensor(sizes, device=dev))
    cols = catalog.rows(users[of_row], catalog.feeds(of_row.numel()), hist[of_row],
                        lengths[of_row], labels=False)
    offsets = np.concatenate([[0], np.cumsum(sizes)])
    return Requests({k: v.cpu().numpy() for k, v in cols.items()}, offsets,
                    np.cumsum(gaps), lengths.cpu().numpy())
