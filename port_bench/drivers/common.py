"""What the drivers share: a run's context, the port's schema and model
configuration built from a configuration file, and device housekeeping."""

from __future__ import annotations

import dataclasses
import gc
import time
from typing import List

import torch

from .. import spec

@dataclasses.dataclass
class Context:
    cell: dict
    config: dict
    traffic: dict
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    started: float            # time.time() at the process's start
    notes: List[str] = dataclasses.field(default_factory=list)  # printed to stderr

    def work(self):
        return spec.module("work", self.config["model"])

    def reference(self):
        return spec.module("reference", self.config["model"])


class Phases:
    """Notes how long each stage of a run took, and the device memory peak
    so far: ``phase(name)`` closes the stage that began at the last call."""

    def __init__(self, ctx: Context):
        self.ctx, self.t = ctx, time.time()

    def __call__(self, name: str) -> None:
        now = time.time()
        peak = memory_peak(self.ctx.device) / 2**30
        self.ctx.notes.append(f"phase {name}: {now - self.t:.3f} s, device peak {peak:.2f} GiB")
        self.t = now


def port_schema(config: dict):
    """The port's WeChat schema with the configuration's table rows, widths
    and sequence lengths."""
    from rank_tpu_torch.features import WECHAT_SCHEMA

    s = config["schema"]
    cats = tuple(dataclasses.replace(f, vocab_size=s["categorical"][f.name][0],
                                     emb_dim=s["categorical"][f.name][1])
                 for f in WECHAT_SCHEMA.categorical)
    seqs = []
    for f in WECHAT_SCHEMA.sequence:
        seq = s["sequence"][f.name]
        rows, dim = s["categorical"][seq["table"]]
        seqs.append(dataclasses.replace(f, vocab_size=rows, emb_dim=dim, max_len=seq["max_len"],
                                        shares_table_with=seq["table"]))
    if len(WECHAT_SCHEMA.dense) != s["dense"]:
        raise ValueError(f"the port's schema has {len(WECHAT_SCHEMA.dense)} dense features, "
                         f"the configuration {s['dense']}")
    return dataclasses.replace(WECHAT_SCHEMA, categorical=cats, sequence=tuple(seqs))


def model_config(config: dict):
    from rank_tpu_torch.models import default_config

    fields = {k: tuple(v) if isinstance(v, list) else v
              for k, v in config["model_config"].items()}
    return default_config(config["model"], **fields)


def release(device: torch.device) -> None:
    """Free what the program held, so the reference has the card's memory."""
    gc.collect()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()


def memory_peak(device: torch.device) -> int:
    return int(torch.cuda.max_memory_allocated(device)) if device.type == "cuda" else 0


def synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)
