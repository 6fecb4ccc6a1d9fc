"""The work counts: hand-worked values at small shapes, no more products
than a plain implementation makes, and the peak that bounds every share."""

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from port_bench import peaks, spec
from port_bench import traffic as T
from port_bench.reference import common
from port_bench.reference import din as ref_din
from port_bench.tests import tiny

BENCH = spec.benchmark()


def test_the_product_peak_is_tf32_over_three():
    assert peaks.PRODUCT_FLOPS == pytest.approx(165e12)
    assert peaks.least_seconds(165e12, 0) == pytest.approx(1.0)
    assert peaks.least_seconds(1.0, 3.35e12) == pytest.approx(1.0)


def test_xdeepfm_counts_by_hand():
    work = spec.module("work", "xdeepfm")
    cfg = spec.config(BENCH, "xdeepfm-wechat")
    # E = 16, F = 7, CIN (128, 128): layer 0 H = 7, layer 1 H = 64; pooled 64 + 128
    cin = 2 * 16 * 7 * 7 * 128 + 2 * 16 * 64 * 7 * 128
    tower = 2 * (128 * 512 + 512 * 256 + 256 * 128 + 128 * 1)
    fwd = cin + 2 * 192 + tower + 2 * 16
    assert work.forward_products(cfg, {}) == fwd == 2_495_136
    cin_bwd = 2 * cin
    tower_bwd = (2 * (128 * 512 + 512 * 256 + 256 * 128 + 128)
                 + 2 * (112 * 512 + 512 * 256 + 256 * 128 + 128))
    assert work.train_products(cfg, {}) == fwd + cin_bwd + 4 * 192 + tower_bwd + 2 * 16
    (f0, b0), (f1, b1) = work.cin_layer_calls(cfg, {"rows": 4, "valid_steps": 0})
    assert (f0, b0) == (2 * 64 * 7 * 7 * 128, 4 * (64 * (7 + 7 + 128) + 128 * 7 * 7))
    assert (f1, b1) == (2 * 64 * 64 * 7 * 128, 4 * (64 * (64 + 7 + 128) + 128 * 64 * 7))


def test_din_counts_by_hand():
    work = spec.module("work", "din")
    cfg = spec.config(BENCH, "din-wechat")
    # E = 16, attention (64, 32); tower in = 16 + (16 + 2 + 4 + 4 + 4 + 4) + 32 = 82
    per_step = 4 * 16 * 64 + 2 * 64 * 32 + 2 * 32 + 2 * 16
    tower = 2 * (82 * 512 + 512 * 256 + 256 * 128 + 128)
    assert work.forward_products(cfg, {"mean_history": 10}) == 2 * 16 * 64 + 10 * per_step + tower
    [(flops, nbytes)] = work.din_attention_calls(cfg, {"rows": 8, "valid_steps": 100})
    assert flops == 8 * 2 * 16 * 64 + 100 * per_step
    weights = 64 * 64 + 64 + 64 * 32 + 2 * 32 + 1
    assert nbytes == 4 * (2 * 8 * 16 + 100 * 16 + 8 + weights)


def test_cin_count_is_what_the_plain_contraction_makes():
    work = spec.module("work", "xdeepfm")
    xk, x0, w = torch.randn(3, 16, 64), torch.randn(3, 16, 7), torch.randn(128, 64, 7)
    with FlopCounterMode(display=False) as fc:
        torch.einsum("bdh,bdf,ohf->bdo", xk, x0, w)
    cfg = spec.config(BENCH, "xdeepfm-wechat")
    _, (flops, _) = work.cin_layer_calls(cfg, {"rows": 3, "valid_steps": 0})
    assert flops <= fc.get_total_flops()


def test_din_attention_count_is_below_the_plain_reference():
    """The folded count over valid steps never passes what the plain
    attention computes over every key."""
    work = spec.module("work", "din")
    cfg = tiny.config("din-wechat")
    g = torch.Generator().manual_seed(0)
    b, t, e = 6, 10, 16
    state = {"attention.w1": torch.randn(4 * e, 64, generator=g), "attention.b1": torch.zeros(64),
             "attention.w2": torch.randn(64, 32, generator=g), "attention.b2": torch.zeros(32),
             "attention.w3": torch.randn(32, 1, generator=g), "attention.b3": torch.zeros(1)}
    lengths = torch.tensor([0, 3, 10, 10, 5, 1])
    with FlopCounterMode(display=False) as fc:
        ref_din.attention(torch.randn(b, e), torch.randn(b, t, e), lengths, state, True)
    [(flops, _)] = work.din_attention_calls(cfg, {"rows": b, "valid_steps": int(lengths.sum())})
    assert flops <= fc.get_total_flops()


@pytest.mark.parametrize("cell", [c["name"] for c in BENCH["workloads"]
                                  if spec.traffic(c["traffic"])["driver"] == "train_staged"])
def test_train_count_is_below_a_plain_step(cell):
    """A step of the plain reference (forward and autograd backward) makes
    at least the products the count says a trained example needs, so the
    whole step's share cannot pass 100%."""
    entry = spec.workload(BENCH, cell)
    cfg = tiny.config(entry["config"], vocab=32, history=50)
    ref = spec.module("reference", cfg["model"])
    work = spec.module("work", cfg["model"])
    g = torch.Generator().manual_seed(1)
    state = {k: torch.randn(s, generator=g) * 0.1 for k, s in ref.shapes(cfg).items()}
    b = 16
    cat = T.Catalog(T.Layout.from_config(cfg), 1.1, g)
    rows = T.train_rows(cat, b)
    rows["_valid"] = torch.ones(b)
    leaves = {k: v.requires_grad_(True) for k, v in state.items()}
    with FlopCounterMode(display=False) as fc:
        logit = ref.forward(leaves, rows, cfg, True)
        common.masked_bce(logit, rows["labels"][:, 0], rows["_valid"]).backward()
    mean_hist = float(rows[cat.layout.history + "_length"].float().mean())
    assert b * work.train_products(cfg, {"mean_history": mean_hist}) <= fc.get_total_flops()
