"""The port's DIEN against the benchmark's plain reference
(``port_bench/reference/dien.py``) on the CPU, on weights drawn from a seed
(``port_bench/weights.py``): the same logits in eval and in train mode, and
the same gradient of every leaf, at a tiny size (tables of 64 rows, a
history of 10) and at the configuration's full widths and history of 50,
on a batch of 48 rows that holds an empty history and a full one.

Tolerances, as ``port_bench/tests/test_port_bench_reference.py`` has them:
both sides compute in f32 with the same products in another order (the
reference writes each GRU product as W x + U h, the port as one product
over [x, h]), so the logits agree to 1e-5 and the gradients, summed over
the history's 50 steps and the batch, to 1e-4 of their size plus 1e-5.
The gradients are of a weighted sum of the logits: a plain sum has none
through the tower's last BatchNorm but for its shift, so every other leaf's
gradient would be rounding on both sides.
"""

import pytest
import torch

from port_bench import spec, weights
from port_bench import traffic as T
from port_bench.drivers.common import model_config, port_schema
from port_bench.reference import common
from port_bench.tests import tiny
from rank_tpu_torch.models import build_model

CONFIG = "dien-wechat"
ROWS = 48


def _pair(full: bool, served: bool, seed: int = 3):
    cfg = spec.config(spec.benchmark(), CONFIG) if full else tiny.config(CONFIG)
    model = build_model(port_schema(cfg), model_config(cfg), device="cpu",
                        generator=torch.Generator().manual_seed(0))
    weights.redraw_(model, torch.Generator().manual_seed(seed), served=served)
    layout = T.Layout.from_config(cfg)
    gen = torch.Generator().manual_seed(seed)
    catalog = T.Catalog(layout, 1.1, gen)
    rows = T.train_rows(catalog, ROWS)
    lengths = rows[layout.history + "_length"]
    lengths[0], lengths[1] = 0, layout.history_len
    hist = catalog.histories(lengths.long())
    rows[layout.history] = hist
    return cfg, model, rows


def _reference():
    return spec.module("reference", "dien")


@pytest.mark.parametrize("full", [False, True], ids=["tiny", "full_width"])
def test_the_batch_holds_an_empty_and_a_full_history(full):
    cfg, _, rows = _pair(full, served=False)
    layout = T.Layout.from_config(cfg)
    lengths = rows[layout.history + "_length"]
    assert int(lengths.min()) == 0 and int(lengths.max()) == layout.history_len
    assert bool((rows[layout.history][1] > 0).all()) and not bool(rows[layout.history][0].any())


@pytest.mark.parametrize("full", [False, True], ids=["tiny", "full_width"])
def test_eval_logits_agree(full):
    cfg, model, rows = _pair(full, served=True)
    model.eval()
    with torch.no_grad(), common.precision(False):
        got = model(rows)["logits"]
        want = _reference().forward(model.state_dict(), rows, cfg, False)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("full", [False, True], ids=["tiny", "full_width"])
def test_train_logits_and_every_gradient_agree(full):
    cfg, model, rows = _pair(full, served=False)
    model.train()
    coef = torch.randn(ROWS, generator=torch.Generator().manual_seed(7))
    with common.precision(False):
        got = model(rows)["logits"]
        (got * coef).sum().backward()
        state = {k: v.detach().clone().requires_grad_(v.is_floating_point())
                 for k, v in model.state_dict().items()}
        want = _reference().forward(state, rows, cfg, True)
        (want * coef).sum().backward()
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    names = [n for n, _ in model.named_parameters()]
    assert set(names) == set(_reference().shapes(cfg))
    for n, p in model.named_parameters():
        assert float(state[n].grad.abs().max()) > 0, n
        torch.testing.assert_close(p.grad, state[n].grad, rtol=1e-4, atol=1e-5, msg=n)


def test_the_configuration_builds_no_aux_projection_and_its_widths():
    cfg, model, _ = _pair(True, served=False)
    assert not hasattr(model, "aux_proj")
    shapes = {n: tuple(p.shape) for n, p in model.named_parameters()}
    assert shapes["tables.table_feedid.weight"] == (106445, 36)
    assert shapes["interest_extractor.gates_kernel"] == (72, 72)
    assert shapes["interest_evolution.candidate_kernel"] == (72, 36)
    assert shapes["attention.w"] == (36, 36)
    assert shapes["fcn.Dense_0.weight"] == (200, 16 + 34 + 36 + 36)
    assert 4.4e6 < sum(p.numel() for p in model.parameters()) < 4.5e6


def test_an_augru_without_its_attention_departs_from_the_reference(monkeypatch):
    """The comparison sees the evolving layer's attention: with the update
    gate taken without its score, the logits move far past the tolerance."""
    from rank_tpu_torch.ops.rnn import AttentionalGRU

    cfg, model, rows = _pair(False, served=True)
    real = AttentionalGRU.forward

    def unscaled(self, inputs, lengths, att_scores=None):
        return real(self, inputs, lengths, None if att_scores is None
                    else torch.ones_like(att_scores))

    monkeypatch.setattr(AttentionalGRU, "forward", unscaled)
    model.eval()
    with torch.no_grad():
        got = model(rows)["logits"]
        want = _reference().forward(model.state_dict(), rows, cfg, False)
    assert float((got - want).abs().max()) > 1e-3
