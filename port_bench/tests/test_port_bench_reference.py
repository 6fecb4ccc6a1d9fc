"""The frozen references against the port's plain path on the CPU, at a
tiny size and at full width with a small batch: the same logits in eval
and in train mode (the dropout stream seeded alike), the same gradients."""

import pytest
import torch

from port_bench import spec, weights
from port_bench import traffic as T
from port_bench.drivers.common import model_config, port_schema
from port_bench.tests import tiny

BENCH = spec.benchmark()
CONFIGS = ("xdeepfm-wechat", "din-wechat")


def _pair(name, full, served, seed=3):
    cfg = spec.config(BENCH, name) if full else tiny.config(name)
    from rank_tpu_torch.models import build_model

    model = build_model(port_schema(cfg), model_config(cfg), device="cpu",
                        generator=torch.Generator().manual_seed(0))
    weights.redraw_(model, torch.Generator().manual_seed(seed), served=served)
    catalog = T.Catalog(T.Layout.from_config(cfg), 1.1, torch.Generator().manual_seed(seed))
    rows = T.train_rows(catalog, 48)
    return cfg, model, rows


@pytest.mark.parametrize("full", [False, True], ids=["tiny", "full_width"])
@pytest.mark.parametrize("name", CONFIGS)
def test_eval_logits_agree(name, full):
    cfg, model, rows = _pair(name, full, served=True)
    ref = spec.module("reference", cfg["model"])
    model.eval()
    with torch.no_grad():
        got = model(rows)["logits"]
        want = ref.forward(model.state_dict(), rows, cfg, False)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("full", [False, True], ids=["tiny", "full_width"])
@pytest.mark.parametrize("name", CONFIGS)
def test_train_logits_and_gradients_agree(name, full):
    cfg, model, rows = _pair(name, full, served=False)
    ref = spec.module("reference", cfg["model"])
    model.train()
    torch.manual_seed(11)
    got = model(rows)["logits"]
    got.sum().backward()
    state = {k: v.detach().clone().requires_grad_(v.is_floating_point())
             for k, v in model.state_dict().items()}
    torch.manual_seed(11)
    want = ref.forward(state, rows, cfg, True)
    want.sum().backward()
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    for n, p in model.named_parameters():
        torch.testing.assert_close(p.grad, state[n].grad, rtol=1e-4, atol=1e-5, msg=n)


@pytest.mark.parametrize("name", CONFIGS)
def test_reference_refuses_a_state_of_other_shapes(name):
    cfg, model, _ = _pair(name, False, served=False)
    ref = spec.module("reference", cfg["model"])
    from port_bench.reference import common

    common.expect(model.state_dict(), ref.shapes(cfg))
    bad = dict(model.state_dict())
    key = next(iter(ref.shapes(cfg)))
    bad[key] = bad[key][:-1]
    with pytest.raises(ValueError):
        common.expect(bad, ref.shapes(cfg))
