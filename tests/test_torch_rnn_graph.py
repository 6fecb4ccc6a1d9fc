"""``cuda_graphs``: DIEN's training stages and its recurrences replayed as
CUDA graphs (``rank_tpu_torch/utils/graphs.py``, ``models/sequence.py``,
``ops/rnn.py``), held against the plain calls they capture.

On the CPU the option runs the plain calls. The card's tests take the ``card``
fixture and skip without a CUDA card; the file imports no JAX, so on the
card's machine it runs without ``tests/conftest.py``:

    python -m pytest --noconftest tests/test_torch_rnn_graph.py -q
"""

import numpy as np
import pytest
import torch

from rank_tpu_torch import default_config, tiny_schema
from rank_tpu_torch.data.synthetic import make_synthetic_dataset
from rank_tpu_torch.ops.rnn import AttentionalGRU
from rank_tpu_torch.train import TrainConfig, Trainer
from rank_tpu_torch.utils import graphs

B, T, H = 1024, 50, 36  # DIEN's cell: batch, history, width


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _trained(graph: bool, device, dropout: float = 0.0, steps: int = 3):
    """The state dict, Adam's state and the model after ``steps`` train
    steps of a tiny DIEN, with or without ``cuda_graphs``."""
    cfg = default_config("dien", hidden_units=(16, 8), dropout_rate=dropout, cuda_graphs=graph)
    torch.manual_seed(11)
    trainer = Trainer(tiny_schema(), cfg,
                      TrainConfig(log_every=0, batch_size=32, matmul_precision="float32"),
                      device=device)
    state, meters = trainer.init_state(), trainer.meters_init()
    for seed in range(steps):
        data = make_synthetic_dataset(tiny_schema(), num_rows=32, seed=seed)
        data["_valid"] = np.ones(32, np.float32)
        trainer.train_step(state, meters, trainer.to_device(data))
    return state["model"].state_dict(), state["optimizer"].state_dict()["state"], state["model"]


def _assert_same_state(a, b):
    (params, adam), (params_g, adam_g) = a[:2], b[:2]
    assert params.keys() == params_g.keys() and adam.keys() == adam_g.keys()
    assert all(torch.equal(params[k], params_g[k]) for k in params)
    assert all(torch.equal(torch.as_tensor(adam[i][k]), torch.as_tensor(adam_g[i][k]))
               for i in adam for k in adam[i])


def test_on_the_cpu_the_option_runs_the_plain_calls():
    eager, graphed = _trained(False, "cpu"), _trained(True, "cpu")
    _assert_same_state(eager, graphed)
    model = graphed[2]
    assert model.interest_extractor.graphed
    assert model not in graphs._GRAPHS and model.interest_extractor not in graphs._GRAPHS


def _inputs(device, mode):
    gen = torch.Generator(device=device).manual_seed(7)
    x = torch.randn(B, T, H, generator=gen, device=device, requires_grad=True)
    lengths = torch.randint(0, T + 1, (B,), generator=gen, device=device)
    lengths[:2] = torch.tensor([0, T], device=device)
    att = torch.rand(B, T, generator=gen, device=device, requires_grad=True)
    return x, lengths, (att if mode == "augru" else None)


def _run(cell, x, lengths, att):
    """Outputs, final state and every gradient of a weighted sum of both."""
    for p in cell.parameters():
        p.grad = None
    leaves = [x] + ([att] if att is not None else [])
    for leaf in leaves:
        leaf.grad = None
    outs, h = cell(x, lengths, att)
    w = torch.linspace(-1.0, 1.0, outs.numel(), device=outs.device).view_as(outs)
    ((outs * w).sum() + h.square().sum()).backward()
    return [outs.detach().clone(), h.detach().clone()] + [
        t.grad.clone() for t in leaves + list(cell.parameters())]


@pytest.mark.card
@pytest.mark.parametrize("mode", ["gru", "augru"])
def test_the_graphs_compute_what_the_loop_computes(mode, card):
    cell = AttentionalGRU(H, H, mode, generator=torch.Generator().manual_seed(3)).to(card)
    x, lengths, att = _inputs(card, mode)
    want = _run(cell, x, lengths, att)
    cell.graphed = True
    for _ in range(2):  # the capture's call, then a replay
        got = _run(cell, x, lengths, att)
        assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert len(graphs._GRAPHS[cell][AttentionalGRU._recurrence][1]) == 1
    half = [None if a is None else a[:B // 2].detach().requires_grad_(a.requires_grad)
            for a in (x, lengths, att)]
    _run(cell, *half)
    assert len(graphs._GRAPHS[cell][AttentionalGRU._recurrence][1]) == 2  # a new shape, a new capture
    cell.eval()
    with torch.no_grad():
        outs, _ = cell(x, lengths, att)
    assert torch.equal(outs, want[0]) and len(graphs._GRAPHS[cell][AttentionalGRU._recurrence][1]) == 2


@pytest.mark.card
@pytest.mark.parametrize("dropout", [0.0, 0.1])  # with dropout the tower runs plain
def test_dien_trains_alike_graphed_and_plain(dropout, card):
    """Three steps: the state dict (BatchNorm's running statistics with
    it) and Adam's state bitwise equal; then an eval forward."""
    plain, graphed = _trained(False, card, dropout), _trained(True, card, dropout)
    _assert_same_state(plain, graphed)
    assert len(graphs._GRAPHS[graphed[2]]) == (3 if dropout == 0.0 else 2)  # stages graphed
    data = make_synthetic_dataset(tiny_schema(), num_rows=32, seed=9)
    batch = {k: torch.as_tensor(v, device=card) for k, v in data.items()}
    scores = []
    for model in (plain[2], graphed[2]):
        model.eval()
        with torch.no_grad():
            scores.append(model(batch)["logits"])
    assert torch.equal(*scores)
