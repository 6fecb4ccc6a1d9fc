"""The port's row-sharded lookups (``rank_tpu_torch/embedding/sharded.py``)
held against JAX's ``rank_tpu/embedding/sharded.py`` and the plain gather.

The port runs 4 gloo ranks on the CPU (``tests/torch_ranks.py``, spawned
once for the module) on a (2 x 2) and a (1 x 4) mesh; JAX runs the same
lookups on 4 of conftest's virtual CPU devices. Ids hold duplicates and
the OOV row 0. Forward and backward agree to 1e-6; the shards' gradients,
summed over the data group, are the unsharded table's gradient: an
all-reducing backward of ``psum``, or an ``alltoall`` backward without
its 1/t, would give t times it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import torch_ranks
from rank_tpu.embedding.sharded import pad_vocab as jax_pad_vocab
from rank_tpu.embedding.sharded import sharded_lookup as jax_sharded_lookup
from rank_tpu.parallel.mesh import make_mesh as jax_make_mesh
from rank_tpu_torch.embedding.sharded import pad_vocab, shard_table
from rank_tpu_torch.parallel import Mesh

TOL = dict(rtol=1e-6, atol=1e-6)
WORLD = 4
V, D, B = 64, 8, 48
CASES = [(t, mode) for t in (2, 4) for mode in ("psum", "alltoall")]


def _inputs():
    rng = np.random.default_rng(0)
    ids = rng.integers(0, V, B).astype(np.int64)
    ids[::5] = 0  # the OOV row
    ids[1::7] = ids[2]  # duplicates, across data shards
    return {
        "table": rng.normal(size=(V, D)).astype(np.float32),
        "ids": ids,
        "ct": rng.normal(size=(B, D)).astype(np.float32),
        "parallelism": (2, 4),
    }


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    """{(t, mode): (out (B, D), table grad (V, D), [per-rank results])}."""
    workdir = tmp_path_factory.mktemp("lookup")
    inputs = _inputs()
    torch_ranks.save(workdir, "lookup_inputs.pkl", inputs)
    torch_ranks.spawn(torch_ranks.lookup_rank, WORLD, workdir)
    ranks = [torch_ranks.load(workdir, f"lookup_{r}.pkl") for r in range(WORLD)]
    out = {}
    for case in CASES:
        t = case[0]
        per = [r[case] for r in ranks]
        rows = [next(p["out"] for p in per if p["data_index"] == i) for i in range(WORLD // t)]
        grads = [next(p["grad"] for p in per if p["table_index"] == j and p["data_index"] == 0)
                 for j in range(t)]
        out[case] = (np.concatenate(rows), np.concatenate(grads), per)
    return inputs, out


def _jax(inputs, t, mode):
    mesh = jax_make_mesh(num_devices=WORLD, table_parallelism=t)
    table, ids, ct = (jnp.asarray(inputs[k]) for k in ("table", "ids", "ct"))

    def loss(tab):
        out = jax_sharded_lookup(tab, ids.astype(jnp.int32), mesh, mode=mode)
        return jnp.sum(out * ct), out

    (_, out), grad = jax.jit(jax.value_and_grad(loss, has_aux=True))(table)
    return np.asarray(out), np.asarray(grad)


def _plain(inputs):
    table = torch.from_numpy(inputs["table"]).requires_grad_(True)
    out = F.embedding(torch.from_numpy(inputs["ids"]), table)
    (out * torch.from_numpy(inputs["ct"])).sum().backward()
    return out.detach().numpy(), table.grad.numpy()


@pytest.mark.parametrize("t,mode", CASES)
def test_lookup_forward_matches_jax(port, t, mode):
    inputs, out = port
    want, _ = _jax(inputs, t, mode)
    np.testing.assert_allclose(out[(t, mode)][0], want, **TOL)


@pytest.mark.parametrize("t,mode", CASES)
def test_lookup_backward_matches_jax(port, t, mode):
    inputs, out = port
    _, want = _jax(inputs, t, mode)
    np.testing.assert_allclose(out[(t, mode)][1], want, **TOL)


@pytest.mark.parametrize("t,mode", CASES)
def test_lookup_matches_plain_gather(port, t, mode):
    """Each id has one owning shard, so the cross-shard sum adds exact
    zeros: the rows are the plain gather's, bit for bit."""
    inputs, out = port
    want, _ = _plain(inputs)
    np.testing.assert_array_equal(out[(t, mode)][0], want)


@pytest.mark.parametrize("t,mode", CASES)
def test_shard_gradients_sum_to_unsharded_gradient(port, t, mode):
    inputs, out = port
    _, want = _plain(inputs)
    got = out[(t, mode)][1]
    np.testing.assert_allclose(got, want, **TOL)
    # the t-fold gradient a wrong backward gives is far outside the bar
    assert not np.allclose(t * want, want, **TOL)


@pytest.mark.parametrize("t,mode", CASES)
def test_table_peers_return_the_same_rows(port, t, mode):
    _, out = port
    per = out[(t, mode)][2]
    for p in per:
        peer = next(q for q in per if q["data_index"] == p["data_index"])
        np.testing.assert_array_equal(p["out"], peer["out"])


@pytest.mark.parametrize("rows,shards", [(65, 2), (64, 2), (65, 4), (1, 3), (106_445, 2)])
def test_pad_vocab_matches_jax(rows, shards):
    table = np.random.default_rng(rows).normal(size=(rows, 3)).astype(np.float32)
    got = pad_vocab(torch.from_numpy(table), shards).numpy()
    want = np.asarray(jax_pad_vocab(jnp.asarray(table), shards))
    assert got.shape == want.shape and got.shape[0] % shards == 0
    np.testing.assert_array_equal(got, want)


def test_indivisible_vocab_raises():
    table = torch.zeros(65, 4)
    mesh = Mesh(world_size=2, rank=1, table_index=1, shape={"data": 1, "table": 2})
    with pytest.raises(ValueError, match="not divisible by table axis 2; use pad_vocab"):
        shard_table(table, mesh)
    with pytest.raises(ValueError, match="not divisible by table axis 2"):
        jax_sharded_lookup(jnp.zeros((65, 4)), jnp.zeros(8, jnp.int32),
                           jax_make_mesh(num_devices=WORLD, table_parallelism=2))
    rows = shard_table(pad_vocab(torch.arange(65.0)[:, None], 2), mesh)
    np.testing.assert_array_equal(rows[:, 0].numpy(), np.r_[33.0:65.0, 0.0])
