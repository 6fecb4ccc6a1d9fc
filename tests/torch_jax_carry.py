"""rank_tpu's training state and epoch order carried into the port, for the
checks that hold the port's training against rank_tpu's from the same
start: ``test_torch_parity_steps.py`` (JAX's state before every step),
``test_torch_whole_run.py`` and ``torch_c4_arms.py`` (JAX's initial state
and JAX's epoch order for whole runs). Imports both packages; the port
itself has no hook for either, so they live here. Not a test module.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from rank_tpu.train import staged as jax_staged
from rank_tpu_torch.interop import state_dict_from_flax
from rank_tpu_torch.train.staged import StagedRunner


def load_jax_state(trainer, state, host) -> None:
    """The port's state set to a JAX trainer's (host copy): parameters,
    BatchNorm statistics, Adam's moments and step count."""
    model, optimizer = state["model"], state["optimizer"]
    extra = host["extra"]
    model.load_state_dict(state_dict_from_flax(model, {"params": host["params"], **extra}))
    adam = host["opt_state"][0]
    mu = state_dict_from_flax(model, {"params": adam.mu, **extra})
    nu = state_dict_from_flax(model, {"params": adam.nu, **extra})
    for name, p in model.named_parameters():
        optimizer.state[p] = {"step": torch.tensor(float(adam.count)),
                              "exp_avg": mu[name].clone(), "exp_avg_sq": nu[name].clone()}
    state["step"] = int(host["step"])


def jax_initial_state(jtrainer, train, batch_size: int):
    """rank_tpu's initial training state as its ``StagedRunner.init_state``
    draws it: from the first batch of the padded, packed train split
    (``rank_tpu/train/staged.py:206-219``), without staging the split."""
    first = {k: v[:batch_size] for k, v in train.items()}
    padded, _ = jax_staged._pad_rows(first, batch_size)
    packed, specs = jax_staged.pack_columns(padded)
    sample = jax.device_get(jax_staged.unpack_columns(jnp.asarray(packed), specs))
    return jtrainer.init_state(sample)


def jax_order(n: int, batch_size: int, seed: int, epoch: int) -> np.ndarray:
    """rank_tpu's epoch order of its ``n`` staged rows: the permutation its
    ``shuffle_global`` draws from ``PRNGKey(seed + epoch)``, composed with
    the block interleave of one data shard (``rank_tpu/train/staged.py:
    114-127,299-301``). Step i trains on rows ``order[i*bs:(i+1)*bs]``, on
    any number of data shards."""
    perm = jax.random.permutation(jax.random.PRNGKey(seed + epoch), n)
    return np.asarray(jnp.take(perm, jax_staged._interleave_index(n, batch_size, 1)))


class JaxOrderRunner(StagedRunner):
    """The port's ``StagedRunner`` on rank_tpu's epoch order: only
    ``shuffled`` differs (one data rank)."""

    def shuffled(self, epoch: int, seed: int):
        n = self.train_steps * self.batch_size
        order = torch.from_numpy(jax_order(n, self.batch_size, seed, epoch).astype(np.int64))
        order = order.to(self.trainer.device)
        return {k: v.index_select(0, order) for k, v in self.train_staged.items()}
