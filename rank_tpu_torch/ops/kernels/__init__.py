"""Hand-written Hopper kernels, each beside its plain torch version.

Importing this package registers the kernels as operators,
``torch.ops.rank_tpu_torch.din_attention`` and
``torch.ops.rank_tpu_torch.cin_layer_t``, which a serving artifact's graph
names (``serve.load_serving_artifact``).
"""

from . import cin, din_attention  # noqa: F401  (registers the operators)
