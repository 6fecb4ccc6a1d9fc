"""Runtime calls a DIEN step inside the port's ``rnn.gru`` and ``rnn.augru``
spans, the recurrences' forward, whose correlation id reaches a kernel,
copy or memset of the traced slice (layer: the recurrences)."""

from port_bench.rnn_spans import rnn_launches_per_step as read  # noqa: F401
