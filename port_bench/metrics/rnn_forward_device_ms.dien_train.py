"""Device milliseconds a DIEN step launched inside the port's ``rnn.gru``
and ``rnn.augru`` spans, the recurrences' forward, by correlation id on the
spans' thread (layer: the recurrences)."""

from port_bench.rnn_spans import rnn_forward_device_ms as read  # noqa: F401
