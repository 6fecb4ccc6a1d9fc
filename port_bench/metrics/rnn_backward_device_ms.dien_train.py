"""Device milliseconds a DIEN step launched inside the autograd nodes that
the recurrences' forward made, tied to the ``rnn.*`` spans by autograd's
sequence numbers, by correlation id on autograd's thread (layer: the
recurrences)."""

from port_bench.rnn_spans import rnn_backward_device_ms as read  # noqa: F401
