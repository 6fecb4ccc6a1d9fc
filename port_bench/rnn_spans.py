"""Readers of the port's recurrence spans in a traced run's slice.

``AttentionalGRU.forward`` (``rank_tpu_torch/ops/rnn.py``) opens one
``rank_tpu_torch.rnn.<mode>`` span a call around its loop over T
(``rnn.gru`` for DIEN's interest extractor, ``rnn.augru`` for its
evolving layer) while a profiler records. The forward's launches lie
inside the span, on its thread, and are tied to device events by
correlation id, as ``program_spans`` ties a stage's. The backward runs
later, on autograd's thread, outside any such span. It is tied to the
recurrence by autograd's sequence numbers: each forward op carries, in the
trace's ``Sequence number`` argument, the number of the next autograd
node its thread makes, and each node's ``evaluate_function`` event carries
that node's number. A number belongs to the recurrence where the last
forward op of the step that carries it, the one that made the node, lies
inside an ``rnn.*`` span.

Each reader gives a mean over the slice's steps and is silent (None) as
``program_spans``' readers are: without one ``trainer.step`` span a unit,
without a device event, or without ``rnn.*`` spans (a program before they
existed, or a model without a recurrence).
"""

from __future__ import annotations

from typing import List, Optional, Set, Tuple

from . import program_spans as ps

RNN = ps.PREFIX + "rnn."
FORWARD = ps.PREFIX + "trainer.forward"
NODE = "autograd::engine::evaluate_function: "
SEQ = "Sequence number"


def _recurrences(record):
    """(steps, the ``rnn.*`` spans inside them), or None."""
    steps = ps._units(record, ps.STEP)
    if steps is None:
        return None
    trace = record["trace"]
    starts = [s["ts"] for s in steps]
    names = {e["name"] for e in trace.host if e["name"].startswith(RNN)}
    rnn = [e for n in sorted(names) for e in ps.spans(trace, n)
           if ps._holder(steps, starts, e["ts"])]
    return (steps, rnn) if rnn else None


def _reached(trace, holders: List[dict]) -> Tuple[int, float]:
    """The launches inside the ``holders`` events (each on its own thread)
    that reach a kernel, copy or memset, and those events' device us."""
    device, launched = ps._device_by_corr(trace), ps._Launched(trace)
    corrs = [corr for e in holders for corr in launched(e) if corr in device]
    return len(corrs), sum(d["dur"] for corr in corrs for d in device[corr])


def _ms_per_step(steps, us: float) -> Optional[float]:
    return us / len(steps) * 1e-3 if us > 0 else None


def rnn_launches_per_step(record) -> Optional[float]:
    """Runtime calls inside ``rnn.*`` spans (on their thread) whose
    correlation id reaches a kernel, copy or memset, a step."""
    found = _recurrences(record)
    if found is None:
        return None
    steps, rnn = found
    n, _ = _reached(record["trace"], rnn)
    return n / len(steps) if n else None


def rnn_forward_device_ms(record) -> Optional[float]:
    """The device ms of every kernel, copy and memset launched inside
    ``rnn.*`` spans (on their thread, by correlation id), a step."""
    found = _recurrences(record)
    if found is None:
        return None
    steps, rnn = found
    return _ms_per_step(steps, _reached(record["trace"], rnn)[1])


def owned_numbers(trace, rnn: List[dict]) -> Set[int]:
    """The sequence numbers of the autograd nodes that ops inside the
    ``rnn`` spans made: those whose last carrier among the forward ops
    (inside ``trainer.forward`` spans, on the spans' thread) lies inside one."""
    forwards = ps.spans(trace, FORWARD)
    last = {}
    for e in sorted((e for e in trace.host if SEQ in e.get("args", {})
                     and any(ps._within(e, f) for f in forwards)), key=lambda e: e["ts"]):
        last[e["args"][SEQ]] = e
    return {n for n, e in last.items() if any(ps._within(e, s) for s in rnn)}


def backward_nodes(trace, steps: List[dict], rnn: List[dict]) -> List[dict]:
    """The ``evaluate_function`` events, inside the ``steps`` (on any
    thread, by start), of the nodes that ops inside the ``rnn`` spans made."""
    owned = owned_numbers(trace, rnn)
    starts = [s["ts"] for s in steps]
    return [e for e in trace.host if e["name"].startswith(NODE)
            and e.get("args", {}).get(SEQ) in owned and ps._holder(steps, starts, e["ts"])]


def rnn_backward_device_ms(record) -> Optional[float]:
    """The device ms of every kernel, copy and memset launched inside the
    recurrences' backward nodes (on their thread, by correlation id), a
    step."""
    found = _recurrences(record)
    if found is None:
        return None
    steps, rnn = found
    nodes = backward_nodes(record["trace"], steps, rnn)
    return _ms_per_step(steps, _reached(record["trace"], nodes)[1])
