"""Cross-node gossip tracing (own copy of ``crdt_tpu.obs.trace``): trace
IDs minted per gossip round, carried over the wire in the ``X-CRDT-Trace``
header and recorded in both sides' event logs, and
``span``, which binds the current ID and opens a same-named
``utils.tracing.trace_region`` (a profiler range while one records), so
the host-side round and its device work line up by name in a captured
profile.
"""
from __future__ import annotations

import contextlib
import contextvars
import itertools
import os
import threading

from crdt_tpu_torch.utils.tracing import trace_region

TRACE_HEADER = "X-CRDT-Trace"

# process-unique prefix + atomic counter: IDs are unique across the fleet
# without coordination
_PROC = f"{os.getpid():x}{os.urandom(3).hex()}"
_SEQ = itertools.count(1)
_SEQ_LOCK = threading.Lock()

_CURRENT: contextvars.ContextVar = contextvars.ContextVar("crdt_trace", default=None)


def mint_trace_id(rid: int = -1) -> str:
    """A fleet-unique trace ID for one gossip round."""
    with _SEQ_LOCK:
        n = next(_SEQ)
    return f"{rid:x}-{_PROC}-{n:x}" if rid >= 0 else f"{_PROC}-{n:x}"


def current_trace():
    """The trace ID of the enclosing ``span`` (None outside one)."""
    return _CURRENT.get()


@contextlib.contextmanager
def span(name: str, trace_id=None):
    """Bind ``trace_id`` (or the enclosing one) as current, whether or not
    a profiler records, and open a same-named ``trace_region``.  Yields the
    trace ID."""
    tid = trace_id or current_trace() or mint_trace_id()
    token = _CURRENT.set(tid)
    try:
        with trace_region(name):
            yield tid
    finally:
        _CURRENT.reset(token)
