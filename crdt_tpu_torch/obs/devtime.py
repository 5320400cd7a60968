"""Per-dispatch device attribution for the node's merge (counterpart of
``crdt_tpu.obs.devtime``).

* :func:`dispatch_annotation`: a ``utils.tracing.trace_region`` range
  keyed to the current trace ID (``crdt.join.merge#trace=<id>``), so one
  gossip round's merge is findable in a captured profile by the ID that
  names its events;
* :func:`observe_join`: the ``join_device`` latency histogram of every
  synced dispatch, and the bytes the dispatch moved (its operand and result
  tensors, each counted once) with the achieved share of the card's HBM
  rate, ``join_hbm_utilization``.  The JAX package takes the bytes from
  XLA's cost analysis and also exports a FLOP count; the port's merge is a
  sequence of sorts and gathers with no cost model, so it counts tensor
  bytes and exports no FLOPs.  The histogram sees every dispatch; the
  gauges are sampled 1 in :data:`GAUGE_SAMPLE_EVERY` a ``(node, kind)``,
  the first dispatch always landing them.  Nothing is recorded on a
  disabled registry (``NULL_REGISTRY``);
* :class:`DispatchTimer`: a wall timer for one dispatch, read after the
  caller synced its result.
"""
from __future__ import annotations

import contextlib
import time
from typing import Dict, Tuple

from crdt_tpu_torch.obs.trace import current_trace
from crdt_tpu_torch.utils.tracing import trace_region
from crdt_tpu_torch.utils.tree import leaves

# NVIDIA H100 SXM (HBM3) memory rate, bytes/s, from NVIDIA's data sheet:
# the denominator of the achieved-bandwidth share
HBM_BYTES_PER_S = 3.35e12

# the gauges are last-write-wins and a dispatch's shapes change only when
# a log grows, so they are set 1 in N dispatches a (node, kind)
GAUGE_SAMPLE_EVERY = 16
_dispatch_counts: Dict[Tuple[str, str], int] = {}


@contextlib.contextmanager
def dispatch_annotation(name: str, enabled: bool = True):
    """Profiler range for one device dispatch, keyed to the enclosing
    gossip round's trace ID (none when not ``enabled``)."""
    if not enabled:
        yield None
        return
    tid = current_trace()
    label = f"crdt.join.{name}" + (f"#trace={tid}" if tid else "")
    with trace_region(label):
        yield label


def tensor_bytes(*states) -> int:
    """Bytes of every tensor leaf of ``states`` (each counted once)."""
    return sum(x.numel() * x.element_size() for s in states for x in leaves(s))


def observe_join(registry, node_label: str, operands, result, seconds: float,
                 kind: str = "merge") -> None:
    """Attribute one completed (synced) dispatch: the latency histogram,
    and 1 in :data:`GAUGE_SAMPLE_EVERY` (the first always) the bytes gauge
    and the achieved share of :data:`HBM_BYTES_PER_S`."""
    if not getattr(registry, "enabled", False):
        return
    registry.observe("join_device", max(seconds, 0.0), node=node_label, kind=kind)
    ckey = (node_label, kind)
    n = _dispatch_counts.get(ckey, 0)
    _dispatch_counts[ckey] = n + 1
    if n % GAUGE_SAMPLE_EVERY:
        return
    nbytes = tensor_bytes(*operands, result)
    registry.set_gauge("join_bytes_per_dispatch", nbytes, node=node_label, kind=kind)
    if seconds > 0:
        registry.set_gauge("join_hbm_utilization",
                           round(nbytes / seconds / HBM_BYTES_PER_S, 9),
                           node=node_label, kind=kind)


class DispatchTimer:
    """A wall timer for one dispatch, whose reading means something only
    after the caller synced the result (the ``int(n_unique)`` the merge
    path already pays)."""

    __slots__ = ("t0", "seconds")

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.seconds = time.perf_counter() - self.t0
