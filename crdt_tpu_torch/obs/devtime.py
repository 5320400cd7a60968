"""Per-dispatch device attribution for the node's merge (counterpart of
``crdt_tpu.obs.devtime``).

* :func:`dispatch_annotation`: a ``torch.profiler.record_function`` range
  keyed to the current trace ID (``crdt.join.merge#trace=<id>``), so one
  gossip round's merge is findable in a captured profile by the ID that
  names its events;
* :func:`observe_join`: the ``join_device`` latency histogram of every
  synced dispatch, and the bytes the dispatch moved (its operand and result
  tensors, each counted once) with the achieved share of the card's HBM
  rate, ``join_hbm_utilization``.  The JAX package takes the bytes from
  XLA's cost analysis and also exports a FLOP count; the port's merge is a
  sequence of sorts and gathers with no cost model, so it counts tensor
  bytes and exports no FLOPs.
"""
from __future__ import annotations

import contextlib

import torch

from crdt_tpu_torch.obs.trace import current_trace
from crdt_tpu_torch.utils.tree import leaves

# NVIDIA H100 SXM (HBM3) memory rate, bytes/s, from NVIDIA's data sheet:
# the denominator of the achieved-bandwidth share
HBM_BYTES_PER_S = 3.35e12


@contextlib.contextmanager
def dispatch_annotation(name: str):
    """Profiler range for one device dispatch, keyed to the enclosing
    gossip round's trace ID."""
    tid = current_trace()
    label = f"crdt.join.{name}" + (f"#trace={tid}" if tid else "")
    with torch.profiler.record_function(label):
        yield label


def tensor_bytes(*states) -> int:
    """Bytes of every tensor leaf of ``states`` (each counted once)."""
    return sum(x.numel() * x.element_size() for s in states for x in leaves(s))


def observe_join(registry, node_label: str, operands, result, seconds: float,
                 kind: str = "merge") -> None:
    """Attribute one completed (synced) dispatch: the latency histogram,
    the bytes gauge and the achieved share of :data:`HBM_BYTES_PER_S`."""
    registry.observe("join_device", max(seconds, 0.0), node=node_label, kind=kind)
    nbytes = tensor_bytes(*operands, result)
    registry.set_gauge("join_bytes_per_dispatch", nbytes, node=node_label, kind=kind)
    if seconds > 0:
        registry.set_gauge("join_hbm_utilization",
                           round(nbytes / seconds / HBM_BYTES_PER_S, 9),
                           node=node_label, kind=kind)
