"""crdt_tpu_torch — the PyTorch/CUDA port of ``crdt_tpu``.

The JAX package ``crdt_tpu`` stays the reference: every module here keeps
its counterpart's name and public functions, and the tests hold the two
bit for bit on seeded inputs.  This package imports ``torch``, numpy and
the standard library only — never ``jax`` and nothing of ``crdt_tpu``.

Layout (mirrors ``crdt_tpu``):

- ``utils``    — constants, table growth, host string interning, the
  structure map over state containers; the host clock and sequence
  numbers, the cluster configuration and the ``Metrics`` surface;
- ``ops``      — ``sorted_union`` and ``joins`` (plain torch), ``pack`` and
  ``union_engine`` (the OR-Set engines), and ``hopper_union``: the wrappers
  of the hand-written CUDA kernels (``csrc/lexn_union.cu``: the lexN union,
  merge and compaction; ``csrc/set_union.cu``: the single-key union, merge
  and bucket-local union) and their plain twins;
- ``models``   — ``oplog``, ``compactlog``, ``oplog_columnar``,
  ``oplog_engine``; ``orset``, ``gset``; ``rseq``, ``rseq_columnar``,
  ``rseq_engine``; ``tomb_gc``; the counters, registers and flags;
- ``api``      — ``node.ReplicaNode`` and ``cluster.LocalCluster``: the
  reference's own system (writes, delta gossip, compaction barriers,
  revival), host bookkeeping in Python, each replica's log on the card;
- ``obs``      — the node's metrics registry, trace spans, event log,
  flight recorder, health gauges and merge attribution;
- ``oracle``   — the reference-semantics oracle (plain Python);
- ``parallel`` — ``swarm`` (anti-entropy over a stacked replica axis, the
  stable frontier and the compaction barrier);
- ``convert``  — state carried across from the JAX package as numpy;
- ``workload`` — seeded reference-shaped writes (for a swarm and for a
  cluster of nodes), the OR-Set swarm and the RSeq editing history.

Device rule: every constructor takes ``device=None``, which resolves to
the CUDA card (:func:`default_device`); without a card that raises rather
than quietly running on the CPU.  Functions that take tensors run on the
tensors' device.
"""
from __future__ import annotations

import torch

__version__ = "0.1.0"


def default_device(device=None) -> torch.device:
    """Resolve a constructor's ``device`` argument: ``None`` means the CUDA
    card, and raises if there is none — pass ``device="cpu"`` explicitly
    to build state on the CPU."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "crdt_tpu_torch: no CUDA device is available; pass device='cpu' "
            "explicitly to build state on the CPU"
        )
    return torch.device("cuda")
