"""crdt_tpu_torch — the PyTorch/CUDA port of ``crdt_tpu``.

The JAX package ``crdt_tpu`` stays the reference: every module here keeps
its counterpart's name and public functions, and the tests hold the two
bit for bit on seeded inputs.  This package imports ``torch``, numpy and
the standard library only — never ``jax`` and nothing of ``crdt_tpu``.

Layout (mirrors ``crdt_tpu``):

- ``utils``    — constants, table growth, host string interning, the
  structure map over state containers; the host clock and sequence
  numbers, the cluster configuration and the ``Metrics`` surface;
- ``ops``      — ``sorted_union``, ``pack`` and ``union_engine`` (the OR-Set
  engines); ``joins`` (the reductions and the join registry), ``randstate``
  (each registered join's seeded generators) and ``algebra`` (the
  product, lexicographic, mapof and semidirect combinators); and
  ``hopper_union``: the wrappers
  of the hand-written CUDA kernels (``csrc/lexn_union.cu``: the lexN union,
  merge and compaction; ``csrc/set_union.cu``: the single-key union, merge
  and bucket-local union) and their plain twins;
- ``models``   — ``oplog``, ``compactlog``, ``oplog_columnar``,
  ``oplog_engine``; ``orset``, ``gset``; ``rseq``, ``rseq_columnar``,
  ``rseq_engine``; ``tomb_gc``; the counters, registers and flags;
  ``ormap`` and ``ormap_gc`` (the OR-Map and its epoch resets) and
  ``composite`` (the four registered composites);
- ``consistency`` — ``vvclock``, the version-vector watermark lattice;
  ``session`` (session tokens) and ``stability`` (stability summaries and
  the ``StabilityTracker``);
- ``api``      — ``node.ReplicaNode`` and ``cluster.LocalCluster``: the
  reference's own system (writes, delta gossip, compaction barriers,
  revival), host bookkeeping in Python, each replica's log on the card;
  beside each KV node its typed siblings ``setnode.SetNode``,
  ``seqnode.SeqNode`` (their shared floor protocol in ``floornode``) and
  ``mapnode.MapNode``, with their GC and reset barriers, and
  ``compositenode.CompositeNode`` (the served ``mapof(pncounter)``);
  ``http_shim``: the reference's HTTP surface over a cluster (demo mode)
  or a daemon; ``net``: the network daemon (``RemotePeer``,
  ``NetworkAgent``, ``NodeHost``);
- ``ingest``   — the front door: the op-page wire format, the admission
  lanes and the shed policy;
- ``obs``      — the node's metrics registry and its Prometheus
  exposition (and ``NULL_REGISTRY``, the telemetry opt-out), trace spans, event log (with its JSONL sink), flight
  recorder, health gauges and samplers, merge attribution, and ``audit``
  (the live divergence audit: the frontier-clamped digest of
  ``ops/digest`` and the watchdog);
- ``oracle``   — the reference-semantics oracle (plain Python) and
  ``shim``, its quirk-compat HTTP surface;
- ``parallel`` — ``swarm`` (anti-entropy over a stacked replica axis, the
  stable frontier and the compaction barrier);
- ``harness``  — ``gc_soak`` (the OR-Set and OR-Map soaks), ``seq_soak``
  (the RSeq allocator and GC soak), checked against Python mirrors, and
  ``soak`` (the cluster and the network daemons under kill/revive,
  checked against the oracle);
- ``convert``  — state carried across from the JAX package as numpy;
- ``workload`` — seeded reference-shaped writes (for a swarm and for a
  cluster of nodes, in process or over HTTP), the OR-Set swarm and the
  RSeq editing history;
- ``utils``    — also ``checkpoint``: crash-safe snapshots in the JAX
  package's file format;
- ``__main__`` — ``python -m crdt_tpu_torch``, the reference's demo
  deployment on the card, or one network daemon (``--daemon``).

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


from crdt_tpu_torch.utils import constants  # noqa: E402,F401
