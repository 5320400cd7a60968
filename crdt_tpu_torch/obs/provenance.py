"""Op-level propagation provenance: the convergence flight recorder's
write-side and merge-side hooks (own copy of the per-node part of
``crdt_tpu.obs.provenance``; the soak harnesses' shared birth ledger and
step clock, and the keyspace tier's shard and tenant labels, are not
ported).

Every local write is stamped with a birth event; every merge derives which
origin-sequence ranges it made newly visible from the version-vector delta
alone.  The vector is monotone per writer, so the ranges
``(vv_before[origin], vv_after[origin]]`` of successive rounds are
disjoint, and a duplicated or reordered delivery (which does not move the
vector) records nothing: exactly once per (origin, seq, observer), with no
dedup table and no per-op scan on the device.  The lag recorded per
origin→observer edge is ``op_propagation`` (seconds), from the op's wire
timestamp (absolute Unix ms).
"""
from __future__ import annotations

import time
from typing import Dict, Optional, Sequence, Tuple

from crdt_tpu_torch.obs.trace import current_trace


class FlightRecorder:
    """Per-replica recorder.  It records every write and merge: the JAX
    package's switches (a null registry, muting during checkpoint restore)
    belong to parts the port does not have."""

    def __init__(self, rid: int, registry, events=None):
        self.rid = int(rid)
        self.node_label = str(rid)
        self.registry = registry
        self.events = events

    # ---- write side ----

    def note_birth(self, seq: int, op_ts_ms: int) -> None:
        """Stamp one local write with an ``op_birth`` event; ``op_ts_ms`` is
        the op's wire timestamp (absolute Unix ms), the identity every
        observer sees."""
        if self.events is not None:
            self.events.emit("op_birth", origin=self.rid, seq=seq,
                             op_ts_ms=int(op_ts_ms))

    def note_births(self, births: Sequence[Tuple[int, int]]) -> None:
        """Batched birth stamp for one write drain: ONE ``op_births`` record
        covering the drain's contiguous seq range (per-op events are the
        cost the batched write path exists to amortize)."""
        if not births or self.events is None:
            return
        self.events.emit(
            "op_births", origin=self.rid, n=len(births),
            seq_first=int(births[0][0]), seq_last=int(births[-1][0]),
            op_ts_ms_first=int(births[0][1]), op_ts_ms_last=int(births[-1][1]))

    # ---- merge side ----

    def note_visible(self, vv_before: Dict[int, int], vv_after: Dict[int, int],
                     births: Optional[Dict[Tuple[int, int], int]] = None,
                     trace: Optional[str] = None) -> int:
        """Record the origin-seq ranges one merge made newly visible: one
        ``op_visible`` event per origin range, one ``op_propagation``
        observation per (origin, seq) that arrived as a raw row (``births``
        maps its ident to the wire ts; seqs made visible by a frontier
        adoption have no row and get the event only).  Returns the number
        of newly-visible ops."""
        now_ms = int(time.time() * 1000)
        tid = trace if trace is not None else current_trace()
        total = 0
        for origin in sorted(vv_after):
            hi = vv_after[origin]
            lo = vv_before.get(origin, -1)
            if hi <= lo or origin < 0 or origin == self.rid:
                # no progress / watermarkless Go-format ops / own writes
                # (local visibility is birth, not propagation)
                continue
            if births is not None:
                olab = str(origin)
                for seq in range(lo + 1, hi + 1):
                    born = births.get((origin, seq))
                    if born is not None:
                        self.registry.observe(
                            "op_propagation", max(0.0, (now_ms - born) / 1e3),
                            origin=olab, node=self.node_label)
            total += hi - lo
            if self.events is not None:
                self.events.emit("op_visible", trace=tid, origin=origin,
                                 seq_lo=lo + 1, seq_hi=hi, n=hi - lo)
        return total
