"""CompactedLog: an OpLog with its stable prefix folded into a per-key
summary (counterpart of ``crdt_tpu.models.compactlog``), bounding the
reference's unbounded log growth.

The reference never prunes its op log (its main.go:75 clears only the
staging buffer) and gossips the full log every round, so memory and the
per-round merge grow without bound.  Compaction coordinated by a *stable
frontier* bounds both:

* a replica's knowledge is summarized by a per-writer version vector
  (:func:`crdt_tpu_torch.models.oplog.version_vector`);
* the swarm's stable frontier is the elementwise min of the alive
  replicas' vectors: every op at or below it is held by every alive
  replica (:func:`crdt_tpu_torch.parallel.swarm.stable_frontier`);
* each replica folds exactly that op set into a fixed-shape per-key
  ``Summary`` and drops the raw rows; the ``tail`` keeps only unstable
  ops, so the log tracks the gossip lag, not the history.

Two invariants make it sound: folding an op set gives one canonical
Summary (determinism), and frontiers only advance to swarm-agreed values,
so any two live frontiers are comparable (chain frontiers).  ``merge``
adopts the further-ahead side's summary and drops both tails' rows under
it; a replica that was dead during a barrier is behind on the chain and
one merge catches it up.

``rebuild`` over (summary, tail) equals ``oplog.rebuild`` over the
uncompacted log (compaction transparency).  Each function takes one
log (no batch dimension) and runs on its tensors' device.
"""
from __future__ import annotations

import dataclasses

import torch

from crdt_tpu_torch import default_device
from crdt_tpu_torch.models import oplog
from crdt_tpu_torch.utils.constants import SENTINEL_PY

TS_NULL_PY = -1
SUMMARY_FIELDS = ("present", "num", "num_count", "ts", "rid", "seq", "payload", "is_num")


@dataclasses.dataclass
class Summary:
    """Deterministic per-key fold of the stable op set (interned key space
    of size K).  ``ts/rid/seq/payload/is_num`` describe the lexicographically
    newest folded op per key (valid iff ``present``); ``num/num_count``
    accumulate every folded numeric delta: together exactly the per-key
    facts ``oplog.rebuild`` extracts, so folded rows can be discarded."""

    present: torch.Tensor    # bool[K]  any folded op for this key
    num: torch.Tensor        # int32[K] sum of folded numeric deltas
    num_count: torch.Tensor  # int32[K] count of folded numeric ops
    ts: torch.Tensor         # int32[K] newest folded op identity...
    rid: torch.Tensor        # int32[K]
    seq: torch.Tensor        # int32[K]
    payload: torch.Tensor    # int32[K] ...its raw-value intern id
    is_num: torch.Tensor     # bool[K]  ...whether it parses as an integer


@dataclasses.dataclass
class CompactedLog:
    summary: Summary         # fold of every op covered by `frontier`
    frontier: torch.Tensor   # int32[W] per-writer max folded seq (-1 = none)
    tail: oplog.OpLog        # ops beyond the frontier (sorted, padded)

    @property
    def capacity(self) -> int:
        return self.tail.capacity

    @property
    def n_keys(self) -> int:
        return self.summary.num.shape[-1]

    @property
    def n_writers(self) -> int:
        return self.frontier.shape[-1]


def empty_summary(n_keys: int, device=None) -> Summary:
    device = default_device(device)

    def full(fill, dtype=torch.int32):
        return torch.full((n_keys,), fill, dtype=dtype, device=device)

    return Summary(
        present=full(False, torch.bool), num=full(0), num_count=full(0),
        ts=full(TS_NULL_PY), rid=full(-1), seq=full(-1), payload=full(0),
        is_num=full(False, torch.bool),
    )


def _no_frontier(n_writers: int, device) -> torch.Tensor:
    return torch.full((n_writers,), -1, dtype=torch.int32, device=device)


def empty(capacity: int, n_keys: int, n_writers: int, device=None) -> CompactedLog:
    device = default_device(device)
    return CompactedLog(summary=empty_summary(n_keys, device),
                        frontier=_no_frontier(n_writers, device),
                        tail=oplog.empty(capacity, device=device))


def fresh(log: oplog.OpLog, n_keys: int, n_writers: int) -> CompactedLog:
    """Wrap an uncompacted log (frontier = -1: nothing folded yet), on the
    log's device."""
    device = log.ts.device
    return CompactedLog(summary=empty_summary(n_keys, device),
                        frontier=_no_frontier(n_writers, device), tail=log)


def size(c: CompactedLog) -> torch.Tensor:
    """Live (unfolded) rows: the quantity compaction keeps bounded."""
    return oplog.size(c.tail)


def received_vv(c: CompactedLog) -> torch.Tensor:
    """This replica's full knowledge watermark: folded or still raw."""
    return torch.maximum(c.frontier, oplog.version_vector(c.tail, c.n_writers))


def _lex_gt(a, b) -> torch.Tensor:
    """(ts, rid, seq) lexicographic strictly-greater, elementwise (signed
    int32 compares)."""
    return ((a[0] > b[0])
            | ((a[0] == b[0]) & (a[1] > b[1]))
            | ((a[0] == b[0]) & (a[1] == b[1]) & (a[2] > b[2])))


def merge(a: CompactedLog, b: CompactedLog) -> CompactedLog:
    """CRDT join of two compacted logs with comparable (chain) frontiers:
    take the further-ahead side's summary and frontier verbatim, then union
    the tails with every row at or under the adopted frontier dropped.

    The adopted frontier is the winning SIDE's, not the elementwise max: if
    the chain precondition is ever violated, the max would drop tail rows
    that NEITHER summary folded; the winner's own frontier never covers
    rows outside its summary.  The choice stays on the device (no sync)."""
    a_geq = torch.all(a.frontier >= b.frontier)
    frontier = torch.where(a_geq, a.frontier, b.frontier)
    summary = Summary(**{
        f: torch.where(a_geq, getattr(a.summary, f), getattr(b.summary, f))
        for f in SUMMARY_FIELDS
    })
    tail = oplog.merge(oplog.delta_since(a.tail, frontier),
                       oplog.delta_since(b.tail, frontier))
    return CompactedLog(summary=summary, frontier=frontier, tail=tail)


def _fold_tail(tail: oplog.OpLog, mask: torch.Tensor, n_keys: int):
    """Per-key facts of the masked tail rows: (has, sums, counts, newest row
    fields) in two scatter-adds and one scatter-max.  Scatter targets follow
    JAX's ``.at[]`` rules over a table of ``n_keys + 1`` slots
    (``oplog._scatter_slots``): a negative key counts from the end once, an
    out-of-range key is dropped, a masked row goes to the spare slot
    ``n_keys``; sums wrap mod 2^32 in int32."""
    key_safe = torch.where(mask, tail.key, n_keys)
    n_slots = n_keys + 1
    flat = oplog._scatter_slots(key_safe, n_slots)
    dev = tail.ts.device

    def table(fill):
        return torch.full((n_slots + 1,), fill, dtype=torch.int32, device=dev)

    numeric = mask & tail.is_num
    sums = table(0).index_add_(0, flat, torch.where(numeric, tail.val, 0))[:n_keys]
    counts = table(0).index_add_(0, flat, numeric.to(torch.int32))[:n_keys]
    # Rows are sorted ascending by (ts, rid, seq), so the largest masked row
    # index per key IS the lexicographically newest masked op.
    idx = torch.arange(tail.capacity, dtype=torch.int32, device=dev)
    last = table(-1).scatter_reduce_(0, flat, torch.where(mask, idx, -1),
                                     reduce="amax", include_self=True)[:n_keys]
    has = last >= 0
    li = last.clamp(min=0).long()
    newest = (tail.ts[li], tail.rid[li], tail.seq[li])
    return has, sums, counts, newest, tail.payload[li], tail.is_num[li]


def compact(c: CompactedLog, new_frontier: torch.Tensor) -> CompactedLog:
    """Advance the compaction frontier: fold every tail row at or under
    ``new_frontier`` into the summary and drop it from the tail.

    ``new_frontier`` must be a swarm-agreed stable frontier, so frontiers
    stay chain-ordered across live replicas.  As a safety net the advance is
    clamped to this replica's own received watermark: a frontier beyond ops
    never received would make later merges drop them as "already folded".
    Observable state is invariant: rebuild(compact(c, f)) == rebuild(c)."""
    s, t = c.summary, c.tail
    frontier = torch.maximum(c.frontier, torch.minimum(new_frontier, received_vv(c)))
    cov = oplog.covered_by(t, frontier)
    has, sums, counts, newest, pay, isnum = _fold_tail(t, cov, c.n_keys)
    newer = has & (~s.present | _lex_gt(newest, (s.ts, s.rid, s.seq)))
    summary = Summary(
        present=s.present | has,
        num=s.num + sums,
        num_count=s.num_count + counts,
        ts=torch.where(newer, newest[0], s.ts),
        rid=torch.where(newer, newest[1], s.rid),
        seq=torch.where(newer, newest[2], s.seq),
        payload=torch.where(newer, pay, s.payload),
        is_num=torch.where(newer, isnum, s.is_num),
    )
    return CompactedLog(summary=summary, frontier=frontier,
                        tail=oplog.delta_since(t, frontier))


def rebuild(c: CompactedLog) -> oplog.KVState:
    """Materialized view over summary + tail, equal to ``oplog.rebuild`` of
    the uncompacted log.  Numeric sums and counts add across the two parts;
    the mode-deciding newest op is the lexicographic max of the summary's
    newest and the tail's newest per key."""
    s, t = c.summary, c.tail
    valid = t.ts != SENTINEL_PY
    has, sums, counts, newest, pay, isnum = _fold_tail(t, valid, c.n_keys)
    tail_newer = has & (~s.present | _lex_gt(newest, (s.ts, s.rid, s.seq)))
    present = s.present | has
    newest_is_num = torch.where(tail_newer, isnum, s.is_num) & present
    return oplog.KVState(
        present=present,
        is_num=newest_is_num,
        num=torch.where(newest_is_num, s.num + sums, 0),
        num_count=s.num_count + counts,
        payload=torch.where(present, torch.where(tail_newer, pay, s.payload), 0),
    )
