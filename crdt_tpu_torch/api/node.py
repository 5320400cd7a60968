"""ReplicaNode: the host-side replica (counterpart of
``crdt_tpu.api.node``), the answer to the reference's ``Server`` struct
(its main.go:23-33), with the replica's log on the CUDA card.

The five capabilities of the reference's HTTP surface are plain methods:

  add_command  <- POST /data   (main.go:173-215)
  get_state    <- GET  /data   (main.go:129-139)
  gossip_payload / receive <- GET /gossip + the pull loop (main.go:154-171,
                               226-261)
  ping         <- GET  /ping   (main.go:115-127)
  set_alive    <- GET  /condition (main.go:141-152)

Gossip payloads carry STRINGS, like the reference's JSON wire format, and
each node interns into its own table on receipt, so two nodes never share
an interner.  Host bookkeeping (the command map, the delta indexes, the
version vector, the compaction frontier and its wire-shaped summary) is
plain Python; the device holds the op log and runs its merge, the
compaction fold and the rebuild (``models.oplog``, ``models.compactlog``).

The live divergence audit (``enable_audit``) keeps an incremental digest
of the node's winner rows on the host (:mod:`crdt_tpu_torch.obs.audit`);
its hooks sit inside the node's locked sections and never take the device
lock.  Checkpoints are :mod:`crdt_tpu_torch.utils.checkpoint`.

Not ported (each raises when asked for): the native C++ interner and wire
store (``use_native=True``), and the device-mesh digest check of
``PendingMerge.commit(digest=)`` (ROADMAP Queue 1 item 6).
"""
from __future__ import annotations

import json
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from crdt_tpu_torch import default_device
from crdt_tpu_torch.models import compactlog, oplog
from crdt_tpu_torch.obs import devtime, health
from crdt_tpu_torch.obs.events import EventLog
from crdt_tpu_torch.obs.provenance import FlightRecorder
from crdt_tpu_torch.obs.trace import current_trace, span
from crdt_tpu_torch.ops import union_engine
from crdt_tpu_torch.utils.clock import HostClock, SeqGen
from crdt_tpu_torch.utils.intern import Interner, encode_value
from crdt_tpu_torch.utils.metrics import Metrics

# Wire key for an op: "ts:rid:seq" (a collision-free op identity).
# Timestamps travel as ABSOLUTE Unix milliseconds: nodes in different
# processes have different int32 epochs, so the wire carries the
# epoch-free value and each receiver rebases onto its own epoch.  Plain
# integer keys (a Go peer's UnixMilli log keys, main.go:187) are accepted
# with rid=-1, seq=0.
INT32_MIN, INT32_MAX = -(2**31), 2**31 - 1

# Reserved payload sections for compaction-aware gossip.  Not part of the
# Go-compatible wire surface: a reference peer would choke on these keys,
# so compaction stays off (the reference never prunes, main.go:75) unless
# the deployment opts in (ClusterConfig.compact_every / compact()).
FRONTIER_KEY = "__frontier__"
SUMMARY_KEY = "__summary__"


def _summary_entry(e: Dict[str, Any]) -> Dict[str, Any]:
    """Normalize one wire-shaped summary entry (the single schema
    definition: payload adoption and the device-summary decoder use it)."""
    return {
        "num": int(e["num"]),
        "num_count": int(e["num_count"]),
        "ts": int(e["ts"]),
        "rid": int(e["rid"]),
        "seq": int(e["seq"]),
        "payload": str(e["payload"]),
        "is_num": bool(e["is_num"]),
    }


def _wire_key(ts_abs: int, rid: int, seq: int) -> str:
    return f"{ts_abs}:{rid}:{seq}"


def _parse_wire_key(k: str) -> Tuple[int, int, int]:
    if ":" in k:
        ts, rid, seq = k.split(":")
        return int(ts), int(rid), int(seq)
    return int(k), -1, 0  # Go-format key: millisecond timestamp only


_WIRE_ESCAPES = {'"': '\\"', "\\": "\\\\", "\b": "\\b", "\f": "\\f", "\n": "\\n",
                 "\r": "\\r", "\t": "\\t"}
_WIRE_ESCAPES.update({chr(c): f"\\u{c:04x}" for c in range(0x20) if chr(c) not in _WIRE_ESCAPES})
_WIRE_ESCAPE_TABLE = str.maketrans(_WIRE_ESCAPES)


def _wire_escape(s: str) -> str:
    """A string escaped as the wire store escapes it (see
    ``ReplicaNode._wire_json_locked``)."""
    return s.translate(_WIRE_ESCAPE_TABLE)


def stable_frontier_host(vvs, frontiers) -> Dict[int, int]:
    """The host-side stable frontier shared by every barrier scheduler: the
    per-writer min over the member version vectors ``vvs``, valid only if
    it dominates every existing fold in ``frontiers`` (the chain rule: a
    non-dominating barrier would mint an incomparable frontier
    generation).  Returns {} when no barrier is possible this round."""
    rids = set().union(*vvs)
    frontier = {
        r: s
        for r in rids
        if (s := min(vv.get(r, -1) for vv in vvs)) >= 0
    }
    for f in frontiers:
        for r, s in f.items():
            if frontier.get(r, -1) < s:
                return {}
    return frontier


# One device section at a time on a device.  Torch work issued from several
# threads at once (the HTTP surface runs each request, and so each drain
# and each pushed merge, on a thread of its own) contends for the
# interpreter between the ops of every merge, so concurrent merges of a
# cluster's replicas each take many times their time alone; taken in
# turns they run at their own speed (PERF.md, PR 12).
_DEVICE_LOCKS: Dict[str, threading.Lock] = {}
_DEVICE_LOCKS_GUARD = threading.Lock()


def device_lock(device) -> threading.Lock:
    """The lock that serializes the nodes' device sections on ``device``
    (taken inside a node's own lock, never the other way round)."""
    with _DEVICE_LOCKS_GUARD:
        return _DEVICE_LOCKS.setdefault(str(torch.device(device)), threading.Lock())


def _n_ops(payload: Dict[str, Any]) -> int:
    return sum(1 for k in payload if k not in (FRONTIER_KEY, SUMMARY_KEY))


def _quarantined(node, metrics, prefix: str, tid, error: str, **who) -> bool:
    """Count and log a malformed payload; the round is skipped."""
    metrics.inc(f"{prefix}_quarantined")
    node.events.emit("payload_quarantine", trace=tid, surface=prefix,
                     error=error[:200], **who)
    return False


def pull_round(node: "ReplicaNode", fetch_payload, metrics, delta: bool,
               prefix: str = "gossip", peer: Optional[str] = None,
               trace: Optional[str] = None, quarantine: bool = False) -> bool:
    """One anti-entropy pull into ``node``: ask the peer for a (delta)
    payload, merge it, and keep the skip/noop/fresh counters (named
    ``{prefix}_*``) consistent across transports.

    ``fetch_payload(since)`` returns the peer's payload dict, or None for
    an unreachable or dead peer (the reference's 502-skip,
    main.go:235-239).  The outcome is emitted to ``node.events`` under the
    round's trace ID, and the delta payload's op count is recorded as the
    lag-behind-``peer`` gauge.

    ``quarantine=True`` (the network agent) turns a MALFORMED payload (bad
    wire keys, out-of-window timestamps, a truncated summary section,
    non-dict commands) into a skipped round: ``{prefix}_quarantined`` and
    a ``payload_quarantine`` event, nothing merged.  In process the
    default raises: there a malformed payload is a local bug.
    """
    lab = str(node.rid)
    if not node.alive:
        metrics.inc(f"{prefix}_skipped")
        node.events.emit("pull_skip", trace=trace, peer=peer, reason="down")
        return False
    with span(f"crdt.pull_round.{prefix}", trace) as tid:
        since = node.version_vector() if delta else None
        payload = fetch_payload(since)
        if payload is None:
            metrics.inc(f"{prefix}_skipped")
            node.events.emit("pull_skip", trace=tid, peer=peer,
                             reason="peer_unreachable")
            return False
        n_ops = _n_ops(payload)
        if delta:
            health.observe_pull_lag(metrics.registry, lab, peer or "?", n_ops)
        if not payload:  # delta mode: peer had nothing we lack, no merge
            metrics.inc(f"{prefix}_noop")
            node.events.emit("pull_noop", trace=tid, peer=peer)
            return False
        metrics.inc(f"{prefix}_payload_ops", n_ops)
        try:
            fresh = node.receive(payload)
        except (ValueError, KeyError, TypeError) as e:
            if not quarantine:
                raise
            return _quarantined(node, metrics, prefix, tid,
                                f"{type(e).__name__}: {e}", peer=peer)
        if not fresh:  # payload was all re-deliveries
            metrics.inc(f"{prefix}_noop")
            node.events.emit("pull_noop", trace=tid, peer=peer, ops=n_ops)
            return False
        metrics.inc(f"{prefix}_rounds")
        health.mark_merge(metrics.registry, lab)
        node.events.emit("pull_merge", trace=tid, peer=peer, ops=n_ops, fresh=fresh)
        return True


def fused_pull_round(node: "ReplicaNode", fetched, metrics, delta: bool,
                     prefix: str = "gossip", trace: Optional[str] = None,
                     quarantine: bool = False) -> bool:
    """The k-way sibling of :func:`pull_round`.  ``fetched`` is a list of
    ``(peer_label, payload_or_None)`` pairs the caller already collected
    against the SAME pre-round version vector; every non-empty payload is
    merged in ONE device merge via :meth:`ReplicaNode.receive_many`.
    Per-peer skip/noop accounting matches the sequential path exactly;
    with ``quarantine=True`` a malformed payload is quarantined alone
    (validated before the merge) and the others still merge."""
    lab = str(node.rid)
    if not node.alive:
        metrics.inc(f"{prefix}_skipped")
        node.events.emit("pull_skip", trace=trace, reason="down")
        return False
    with span(f"crdt.fused_pull_round.{prefix}", trace) as tid:
        payloads, labels, total_ops = [], [], 0
        for peer, payload in fetched:
            if payload is None:
                metrics.inc(f"{prefix}_skipped")
                node.events.emit("pull_skip", trace=tid, peer=peer,
                                 reason="peer_unreachable")
                continue
            n_ops = _n_ops(payload)
            if delta:
                health.observe_pull_lag(metrics.registry, lab, peer or "?", n_ops)
            if not payload:  # delta mode: this peer had nothing we lack
                metrics.inc(f"{prefix}_noop")
                node.events.emit("pull_noop", trace=tid, peer=peer)
                continue
            if quarantine:
                bad = node.validate_payload(payload)
                if bad is not None:
                    _quarantined(node, metrics, prefix, tid, bad, peer=peer)
                    continue
            payloads.append(payload)
            labels.append(peer)
            total_ops += n_ops
        if not payloads:
            return False
        health.observe_fused_pull(metrics.registry, lab, len(payloads))
        metrics.inc(f"{prefix}_payload_ops", total_ops)
        try:
            fresh = node.receive_many(payloads)
        except (ValueError, KeyError, TypeError) as e:
            if not quarantine:
                raise
            return _quarantined(node, metrics, prefix, tid,
                                f"{type(e).__name__}: {e}", peers=labels)
        if not fresh:  # every payload was re-deliveries
            metrics.inc(f"{prefix}_noop")
            node.events.emit("pull_noop", trace=tid, peers=labels, ops=total_ops)
            return False
        metrics.inc(f"{prefix}_rounds")
        health.mark_merge(metrics.registry, lab)
        node.events.emit("pull_merge_fused", trace=tid, peers=labels,
                         ops=total_ops, fresh=fresh)
        return True


def _check_window(tss: List[int]) -> None:
    """Local timestamps must lie in [0, INT32_MAX): ts == INT32_MAX is the
    SENTINEL padding encoding, so a row minted there would be invisible to
    every sorted-table path.  Checked for the whole batch before any
    bookkeeping mutates (all-or-nothing)."""
    if not (0 <= min(tss) and max(tss) < INT32_MAX):
        i, ts = next((i, t) for i, t in enumerate(tss) if not (0 <= t < INT32_MAX))
        raise ValueError(
            f"batch op {i}: timestamp {ts} outside the storable int32 window "
            f"[0, {INT32_MAX}) (ts == {INT32_MAX} is the SENTINEL padding encoding)"
        )


class PendingMerge:
    """One plane's decoded and accepted, not yet merged, ingest batch.

    Produced by :meth:`ReplicaNode.merge_begin` /
    :meth:`ReplicaNode.add_commands_begin` with the node lock HELD; it stays
    held until :meth:`commit` / :meth:`commit_inline` / :meth:`abort`, so a
    caller can merge many planes' batches in one dispatch of its own while
    each plane's host bookkeeping lands exactly where the inline path puts
    it.
    """

    __slots__ = ("node", "ops", "fresh", "adopted", "rows", "births",
                 "vv_before", "done", "dig", "dig_sum")

    def __init__(self, node: "ReplicaNode"):
        self.node = node
        self.ops: Optional[Dict[str, np.ndarray]] = None
        self.fresh = 0
        self.adopted = 0
        # decoded wire rows (the recorder's birth stamps on commit)
        self.rows: List[Tuple[int, int, int, Dict[str, str]]] = []
        # locally-minted (seq, abs_ts) birth stamps (add_commands_begin)
        self.births: List[Tuple[int, int]] = []
        # the vector before a merge_begin (None for local writes, whose
        # visibility is birth, not propagation)
        self.vv_before: Optional[Dict[int, int]] = None
        self.done = False
        # audit-digest lanes of the packed batch (fresh, 4 uint32) and
        # their host-side sum, as the JAX package carries them for its
        # device-mesh fold's check
        self.dig: Optional[np.ndarray] = None
        self.dig_sum: Optional[np.ndarray] = None

    def rows_held(self) -> int:
        """Live log rows of the plane (the lock is held, so it is stable)."""
        n = self.node._log_rows
        if n is None:
            n = int(oplog.size(self.node.log))
            self.node._log_rows = n
        return n

    def commit(self, merged_log: oplog.OpLog, n_unique: int, digest=None) -> int:
        """Finish the deferred merge with the caller's merged log: rebind
        the log, finish accounting, release the node lock.  ``n_unique``
        must already be a host int.  ``digest`` (the device-mesh plane's
        folded digest lanes, checked against :attr:`dig_sum`) is not
        ported and raises."""
        node = self.node
        if digest is not None:
            self.abort()
            raise NotImplementedError(
                "PendingMerge.commit(digest=): the device-mesh digest check is not "
                "ported (ROADMAP Queue 1 item 6)")
        try:
            if self.fresh:
                assert n_unique <= merged_log.ts.shape[-1], (
                    f"fused union {n_unique} rows overflowed lane capacity "
                    f"{merged_log.ts.shape[-1]}")
                node.log = merged_log
                node._log_rows = int(n_unique)
                node.metrics.inc("ops_ingested", self.fresh)
                node._count_lane_fold()
            self._finish_recording()
        finally:
            self.done = True
            node._lock.release()
        return self.fresh + self.adopted

    def commit_inline(self) -> int:
        """Run THIS plane's merge as the inline dispatch (exactly
        ``_merge_batch``) and finish accounting."""
        node = self.node
        try:
            if self.fresh:
                node._merge_batch(self.ops, self.fresh)
            self._finish_recording()
        finally:
            self.done = True
            node._lock.release()
        return self.fresh + self.adopted

    def abort(self) -> None:
        """Release the node lock WITHOUT merging.  If fresh ops were
        accepted, the host indexes are ahead of the log until a later merge
        lands them (prefer commit_inline)."""
        self.done = True
        self.node._lock.release()

    def _finish_recording(self) -> None:
        node = self.node
        if self.births and node.recorder.enabled:
            node.recorder.note_births(self.births)
        if self.vv_before is None:
            return
        vv_after = node._version_vector_locked()
        if vv_after == self.vv_before:
            return
        epoch = node.clock.epoch_ms
        cmds = None
        if node.recorder.tenant_of is not None:
            # tenant attribution (keyspace shards): the raw command rows
            cmds = {(rid, seq): cmd for _, rid, seq, cmd in self.rows}
        node.recorder.note_visible(
            self.vv_before, vv_after,
            births={(rid, seq): ts + epoch for ts, rid, seq, _ in self.rows},
            cmds=cmds)


class ReplicaNode:
    def __init__(
        self,
        rid: int,
        capacity: int = 1024,
        clock: Optional[HostClock] = None,
        metrics: Optional[Metrics] = None,
        use_native: Optional[bool] = None,
        go_compat_gossip: bool = False,
        events: Optional[EventLog] = None,
        device=None,
    ):
        if use_native:
            raise ValueError(
                "use_native=True: the native C++ interner and wire store are "
                "not ported; the port interns and packs in Python")
        self.rid = rid
        self.device = default_device(device)
        self.events = events if events is not None else EventLog(node=str(rid))
        # Opt-in mixed-fleet mode: full-dump gossip with the reference's
        # BARE integer-ms keys, so an original Go peer can pull from this
        # node.  Lossy by the reference's own rule: ops sharing a
        # millisecond collapse to the highest (rid, seq).  Compaction is
        # forbidden (summary sections are not Go-parseable).
        self.go_compat_gossip = bool(go_compat_gossip)
        # the live divergence audit's incremental digest (obs.audit),
        # opt-in via enable_audit(): a bare node pays one None check on
        # the ingest paths
        self.digest = None
        self.clock = clock or HostClock()
        self.metrics = metrics or Metrics()
        # convergence flight recorder: birth stamps on the write path,
        # vv-delta visibility on the merge path
        self.recorder = FlightRecorder(rid, self.metrics.registry, events=self.events)
        if self.events.registry is None:
            self.events.registry = self.metrics.registry
        self.keys = Interner()
        self.values = Interner()
        self.log = oplog.empty(capacity, device=self.device)
        # host-tracked live row count of self.log, or None when unknown
        # (after a fold): spares a size reduction and a sync per write batch
        self._log_rows: Optional[int] = 0
        self.alive = True
        self._seq = SeqGen()
        self._lock = threading.Lock()
        # host copy of raw commands per op, for gossip serving:
        # (ts, rid, seq) -> {key: value}
        self._commands: Dict[Tuple[int, int, int], Dict[str, str]] = {}
        # delta-extraction indexes over _commands (sharing the cmd dicts):
        # per-writer ops in ascending-seq order (seqs are per-writer
        # contiguous, so "ops after seq s" is a list slice and delta gossip
        # costs O(delta)), watermarkless rid<0 (Go-peer) ops, and the
        # incremental received watermark
        self._by_writer: Dict[int, List[Tuple[Tuple[int, int, int], Dict[str, str]]]] = {}
        self._foreign: List[Tuple[Tuple[int, int, int], Dict[str, str]]] = []
        self._vv: Dict[int, int] = {}
        # go-compat echo dedup: ops round-tripping through a Go peer come
        # back with only their ts (rid=-1); a rid<0 op whose ts any held op
        # already occupies is a re-echo and is dropped (local wins)
        self._ts_seen: set = set()
        # compaction state: per-writer folded watermark + the per-key fold
        # of everything under it, wire-shaped: {"num", "num_count", "ts"
        # (absolute ms), "rid", "seq", "payload" (raw string), "is_num"}
        self._frontier: Dict[int, int] = {}
        self._summary: Dict[str, Dict[str, Any]] = {}
        # encoded-summary cache: (Summary tensors, key-space size); the
        # host summary changes only on compact/adopt
        self._summary_cache: Optional[Tuple[compactlog.Summary, int]] = None
        # extra metric labels for this plane's merge accounting (the
        # sharded keyspace binds {"shard": i}): the label-free counters
        # keep their one-tick-per-merge meaning, and with labels bound
        # merge_dispatches{shard=..} / union_path{shard=..} also tick once
        # per folded lane
        self._metric_labels: Dict[str, str] = {}

    # ---- write path ----

    def add_command(self, cmd: Dict[str, str], ts: Optional[int] = None) -> bool:
        """POST /data: append one multi-key command.  Returns False when the
        node is down (the reference 502s, main.go:210-212)."""
        with self._lock:
            if not self.alive:
                return False
            ts = self.clock.now_ms() if ts is None else ts
            _check_window([ts])
            seq = self._seq.next()
            with self.metrics.timer("write"):
                self._ingest([(ts, self.rid, seq, dict(cmd))])
            if self.recorder.enabled:
                self.recorder.note_birth(seq, ts + self.clock.epoch_ms)
            return True

    def _stamps(self, n: int, tss: Optional[List[Optional[int]]]) -> List[int]:
        if tss is None:
            return [self.clock.now_ms()] * n
        if len(tss) != n:
            raise ValueError(f"{len(tss)} timestamps for {n} commands")
        if None in tss:
            now = self.clock.now_ms()
            tss = [now if t is None else t for t in tss]
        _check_window(tss)
        return tss

    def add_commands(
        self,
        cmds: List[Dict[str, str]],
        tss: Optional[List[Optional[int]]] = None,
    ) -> Optional[List[Tuple[int, int]]]:
        """Batched write path: mint seqs for every command and land them all
        in ONE device merge.  ``tss[i]`` (None = stamp now) must satisfy the
        same int32 window as add_command.  Returns the minted (rid, seq)
        idents in submission order, or None when the node is down (the
        whole batch is refused).  The command dicts are adopted without a
        copy and must not be mutated after the call."""
        with self._lock:
            if not self.alive:
                return None
            if not cmds:
                return []
            n = len(cmds)
            tss = self._stamps(n, tss)
            seq0 = self._seq.reserve(n)
            with self.metrics.timer("write"):
                ops, fresh = self._pack_local_batch(cmds, tss, seq0)
                if fresh:
                    self._merge_batch(ops, fresh)
            if self.recorder.enabled:
                epoch = self.clock.epoch_ms
                self.recorder.note_births([(seq0 + i, t + epoch) for i, t in enumerate(tss)])
            return [(self.rid, seq0 + i) for i in range(n)]

    # ---- read path ----

    def get_state(self) -> Optional[Dict[str, str]]:
        """GET /data: the materialized key-value view (None when down)."""
        if not self.alive:
            return None
        with self._lock, device_lock(self.device):
            if self._frontier:
                kv = compactlog.rebuild(self._device_clog_locked())
            else:
                kv = oplog.rebuild(self.log, n_keys=self._n_keys())
            return oplog.materialize(kv, self.keys, self.values)

    # round tensor dims up to powers of two, as the JAX package does to
    # bound its recompiles (materialize only reads len(keys))
    def _n_keys(self) -> int:
        n = 16
        while n < len(self.keys):
            n *= 2
        return n

    def _n_writers(self) -> int:
        top = max([self.rid, *self._frontier, *self._vv], default=0)
        n = 8
        while n <= top:
            n *= 2
        return n

    # ---- gossip ----

    def version_vector(self) -> Dict[int, int]:
        """This node's received watermark: writer rid -> max contiguous seq
        held (folded or raw).  The delta-gossip request token."""
        with self._lock:
            return self._version_vector_locked()

    def vv_snapshot(self) -> Tuple[Dict[int, int], Dict[int, int]]:
        """(version vector, folded frontier) under ONE lock acquisition:
        barrier coordinators need the pair mutually consistent (a frontier
        adopted between two reads would run ahead of the vv)."""
        with self._lock:
            return self._version_vector_locked(), dict(self._frontier)

    def audit_snapshot(self) -> Tuple[Dict[int, int], Dict[int, int], Optional[str]]:
        """One-lock (vv, frontier, digest-at-frontier hex) snapshot, the
        source of the gossip response's stability header: the digest must
        be clamped at the same frontier the summary carries.  The digest
        is None until :meth:`enable_audit`."""
        with self._lock:
            vv = self._version_vector_locked()
            frontier = dict(self._frontier)
            d = self.digest
            dig = d.digest_hex_at(frontier) if d is not None and d.enabled else None
        return vv, frontier, dig

    @property
    def frontier(self) -> Dict[int, int]:
        """This node's folded watermark (snapshot copy)."""
        with self._lock:
            return dict(self._frontier)

    def _version_vector_locked(self) -> Dict[int, int]:
        vv = dict(self._frontier)
        for rid, seq in self._vv.items():
            if seq > vv.get(rid, -1):
                vv[rid] = seq
        return vv

    def gossip_payload(
        self, since: Optional[Dict[int, int]] = None
    ) -> Optional[Dict[str, Any]]:
        """GET /gossip: op-log wire JSON (None when down; the caller skips,
        as on the reference's 502 path, main.go:166-169).

        ``since`` is the requester's version vector: only ops it is missing
        are included (delta gossip; the reference re-ships its ENTIRE log
        every round, main.go:159).  When this node has compacted past what
        ``since`` covers, the payload also carries the summary and frontier
        sections so the requester can adopt the fold.  rid<0 (Go-format)
        ops carry no watermark and ride every payload."""
        if not self.alive:
            return None
        with self._lock:
            return self._payload_locked(since)

    def _needs_sections_locked(self, since: Optional[Dict[int, int]]) -> bool:
        """Must the payload carry the __frontier__/__summary__ sections?
        (Yes when this node has folded past what ``since`` covers.)"""
        since = since or {}
        return bool(self._frontier) and not all(
            since.get(r, -1) >= s for r, s in self._frontier.items()
        )

    def _payload_locked(self, since: Optional[Dict[int, int]]) -> Dict[str, Any]:
        epoch = self.clock.epoch_ms
        if since is None:
            if self.go_compat_gossip:
                # reference-format full dump: bare integer-ms keys; iteration
                # is (ts, rid, seq)-ascending, so same-ms ops collapse to the
                # highest (rid, seq)
                return {str(k[0] + epoch): dict(v) for k, v in sorted(self._commands.items())}
            # full dump of retained raw ops, ts-sorted like the reference's
            # treemap JSON (main.go:159)
            payload: Dict[str, Any] = {
                _wire_key(k[0] + epoch, k[1], k[2]): dict(v)
                for k, v in sorted(self._commands.items())
            }
        else:
            # delta: per-writer tail slices, O(|delta|)
            payload = {_wire_key(k[0] + epoch, k[1], k[2]): dict(v) for k, v in self._foreign}
            for w, lst in self._by_writer.items():
                if not lst:
                    continue
                start = since.get(w, -1) + 1 - lst[0][0][2]
                for k, v in lst[max(start, 0):]:
                    payload[_wire_key(k[0] + epoch, k[1], k[2])] = dict(v)
        if self._frontier:
            # the frontier piggybacks on EVERY payload (a caught-up
            # requester folds and prunes at adoption time from its own raw
            # ops); the summary rides along only when the requester is
            # behind the fold
            payload[FRONTIER_KEY] = {str(r): s for r, s in self._frontier.items()}
            if self._needs_sections_locked(since):
                payload[SUMMARY_KEY] = {k: dict(e) for k, e in self._summary.items()}
        return payload

    def gossip_payload_json(
        self, since: Optional[Dict[int, int]] = None
    ) -> Optional[bytes]:
        """``gossip_payload`` as UTF-8 JSON bytes (the HTTP serving path),
        the bytes the JAX node serves: while no compaction section is
        needed, its wire store's compact form (:meth:`_wire_json_locked`);
        otherwise ``json.dumps`` of the payload.  One lock acquisition
        either way."""
        if not self.alive:
            return None
        with self._lock:
            if not self._frontier and not (self.go_compat_gossip and since is None):
                return self._wire_json_locked(since)
            payload = self._payload_locked(since)
        return json.dumps(payload).encode()

    def _wire_json_locked(self, since: Optional[Dict[int, int]]) -> bytes:
        """The op payload as the JAX package's native wire store emits it:
        ``{"ts:rid:seq":{"key":"value",...},...}`` in identity order, no
        whitespace, strings escaped byte-wise (``\\"``, ``\\\\``, the
        short escapes of \\b \\f \\n \\r \\t, ``\\u00xx`` for the other
        control characters, every other character raw UTF-8).  With
        ``since`` the ops it covers are skipped; rid<0 ops always ride."""
        epoch = self.clock.epoch_ms
        if since is None:
            items = sorted(self._commands.items())
        else:
            items = list(self._foreign)
            for w, lst in self._by_writer.items():
                if lst:
                    items += lst[max(since.get(w, -1) + 1 - lst[0][0][2], 0):]
            items.sort(key=lambda kv: kv[0])
        ops = (f'"{ts + epoch}:{rid}:{seq}":{{'
               + ",".join(f'"{_wire_escape(k)}":"{_wire_escape(v)}"' for k, v in cmd.items())
               + "}"
               for (ts, rid, seq), cmd in items)
        return ("{" + ",".join(ops) + "}").encode()

    def _decode_payload(self, payload: Dict[str, Any], check_cmds: bool = True):
        """Wire payload -> (remote_frontier, remote_summary, op rows),
        timestamps rebased onto this node's int32 window.  A malformed key
        raises ValueError (the reference silently killed its gossip loop);
        with ``check_cmds`` a non-dict command raises TypeError once every
        key has decoded, before the node lock, so a payload is merged whole
        or not at all."""
        payload = dict(payload)
        remote_frontier = {
            int(r): int(s) for r, s in (payload.pop(FRONTIER_KEY, None) or {}).items()
        }
        remote_summary = payload.pop(SUMMARY_KEY, None) or {}
        epoch = self.clock.epoch_ms
        rows = []
        for k, cmd in payload.items():
            ts_abs, rid, seq = _parse_wire_key(k)
            ts = ts_abs - epoch  # rebase onto this node's int32 window
            # strict upper bound: ts == INT32_MAX is the SENTINEL padding
            if not (INT32_MIN <= ts < INT32_MAX):
                raise ValueError(
                    f"gossip timestamp {ts_abs} is outside this node's int32 "
                    f"window (epoch {epoch}); reference quirk §0.1.8 made this "
                    "kill gossip silently — here it fails loudly"
                )
            rows.append((ts, rid, seq, cmd))
        if check_cmds:
            for _, _, _, cmd in rows:
                if not isinstance(cmd, dict):
                    raise TypeError(f"non-dict command: {type(cmd).__name__}")
        return remote_frontier, remote_summary, rows

    def validate_payload(self, payload: Dict[str, Any]) -> Optional[str]:
        """Structural check of a wire payload WITHOUT merging: None when
        ``receive`` would accept it, else a short reason.  The network
        pull paths quarantine a payload this refuses instead of merging
        any part of it."""
        try:
            _, summary, rows = self._decode_payload(dict(payload), check_cmds=False)
        except (ValueError, KeyError, TypeError, AttributeError) as e:
            return f"{type(e).__name__}: {e}"
        for _, _, _, cmd in rows:
            if not isinstance(cmd, dict):
                return f"non-dict command: {type(cmd).__name__}"
        for k, entry in summary.items():
            if not isinstance(entry, dict):
                return f"non-dict summary entry for key {k!r}"
        return None

    def receive(self, payload: Optional[Dict[str, Any]]) -> int:
        """Pull-side merge of a peer's gossip payload (main.go:250-257);
        returns the number of genuinely new ops absorbed (0 = the payload
        taught us nothing).  Unknown strings are interned locally."""
        if not payload or not self.alive:
            return 0
        return self._receive([payload], "crdt.merge")

    def receive_many(self, payloads: List[Dict[str, Any]]) -> int:
        """K-way FUSED merge: absorb several peers' gossip payloads in ONE
        device merge.  Bit-exact against merging them one ``receive`` at a
        time in any order: the op union is ACI, and compaction frontiers
        form a chain, so adopting them in payload order lands on the same
        fold; only the number of device merges changes."""
        if not self.alive:
            return 0
        return self._receive(payloads, "crdt.merge_fused")

    def _receive(self, payloads: List[Dict[str, Any]], span_name: str) -> int:
        decoded = [self._decode_payload(p) for p in payloads if p]
        if not decoded:
            return 0
        # a muted recorder (a checkpoint replay: recovery, not
        # propagation) or a disabled registry records nothing
        recording = self.recorder.enabled
        vv_before = vv_after = None
        with self._lock:
            with self.metrics.timer("merge"), span(span_name):
                if recording:
                    vv_before = self._version_vector_locked()
                adopted, rows_all = self._adopt_all_locked(decoded)
                fresh = self._ingest(rows_all)
                if recording:
                    vv_after = self._version_vector_locked()
        if recording and vv_after != vv_before:
            # one vv delta covers the whole round: per (origin, seq) the
            # payloads' duplicates collapse to one visibility
            epoch = self.clock.epoch_ms
            cmds = None
            if self.recorder.tenant_of is not None:
                # tenant attribution (keyspace shards): the raw command rows
                cmds = {(rid, seq): cmd for _, rid, seq, cmd in rows_all}
            self.recorder.note_visible(
                vv_before, vv_after,
                births={(rid, seq): ts + epoch for ts, rid, seq, _ in rows_all},
                cmds=cmds)
        return fresh + adopted

    def _adopt_all_locked(self, decoded):
        """Adopt each payload's frontier in order; returns (adoptions, every
        payload's op rows)."""
        adopted = 0
        rows_all: List[Tuple[int, int, int, Dict[str, str]]] = []
        for remote_frontier, remote_summary, rows in decoded:
            if remote_frontier:
                adopted += self._adopt_frontier_locked(remote_frontier, remote_summary)
            rows_all.extend(rows)
        return adopted, rows_all

    # ---- deferred merge ----

    def merge_begin(self, payloads: List[Dict[str, Any]]) -> PendingMerge:
        """Deferred-merge half of :meth:`receive_many`: decode, adopt
        frontiers, accept and pack ``payloads`` exactly like the inline
        path, but STOP before the device merge and return the packed batch
        with the node lock HELD.  Never call from a thread already holding
        this node's lock; an empty ``payloads`` still returns a zero-fresh
        pending."""
        decoded = [self._decode_payload(p) for p in payloads if p]
        pending = PendingMerge(self)
        self._lock.acquire()
        try:
            if self.recorder.enabled:
                pending.vv_before = self._version_vector_locked()
            if self.alive and decoded:
                pending.adopted, pending.rows = self._adopt_all_locked(decoded)
                accepted = self._accept_locked(pending.rows)
                pending.ops, pending.fresh = self._pack_accepted_locked(accepted)
                if pending.fresh and self.digest is not None and self.digest.enabled:
                    pending.dig = self.digest.dig_column(accepted, self.clock.epoch_ms)
                    pending.dig_sum = pending.dig.sum(axis=0, dtype=np.uint32)
        except BaseException:
            self._lock.release()
            raise
        return pending

    def add_commands_begin(
        self,
        cmds: List[Dict[str, str]],
        tss: Optional[List[Optional[int]]] = None,
    ) -> Tuple[Optional[List[Tuple[int, int]]], PendingMerge]:
        """Deferred-merge half of :meth:`add_commands`: mint seqs and do
        every piece of host bookkeeping, but leave the device merge to the
        caller.  Returns ``(idents, pending)`` with the node lock HELD
        inside ``pending``; idents is None when the node is down (the
        pending is then zero-fresh and must still be committed or
        aborted)."""
        pending = PendingMerge(self)
        self._lock.acquire()
        try:
            if not self.alive:
                return None, pending
            if not cmds:
                return [], pending
            n = len(cmds)
            tss = self._stamps(n, tss)
            seq0 = self._seq.reserve(n)
            pending.ops, pending.fresh = self._pack_local_batch(cmds, tss, seq0)
            epoch = self.clock.epoch_ms
            if pending.fresh and self.digest is not None and self.digest.enabled:
                pending.dig = self.digest.dig_column(
                    [(t, self.rid, seq0 + i, c) for i, (c, t) in enumerate(zip(cmds, tss))],
                    epoch)
                pending.dig_sum = pending.dig.sum(axis=0, dtype=np.uint32)
            pending.births = [(seq0 + i, t + epoch) for i, t in enumerate(tss)]
            return [(self.rid, seq0 + i) for i in range(n)], pending
        except BaseException:
            self._lock.release()
            raise

    # ---- the live divergence audit (obs.audit) ----

    def enable_audit(self, plane: str = "host"):
        """Opt in to the live divergence audit: attach an incremental
        winner-row digest (:class:`~crdt_tpu_torch.obs.audit.PlaneDigest`)
        and seed it from the current store.  Idempotent (re-labels and
        reseeds); returns the digest."""
        from crdt_tpu_torch.obs.audit import PlaneDigest

        with self._lock:
            if self.digest is None:
                self.digest = PlaneDigest(self, plane=plane)
            else:
                self.digest.plane = plane
            self.digest.resync()
        return self.digest

    def audit_digest_at(self, frontier: Dict[int, int]) -> Optional[str]:
        """Hex digest of this node's state clamped at ``frontier``, or
        None when the clamp is not comparable here: it is well-defined
        only while this node's own compaction frontier <= F (folded
        non-winner candidates under our fold are gone) and F <= our vv (we
        have seen everything under F).  Inside that window the below-F
        winner set is immutable, so the result is independent of
        in-flight ops and delivery order."""
        with self._lock:
            d = self.digest
            if d is None or not d.enabled:
                return None
            frontier = {int(r): int(s) for r, s in frontier.items()}
            if not all(frontier.get(r, -1) >= s for r, s in self._frontier.items()):
                return None
            vv = self._version_vector_locked()
            if not all(s <= vv.get(r, -1) for r, s in frontier.items()):
                return None
            return d.digest_hex_at(frontier)

    def audit_scrub(self) -> bool:
        """Recompute the digest FROM the store and adopt it; True when the
        accumulator disagreed (the store changed underneath the digest:
        silent corruption entering the served digest)."""
        with self._lock:
            d = self.digest
            if d is None or not d.enabled:
                return False
            return d.scrub()

    def _digest_resync_locked(self) -> None:
        if self.digest is not None and self.digest.enabled:
            self.digest.resync()

    # ---- health / fault injection ----

    def ping(self) -> bool:
        return self.alive

    def set_alive(self, alive: bool) -> None:
        self.alive = bool(alive)

    # ---- compaction (delta-CRDT log pruning, models.compactlog) ----

    def compact(self, frontier: Dict[int, int]) -> None:
        """Fold every held op at or under ``frontier`` into the summary and
        prune it from the log and the command map.

        ``frontier`` must be swarm-stable (LocalCluster.compact computes the
        min over the alive nodes' version vectors); it is clamped to this
        node's own knowledge, so a too-eager frontier cannot drop
        never-received ops.  The fold runs on the device
        (compactlog.compact) and is decoded back to the wire-shaped host
        summary."""
        if self.go_compat_gossip:
            raise ValueError(
                "compaction is forbidden in go-compat gossip mode: a folded "
                "node's payload needs the __summary__ sections, which a Go "
                "peer cannot parse"
            )
        with self._lock:
            vv = self._version_vector_locked()
            target = {r: min(s, vv.get(r, -1)) for r, s in frontier.items()}
            target = {r: s for r, s in target.items() if s > self._frontier.get(r, -1)}
            if not target:
                return
            merged = dict(self._frontier)
            merged.update(target)
            with span("crdt.compact") as tid:
                self._compact_to_locked(merged)
                self.metrics.inc("compactions")
                self.events.emit("compact", trace=tid,
                                 frontier={str(r): s for r, s in merged.items()})

    def _compact_to_locked(self, merged: Dict[int, int]) -> None:
        """Device fold to ``merged`` + host pruning (the caller holds the
        lock and has clamped ``merged`` to this node's vv).  Shared by
        :meth:`compact` and the adoption-time local fold; the caller owns
        the counter and event."""
        w = self._n_writers()
        with device_lock(self.device):
            folded = compactlog.compact(self._device_clog_locked(n_writers=w),
                                        self._frontier_array(merged, w))
        self.log = folded.tail
        self._log_rows = None
        self._frontier = merged
        self._summary = self._decode_summary(folded.summary)
        self._summary_cache = (folded.summary, folded.summary.num.shape[-1])
        self._prune_commands_locked()
        # the fold rewrote the store wholesale: rebuild the audit digest
        self._digest_resync_locked()

    def _adopt_frontier_locked(
        self, remote_frontier: Dict[int, int], remote_summary: Dict[str, Any]
    ) -> int:
        """Adopt a further-ahead peer's fold (compactlog.merge's chain rule
        on the wire); returns 1 if the frontier advanced.  Incomparable
        frontiers mean a mis-deployed cluster and fail loudly."""
        rids = set(self._frontier) | set(remote_frontier)
        if all(self._frontier.get(r, -1) >= remote_frontier.get(r, -1) for r in rids):
            return 0  # our fold covers theirs; their ops filter in _accept
        if not all(remote_frontier.get(r, -1) >= self._frontier.get(r, -1) for r in rids):
            raise ValueError(
                f"incomparable compaction frontiers (ours {self._frontier}, "
                f"remote {remote_frontier}): frontiers must advance through "
                "swarm-stable barriers (chain rule)"
            )
        if all(s <= self._vv.get(r, -1) for r, s in remote_frontier.items()):
            # Our raw ops already cover the remote fold, so fold LOCALLY
            # instead of adopting the wire summary: a deterministic fold over
            # identical per-writer prefixes is bit-identical to the peer's,
            # which lets the frontier piggyback on every payload without
            # summary sections (eager pruning at adoption time).
            merged = dict(self._frontier)
            merged.update(remote_frontier)
            self._compact_to_locked(merged)
        else:
            # A non-trivial frontier always folds >=1 op, and every folded
            # op contributes a key: an empty summary means a truncated
            # payload, and adopting it would destroy the folded state.
            if any(s >= 0 for s in remote_frontier.values()) and not remote_summary:
                raise ValueError(
                    f"frontier {remote_frontier} arrived with an empty/missing "
                    "__summary__ section: refusing to adopt (truncated payload?)"
                )
            self._summary = {str(k): _summary_entry(e) for k, e in remote_summary.items()}
            self._frontier = dict(remote_frontier)
            self._summary_cache = None
            for r, s in remote_frontier.items():  # the summary extends our knowledge
                if s > self._vv.get(r, -1):
                    self._vv[r] = s
            # drop now-folded raw rows (the adopted summary accounts for them)
            w = self._n_writers()
            self.log = oplog.delta_since(self.log, self._frontier_array(self._frontier, w))
            self._log_rows = None
            self._prune_commands_locked()
            self._digest_resync_locked()  # the adopted summary replaced ours
        self.metrics.inc("frontier_adoptions")
        self.events.emit("frontier_adopt", trace=current_trace(),
                         frontier={str(r): s for r, s in self._frontier.items()})
        return 1

    def _prune_commands_locked(self) -> None:
        f = self._frontier
        kept = {k: v for k, v in self._commands.items()
                if not (k[1] >= 0 and k[2] <= f.get(k[1], -1))}
        reclaimed = len(self._commands) - len(kept)
        if reclaimed:
            self.metrics.inc("gc_reclaimed_ops", reclaimed)
        self._commands = kept
        for w, lst in self._by_writer.items():
            cut = f.get(w, -1)
            if lst and lst[0][0][2] <= cut:
                self._by_writer[w] = [e for e in lst if e[0][2] > cut]

    def _rebuild_indexes_locked(self) -> None:
        """Recompute the delta indexes, the vv and the audit digest from
        ``_commands`` and the frontier (the snapshot restore path,
        :func:`crdt_tpu_torch.utils.checkpoint.restore_node`)."""
        self._by_writer = {}
        self._foreign = []
        self._vv = {}
        self._ts_seen = {k[0] for k in self._commands} if self.go_compat_gossip else set()
        self._summary_cache = None
        for ident in sorted(self._commands, key=lambda k: (k[1], k[2], k[0])):
            stored = self._commands[ident]
            rid, seq = ident[1], ident[2]
            if rid >= 0:
                self._by_writer.setdefault(rid, []).append((ident, stored))
                if seq > self._vv.get(rid, -1):
                    self._vv[rid] = seq
            else:
                self._foreign.append((ident, stored))
        for r, s in self._frontier.items():
            if s > self._vv.get(r, -1):
                self._vv[r] = s
        self._digest_resync_locked()

    def _frontier_array(self, frontier: Dict[int, int], n_writers: int) -> torch.Tensor:
        arr = np.full((n_writers,), -1, np.int32)
        for r, s in frontier.items():
            if 0 <= r < n_writers:
                arr[r] = s
        return torch.from_numpy(arr).to(self.device)

    def _device_clog_locked(self, n_writers: Optional[int] = None) -> compactlog.CompactedLog:
        """The device view of this node's full state: host summary and
        frontier encoded as tensors over the current interned key space,
        tail = log."""
        # intern summary strings BEFORE sizing the key space: an adopted
        # summary can mention keys this node never saw as raw ops
        for key_str, e in self._summary.items():
            self.keys.intern(key_str)
            self.values.intern(e["payload"])
        k = self._n_keys()
        w = n_writers or self._n_writers()
        frontier = self._frontier_array(self._frontier, w)
        if self._summary_cache is not None and self._summary_cache[1] == k:
            return compactlog.CompactedLog(summary=self._summary_cache[0],
                                           frontier=frontier, tail=self.log)
        epoch = self.clock.epoch_ms
        cols = {
            "present": np.zeros(k, bool), "num": np.zeros(k, np.int32),
            "num_count": np.zeros(k, np.int32),
            "ts": np.full(k, compactlog.TS_NULL_PY, np.int32),
            "rid": np.full(k, -1, np.int32), "seq": np.full(k, -1, np.int32),
            "payload": np.zeros(k, np.int32), "is_num": np.zeros(k, bool),
        }
        for key_str, e in self._summary.items():
            i = self.keys.intern(key_str)
            ts = e["ts"] - epoch
            if not (INT32_MIN <= ts <= INT32_MAX):
                raise ValueError(f"summary timestamp {e['ts']} outside this node's "
                                 f"int32 window (epoch {epoch})")
            cols["present"][i] = True
            cols["num"][i] = e["num"]
            cols["num_count"][i] = e["num_count"]
            cols["ts"][i] = ts
            cols["rid"][i] = e["rid"]
            cols["seq"][i] = e["seq"]
            cols["payload"][i] = self.values.intern(e["payload"])
            cols["is_num"][i] = e["is_num"]
        s = compactlog.Summary(**{n: torch.from_numpy(c).to(self.device)
                                  for n, c in cols.items()})
        self._summary_cache = (s, k)
        return compactlog.CompactedLog(summary=s, frontier=frontier, tail=self.log)

    def _decode_summary(self, s: compactlog.Summary) -> Dict[str, Dict[str, Any]]:
        epoch = self.clock.epoch_ms
        c = {f: getattr(s, f).cpu().numpy() for f in compactlog.SUMMARY_FIELDS}
        out: Dict[str, Dict[str, Any]] = {}
        for i in np.flatnonzero(c["present"][:len(self.keys)]):
            out[self.keys.lookup(int(i))] = _summary_entry({
                "num": c["num"][i],
                "num_count": c["num_count"][i],
                "ts": int(c["ts"][i]) + epoch,
                "rid": c["rid"][i],
                "seq": c["seq"][i],
                "payload": self.values.lookup(int(c["payload"][i])),
                "is_num": c["is_num"][i],
            })
        return out

    # ---- internals ----

    def _accept_locked(self, rows) -> List[Tuple[int, int, int, Dict[str, str]]]:
        """Filter duplicate / already-folded rows, record the survivors in
        the command map and delta indexes, and return them.  Rows are taken
        in (rid, seq) order so each writer's index list stays seq-ascending."""
        accepted = []
        f = self._frontier
        for ts, rid, seq, cmd in sorted(rows, key=lambda r: (r[1], r[2], r[0])):
            ident = (ts, rid, seq)
            if ident in self._commands:
                continue  # duplicate op (gossip re-delivery): union no-op
            if rid >= 0 and seq <= f.get(rid, -1):
                continue  # already folded into the summary
            if self.go_compat_gossip and rid < 0 and ts in self._ts_seen:
                continue  # go-compat echo: ts-identity, local wins
            stored = dict(cmd)
            self._commands[ident] = stored
            if self.go_compat_gossip:
                self._ts_seen.add(ts)
            if rid >= 0:
                self._by_writer.setdefault(rid, []).append((ident, stored))
                if seq > self._vv.get(rid, -1):
                    self._vv[rid] = seq
            else:
                self._foreign.append((ident, stored))
            accepted.append((ts, rid, seq, stored))
        if accepted and self.digest is not None and self.digest.enabled:
            self.digest.observe_rows(accepted, self.clock.epoch_ms)
        return accepted

    def _pack_accepted_locked(
        self, accepted: List[Tuple[int, int, int, Dict[str, str]]]
    ) -> Tuple[Optional[Dict[str, np.ndarray]], int]:
        """Pack accepted rows into merge-ready op columns; ``(ops, fresh)``
        with ``ops=None`` when nothing is fresh."""
        cols = {n: [] for n in oplog._FIELDS}
        for ts, rid, seq, cmd in accepted:
            for k, v in cmd.items():
                val, payload, is_num = encode_value(v, self.values)
                cols["ts"].append(ts)
                cols["rid"].append(rid)
                cols["seq"].append(seq)
                cols["key"].append(self.keys.intern(k))
                cols["val"].append(val)
                cols["payload"].append(payload)
                cols["is_num"].append(is_num)
        fresh = len(cols["ts"])
        if not fresh:
            return None, 0
        return {n: np.asarray(c, bool if n == "is_num" else np.int32)
                for n, c in cols.items()}, fresh

    def _ingest(self, rows: List[Tuple[int, int, int, Dict[str, str]]]) -> int:
        """Append/merge op rows (caller holds the lock); returns how many
        genuinely new ops landed.  Grows the log (2x) instead of dropping
        ops at capacity overflow."""
        ops, fresh = self._pack_accepted_locked(self._accept_locked(rows))
        if fresh:
            self._merge_batch(ops, fresh)
        return fresh

    def _pack_local_batch(
        self, cmds: List[Dict[str, str]], tss: List[int], seq0: int
    ) -> Tuple[Optional[Dict[str, np.ndarray]], int]:
        """The batched write path (caller holds the lock): record locally
        minted rows (cmds[i] at ts tss[i] with seq seq0 + i), seq-ascending
        and fresh by construction, so _accept_locked's sort and checks are
        skipped.  The encode/intern work is memoized per DISTINCT command
        dict and per (key, value) pair, and the columns are gathered per op
        with one vectorized take."""
        rid = self.rid
        by_writer = self._by_writer.setdefault(rid, [])
        kcache: Dict[str, int] = {}
        vcache: Dict[str, Tuple[int, int, bool]] = {}
        # id(cmd) -> entry idxs; every cmd stays referenced by `cmds` for
        # the whole loop, so ids are stable
        icache: Dict[int, List[int]] = {}
        # entry planes: one slot per distinct (key, value) pair
        e_key: List[int] = []
        e_val: List[int] = []
        e_pay: List[int] = []
        e_num: List[bool] = []
        # per-op planes
        c_ts: List[int] = []
        c_seq: List[int] = []
        c_eidx: List[int] = []
        commands = self._commands
        go_compat = self.go_compat_gossip
        seq = seq0
        for cmd, ts in zip(cmds, tss):
            ident = (ts, rid, seq)
            commands[ident] = cmd
            if go_compat:
                self._ts_seen.add(ts)
            by_writer.append((ident, cmd))
            eidxs = icache.get(id(cmd))
            if eidxs is None:
                eidxs = icache[id(cmd)] = []
                for k, v in cmd.items():
                    kid = kcache.get(k)
                    if kid is None:
                        kid = kcache[k] = self.keys.intern(k)
                    enc = vcache.get(v)
                    if enc is None:
                        enc = vcache[v] = encode_value(v, self.values)
                    eidxs.append(len(e_key))
                    e_key.append(kid)
                    e_val.append(enc[0])
                    e_pay.append(enc[1])
                    e_num.append(enc[2])
            for e in eidxs:  # multi-key command: one log row per pair
                c_eidx.append(e)
                c_ts.append(ts)
                c_seq.append(seq)
            seq += 1
        self._vv[rid] = max(self._vv.get(rid, -1), seq - 1)
        if self.digest is not None and self.digest.enabled:
            self.digest.observe_rows(
                [(t, rid, seq0 + i, c) for i, (c, t) in enumerate(zip(cmds, tss))],
                self.clock.epoch_ms)
        fresh = len(c_eidx)
        if not fresh:
            return None, 0
        eidx = np.asarray(c_eidx, np.intp)
        return {
            "ts": np.asarray(c_ts, np.int32),
            "rid": np.full(fresh, rid, np.int32),
            "seq": np.asarray(c_seq, np.int32),
            "key": np.asarray(e_key, np.int32)[eidx],
            "val": np.asarray(e_val, np.int32)[eidx],
            "payload": np.asarray(e_pay, np.int32)[eidx],
            "is_num": np.asarray(e_num, bool)[eidx],
        }, fresh

    def _count_lane_fold(self) -> None:
        # labeled per-lane merge accounting (see _metric_labels)
        if self._metric_labels:
            reg = self.metrics.registry
            reg.inc("merge_dispatches", 1, **self._metric_labels)
            reg.inc("union_path", 1, path="sort", **self._metric_labels)

    def _merge_batch(self, ops: Dict[str, np.ndarray], fresh: int) -> None:
        """Land one packed op batch in ONE device merge (caller holds the
        lock)."""
        with device_lock(self.device):
            self._merge_batch_device(ops, fresh)

    def _merge_batch_device(self, ops: Dict[str, np.ndarray], fresh: int) -> None:
        size = self._log_rows
        if size is None:
            size = int(oplog.size(self.log))
        while size + fresh > self.log.capacity:
            # tail-pad capacity doubling: lossless, no union
            self.log = oplog.grow(self.log, self.log.capacity * 2)
            self.metrics.inc("log_grow")
        # one device merge per ingest batch, however many peers' rows it
        # fuses: the counter the dispatch-count checks pin
        self.metrics.inc("merge_dispatches")
        # the op-log merge is a sorted union; record which set-union engine
        # served it (always "sort": the log's lex keys have no packed form)
        union_engine.record_union_path("sort")
        self._count_lane_fold()
        batch = oplog.from_ops(max(fresh, 1), ops, device=self.device)
        t0 = time.perf_counter()
        with devtime.dispatch_annotation("merge"):
            merged, n_unique = oplog.merge_checked(self.log, batch)
        # int(n_unique) is a host sync, so t1 - t0 is the device + dispatch
        # wall time; the assert is the node's overflow check
        assert int(n_unique) <= self.log.capacity
        devtime.observe_join(self.metrics.registry, str(self.rid),
                             (self.log, batch), merged, time.perf_counter() - t0)
        self.log = merged
        self._log_rows = int(n_unique)  # already synced by the assert
        self.metrics.inc("ops_ingested", fresh)
