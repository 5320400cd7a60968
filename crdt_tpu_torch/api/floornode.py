"""The host layer that ``SetNode`` and ``SeqNode`` share: op records with
per-writer contiguous seqs, version vectors, the floor-carrying delta
protocol and the all-or-nothing barrier fold (the JAX package writes it
out twice, in ``crdt_tpu.api.setnode`` and ``crdt_tpu.api.seqnode``; the
behaviour here is both of those, line for line).

* A replica's version vector covers every op kind, so a delta is the
  per-writer tail above the requester's vv.
* A delta is valid only when the requester's vv dominates this node's GC
  floor; otherwise the sender ships every retained op marked ``__full__``
  and the receiver runs absence-implies-collected suppression: its own
  floor-covered rows absent from the payload's insert set were collected
  remotely, so they are tombstoned, never resurrected.
* Barrier floors come from :func:`floor_barrier` (the per-writer min over
  every member's vv, chain-ruled against every member's floor) and are
  adopted all or nothing.

A subclass supplies the lattice: ``INSERT``/``REMOVE`` (its op kinds), the
metric prefix, and the device-table hooks ``_ingest_locked``,
``_table_idents_locked``, ``_suppress_locked``, ``_collect_device_locked``,
``_targets`` and ``_reset_table_locked``.
"""
from __future__ import annotations

import bisect
import threading
from typing import Any, Dict, List, Optional, Set, Tuple

import torch

from crdt_tpu_torch import default_device
from crdt_tpu_torch.utils.clock import SeqGen
from crdt_tpu_torch.utils.intern import Interner
from crdt_tpu_torch.utils.metrics import Metrics

FLOOR_KEY = "__floor__"
FULL_KEY = "__full__"

Ident = Tuple[int, int]


def _wire_key(rid: int, seq: int) -> str:
    return f"{rid}:{seq}"


def _parse_wire_key(k: str) -> Ident:
    rid, seq = k.split(":")
    return int(rid), int(seq)


class FloorNode:
    """One replica of a GC'd tag-identified lattice: host op records are
    the wire, the Gc-wrapped table on ``device`` is the state.  One lock
    over mutation, read and serve."""

    INSERT = ""            # the op kind that adds a row
    REMOVE = ""            # the op kind that tombstones rows
    PREFIX = ""            # metric name prefix
    # the sequence node also drops floor-covered entries of the tombstone
    # index at every floor advance; the set node keeps them
    PRUNE_TOMBSTONED = False
    # the set node records suppressed tags in the tombstone index too
    INDEX_SUPPRESSED = False

    def __init__(self, rid: int, capacity: int, n_writers: int,
                 metrics: Optional[Metrics], device):
        self.rid = rid
        self.metrics = metrics or Metrics()
        self.device = default_device(device)
        self.elems = Interner()
        self.alive = True
        self._lock = threading.Lock()
        self._seq = SeqGen()
        self._capacity = capacity
        self._n_writers = n_writers
        self._ops: Dict[Ident, Dict[str, Any]] = {}
        # per-writer ascending-seq lists (delta slices are O(delta))
        self._by_writer: Dict[int, List[Tuple[Ident, Dict[str, Any]]]] = {}
        self._vv: Dict[int, int] = {}
        self._floor: Dict[int, int] = {}
        # identities targeted by a retained remove: an insert arriving
        # after the remove that observed it lands tombstoned
        self._tombstoned: Set[Ident] = set()

    # ---- read path ----

    def op_record(self, ident: Ident) -> Optional[Dict[str, Any]]:
        """Copy of one retained op record (None if unknown/pruned)."""
        with self._lock:
            op = self._ops.get(tuple(ident))
            return dict(op) if op is not None else None

    def ping(self) -> bool:
        return self.alive

    def set_alive(self, alive: bool) -> None:
        self.alive = bool(alive)

    # ---- gossip ----

    def version_vector(self) -> Dict[int, int]:
        with self._lock:
            return self._vv_locked()

    def vv_snapshot(self) -> Tuple[Dict[int, int], Dict[int, int]]:
        """(vv, floor) under one lock acquisition — barrier coordinators
        need the pair mutually consistent."""
        with self._lock:
            return self._vv_locked(), dict(self._floor)

    def _vv_locked(self) -> Dict[int, int]:
        vv = dict(self._floor)
        for rid, seq in self._vv.items():
            if seq > vv.get(rid, -1):
                vv[rid] = seq
        return vv

    def gossip_payload(self, since: Optional[Dict[int, int]] = None
                       ) -> Optional[Dict[str, Any]]:
        """The wire payload (None when down).  ``since`` = the requester's
        vv; delta mode requires it to dominate this node's floor, else the
        payload is the full retained-op dump marked ``__full__``."""
        if not self.alive:
            return None
        with self._lock:
            floor_wire = {str(r): s for r, s in self._floor.items()}
            if since is not None and all(
                since.get(r, -1) >= s for r, s in self._floor.items()
            ):
                payload: Dict[str, Any] = {}
                for w, lst in self._by_writer.items():
                    # seq-ascending WITH HOLES (GC prunes collected ops
                    # out of the middle): binary-search the first op above
                    # the requester's watermark
                    start = bisect.bisect_right(lst, since.get(w, -1), key=lambda e: e[0][1])
                    for ident, op in lst[start:]:
                        payload[_wire_key(*ident)] = dict(op)
                if payload or floor_wire:
                    payload[FLOOR_KEY] = floor_wire
                return payload
            payload = {_wire_key(*ident): dict(op) for ident, op in self._ops.items()}
            payload[FLOOR_KEY] = floor_wire
            payload[FULL_KEY] = True
            return payload

    def receive(self, payload: Optional[Dict[str, Any]]) -> int:
        """Merge a peer's payload; returns the genuinely new op count."""
        if not payload or not self.alive:
            return 0
        payload = dict(payload)
        remote_floor = {int(r): int(s)
                        for r, s in (payload.pop(FLOOR_KEY, None) or {}).items()}
        is_full = bool(payload.pop(FULL_KEY, False))
        rows = [(_parse_wire_key(k), op) for k, op in payload.items()]
        with self._lock:
            fresh = self._ingest_locked(rows)
            if remote_floor:
                self._adopt_floor_locked(
                    remote_floor,
                    {ident for ident, op in rows if self.INSERT in op} if is_full else None,
                )
            return fresh

    # ---- GC barrier surface ----

    def collect(self, floor: Dict[int, int]) -> None:
        """Fold the swarm-agreed ``floor`` (barrier-minted, chain-ruled).
        All or nothing: a node whose vv does not dominate the floor adopts
        nothing (a per-writer clamp could mint incomparable floors) and
        catches up at its next pull."""
        with self._lock:
            vv = self._vv_locked()
            if any(s > vv.get(r, -1) for r, s in floor.items()):
                self.metrics.inc(f"{self.PREFIX}_collect_behind")
                return
            target = {r: s for r, s in floor.items() if s > self._floor.get(r, -1)}
            if not target:
                return
            merged = dict(self._floor)
            merged.update(target)
            self._apply_floor_locked(merged)
            self.metrics.inc(f"{self.PREFIX}_collections")

    # ---- internals ----

    def _record_locked(self, rows) -> List[Tuple[Ident, Dict[str, Any]]]:
        """Record the genuinely new op rows in (rid, seq) order: ops at or
        below the floor are collected history, re-deliveries are skipped."""
        staged = []
        for ident, op in sorted(rows, key=lambda r: (r[0][0], r[0][1])):
            rid, seq = ident
            if ident in self._ops:
                continue  # re-delivery
            if seq <= self._floor.get(rid, -1):
                continue  # covered: folded/collected history
            op = dict(op)
            self._ops[ident] = op
            self._by_writer.setdefault(rid, []).append((ident, op))
            if seq > self._vv.get(rid, -1):
                self._vv[rid] = seq
            if rid >= self._n_writers:
                self._grow_writers(rid)
            staged.append((ident, op))
        return staged

    def _grow_writers(self, rid: int) -> None:
        w = self._n_writers
        while rid >= w:
            w *= 2
        pad = torch.full((w - self._n_writers,), -1, dtype=torch.int32, device=self.device)
        self.gc = type(self.gc)(inner=self.gc.inner, floor=torch.cat([self.gc.floor, pad]))
        self._n_writers = w

    def _apply_floor_locked(self, merged: Dict[int, int]) -> None:
        """Advance to floor ``merged``: device collect, then host prunes.
        An insert record goes exactly when its row was collected; a remove
        record only when the floor covers its own identity and every
        target."""
        arr = [-1] * self._n_writers
        for r, s in merged.items():
            if 0 <= r < self._n_writers:
                arr[r] = s
        self._collect_device_locked(torch.tensor(arr, dtype=torch.int32, device=self.device))
        self._floor = merged

        def covered(ident) -> bool:
            return ident[1] <= merged.get(ident[0], -1)

        # the device table after collect is the authority on what remains
        kept = set(self._table_idents_locked())
        drop = []
        for ident, op in self._ops.items():
            if self.INSERT in op:
                if covered(ident) and ident not in kept:
                    drop.append(ident)  # collected
            elif covered(ident) and all(covered(t) for t in self._targets(op)):
                drop.append(ident)
        for ident in drop:
            op = self._ops.pop(ident)
            if self.REMOVE in op:
                for t in self._targets(op):
                    self._tombstoned.discard(t)
        if drop:
            dropped = set(drop)
            for w, lst in self._by_writer.items():
                self._by_writer[w] = [e for e in lst if e[0] not in dropped]
        if self.PRUNE_TOMBSTONED:
            # floor coverage alone blocks re-ingestion, so covered index
            # entries (suppression-derived ones included) are dead weight
            self._tombstoned = {t for t in self._tombstoned if not covered(t)}

    def _adopt_floor_locked(self, remote_floor: Dict[int, int],
                            payload_inserts: Optional[Set[Ident]]) -> None:
        """Adopt a peer's floor after ingesting its payload.  Chain rule:
        barrier floors are totally ordered, incomparable ones fail loudly.
        For a full payload (``payload_inserts`` given), rows this node holds
        that the remote floor covers but the payload lacks were collected
        remotely and are tombstoned before the floor advances."""
        rids = set(self._floor) | set(remote_floor)
        if all(self._floor.get(r, -1) >= remote_floor.get(r, -1) for r in rids):
            return
        if not all(remote_floor.get(r, -1) >= self._floor.get(r, -1) for r in rids):
            raise ValueError(
                f"incomparable GC floors (ours {self._floor}, remote {remote_floor}): "
                "floors must advance through swarm barriers (chain rule)")
        if payload_inserts is not None:
            stale = [t for t in self._table_idents_locked()
                     if t[1] <= remote_floor.get(t[0], -1) and t not in payload_inserts]
            if stale:
                if self.INDEX_SUPPRESSED:
                    self._tombstoned.update(stale)
                self._suppress_locked(stale)
        elif not all(self._vv_locked().get(r, -1) >= s for r, s in remote_floor.items()):
            raise ValueError(
                "delta payload carried a floor beyond this node's knowledge — sender "
                "must have fallen back to a full payload (bug in gossip_payload's "
                "delta-validity rule)")
        merged = dict(self._floor)
        for r, s in remote_floor.items():
            if s > merged.get(r, -1):
                merged[r] = s
        # floor coverage extends knowledge (everything under it is history)
        for r, s in merged.items():
            if s > self._vv.get(r, -1):
                self._vv[r] = s
        self._apply_floor_locked(merged)
        self.metrics.inc(f"{self.PREFIX}_floor_adoptions")

    # ---- snapshot (crash-safe checkpoint sections) ----

    def to_snapshot(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "rid": self.rid,
                "seq_next": self._seq.count,
                "floor": {str(r): s for r, s in self._floor.items()},
                "ops": {_wire_key(*ident): dict(op) for ident, op in self._ops.items()},
            }

    def from_snapshot(self, snap: Dict[str, Any]) -> None:
        with self._lock:
            self._floor = {int(r): int(s) for r, s in (snap.get("floor") or {}).items()}
            self._ops = {}
            self._by_writer = {}
            self._vv = {}
            self._tombstoned = set()
            self._reset_table_locked()
            rows = [(_parse_wire_key(k), op) for k, op in (snap.get("ops") or {}).items()]
            # pre-seed the tombstone index so replay is order-insensitive
            # (an insert's remover may sort before or after it)
            for _, op in rows:
                if self.REMOVE in op:
                    self._tombstoned.update(self._targets(op))
            floor = self._floor
            self._floor = {}  # ingest everything, then re-apply the floor
            self._ingest_locked(rows)
            if floor:
                self._apply_floor_locked(floor)
            if int(snap.get("rid", self.rid)) == self.rid:
                self._seq.count = int(snap.get("seq_next", 0))
            # else: incarnation restore — this boot's fresh rid starts at 0;
            # the dead rid's counter belongs to its frozen prefix


def floor_barrier(local: FloorNode,
                  peer_vv_floors: List[Optional[Tuple[Dict[int, int], Dict[int, int]]]]
                  ) -> Dict[int, int]:
    """One swarm-wide GC barrier floor: the per-writer min over ALL
    members' vvs, chain-ruled against every member's floor.  Any
    unreachable member (None entry) skips the barrier ({}).  Run from ONE
    coordinator."""
    from crdt_tpu_torch.api.node import stable_frontier_host

    own_vv, own_floor = local.vv_snapshot()
    vvs, floors = [own_vv], [own_floor]
    for got in peer_vv_floors:
        if got is None:
            return {}
        vvs.append(got[0])
        floors.append(got[1])
    return stable_frontier_host(vvs, floors)


def pack_idents(idents, device) -> torch.Tensor:
    """(rid, seq) identities as one int64 key each, on ``device``."""
    return torch.tensor([(r << 32) | (s & 0xFFFFFFFF) for r, s in idents],
                        dtype=torch.int64, device=device)


def ident_keys(rid: torch.Tensor, seq: torch.Tensor) -> torch.Tensor:
    """The :func:`pack_idents` key of every table row."""
    return (rid.to(torch.int64) << 32) | (seq.to(torch.int64) & 0xFFFFFFFF)
