"""SeqNode: the host-side replicated-sequence (RSeq+GC) replica
(counterpart of ``crdt_tpu.api.seqnode``), with its Gc-wrapped RSeq on
the card.

Op model:

* ``insert`` is op (rid, seq) minting an element whose PATH KEY's own
  level carries the same (rid, seq) (``rseq.alloc_key``).  The wire
  carries only the REAL path levels (``[[pos_hi, pos_lo, rid, seq],
  ...]``); the receiver re-stamps them to its own table depth, so replicas
  with different depths interoperate;
* ``remove`` is op (rid, seq) targeting exactly ONE element identity
  (``[rid_t, seq_t]``);
* the prune rules mirror SetNode's: an insert record goes when its row was
  collected, a remove record when the floor covers its own identity and
  its target.

The delta protocol, the full-payload suppression and the barrier fold are
:mod:`crdt_tpu_torch.api.floornode`'s.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from crdt_tpu_torch.api.floornode import (  # noqa: F401  (the wire keys are public)
    FLOOR_KEY,
    FULL_KEY,
    FloorNode,
    floor_barrier,
    ident_keys,
    pack_idents,
)
from crdt_tpu_torch.models import rseq, tomb_gc
from crdt_tpu_torch.utils.constants import SENTINEL_PY
from crdt_tpu_torch.utils.metrics import Metrics


def _levels_of_row(row, depth: int):
    """Real (pos, rid, seq) levels of a flattened stamped key row."""
    triples = rseq._triples(row, depth)
    return list(triples[: rseq.real_depth(triples)])


def _wire_path(levels) -> List[List[int]]:
    out = []
    for pos, rid, seq in levels:
        hi, lo = rseq.split_pos(pos)
        out.append([int(hi), int(lo), int(rid), int(seq)])
    return out


def _levels_from_wire(path) -> List[Tuple[int, int, int]]:
    out = []
    for lvl in path:
        hi, lo, rid, seq = (int(x) for x in lvl)
        out.append((rseq.join_pos(hi, lo), rid, seq))
    return out


class SeqNode(FloorNode):
    """One replica of the GC'd replicated sequence."""

    INSERT, REMOVE, PREFIX = "ins", "del", "seq"
    PRUNE_TOMBSTONED = True

    def __init__(self, rid: int, capacity: int = 256, n_writers: int = 64,
                 depth: int = rseq.DEPTH, metrics: Optional[Metrics] = None, device=None):
        super().__init__(rid, capacity, n_writers, metrics, device)
        self._depth = depth
        self._init_depth = depth  # restore target; ingest re-widens on demand
        self._reset_table_locked()

    # ---- write path ----

    @staticmethod
    def _neighbours(keys, live_idx, index: int):
        left = tuple(int(x) for x in keys[live_idx[index - 1]]) if index > 0 else None
        right = (tuple(int(x) for x in keys[live_idx[index]])
                 if index < len(live_idx) else None)
        return left, right

    def insert_at(self, index: Optional[int], elem: str) -> Optional[Tuple[int, int]]:
        """Mint one insert op before live position ``index`` (None =
        append); returns its (rid, seq) identity, or None when the node is
        down.  GapExhausted recovers by widening the local table."""
        with self._lock:
            if not self.alive:
                return None
            keys, occupied, live_idx = self._snapshot_locked()
            if int(occupied.sum()) >= self.gc.inner.capacity:
                self._grow_capacity_locked(int(occupied.sum()) + 1)
                keys, occupied, live_idx = self._snapshot_locked()
            if index is None or index > len(live_idx):
                index = len(live_idx)
            elif index < 0:
                index = 0
            left, right = self._neighbours(keys, live_idx, index)
            seq = self._seq.count  # mint only after allocation succeeds
            ident = (self.rid, seq)
            try:
                row = rseq.alloc_key(left, right, self.rid, seq, self._depth)
            except rseq.GapExhausted:
                self._widen_locked(self._depth + 2)
                keys, _, live_idx = self._snapshot_locked()
                left, right = self._neighbours(keys, live_idx, index)
                row = rseq.alloc_key(left, right, self.rid, seq, self._depth)
            self._seq.next()
            path = _wire_path(_levels_of_row(row, self._depth))
            self._ingest_locked([(ident, {"ins": str(elem), "path": path})])
            return ident

    def append(self, elem: str) -> Optional[Tuple[int, int]]:
        return self.insert_at(None, elem)

    def remove_at(self, index: int) -> Optional[Tuple[int, int]]:
        """Mint one remove op targeting the element at live position
        ``index``.  None when down or out of range."""
        with self._lock:
            if not self.alive:
                return None
            keys, _, live_idx = self._snapshot_locked()
            if not 0 <= index < len(live_idx):
                return None
            row = keys[live_idx[index]]
            target = (int(row[-2]), int(row[-1]))
            ident = (self.rid, self._seq.next())
            self._ingest_locked([(ident, {"del": list(target)})])
            return ident

    # ---- read path ----

    def items(self) -> Optional[List[str]]:
        """The live sequence, in order (None when down)."""
        if not self.alive:
            return None
        with self._lock:
            return [self.elems.lookup(i) for i in rseq.to_list(self.gc.inner)]

    def idents(self) -> Optional[List[Tuple[int, int]]]:
        """Live element identities in sequence order."""
        if not self.alive:
            return None
        with self._lock:
            keys, _, live_idx = self._snapshot_locked()
            return [(int(keys[i][-2]), int(keys[i][-1])) for i in live_idx]

    def warmup(self) -> None:
        """Run the device paths (insert union, tombstone punch, collect,
        full-payload receive) once on throwaway nodes of identical shapes
        on this node's device, so the first real ingest pays no one-time
        setup (the JAX package compiles its jits here)."""
        def scratch():
            return SeqNode(rid=self.rid, capacity=self._capacity, n_writers=self._n_writers,
                           depth=self._depth, metrics=Metrics(), device=self.device)

        a = scratch()
        a.append("warmup")
        a.append("warmup2")
        a.remove_at(0)
        a.collect({a.rid: 0})
        scratch().receive(a.gossip_payload())

    # ---- internals ----

    def _snapshot_locked(self):
        """(np keys, occupied mask, live row indices in order) — one host
        transfer of the key table and the removed flags."""
        s = self.gc.inner
        host = torch.cat([s.keys, s.removed[:, None].to(torch.int32)], dim=1).cpu().numpy()
        keys = host[:, :-1]
        occupied = keys[:, 0] != SENTINEL_PY
        live = occupied & (host[:, -1] == 0)
        return keys, occupied, np.nonzero(live)[0]

    def _table_idents_locked(self) -> List[Tuple[int, int]]:
        keys, occupied, _ = self._snapshot_locked()
        return [(int(keys[i][-2]), int(keys[i][-1])) for i in np.nonzero(occupied)[0]]

    def _targets(self, op) -> List[Tuple[int, int]]:
        return [tuple(int(x) for x in op["del"])]

    def _reset_table_locked(self) -> None:
        # rebuild at the CONSTRUCTOR depth: ingest widens on demand
        self._depth = self._init_depth
        self.gc = tomb_gc.wrap(rseq.empty(self._capacity, depth=self._depth, device=self.device),
                               self._n_writers, device=self.device)

    def _collect_device_locked(self, floor: torch.Tensor) -> None:
        self.gc = tomb_gc.collect(self.gc, floor, rseq.GC_ADAPTER)

    def _suppress_locked(self, stale) -> None:
        # device rows only: these identities sit at/below the adopted
        # floor, and floor coverage already blocks re-ingestion
        self.gc = tomb_gc.Gc(inner=_tombstone_idents(self.gc.inner, stale), floor=self.gc.floor)

    def _grow_capacity_locked(self, need: int) -> None:
        cap = self.gc.inner.capacity
        while need > cap:
            cap *= 2
        if cap != self.gc.inner.capacity:
            self.gc = tomb_gc.Gc(inner=rseq.grow(self.gc.inner, cap), floor=self.gc.floor)
            self.metrics.inc("seq_grow")

    def _widen_locked(self, new_depth: int) -> None:
        self.gc = tomb_gc.Gc(inner=rseq.widen(self.gc.inner, new_depth), floor=self.gc.floor)
        self._depth = new_depth
        self.metrics.inc("seq_widen")

    @staticmethod
    def _validate_op(ident, op) -> None:
        """Wire-content validation, run BEFORE any state mutates: an insert
        path's deepest level must carry the op identity (honest allocators
        mint them equal), positions must lie in the 60-bit space, a remove
        must target one (rid, seq) pair."""
        rid, seq = ident
        if "ins" in op:
            levels = _levels_from_wire(op["path"])  # raises on bad shape
            if not levels:
                raise ValueError(f"op {ident}: empty path")
            if tuple(levels[-1][1:]) != (rid, seq):
                raise ValueError(
                    f"op {ident}: path's own level carries identity {levels[-1][1:]} != "
                    "the op identity (hostile or corrupt wire — honest allocators mint "
                    "them equal)")
            for pos, _, _ in levels:
                if not 0 <= pos < rseq.POS_MAX:
                    raise ValueError(
                        f"op {ident}: position {pos} outside the 60-bit coordinate space")
        elif "del" in op:
            t = op["del"]
            if len(t) != 2:
                raise ValueError(f"op {ident}: del target {t!r} is not a (rid, seq) pair")
            int(t[0]), int(t[1])  # raises on non-numeric
        else:
            raise ValueError(f"op {ident}: unknown op kind {sorted(op)}")

    def _ingest_locked(self, rows) -> int:
        """Apply op rows in (rid, seq) order; returns the genuinely new
        count.  A malformed row rejects the whole batch before anything
        mutates."""
        for ident, op in sorted(rows, key=lambda r: (r[0][0], r[0][1])):
            if ident in self._ops or ident[1] <= self._floor.get(ident[0], -1):
                continue
            self._validate_op(ident, op)
        staged = self._record_locked(rows)
        if not staged:
            return 0
        # widen BEFORE building key rows so every row is stamped to one depth
        for _, op in staged:
            if "ins" in op and len(op["path"]) > self._depth:
                self._widen_locked(len(op["path"]))
        ins_rows: List[Tuple[Tuple[int, ...], int, bool]] = []
        tomb: List[Tuple[int, int]] = []
        for ident, op in staged:
            if "ins" in op:
                eid = self.elems.intern(str(op["ins"]))
                row = rseq._stamp(_levels_from_wire(op["path"]), ident[0], ident[1],
                                  self._depth)
                ins_rows.append((row, eid, ident in self._tombstoned))
            else:
                target = tuple(int(x) for x in op["del"])
                self._tombstoned.add(target)
                tomb.append(target)
        s = self.gc.inner
        if ins_rows:
            self._grow_capacity_locked(int(rseq.n_rows(s)) + len(ins_rows))
            s = self.gc.inner
            batch = _rseq_from_rows(s.capacity, s.depth, [r for r, _, _ in ins_rows],
                                    [e for _, e, _ in ins_rows], [t for _, _, t in ins_rows],
                                    self.device)
            s, n_unique = rseq.join_checked(s, batch)
            if int(n_unique) > s.capacity:
                raise tomb_gc.GcOverflow(
                    f"seq ingest needs {int(n_unique)} rows, capacity {s.capacity} "
                    "(grow failed to keep up)")
        if tomb:
            s = _tombstone_idents(s, tomb)
        self.gc = tomb_gc.Gc(inner=s, floor=self.gc.floor)
        self.metrics.inc("seq_ops_ingested", len(staged))
        return len(staged)


def _rseq_from_rows(capacity, depth, key_rows, elems, removed, device) -> rseq.RSeq:
    """A sorted RSeq table from host rows (sorted lexicographically and
    stably on the host, SENTINEL-padded, one transfer)."""
    n = len(key_rows)
    assert n <= capacity
    w = 4 * depth
    keys = np.full((capacity, w), SENTINEL_PY, np.int64)
    vals = np.zeros((capacity, 2), np.int64)
    if n:
        rows = np.asarray(key_rows, np.int64).reshape(n, w)
        order = np.lexsort(rows.T[::-1])
        keys[:n] = rows[order]
        vals[:n] = np.stack([np.asarray(elems, np.int64), np.asarray(removed, np.int64)],
                            axis=1)[order]
    t = torch.tensor(np.concatenate([keys, vals], axis=1), dtype=torch.int32, device=device)
    return rseq.RSeq(keys=t[:, :w].contiguous(), elem=t[:, w].contiguous(),
                     removed=t[:, w + 1].to(torch.bool))


def _tombstone_idents(s: rseq.RSeq, idents) -> rseq.RSeq:
    """Punch tombstones by element identity (the last level's rid/seq
    columns)."""
    hit = torch.isin(ident_keys(s.keys[:, -2], s.keys[:, -1]), pack_idents(idents, s.keys.device))
    hit &= s.keys[:, 0] != SENTINEL_PY
    return rseq.RSeq(keys=s.keys, elem=s.elem, removed=s.removed | hit)


def seq_barrier(local: SeqNode,
                peer_vv_floors: List[Optional[Tuple[Dict[int, int], Dict[int, int]]]]
                ) -> Dict[int, int]:
    """One swarm-wide GC barrier floor for the sequence fleet
    (:func:`~crdt_tpu_torch.api.floornode.floor_barrier`)."""
    return floor_barrier(local, peer_vv_floors)

