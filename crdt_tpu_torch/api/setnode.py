"""SetNode: the host-side OR-Set(+GC) replica (counterpart of
``crdt_tpu.api.setnode``), with its Gc-wrapped ORSet on the card.

Op model:

* every mutation is an identified op minted by its writer with per-writer
  contiguous seqs: ``add(elem)`` is op (rid, seq) creating tag (rid, seq);
  ``remove(elem)`` is op (rid, seq) carrying the list of OBSERVED tags it
  tombstones (observed-remove: concurrent re-adds survive);
* the GC floor is a per-writer watermark of collected knowledge: an add
  record is pruned exactly when its row is collected (removed AND
  floor-covered); a remove record only when the floor covers its own
  identity AND every target tag.

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
from crdt_tpu_torch.models import orset, tomb_gc
from crdt_tpu_torch.utils.constants import SENTINEL_PY
from crdt_tpu_torch.utils.metrics import Metrics


class SetNode(FloorNode):
    """One replica of the GC'd observed-remove set."""

    INSERT, REMOVE, PREFIX = "add", "remove", "set"
    INDEX_SUPPRESSED = True

    def __init__(self, rid: int, capacity: int = 256, n_writers: int = 64,
                 metrics: Optional[Metrics] = None, device=None):
        super().__init__(rid, capacity, n_writers, metrics, device)
        self._reset_table_locked()

    # ---- write path ----

    def add(self, elem: str) -> Optional[Tuple[int, int]]:
        """Mint one add op; returns its (rid, seq) identity, or None when
        the node is down."""
        with self._lock:
            if not self.alive:
                return None
            ident = (self.rid, self._seq.next())
            self._ingest_locked([(ident, {"add": str(elem)})])
            return ident

    def remove(self, elem: str) -> Optional[Tuple[int, int]]:
        """Mint one remove op tombstoning every currently observed live tag
        of ``elem``.  None when down OR when no live tag exists."""
        with self._lock:
            if not self.alive:
                return None
            tags = self._live_tags_locked(str(elem))
            if not tags:
                return None
            ident = (self.rid, self._seq.next())
            self._ingest_locked([(ident, {"remove": str(elem),
                                          "tags": [list(t) for t in tags]})])
            return ident

    # ---- read path ----

    def members(self) -> Optional[List[str]]:
        """The live member set (None when down)."""
        if not self.alive:
            return None
        with self._lock:
            n = self._n_universe_locked()
            if n == 0:
                return []
            mask = orset.member_mask(self.gc.inner, n).cpu().numpy()
            return sorted(self.elems.lookup(i) for i in np.nonzero(mask)[0])

    # ---- internals ----

    def _n_universe_locked(self) -> int:
        n = 16
        while n < len(self.elems):
            n *= 2
        return n

    def _table_locked(self) -> np.ndarray:
        """(4, C) host copy of elem / rid / seq / removed, one transfer."""
        s = self.gc.inner
        return torch.stack([s.elem, s.rid, s.seq, s.removed.to(torch.int32)]).cpu().numpy()

    def _live_tags_locked(self, elem: str) -> List[Tuple[int, int]]:
        eid = self.elems.intern(elem)
        e, rid, seq, removed = self._table_locked()
        live = (e == eid) & (removed == 0)
        return [(int(r), int(q)) for r, q in zip(rid[live], seq[live])]

    def _table_idents_locked(self) -> List[Tuple[int, int]]:
        e, rid, seq, _ = self._table_locked()
        valid = e != SENTINEL_PY
        return [(int(r), int(q)) for r, q in zip(rid[valid], seq[valid])]

    def _targets(self, op) -> List[Tuple[int, int]]:
        return [tuple(map(int, t)) for t in op.get("tags", [])]

    def _reset_table_locked(self) -> None:
        self.gc = tomb_gc.wrap(orset.empty(self._capacity, device=self.device),
                               self._n_writers, device=self.device)

    def _collect_device_locked(self, floor: torch.Tensor) -> None:
        self.gc = tomb_gc.collect(self.gc, floor, orset.GC_ADAPTER)

    def _suppress_locked(self, stale) -> None:
        self.gc = tomb_gc.Gc(inner=_tombstone_tags(self.gc.inner, stale), floor=self.gc.floor)

    def _ingest_locked(self, rows) -> int:
        """Apply op rows in (rid, seq) order; returns the genuinely new
        count.  Adds below the floor are skipped (collected history)."""
        add_elem: List[int] = []
        add_rid: List[int] = []
        add_seq: List[int] = []
        add_removed: List[bool] = []
        tomb: List[Tuple[int, int]] = []
        staged = self._record_locked(rows)
        for (rid, seq), op in staged:
            if "add" in op:
                add_elem.append(self.elems.intern(str(op["add"])))
                add_rid.append(rid)
                add_seq.append(seq)
                add_removed.append((rid, seq) in self._tombstoned)
            else:
                targets = self._targets(op)
                self._tombstoned.update(targets)
                tomb.extend(targets)
        if not staged:
            return 0
        s = self.gc.inner
        if add_elem:
            need = int(orset.size(s)) + len(add_elem)
            while need > s.capacity:
                s = orset.grow(s, s.capacity * 2)
                self.metrics.inc("set_grow")
            batch = _orset_from_rows(s.capacity, add_elem, add_rid, add_seq, add_removed,
                                     self.device)
            s, n_unique = orset.join_checked(s, batch)
            if int(n_unique) > s.capacity:
                raise tomb_gc.GcOverflow(
                    f"set ingest needs {int(n_unique)} rows, capacity {s.capacity} "
                    "(grow failed to keep up)")
        if tomb:
            s = _tombstone_tags(s, tomb)
        self.gc = tomb_gc.Gc(inner=s, floor=self.gc.floor)
        self.metrics.inc("set_ops_ingested", len(staged))
        return len(staged)


def _orset_from_rows(capacity, elems, rids, seqs, removed, device) -> orset.ORSet:
    """A sorted ORSet table from host rows: sorted by (elem, rid, seq)
    stably on the host, padded with SENTINEL rows, one transfer."""
    n = len(elems)
    assert n <= capacity
    cols = np.full((4, capacity), SENTINEL_PY, np.int64)
    cols[:, :n] = [elems, rids, seqs, removed]
    cols[3, n:] = 0
    order = np.lexsort((cols[2, :n], cols[1, :n], cols[0, :n]))
    cols[:, :n] = cols[:, :n][:, order]
    t = torch.tensor(cols, dtype=torch.int32, device=device)
    return orset.ORSet(elem=t[0], rid=t[1], seq=t[2], removed=t[3].to(torch.bool))


def _tombstone_tags(s: orset.ORSet, tags) -> orset.ORSet:
    """Tombstone every row whose (rid, seq) tag is in ``tags``."""
    hit = torch.isin(ident_keys(s.rid, s.seq), pack_idents(tags, s.rid.device))
    hit &= s.elem != SENTINEL_PY
    return orset.ORSet(elem=s.elem, rid=s.rid, seq=s.seq, removed=s.removed | hit)


def set_barrier(local: SetNode,
                peer_vv_floors: List[Optional[Tuple[Dict[int, int], Dict[int, int]]]]
                ) -> Dict[int, int]:
    """One swarm-wide GC barrier floor for the set fleet
    (:func:`~crdt_tpu_torch.api.floornode.floor_barrier`); {} when a
    member is unreachable or the chain rule refuses."""
    return floor_barrier(local, peer_vv_floors)
