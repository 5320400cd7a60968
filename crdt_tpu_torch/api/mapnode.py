"""MapNode: the general map lattice across the process boundary
(counterpart of ``crdt_tpu.api.mapnode``): string key → PN-Counter cell
with observed-remove presence (``models.ormap``) and the
reset-on-stable-remove GC of ``models.ormap_gc`` (epoch-guarded
reset-wins, full-fleet barriers only).

Host op records carry the wire/delta machinery; the folded planes are the
OR-Map lattice's encoding (TokenPlane tok/obs, PN pos/neg, per-key epoch)
kept as numpy mirrors on the host, as the JAX node keeps them, and
exported by :meth:`MapNode.device_state` as a ``MapGc`` on the node's
device.

Op model:

* ``upd(key, delta)`` — op (rid, seq) minted at the key's CURRENT epoch:
  one presence token (``tok[k, rid] += 1``) and the signed delta folded
  into the writer's PN slot;
* ``rem(key)`` — op (rid, seq) carrying the token vector it OBSERVED;
* an op whose epoch is below its key's current epoch is DOMINATED — void
  everywhere, never applied (reset-wins, op-wise).

Epochs ride every gossip payload (max-adoption): adopting a higher epoch
resets the key's planes and prunes the records it dominates, so a reset
propagates through ordinary anti-entropy.  The reset barrier is
coordinator-scheduled: :func:`map_barrier_ready` (every member reachable,
the coordinator's vv dominating each), then :meth:`MapNode.mint_reset`
and :meth:`MapNode.adopt_epochs` on the members.
"""
from __future__ import annotations

import bisect
import threading
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from crdt_tpu_torch import default_device
from crdt_tpu_torch.utils.clock import SeqGen
from crdt_tpu_torch.utils.intern import Interner
from crdt_tpu_torch.utils.metrics import Metrics

EPOCH_KEY = "__epochs__"
VV_KEY = "__vv__"


def _wire_key(rid: int, seq: int) -> str:
    return f"{rid}:{seq}"


def _parse_wire_key(k: str) -> Tuple[int, int]:
    rid, seq = k.split(":")
    return int(rid), int(seq)


class MapNode:
    """One replica of the PN-composition map with reset GC.

    Thread-safe like SetNode (one lock over mutation/read/serve); numpy
    plane mirrors of the device OR-Map lattice carry the folded state,
    host records carry the wire."""

    def __init__(self, rid: int, n_keys: int = 16, n_writers: int = 8,
                 metrics: Optional[Metrics] = None, device=None):
        self.rid = rid
        self.device = default_device(device)
        self.metrics = metrics or Metrics()
        self.keys = Interner()
        self.alive = True
        self._lock = threading.Lock()
        self._seq = SeqGen()
        self._k = n_keys
        self._w = n_writers
        # the OR-Map plane mirrors (device encoding, numpy residency):
        self._tok = np.full((n_keys, n_writers), -1, np.int32)
        self._obs = np.full((n_keys, n_writers, n_writers), -1, np.int32)
        self._pos = np.zeros((n_keys, n_writers), np.int64)
        self._neg = np.zeros((n_keys, n_writers), np.int64)
        self._epoch = np.zeros((n_keys,), np.int32)
        # host op records: identity -> op dict (wire-shaped):
        #   upd: {"upd": key_str, "d": delta, "e": epoch_at_mint}
        #   rem: {"rem": key_str, "obs": {writer: tok_seq}, "e": epoch}
        self._ops: Dict[Tuple[int, int], Dict[str, Any]] = {}
        self._by_writer: Dict[int, List[Tuple[Tuple[int, int], Dict[str, Any]]]] = {}
        self._vv: Dict[int, int] = {}

    # ---- write path ----

    def upd(self, key: str, delta: int) -> Optional[Tuple[int, int]]:
        """Mint one update op (token + signed PN delta); returns its
        (rid, seq) identity, or None when the node is down."""
        with self._lock:
            if not self.alive:
                return None
            kid = self._kid_locked(str(key))
            seq = self._seq.next()
            ident = (self.rid, seq)
            self._ingest_locked([(ident, {
                "upd": str(key), "d": int(delta),
                "e": int(self._epoch[kid]),
            })])
            return ident

    def upd_many(
        self, pairs: List[Tuple[str, int]],
    ) -> Optional[List[Tuple[int, int]]]:
        """Batched update mint: every (key, delta) in ``pairs`` lands under
        ONE lock acquisition and one ``_ingest_locked`` call, in submission
        order — the same per-op semantics as N ``upd`` calls.  Returns the
        minted idents; None when the node is down."""
        with self._lock:
            if not self.alive:
                return None
            rows = []
            idents: List[Tuple[int, int]] = []
            for key, delta in pairs:
                kid = self._kid_locked(str(key))
                seq = self._seq.next()
                ident = (self.rid, seq)
                rows.append((ident, {
                    "upd": str(key), "d": int(delta),
                    "e": int(self._epoch[kid]),
                }))
                idents.append(ident)
            if rows:
                self._ingest_locked(rows)
            return idents

    def rem(self, key: str) -> Optional[Tuple[int, int]]:
        """Mint one observed-remove op for ``key``: clears exactly the
        presence tokens this state has seen.  Returns the op identity;
        None when down OR when the key is not currently contained
        (nothing observed — no op minted)."""
        with self._lock:
            if not self.alive:
                return None
            k = str(key)
            if k not in self.keys:
                return None
            kid = self.keys.intern(k)
            if not self._contains_locked(kid):
                return None
            observed = {
                str(w): int(self._tok[kid, w])
                for w in range(self._w) if self._tok[kid, w] >= 0
            }
            seq = self._seq.next()
            ident = (self.rid, seq)
            self._ingest_locked([(ident, {
                "rem": k, "obs": observed, "e": int(self._epoch[kid]),
            })])
            return ident

    # ---- read path ----

    def op_record(self, ident: Tuple[int, int]) -> Optional[Dict[str, Any]]:
        with self._lock:
            op = self._ops.get(tuple(ident))
            return dict(op) if op is not None else None

    def value(self, key: str) -> Optional[int]:
        """The key's PN value, or None when absent/down."""
        if not self.alive:
            return None
        with self._lock:
            k = str(key)
            if k not in self.keys:
                return None
            kid = self.keys.intern(k)
            if not self._contains_locked(kid):
                return None
            return int(self._pos[kid].sum() - self._neg[kid].sum())

    def items(self) -> Optional[Dict[str, int]]:
        """{key: value} over contained keys (None when down)."""
        if not self.alive:
            return None
        with self._lock:
            out = {}
            for k, kid in self.keys.items():
                if self._contains_locked(kid):
                    out[k] = int(self._pos[kid].sum() - self._neg[kid].sum())
            return out

    def epochs(self) -> Optional[Dict[str, int]]:
        """{key: epoch} over keys with a nonzero epoch (None when down)."""
        if not self.alive:
            return None
        with self._lock:
            return self._epochs_locked()

    def n_records(self) -> int:
        """Retained host op-record count — the map's state-growth gauge
        (the churn soak samples it to measure growth between successful
        reset barriers)."""
        with self._lock:
            return len(self._ops)

    def ping(self) -> bool:
        return self.alive

    def set_alive(self, alive: bool) -> None:
        self.alive = bool(alive)

    # ---- gossip ----

    def version_vector(self) -> Dict[int, int]:
        with self._lock:
            return dict(self._vv)

    def vv_snapshot(self) -> Tuple[Dict[int, int], Dict[str, int]]:
        """(vv, epochs) under one lock acquisition."""
        with self._lock:
            return dict(self._vv), self._epochs_locked()

    def gossip_payload(
        self, since: Optional[Dict[int, int]] = None
    ) -> Optional[Dict[str, Any]]:
        """The map wire payload (None when down): retained ops above
        ``since`` plus this node's per-key epochs.  Epochs are state-based
        (max-adoption) so a delta payload is ALWAYS valid — an op the
        sender pruned as reset-dominated is void at every receiver that
        adopts the sender's epochs (module docstring)."""
        if not self.alive:
            return None
        with self._lock:
            payload: Dict[str, Any] = {}
            if since is not None:
                for w, lst in self._by_writer.items():
                    # seq-ascending WITH HOLES (reset pruning), so binary-
                    # search the first op above the watermark (SetNode rule)
                    start = bisect.bisect_right(
                        lst, since.get(w, -1), key=lambda e: e[0][1]
                    )
                    for ident, op in lst[start:]:
                        payload[_wire_key(*ident)] = dict(op)
            else:
                for ident, op in self._ops.items():
                    payload[_wire_key(*ident)] = dict(op)
            ep = self._epochs_locked()
            if ep or payload:
                payload[EPOCH_KEY] = ep
            # the vv section restores watermark convergence across reset
            # pruning: an op a reset voided is PRUNED from the sender's
            # records and never re-sent, so a receiver that missed it
            # would keep a permanent vv hole without this.  Max-adopting
            # the sender's vv is safe because every op at or under it is
            # either in this payload (retained, above `since`), already
            # held, or pruned-void (dominated by an epoch this payload
            # also carries) — the floor-extends-knowledge rule the
            # set/seq nodes use, epoch-wise.
            if self._vv:
                payload[VV_KEY] = {str(r): s for r, s in self._vv.items()}
            return payload

    def receive(self, payload: Optional[Dict[str, Any]]) -> int:
        """Merge a peer's payload; returns genuinely-new op count.
        Epochs adopt FIRST so every op in the payload lands at-or-below
        its key's adopted epoch (dominated ops are void, not recorded)."""
        if not payload or not self.alive:
            return 0
        payload = dict(payload)
        epochs = {
            str(k): int(e)
            for k, e in (payload.pop(EPOCH_KEY, None) or {}).items()
        }
        remote_vv = {
            int(r): int(s)
            for r, s in (payload.pop(VV_KEY, None) or {}).items()
        }
        rows = [(_parse_wire_key(k), op) for k, op in payload.items()]
        with self._lock:
            if epochs:
                self._adopt_epochs_locked(epochs)
            fresh = self._ingest_locked(rows)
            for r, s2 in remote_vv.items():
                if s2 > self._vv.get(r, -1):
                    self._vv[r] = s2
            return fresh

    # ---- reset barrier surface ----

    def adopt_epochs(self, epochs: Dict[str, int]) -> None:
        """Fold barrier-minted epochs (POST /map/reset): reset the planes
        of any key whose epoch advances, void + prune its dominated
        records."""
        with self._lock:
            self._adopt_epochs_locked(
                {str(k): int(e) for k, e in epochs.items()}
            )

    def mint_reset(self) -> Dict[str, int]:
        """Coordinator-side barrier mint — call ONLY with every member's
        contributions folded (:func:`map_barrier_ready` checks the vv
        domination first).  Resets every key with
        history whose removal is folded (had tokens, none live), bumps
        its epoch, prunes its dominated records.  Returns {key: new_epoch}
        ({} = nothing stably removed)."""
        with self._lock:
            out: Dict[str, int] = {}
            for k, kid in self.keys.items():
                had_history = bool((self._tok[kid] > -1).any())
                if had_history and not self._contains_locked(kid):
                    out[k] = int(self._epoch[kid]) + 1
            if out:
                self._adopt_epochs_locked(out)
                self.metrics.inc("map_resets_minted", len(out))
            return out

    # ---- device bridge ----

    def device_state(self):
        """The folded state as a ``MapGc`` on the node's device (the OR-Map
        lattice with PN values): ``ormap_gc.join`` of two nodes' device
        states equals the receiving node's device state after a wire
        merge."""
        from crdt_tpu_torch.models import flags, ormap, ormap_gc, pncounter

        def t(x):
            return torch.tensor(x, dtype=torch.int32, device=self.device)

        with self._lock:
            m = ormap.ORMap(
                presence=flags.TokenPlane(tok=t(self._tok), obs=t(self._obs)),
                values=pncounter.PNCounter(pos=t(self._pos.astype(np.int32)),
                                           neg=t(self._neg.astype(np.int32))),
            )
            return ormap_gc.MapGc(map=m, epoch=t(self._epoch))

    # ---- internals (all under self._lock) ----

    def _kid_locked(self, key: str) -> int:
        kid = self.keys.intern(key)
        if kid >= self._k:
            k2 = self._k
            while kid >= k2:
                k2 *= 2
            self._tok = np.pad(self._tok, ((0, k2 - self._k), (0, 0)),
                               constant_values=-1)
            self._obs = np.pad(
                self._obs, ((0, k2 - self._k), (0, 0), (0, 0)),
                constant_values=-1,
            )
            self._pos = np.pad(self._pos, ((0, k2 - self._k), (0, 0)))
            self._neg = np.pad(self._neg, ((0, k2 - self._k), (0, 0)))
            self._epoch = np.pad(self._epoch, (0, k2 - self._k))
            self._k = k2
        return kid

    def _grow_writers_locked(self, rid: int) -> None:
        w2 = self._w
        while rid >= w2:
            w2 *= 2
        dw = w2 - self._w
        self._tok = np.pad(self._tok, ((0, 0), (0, dw)), constant_values=-1)
        self._obs = np.pad(self._obs, ((0, 0), (0, dw), (0, dw)),
                           constant_values=-1)
        self._pos = np.pad(self._pos, ((0, 0), (0, dw)))
        self._neg = np.pad(self._neg, ((0, 0), (0, dw)))
        self._w = w2

    def _contains_locked(self, kid: int) -> bool:
        """The TokenPlane active rule: some token unobserved by every
        remove (flags.plane_active)."""
        tok = self._tok[kid]
        seen = self._obs[kid].max(axis=0)
        return bool(((tok >= 0) & (tok > seen)).any())

    def _epochs_locked(self) -> Dict[str, int]:
        out = {}
        for k, kid in self.keys.items():
            if self._epoch[kid] > 0:
                out[k] = int(self._epoch[kid])
        return out

    def _ingest_locked(self, rows) -> int:
        """Apply op rows; returns genuinely-new count.  Ops below their
        key's current epoch are DOMINATED: the vv still advances (they
        were seen) but they are void — neither recorded nor applied."""
        fresh = 0
        for ident, op in sorted(rows, key=lambda r: (r[0][0], r[0][1])):
            rid, seq = ident
            if ident in self._ops:
                continue  # re-delivery
            if seq <= self._vv.get(rid, -1):
                continue  # already seen (possibly pruned as dominated)
            self._vv[rid] = max(self._vv.get(rid, -1), seq)
            key = str(op.get("upd") if "upd" in op else op.get("rem"))
            kid = self._kid_locked(key)
            if rid >= self._w:
                self._grow_writers_locked(rid)
            e = int(op.get("e", 0))
            if e < int(self._epoch[kid]):
                self.metrics.inc("map_ops_dominated")
                continue  # reset-wins: void everywhere, don't record
            op = dict(op)
            self._ops[ident] = op
            self._by_writer.setdefault(rid, []).append((ident, op))
            if "upd" in op:
                d = int(op["d"])
                self._tok[kid, rid] += 1
                if d >= 0:
                    self._pos[kid, rid] += d
                else:
                    self._neg[kid, rid] += -d
            else:
                for w_s, t in (op.get("obs") or {}).items():
                    w = int(w_s)
                    if w >= self._w:
                        self._grow_writers_locked(w)
                    self._obs[kid, rid, w] = max(
                        int(self._obs[kid, rid, w]), int(t)
                    )
            fresh += 1
        if fresh:
            self.metrics.inc("map_ops_ingested", fresh)
        return fresh

    def _adopt_epochs_locked(self, epochs: Dict[str, int]) -> None:
        """Max-adopt per-key epochs; an advance resets the key's planes
        and prunes every retained record the new epoch dominates."""
        dropped: List[Tuple[int, int]] = []
        for k, e in epochs.items():
            kid = self._kid_locked(k)
            if e <= int(self._epoch[kid]):
                continue
            self._epoch[kid] = e
            self._tok[kid] = -1
            self._obs[kid] = -1
            self._pos[kid] = 0
            self._neg[kid] = 0
            for ident, op in self._ops.items():
                op_key = str(op.get("upd") if "upd" in op else op.get("rem"))
                if op_key == k and int(op.get("e", 0)) < e:
                    dropped.append(ident)
            self.metrics.inc("map_epoch_adoptions")
        if dropped:
            ds = set(dropped)
            for ident in ds:
                self._ops.pop(ident, None)
            for w, lst in self._by_writer.items():
                self._by_writer[w] = [e2 for e2 in lst if e2[0] not in ds]

    # ---- snapshot (crash-safe checkpoint sections) ----

    def to_snapshot(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "rid": self.rid,
                "seq_next": self._seq.count,
                "epochs": self._epochs_locked(),
                "ops": {
                    _wire_key(*ident): dict(op)
                    for ident, op in self._ops.items()
                },
            }

    def from_snapshot(self, snap: Dict[str, Any]) -> None:
        with self._lock:
            self._ops = {}
            self._by_writer = {}
            self._vv = {}
            self._tok = np.full((self._k, self._w), -1, np.int32)
            self._obs = np.full((self._k, self._w, self._w), -1, np.int32)
            self._pos = np.zeros((self._k, self._w), np.int64)
            self._neg = np.zeros((self._k, self._w), np.int64)
            self._epoch = np.zeros((self._k,), np.int32)
            # epochs first: replay must void any op the snapshot retained
            # only by races (defensive — save prunes dominated ops already)
            for k, e in (snap.get("epochs") or {}).items():
                kid = self._kid_locked(str(k))
                self._epoch[kid] = int(e)
            rows = [
                (_parse_wire_key(k), op)
                for k, op in (snap.get("ops") or {}).items()
            ]
            self._ingest_locked(rows)
            if int(snap.get("rid", self.rid)) == self.rid:
                self._seq.count = int(snap.get("seq_next", 0))
            # else: incarnation restore — fresh rid starts at 0


def map_barrier_ready(
    local: MapNode,
    peer_vvs: List[Optional[Dict[int, int]]],
) -> bool:
    """Full-fleet precondition for a reset barrier: every member
    reachable (no None) and the coordinator's vv dominates every
    member's — i.e. every contribution is folded locally, so the mint
    decision sees the converged state (module docstring)."""
    own = local.version_vector()
    for vv in peer_vvs:
        if vv is None:
            return False
        if any(s > own.get(r, -1) for r, s in vv.items()):
            return False
    return True
