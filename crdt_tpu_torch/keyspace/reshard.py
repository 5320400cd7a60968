"""Online keyspace resharding: epoch-fenced live shard migration (own copy
of ``crdt_tpu.keyspace.reshard``).

Changes a live :class:`ShardedKeyspace` from S to S' shards with zero
lost writes, zero read unavailability, and bounded (shed-with-
provenance, never silent) write impact.  The design leans on the two
facts the tier already guarantees:

* **every node holds every shard** — sharding partitions the keyspace
  into independent CRDT planes for dispatch size and GC locality, not
  placement across machines.  Migration is therefore NODE-LOCAL and
  deterministic; the only cross-node concerns are epoch agreement and
  post-cutover convergence of the re-homed state, both of which ride
  the ordinary anti-entropy machinery.
* **(rid, seq) spaces collide across shards by design** and only stay
  safe because gossip is shard-scoped.  A re-homed op therefore CANNOT
  keep its identity in the destination plane; cutover re-mints each
  surviving winner as a fresh local op with the ORIGINAL timestamp
  preserved, so LWW order across the boundary is untouched.

The protocol is a three-phase state machine behind one monotone
**reshard epoch** that fences every keyspace wire surface (stale-epoch
traffic gets a 409 naming the current epoch, mirroring the lease tier's
``check_push_fences``):

PREPARE   the S' router is derived from the live one through the
          minimal-remap constructors (``with_member``/``without_member``
          chained), and the moved key set is exactly the keys whose
          owner changed — no key moves twice, moved + kept covers the
          keyspace (property-tested in tests/test_torch_keyspace.py).
MIGRATE   a dual-route window: admits keep landing in the OLD owner
          lanes (reads and writes stay available), while per-shard
          op-log slices of the moved keys stream to peers as ordinary
          wire payloads (``POST /ks/migrate``) folded into a
          per-destination migration buffer — retries ride the
          ``RemotePeer`` breaker/backoff, corrupt payloads quarantine
          without wedging the window.
CUTOVER   the epoch bumps and every plane is reborn at the new shard
          count: the LWW winner of each key (over the old planes' raw
          ops + folded summaries + the migration buffer, compared by
          the op order ``(ts, rid, seq)`` — the same order the device
          rebuild uses) is re-minted into its new owner plane.  Old
          epoch ops never cross into the new epoch: the fence is what
          makes the re-minted identities safe.  Discarding the
          non-winning history at the boundary is the same fold the
          stability machinery performs, minus the fleet-stability
          wait — which is unattainable mid-partition, exactly when
          resharding must still complete.

ABORT rolls back to the old epoch from any pre-cutover phase: nothing
is mutated before CUTOVER, so abort just discards the plan and buffer
and the pre-reshard state is bit-identical.

Crash recovery: the reshard ledger ({epoch, phase, target, n_shards})
persists in every checkpoint (``ks-reshard.json``, covered by the
snapshot manifest), so a node rebooting mid-MIGRATE deterministically
RESUMES the window (the plan is recomputed from the restored planes;
peer slices re-stream on the next round), and a node restored from a
post-cutover snapshot reshapes to S' before its shard files load.

Lock order at cutover: the coordinator's phase lock (its own class —
never taken by a thread already holding admission/drain/node locks),
then the tenant door's admission lock, then drain slots, then per-shard
node locks taken one at a time in ascending shard order — the same
drain-before-node discipline every other multi-shard path declares.
The card's ``device_lock`` is innermost and held only inside one
plane's merge: the reborn planes are built (tensor allocation, no
merge) without it, and each re-mint takes it for its own merge alone.
"""
from __future__ import annotations

import threading
from typing import Any, Dict, List, Optional, Tuple

from crdt_tpu_torch.api.node import INT32_MAX, _parse_wire_key, _wire_key
from crdt_tpu_torch.keyspace.routing import RendezvousRouter, route_key
from crdt_tpu_torch.keyspace.shards import split_qualified

PHASE_IDLE = "idle"
PHASE_MIGRATE = "migrate"

# crdt_ks_reshard_state gauge encoding (obs/health.sample_keyspace)
PHASE_GAUGE = {PHASE_IDLE: 0, PHASE_MIGRATE: 1}


def fence_body(surface: str, ours: int, got: Any) -> Dict[str, Any]:
    """The 409 body a stale-epoch request gets on every fenced keyspace
    surface — mirrors the lease firewall's ``{"fenced": True, ...}``
    shape so clients share one refusal grammar."""
    return {"fenced": True, "surface": surface,
            "epoch": int(ours), "got": got}


def shard_members(n: int) -> List[str]:
    return [f"shard-{i}" for i in range(n)]


def next_router(router: RendezvousRouter, target: int) -> RendezvousRouter:
    """The S' router derived from the live one through the MINIMAL-REMAP
    constructors: grow appends ``shard-S .. shard-(S'-1)`` one
    ``with_member`` at a time (only keys the new members win move);
    shrink peels the top members with ``without_member`` (only the
    departing members' keys move).  The chain endpoint is identical to
    ``RendezvousRouter(shard_members(target))`` — HRW scores are
    per-member — but deriving it this way keeps the minimal-remap
    property the migration plan is tested against."""
    target = int(target)
    if target < 1:
        raise ValueError(f"reshard target must be >= 1, got {target}")
    n = len(router.members)
    r = router
    if target >= n:
        for i in range(n, target):
            r = r.with_member(f"shard-{i}")
    else:
        for i in range(n - 1, target - 1, -1):
            r = r.without_member(f"shard-{i}")
    return r


def migration_plan(old_router: RendezvousRouter,
                   new_router: RendezvousRouter,
                   qkeys) -> Dict[Tuple[int, int], List[str]]:
    """``(src, dst) -> [qualified key]`` for exactly the keys whose
    owner changed between the two routers.  Every key appears at most
    once across all groups (a key has one old and one new owner), and
    the union of moved + kept keys is the input key set — the
    properties tests/test_torch_keyspace.py pins for random S -> S'."""
    plan: Dict[Tuple[int, int], List[str]] = {}
    for qkey in qkeys:
        tenant, key = split_qualified(qkey)
        rk = route_key(tenant, key)
        src = old_router.owner_index(rk)
        dst = new_router.owner_index(rk)
        if src != dst:
            plan.setdefault((src, dst), []).append(qkey)
    return plan


class ReshardCoordinator:
    """The per-node reshard state machine over one ShardedKeyspace."""

    def __init__(self, ks):
        self.ks = ks
        # serializes phase transitions; RLock so fenced serving paths may
        # consult the phase while a transition is mid-flight on the same
        # thread (status from inside admin handlers)
        self._phase_lock = threading.RLock()
        self.phase = PHASE_IDLE
        self.target: Optional[int] = None
        self._next_router: Optional[RendezvousRouter] = None
        # migration buffer: dst shard -> {qkey: (ts_abs, rid, seq, val)}
        # holding the max-(ts, rid, seq) candidate per key streamed in by
        # peers; folded into the cutover winner set, NOT persisted — a
        # resumed window re-streams (the planes hold everything local)
        self._buffer: Dict[int, Dict[str, Tuple[int, int, int, str]]] = {}
        # provenance counters (1:1 against ks_reshard_* events)
        self.fences = 0
        self.quarantines = 0

    # ---- observability ----

    def _emit(self, event: str, **fields) -> None:
        ev = self.ks.events
        if ev is not None:
            ev.emit(event, **fields)

    def phase_gauge(self) -> int:
        return PHASE_GAUGE.get(self.phase, 0)

    def status(self) -> Dict[str, Any]:
        # lock-free read: each field is an independent scalar assigned
        # under the phase lock, and readers (admin handlers, checkpoint,
        # reshape callbacks) may already hold node/admission locks — the
        # phase lock must never be taken from under any other lock class
        return {"epoch": self.ks.epoch, "phase": self.phase,
                "target": self.target, "n_shards": self.ks.n_shards}

    # ---- epoch fencing (every keyspace wire surface) ----

    def check_epoch(self, got, surface: str,
                    peer: Optional[str] = None) -> Optional[Dict[str, Any]]:
        """None when ``got`` may pass; else the 409 body.  ``got=None``
        (a pre-reshard client that sends no epoch) is treated as epoch 0
        — back-compatible until the first reshard, fenced after it,
        which is exactly the point.  Every refusal is black-boxed
        (``ks_reshard_fence`` role=serve) so a soak can reconcile
        409s 1:1."""
        try:
            got = 0 if got is None else int(got)
        except (TypeError, ValueError):
            got = -1
        ours = self.ks.epoch
        if got == ours:
            return None
        with self._phase_lock:
            self.fences += 1
        self.ks.metrics.inc("ks_reshard_fenced")
        self._emit("ks_reshard_fence", role="serve", surface=surface,
                   epoch=ours, got=got, peer=peer)
        return fence_body(surface, ours, got)

    # ---- PREPARE -> MIGRATE ----

    def start(self, target: int) -> Dict[str, Any]:
        """PREPARE + enter the MIGRATE window.  Idempotent for the same
        target (a re-sent admin request or a resumed node reports the
        live window instead of failing)."""
        target = int(target)
        with self._phase_lock:
            if self.phase == PHASE_MIGRATE:
                if self.target == target:
                    return self.status()
                raise ValueError(
                    f"reshard to {self.target} already migrating "
                    f"(epoch {self.ks.epoch}); abort it first")
            if target == self.ks.n_shards:
                raise ValueError(
                    f"keyspace already has {target} shards")
            self._next_router = next_router(self.ks.router, target)
            self.target = target
            self._buffer = {}
            self.phase = PHASE_MIGRATE
            moved = sum(
                len(v) for v in migration_plan(
                    self.ks.router, self._next_router,
                    self.ks.state().keys()).values())
            self._emit("ks_reshard_phase", phase=PHASE_MIGRATE,
                       epoch=self.ks.epoch, target=target, moved=moved)
            out = self.status()
            out["moved"] = moved
            return out

    def resume(self, target: int) -> None:
        """Deterministic crash recovery: a node restored from a snapshot
        whose ledger says MIGRATE re-enters the window against its
        restored planes (checkpoint.restore_node calls this after the
        shard files load).  The buffer starts empty — peers re-stream
        their slices on the next round."""
        target = int(target)
        with self._phase_lock:
            self._next_router = next_router(self.ks.router, target)
            self.target = target
            self._buffer = {}
            self.phase = PHASE_MIGRATE
            self._emit("ks_reshard_phase", phase="resume",
                       epoch=self.ks.epoch, target=target)

    # ---- MIGRATE: the dual-route window ----

    def moved_to(self, qkey: str) -> Optional[int]:
        """Destination shard of ``qkey`` under the NEXT router, or None
        when its owner does not change.  Computed live (not from a
        frozen plan) so writes admitted DURING the window — which land
        in their old owner's plane as usual — are migrated too."""
        nr = self._next_router
        if nr is None:
            return None
        tenant, key = split_qualified(qkey)
        rk = route_key(tenant, key)
        if self.ks.router.owner_index(rk) == nr.owner_index(rk):
            return None
        return nr.owner_index(rk)

    def migration_slices(self) -> List[Tuple[int, Dict[str, Any]]]:
        """``(dst_shard, wire payload)`` per destination: every moved
        key's surviving evidence — raw op rows (from ``_commands``) plus
        the folded summary winner where compaction already ate the raw
        history — as ordinary ``ts:rid:seq`` wire rows.  Peers fold
        these into their migration buffers; the payloads are built
        under each source shard's lock, ascending, one at a time."""
        with self._phase_lock:
            if self.phase != PHASE_MIGRATE:
                return []
            slices: Dict[int, Dict[str, Dict[str, str]]] = {}
            for shard in self.ks.shards:
                epoch_ms = shard.clock.epoch_ms
                with shard._lock:
                    for (ts, rid, seq), cmd in shard._commands.items():
                        for qkey, val in cmd.items():
                            dst = self.moved_to(qkey)
                            if dst is None:
                                continue
                            wk = _wire_key(ts + epoch_ms, rid, seq)
                            slices.setdefault(dst, {}).setdefault(
                                wk, {})[qkey] = str(val)
                    for qkey, e in shard._summary.items():
                        dst = self.moved_to(qkey)
                        if dst is None:
                            continue
                        wk = _wire_key(int(e["ts"]), int(e["rid"]),
                                       int(e["seq"]))
                        slices.setdefault(dst, {}).setdefault(
                            wk, {})[qkey] = str(e["payload"])
            return sorted(slices.items())

    def receive_migration(self, shard: int, payload: Any,
                          peer: Optional[str] = None) -> Dict[str, Any]:
        """Fold one peer's migration slice for destination ``shard``
        into the buffer.  Validates like a gossip body BEFORE folding
        (all-or-nothing): malformed wire keys, non-dict commands, or
        rows routed at the wrong destination quarantine the WHOLE
        payload — loudly black-boxed, never wedging the window (the
        sender retries with clean bytes on a later round)."""
        with self._phase_lock:
            if self.phase != PHASE_MIGRATE:
                return {"ok": False, "reason": "not-migrating",
                        "epoch": self.ks.epoch}
            shard = int(shard)
            err = None
            rows: List[Tuple[int, int, int, str, str]] = []
            try:
                if not isinstance(payload, dict):
                    raise ValueError(
                        f"payload must be a wire dict, got "
                        f"{type(payload).__name__}")
                if self._next_router is None \
                        or not 0 <= shard < len(self._next_router.members):
                    raise ValueError(f"destination shard {shard} outside "
                                     "the target shard map")
                for wk, cmd in payload.items():
                    ts_abs, rid, seq = _parse_wire_key(str(wk))
                    if not isinstance(cmd, dict):
                        raise ValueError(
                            f"non-dict command: {type(cmd).__name__}")
                    for qkey, val in cmd.items():
                        if self.moved_to(qkey) != shard:
                            raise ValueError(
                                f"key {qkey!r} does not migrate to "
                                f"shard {shard}")
                        rows.append((ts_abs, rid, seq, str(qkey),
                                     str(val)))
            except (ValueError, KeyError, TypeError) as e:
                err = f"{type(e).__name__}: {e}"
            if err is not None:
                self.quarantines += 1
                self.ks.metrics.inc("ks_reshard_quarantined")
                self._emit("ks_reshard_quarantine", peer=peer,
                           shard=shard, error=err[:200])
                return {"ok": False, "quarantined": err[:200]}
            buf = self._buffer.setdefault(shard, {})
            for ts_abs, rid, seq, qkey, val in rows:
                cand = (ts_abs, rid, seq, val)
                held = buf.get(qkey)
                if held is None or cand[:3] > held[:3]:
                    buf[qkey] = cand
            self._emit("ks_reshard_migrate_fold", peer=peer, shard=shard,
                       ops=len(rows))
            return {"ok": True, "folded": len(rows)}

    # ---- CUTOVER ----

    def _collect_winners(self) -> Dict[str, Tuple[int, int, int, str]]:
        """The LWW winner of every live key, over raw ops + folded
        summaries of every old plane plus the migration buffer —
        compared by the op order ``(ts_abs, rid, seq)``, exactly the
        order the device rebuild resolves keys by, so the re-minted
        state is the state every reader already saw."""
        winners: Dict[str, Tuple[int, int, int, str]] = {}

        def offer(qkey, ts_abs, rid, seq, val):
            cand = (int(ts_abs), int(rid), int(seq), str(val))
            held = winners.get(qkey)
            if held is None or cand[:3] > held[:3]:
                winners[qkey] = cand

        for shard in self.ks.shards:  # shard index ascending, one lock
            epoch_ms = shard.clock.epoch_ms  # at a time (never two)
            with shard._lock:
                for qkey, e in shard._summary.items():
                    offer(qkey, e["ts"], e["rid"], e["seq"], e["payload"])
                for (ts, rid, seq), cmd in shard._commands.items():
                    for qkey, val in cmd.items():
                        offer(qkey, ts + epoch_ms, rid, seq, val)
        for buf in self._buffer.values():
            for qkey, (ts_abs, rid, seq, val) in buf.items():
                offer(qkey, ts_abs, rid, seq, val)
        return winners

    def cutover(self) -> Dict[str, Any]:
        """Bump the epoch and rebirth every plane at the target shard
        count.  Blocks tenant admissions for the window (the door's
        admission lock), drains the lanes, re-mints each winner into
        its new owner plane with its ORIGINAL timestamp, swaps the
        shard set + router + epoch atomically, then runs the reshape
        callbacks (door lanes, stability trackers, recorders, mesh
        plane).  Reads stay served off the old planes until the swap —
        zero read unavailability; writes wait out the window and
        observe only latency, never loss."""
        with self._phase_lock:
            if self.phase != PHASE_MIGRATE:
                raise ValueError(
                    f"cutover without a migrate window (phase "
                    f"{self.phase!r}, epoch {self.ks.epoch})")
            door = self.ks._door
            if door is None:
                return self._finish_cutover(None)
            with door._adm:  # no new admissions past this point
                return self._finish_cutover(door)

    def _finish_cutover(self, door) -> Dict[str, Any]:
        # cutover() holds the phase lock (and the door's admission
        # lock, when a door is wired) for the whole window
        if door is not None:
            door.flush_all()  # drain every lane into the planes
        winners = self._collect_winners()
        new_router = self._next_router
        new_shards = [self.ks._make_shard(i)
                      for i in range(self.target)]
        # group winners per destination, key-sorted: the mint
        # order (and thus each plane's seq assignment) is a pure
        # function of the winner set
        groups: Dict[int, List[Tuple[str, Tuple]]] = {}
        for qkey in sorted(winners):
            tenant, key = split_qualified(qkey)
            dst = new_router.owner_index(route_key(tenant, key))
            groups.setdefault(dst, []).append(
                (qkey, winners[qkey]))
        minted = 0
        for dst in sorted(groups):
            cmds = [{qkey: w[3]} for qkey, w in groups[dst]]
            # original timestamps preserved (rebased onto the
            # destination plane's clock; clamped into the
            # storable window so a pre-epoch op cannot poison
            # the mint — LWW order among survivors is unchanged
            # either way, and only one winner per key exists)
            epoch_ms = new_shards[dst].clock.epoch_ms
            tss = [min(max(0, w[0] - epoch_ms), INT32_MAX - 1)
                   for _, w in groups[dst]]
            idents = new_shards[dst].add_commands(cmds, tss)
            minted += 0 if idents is None else len(idents)
        old_epoch = self.ks.epoch
        self.ks._adopt_planes(new_router, new_shards,
                              old_epoch + 1)
        self.phase = PHASE_IDLE
        self.target = None
        self._next_router = None
        self._buffer = {}
        self._emit("ks_reshard_phase", phase="cutover",
                   epoch=self.ks.epoch, n_shards=self.ks.n_shards,
                   minted=minted)
        # reshape callbacks AFTER the swap: door lane rebuild
        # (the admission lock is still held — the door's
        # contract), stability trackers, recorder re-install,
        # meshplane reset
        if door is not None:
            door.rebuild_lanes()
        for cb in list(self.ks._reshape_cbs):
            cb()
        return {"epoch": self.ks.epoch, "phase": self.phase,
                "target": self.target, "n_shards": self.ks.n_shards,
                "minted": minted}

    # ---- ABORT ----

    def abort(self, reason: str = "") -> Dict[str, Any]:
        """Roll back to the old epoch from any pre-cutover phase.
        Nothing was mutated before CUTOVER, so dropping the plan and
        buffer restores bit-identical pre-reshard state."""
        with self._phase_lock:
            if self.phase == PHASE_IDLE:
                return self.status()
            self.phase = PHASE_IDLE
            self.target = None
            self._next_router = None
            self._buffer = {}
            self._emit("ks_reshard_phase", phase="abort",
                       epoch=self.ks.epoch, reason=reason[:200])
            return self.status()

    # ---- crash-recovery ledger (persisted by utils/checkpoint) ----

    def ledger(self) -> Dict[str, Any]:
        # same lock-free contract as status(): save_node_atomic reads
        # the ledger while holding node locks (its consistent cut)
        return {"epoch": self.ks.epoch, "phase": self.phase,
                "target": self.target, "n_shards": self.ks.n_shards}

    def restore_ledger(self, snap: Dict[str, Any]) -> None:
        """Resume or settle from a restored ledger (the keyspace was
        already reshaped to the ledger's shard count before the shard
        files loaded).  A MIGRATE ledger resumes the window; anything
        else is a settled epoch and restores idle."""
        phase = str(snap.get("phase", PHASE_IDLE))
        target = snap.get("target")
        if phase == PHASE_MIGRATE and target is not None:
            self.resume(int(target))
        else:
            with self._phase_lock:
                self.phase = PHASE_IDLE
                self.target = None
                self._next_router = None
                self._buffer = {}
