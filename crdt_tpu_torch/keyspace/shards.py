"""The sharded keyspace: S independent CRDT planes behind one router (own
copy of ``crdt_tpu.keyspace.shards``, each plane a ``ReplicaNode`` on the
card).

One ``ShardedKeyspace`` holds ``n_shards`` full :class:`ReplicaNode`
planes.  Every tenant-scoped key is owned by exactly one shard —
``RendezvousRouter`` over the ``shard-0 .. shard-(S-1)`` member list,
computed identically on every node — so each shard is a self-contained
CRDT: its own op tensor (capacity ``keyspace_capacity``, growing 2x
independently), its own interner, its own version vector, and its own
stability frontier / GC.  No single host structure grows with the TOTAL
keyspace; a million keys over 64 shards is 64 planes of ~16k keys each.

Interning is two-level: the keyspace interns tenants to small ids (for
per-tenant accounting tables and gauge labels), and each shard's own
interner sees only the qualified keys (``tenant:key``) that route to
it.  The qualified key — not a tenant id — is what's stored and
gossiped, so the wire stays deterministic across nodes regardless of
tenant arrival order.

Shards share the host's rid: ``(rid, seq)`` spaces would collide across
shards, but never meet — gossip is SHARD-SCOPED (``/ks/gossip?shard=i``
pulls shard i's payload into the peer's shard i and nothing else), and
shards never merge with each other.  Deterministic routing guarantees
shard i holds the same key set on every node, so per-shard convergence
is fleet convergence.

Shards fold on the host path (one merge per shard and payload) or, with
``mesh="on"`` (and ``"auto"`` with at least two cards), all S at once in
one step of the mesh plane (:mod:`crdt_tpu_torch.parallel.meshplane`),
as in the JAX package.
"""
from __future__ import annotations

import threading
from typing import Any, Dict, List, Optional, Tuple

from crdt_tpu_torch import default_device
from crdt_tpu_torch.api.node import ReplicaNode
from crdt_tpu_torch.keyspace.routing import (RendezvousRouter, route_key,
                                       validate_tenant)

# separates tenant from key in the STORED (and gossiped) qualified key;
# unambiguous because validate_tenant bans ':' in tenant names
QUALIFY_SEP = ":"


def qualify(tenant: str, key: str) -> str:
    """The shard-local stored key for ``(tenant, key)``."""
    return f"{tenant}{QUALIFY_SEP}{key}"


def split_qualified(qkey: str) -> Tuple[str, str]:
    """Inverse of :func:`qualify` (first ``:`` wins — keys may contain
    more of them)."""
    tenant, _, key = qkey.partition(QUALIFY_SEP)
    return tenant, key


def tenant_of_cmd(cmd: Dict[str, str]) -> Optional[str]:
    """Tenant of one shard-local command: the :func:`qualify` prefix of
    its first key.  Every key the front door admits is tenant-qualified;
    a bare key (a direct shard poke in tests) has no tenant and gets
    none.  The flight recorder's merge side calls this per newly-visible
    op to label the propagation histograms (obs/provenance)."""
    for qkey in cmd:
        tenant, sep, _ = qkey.partition(QUALIFY_SEP)
        return tenant if sep else None
    return None


class ShardedKeyspace:
    """S independent plane shards + the deterministic router over them."""

    def __init__(self, rid: int, n_shards: int, *, capacity: int = 1024,
                 metrics=None, events=None, clock=None, mesh: str = "auto",
                 device=None):
        if mesh not in ("auto", "on", "off"):
            raise ValueError(f"mesh={mesh!r} must be one of auto|on|off")
        n_shards = int(n_shards)
        if n_shards < 1:
            raise ValueError(
                f"ShardedKeyspace needs n_shards >= 1, got {n_shards} "
                "(use ClusterConfig.keyspace_shards=0 to disable the "
                "tier instead)")
        self.rid = int(rid)
        self.n_shards = n_shards
        self.router = RendezvousRouter(
            [f"shard-{i}" for i in range(n_shards)])
        # construction args kept: online resharding (keyspace/reshard)
        # rebirths the plane set at a new shard count and must build the
        # replacement shards with identical wiring
        self.capacity = int(capacity)
        # every shard's tensors live here (None = the CUDA card, raising
        # without one)
        self.device = default_device(device)
        self.events = events
        self.clock = clock
        self._metrics_arg = metrics
        # live divergence audit (crdt_tpu_torch.obs.audit): once enabled, every
        # plane _make_shard builds — including reshard cutover/restore
        # rebirths — re-mints its digest from its (fresh) store
        self._audit = False
        # shards share the host's metrics/events sinks: merge-dispatch
        # counters aggregate (what the bench reads) and shard events land
        # in the same black box
        self.shards: List[ReplicaNode] = [
            self._make_shard(i) for i in range(n_shards)
        ]
        self.metrics = self.shards[0].metrics
        # level-1 interning: tenant -> small id (accounting only — ids
        # are NEVER stored or gossiped; arrival order may differ per node)
        self._tenants: Dict[str, int] = {}
        self._tenant_lock = threading.Lock()
        # the fused shard plane (parallel.meshplane): built lazily on first
        # use, so a keyspace that never folds through it pays nothing
        self.mesh_mode = mesh
        self._mesh_requested = mesh  # pre-resolution mode, for reshapes
        self._meshplane = None
        self._meshplane_lock = threading.Lock()
        # online resharding: the monotone reshard epoch fencing every
        # keyspace wire surface, the per-node state machine over it, the
        # tenant door (registered by KeyspaceFrontDoor, drained at
        # cutover), and the reshape callbacks the host layers register
        # (stability trackers, flight recorders, lane sets)
        self.epoch = 0
        self._door = None
        self._reshape_cbs: List[Any] = []
        from crdt_tpu_torch.keyspace.reshard import ReshardCoordinator
        self.reshard = ReshardCoordinator(self)

    def _make_shard(self, i: int) -> ReplicaNode:
        """One plane shard, fully wired: per-shard flight-recorder
        identity (shards share the host's rid AND its seq-from-0 space,
        so their op_birth/op_visible records and propagation series
        carry the shard label to stay disjoint from the host plane's and
        each other's — tenant_of turns each merged op's qualified key
        into a tenant label) and per-shard merge attribution
        (merge_dispatches{shard=i} / union_path{shard=i} tick once per
        folded lane, as in the JAX package on both its paths).  Used at
        construction AND by reshard cutover/restore, which rebuild the
        plane set at a new shard count on the keyspace's device."""
        shard = ReplicaNode(rid=self.rid, capacity=self.capacity,
                            metrics=self._metrics_arg, clock=self.clock,
                            events=self.events, device=self.device)
        shard.recorder.bind(extra={"shard": str(i)},
                            tenant_of=tenant_of_cmd)
        shard._metric_labels = {"shard": str(i)}
        if self._audit:
            shard.enable_audit(plane=f"ks-{i}")
        return shard

    def enable_audit(self) -> None:
        """Opt every shard plane into the live divergence audit
        (crdt_tpu_torch.obs.audit), labeled ``ks-<i>``.  Planes built later —
        reshard cutover, restore reshape — inherit the opt-in and
        re-mint their digests from their rebuilt stores (epoch-fenced:
        cross-epoch digests are never compared because cross-epoch
        gossip is already 409-fenced)."""
        self._audit = True
        for i, shard in enumerate(self.shards):
            shard.enable_audit(plane=f"ks-{i}")

    def audit_snapshot(self, shard: int):
        """One-lock (vv, frontier, digest) snapshot of one shard plane —
        the /ks/gossip piggyback source (api.http_shim)."""
        return self.shards[shard].audit_snapshot()

    # ---- online resharding (keyspace/reshard.py drives these) ----

    def attach_door(self, door) -> None:
        """The tenant front door registers itself so cutover can gate
        admissions and drain the lanes under the declared lock order."""
        self._door = door

    def on_reshape(self, cb) -> None:
        """Register a callback run (admission lock held) after the plane
        set is swapped at cutover — hosts rebuild stability trackers,
        re-install flight recorders, and re-point anything that cached
        ``shards``/``n_shards``."""
        self._reshape_cbs.append(cb)

    def check_epoch(self, got, surface: str, peer: Optional[str] = None):
        """None when ``got`` matches the live reshard epoch; else the
        409 body naming it (see reshard.fence_body)."""
        return self.reshard.check_epoch(got, surface, peer=peer)

    def _adopt_planes(self, router: RendezvousRouter,
                      shards: List[ReplicaNode], epoch: int) -> None:
        """Atomic swap at cutover: router + plane set + shard count +
        epoch move together (callers hold the coordinator lock and the
        door's admission lock).  The mesh plane resets to the REQUESTED
        mode: auto may resolve differently at the new shard count."""
        self.router = router
        self.shards = shards
        self.n_shards = len(shards)
        self.epoch = int(epoch)
        with self._meshplane_lock:
            self.mesh_mode = self._mesh_requested
            self._meshplane = None

    def reshape_for_restore(self, n_shards: int, epoch: int) -> None:
        """Snapshot restore found a ledger at a different shard count:
        rebuild empty planes at that count BEFORE the per-shard files
        load.  No reshape callbacks — restore runs before the host
        builds doors/agents (NodeHost restores first, wires after)."""
        n_shards = int(n_shards)
        if n_shards < 1:
            raise ValueError(
                f"reshard ledger names invalid shard count {n_shards}")
        self._adopt_planes(
            RendezvousRouter([f"shard-{i}" for i in range(n_shards)]),
            [self._make_shard(i) for i in range(n_shards)], epoch)

    def reshard_ledger(self) -> Dict[str, Any]:
        """The crash-recovery ledger checkpointed as ks-reshard.json."""
        return self.reshard.ledger()

    def restore_reshard(self, snap: Dict[str, Any]) -> None:
        """Resume (or settle) the reshard state machine from a restored
        ledger — after the shard files have loaded."""
        self.reshard.restore_ledger(snap)

    # ---- the fused shard plane ----

    def _plane(self):
        """The lazily built MeshPlane, or None on the host path (mode off,
        or auto without enough devices or shards).  The decision is
        cached: the mode resolves once."""
        if self.mesh_mode == "off":
            return None
        with self._meshplane_lock:
            if self._meshplane is None:
                from crdt_tpu_torch.parallel.meshplane import MeshPlane, select_engine
                if select_engine(self.n_shards, self.mesh_mode, self.device) is None:
                    self.mesh_mode = "off"  # cache the host-path decision
                    return None
                self._meshplane = MeshPlane(
                    self.n_shards, mode=self.mesh_mode,
                    metrics=self.shards[0].metrics, device=self.device)
            return self._meshplane

    @property
    def mesh_active(self) -> bool:
        """Does this keyspace fold its shards through the mesh plane?"""
        return self._plane() is not None

    @property
    def mesh_engine(self) -> Optional[str]:
        plane = self._plane()
        return None if plane is None else plane.engine

    def receive_all(self, payloads: List[Optional[Dict[str, Any]]],
                    quarantine: bool = False) -> List[Any]:
        """Fold one payload per shard: ALL shards in one fused step when the
        mesh plane is active, else one host merge per shard.

        ``payloads[i]`` lands in shard i (None = nothing for that shard
        this round).  Returns a per-shard result list: an int (ops
        absorbed) or, with ``quarantine=True``, an error string for a
        shard whose payload failed structural validation; that shard's
        lane folds empty while its SIBLINGS still converge.  Without
        quarantine a bad payload raises, after every lane was released."""
        if len(payloads) != self.n_shards:
            raise ValueError(
                f"receive_all needs one payload per shard "
                f"({self.n_shards}), got {len(payloads)}")
        plane = self._plane()
        if plane is None:
            out: List[Any] = []
            for shard, p in zip(self.shards, payloads):
                if p is None:
                    out.append(0)
                    continue
                if quarantine:
                    err = shard.validate_payload(p)
                    if err is not None:
                        out.append(err)
                        continue
                out.append(shard.receive(p))
            return out
        results: List[Any] = [0] * self.n_shards
        clean: List[Optional[Dict[str, Any]]] = [None] * self.n_shards
        for i, (shard, p) in enumerate(zip(self.shards, payloads)):
            if p is None:
                continue
            err = shard.validate_payload(p)
            if err is not None:
                if not quarantine:
                    raise ValueError(f"shard {i} payload failed validation: {err}")
                results[i] = err  # the lane folds empty; siblings unaffected
                continue
            clean[i] = p
        # lock order: shard index ascending (as every multi-shard path);
        # merge_begin HOLDS each lock until the plane commits the lane
        pendings: List[Any] = []
        try:
            for i, (shard, p) in enumerate(zip(self.shards, clean)):
                try:
                    pendings.append(shard.merge_begin([p] if p is not None else []))
                except ValueError as exc:
                    # an adoption-time refusal (incomparable frontier, a
                    # frontier without __summary__) depends on this shard's
                    # state, so validate_payload cannot screen it; merge_begin
                    # released shard i's lock.  Quarantine folds the lane
                    # empty so the siblings converge; otherwise re-raise once
                    # the held lanes landed (below).
                    if not quarantine:
                        raise
                    results[i] = f"{type(exc).__name__}: {exc}"
                    pendings.append(shard.merge_begin([]))
        except BaseException:
            # a lane failed mid-build: land every held lane with its own
            # inline merge so no shard lock leaks
            from crdt_tpu_torch.parallel.meshplane import land_all_inline
            land_all_inline(pendings)
            raise
        plane.converge(pendings)
        for i, p in enumerate(pendings):
            if not isinstance(results[i], str):
                results[i] = p.fresh + p.adopted
        return results

    # ---- routing & interning ----

    def shard_of(self, tenant: str, key: str) -> int:
        return self.router.owner_index(route_key(tenant, key))

    def tenant_id(self, tenant: str) -> int:
        validate_tenant(tenant)
        with self._tenant_lock:
            tid = self._tenants.get(tenant)
            if tid is None:
                tid = self._tenants[tenant] = len(self._tenants)
            return tid

    def tenants(self) -> List[str]:
        with self._tenant_lock:
            return list(self._tenants)

    # ---- reads ----

    def get(self, tenant: str, key: str) -> Optional[str]:
        state = self.shards[self.shard_of(tenant, key)].get_state()
        return None if state is None else state.get(qualify(tenant, key))

    def tenant_state(self, tenant: str) -> Dict[str, str]:
        """Every live key of one tenant, un-qualified (folds all shards —
        a tenant's keys spread over the whole ring)."""
        prefix = tenant + QUALIFY_SEP
        out: Dict[str, str] = {}
        for shard in self.shards:
            for qkey, val in (shard.get_state() or {}).items():
                if qkey.startswith(prefix):
                    out[qkey[len(prefix):]] = val
        return out

    def state(self) -> Dict[str, str]:
        """The full qualified-key state (shards own disjoint key sets, so
        a plain union is exact)."""
        out: Dict[str, str] = {}
        for shard in self.shards:
            out.update(shard.get_state() or {})
        return out

    # ---- anti-entropy (shard-scoped) ----

    def gossip_payload(self, shard: int,
                       since: Optional[Dict[int, int]] = None):
        return self.shards[shard].gossip_payload(since=since)

    def receive(self, shard: int, payload: Dict[str, Any]) -> int:
        return self.shards[shard].receive(payload)

    def version_vector(self, shard: int) -> Dict[int, int]:
        return self.shards[shard].version_vector()

    def vv_snapshot(self, shard: int):
        return self.shards[shard].vv_snapshot()

    def compact_shard(self, shard: int, frontier: Dict[int, int]) -> None:
        """Stability-frontier GC, shard-local: one shard folds without
        touching its siblings' logs."""
        self.shards[shard].compact(frontier)

    # ---- accounting ----

    def shard_stats(self) -> List[Dict[str, int]]:
        """Per-shard {ops: live op-log rows, keys: live keys} — the
        keyspace_shard_* gauges' source."""
        out = []
        for shard in self.shards:
            out.append({
                "ops": len(shard._commands),
                "keys": len(shard.get_state() or {}),
            })
        return out


def keyspace_from_config(rid: int, config, metrics=None, events=None,
                         clock=None, device=None) -> Optional[ShardedKeyspace]:
    """Build the tier from ClusterConfig's keyspace knobs; None when
    disabled (keyspace_shards=0 or a config predating the tier)."""
    n = int(getattr(config, "keyspace_shards", 0) or 0)
    if n < 1:
        return None
    return ShardedKeyspace(
        rid, n, capacity=int(getattr(config, "keyspace_capacity", 1024)),
        metrics=metrics, events=events, clock=clock,
        mesh=str(getattr(config, "keyspace_mesh", "auto")), device=device)
