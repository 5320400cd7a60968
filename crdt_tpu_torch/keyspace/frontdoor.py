"""Keyspace front door: per-shard admission lanes + per-tenant quota (own
copy of ``crdt_tpu.keyspace.frontdoor``).

The multi-tenant face of the ingest front door (crdt_tpu_torch.ingest): every
write names a tenant, routes through the keyspace's rendezvous router,
and lands in the OWNING SHARD's admission lane — one
:class:`AdmissionQueue` per shard, each draining as one device merge
into its own small plane.  A hot shard drains independently; a cold one
costs nothing.

Backpressure is two-level and all-or-nothing:

* **lane marks** — each shard lane keeps the global ``high_water``
  (pending ops per lane, as before);
* **tenant slices** — ``ShedPolicy.tenant_high_water`` bounds one
  TENANT's pending ops across all lanes, so a noisy tenant sheds alone
  while its neighbors keep writing.

A page may fan out to several shards, but shedding stays WHOLE-PAGE:
admissions serialize on one door lock, every target lane (and the
tenant slice) is checked before anything enqueues, and lane depths only
shrink concurrently (drains), so a passed pre-check cannot shed at the
lane.  Every shed and quarantine carries the tenant label — provenance
a client can check 1:1 against its own counts.
"""
from __future__ import annotations

import threading
from typing import Any, Dict, List, Optional, Tuple

from crdt_tpu_torch.ingest import wire
from crdt_tpu_torch.ingest.admission import AdmissionQueue
from crdt_tpu_torch.ingest.shed import ShedPolicy
from crdt_tpu_torch.keyspace.routing import validate_tenant
from crdt_tpu_torch.keyspace.shards import ShardedKeyspace, qualify

# lane label a tenant-quota shed is accounted under (the lane itself had
# room — the tenant's slice did the shedding)
TENANT_LANE = "tenant"

# HTTP header that names the writing tenant on /data, /ingest/page and
# /map/upd; with a keyspace tier present it routes the write through the
# tenant door, without one it still labels shed/quarantine provenance
TENANT_HEADER = "X-CRDT-Tenant"


class KeyspaceFrontDoor:
    """Admission lanes ``ks0 .. ks(S-1)`` over one ShardedKeyspace.

    ``inner`` (the host's single-plane :class:`IngestFrontDoor`) is
    optional: when present, tenant-scoped ``/map/upd`` writes ride its
    map lane with the tenant's quota slice applied here first.
    """

    def __init__(self, ks: ShardedKeyspace, *, inner=None,
                 max_batch: int = 64, flush_deadline_s: float = 0.002,
                 policy: Optional[ShedPolicy] = None, metrics=None,
                 events=None, node: str = "?"):
        self.ks = ks
        self.inner = inner
        self.policy = policy or ShedPolicy()
        self.metrics = metrics if metrics is not None \
            else ks.shards[0].metrics
        self.events = events
        self.node = str(node)
        # lane construction knobs kept: reshard cutover rebuilds the
        # lane set at the new shard count with identical wiring
        self._max_batch = max_batch
        self._flush_deadline_s = flush_deadline_s
        # one lane per shard; lane items are (ts, {qkey: value}, tenant)
        self.lanes: List[AdmissionQueue] = self._build_lanes()
        # serializes ADMISSIONS across lanes (whole-page atomicity);
        # drains never take it — they only shrink lane depths
        self._adm = threading.Lock()
        # per-tenant pending-op depth across all ks lanes (innermost
        # lock: taken by admit threads AND drain callbacks, never while
        # acquiring another lock)
        self._depth_lock = threading.Lock()
        self._tenant_depth: Dict[str, int] = {}
        # per-origin page-seq watermark, same retry-idempotence contract
        # as IngestFrontDoor.admit_page
        self._page_watermark: Dict[int, int] = {}
        self._wm_lock = threading.Lock()
        # reshard cutover gates admissions through self._adm and drains/
        # rebuilds the lanes while holding it
        ks.attach_door(self)

    def _build_lanes(self) -> List[AdmissionQueue]:
        return [
            AdmissionQueue(
                f"ks{i}", self._make_flush(i), max_batch=self._max_batch,
                flush_deadline_s=self._flush_deadline_s,
                policy=self.policy, metrics=self.metrics,
                events=self.events, node=self.node)
            for i in range(self.ks.n_shards)
        ]

    def rebuild_lanes(self) -> None:
        """Swap in a fresh lane set for the post-cutover shard count.
        CALLER HOLDS ``self._adm`` (the reshard coordinator, which also
        drained every lane first) — no admission can race the swap, and
        drains never touch ``self.lanes`` except through a claim they
        already hold.  The flush closures capture shard INDICES and read
        ``self.ks.shards[i]`` live, so the new lanes mint into the new
        planes with no further rewiring."""
        self.lanes = self._build_lanes()

    # ---- drain side ----

    def _pre_drain(
        self, items: List[Tuple[Optional[int], Dict[str, str], str]]
    ) -> Dict[str, int]:
        """Un-book the drained tenants' quota depth; returns per-tenant
        drain counts for :meth:`_post_drain`'s accounting."""
        drained: Dict[str, int] = {}
        for _, _, tenant in items:
            drained[tenant] = drained.get(tenant, 0) + 1
        with self._depth_lock:
            for tenant, n in drained.items():
                left = self._tenant_depth.get(tenant, 0) - n
                if left > 0:
                    self._tenant_depth[tenant] = left
                else:
                    self._tenant_depth.pop(tenant, None)
        return drained

    def _post_drain(self, shard: int, items: List[Any],
                    idents: List[Tuple[int, int]],
                    drained: Dict[str, int]) -> None:
        reg = self.metrics.registry
        for tenant, n in drained.items():
            reg.inc("keyspace_tenant_ops", float(n), tenant=tenant,
                    node=self.node)
        if self.events is not None and reg.enabled:
            # per-drain birth provenance: which tenants this drain
            # minted how many ops for, joined to the shard recorder's
            # op_births record by (shard, seq range).  ONE event per
            # drain — the per-op emission cost stays amortized, and
            # offline tooling (assemble/fleet) gets per-tenant
            # expected counts without a dedup table.
            self.events.emit(
                "ks_births", shard=shard, n=len(items),
                seq_first=int(idents[0][1]), seq_last=int(idents[-1][1]),
                tenants=drained)

    def _make_flush(self, shard: int):
        def flush(items: List[Tuple[Optional[int], Dict[str, str], str]]):
            drained = self._pre_drain(items)
            tss = [ts for ts, _, _ in items]
            cmds = [cmd for _, cmd, _ in items]
            idents = self.ks.shards[shard].add_commands(cmds, tss)
            if idents is None:
                return [None] * len(items)
            self._post_drain(shard, items, idents, drained)
            return idents
        return flush

    # ---- shed checks (under self._adm) ----

    def _check_and_book(self, groups: Dict[int, List[Any]],
                        tenant: str, total: int) -> None:
        """All-or-nothing admission check: every target lane AND the
        tenant's quota slice must fit the WHOLE submission, else one
        tenant-labeled shed for the whole thing.  Books the tenant depth
        on success (drains un-book)."""
        with self._depth_lock:
            tdepth = self._tenant_depth.get(tenant, 0)
        if self.policy.would_shed_tenant(tenant, tdepth, total):
            raise self.policy.shed(
                TENANT_LANE, total, tdepth, self.metrics, self.events,
                self.node, tenant=tenant,
                high_water=self.policy.tenant_mark(tenant))
        for i, items in groups.items():
            lane = self.lanes[i]
            if self.policy.would_shed(lane.depth, len(items)):
                raise self.policy.shed(
                    lane.name, total, lane.depth, self.metrics,
                    self.events, self.node, tenant=tenant)
        with self._depth_lock:
            self._tenant_depth[tenant] = \
                self._tenant_depth.get(tenant, 0) + total

    def _submit_groups(self, groups: Dict[int, List[Any]], tenant: str):
        """Route-checked enqueue; returns the per-lane tickets.  Caller
        holds nothing; the door lock scopes check+enqueue."""
        total = sum(len(v) for v in groups.values())
        with self._adm:
            self._check_and_book(groups, tenant, total)
            return [(self.lanes[i], self.lanes[i].submit_many(
                items, tenant=tenant)) for i, items in groups.items()]

    # ---- admission surfaces ----

    def admit_kv(self, tenant: str, key: str, value: str,
                 ts: Optional[int] = None, timeout: Optional[float] = 30.0):
        """One tenant-scoped write; returns the op's (rid, seq) ident or
        None when the plane is down.  Raises ShedError under overload."""
        validate_tenant(tenant)
        shard = self.ks.shard_of(tenant, key)
        item = (ts, {qualify(tenant, key): str(value)}, tenant)
        tickets = self._submit_groups({shard: [item]}, tenant)
        return tickets[0][1].wait(timeout)[0]

    def admit_cmd(self, tenant: str, cmd: Dict[str, str],
                  ts: Optional[int] = None,
                  timeout: Optional[float] = 30.0) -> List[Any]:
        """The /data route's dict form: every (key, value) pair routes to
        its shard; admission is all-or-nothing across the pairs.
        Returns one ident (or None) per pair, in dict order."""
        validate_tenant(tenant)
        order: List[Tuple[int, int]] = []  # (shard, index-in-group)
        groups: Dict[int, List[Any]] = {}
        for k, v in cmd.items():
            shard = self.ks.shard_of(tenant, k)
            group = groups.setdefault(shard, [])
            order.append((shard, len(group)))
            group.append((ts, {qualify(tenant, k): str(v)}, tenant))
        if not order:
            return []
        tickets = dict(
            (lane.name, t) for lane, t in self._submit_groups(groups, tenant))
        results = {name: t.wait(timeout) for name, t in tickets.items()}
        return [results[f"ks{shard}"][i] for shard, i in order]

    def admit_page(self, raw: bytes, tenant: str,
                   timeout: Optional[float] = 30.0) -> Dict[str, Any]:
        """Tenant-scoped op page: decode-validates-everything, dedups on
        (origin, page_seq), fans the rows out to their owning shards,
        and admits ALL-OR-NOTHING against every target lane and the
        tenant's quota slice.  Quarantines and sheds stay whole-page and
        tenant-labeled."""
        validate_tenant(tenant)
        reg = self.metrics.registry
        reg.inc("ingest_pages", node=self.node)
        try:
            page = wire.decode_page(raw)
        except wire.PageFormatError:
            reg.inc("ingest_pages_quarantined", node=self.node,
                    tenant=tenant)
            if self.events is not None:
                self.events.emit("ingest_page_quarantine",
                                 n_bytes=len(raw), tenant=tenant)
            raise
        with self._wm_lock:
            wm = self._page_watermark.get(page.origin)
            if wm is not None and page.page_seq <= wm:
                reg.inc("ingest_pages_duplicate", node=self.node)
                return {"admitted": 0, "dup": True,
                        "page_seq": page.page_seq, "shards": 0}
        groups: Dict[int, List[Any]] = {}
        for ts, cmd in page.rows():
            for k, v in cmd.items():
                shard = self.ks.shard_of(tenant, k)
                groups.setdefault(shard, []).append(
                    (ts, {qualify(tenant, k): v}, tenant))
        tickets = self._submit_groups(groups, tenant)  # ShedError whole
        with self._wm_lock:
            prev = self._page_watermark.get(page.origin)
            if prev is None or page.page_seq > prev:
                self._page_watermark[page.origin] = page.page_seq
        admitted = 0
        for _, ticket in tickets:
            admitted += sum(1 for i in ticket.wait(timeout) if i is not None)
        return {"admitted": admitted, "dup": False,
                "page_seq": page.page_seq, "shards": len(tickets)}

    def admit_map_upd(self, tenant: str, key: str, delta: int,
                      timeout: Optional[float] = 30.0):
        """Tenant-scoped /map/upd: the map lattice stays single-plane
        (host-resident, no shard tensors), but the write books against
        the tenant's quota slice and carries the tenant label through
        the shared lane's shed accounting."""
        validate_tenant(tenant)
        if self.inner is None or self.inner.map is None:
            raise RuntimeError("no map lane behind this keyspace door")
        with self._depth_lock:
            tdepth = self._tenant_depth.get(tenant, 0)
        if self.policy.would_shed_tenant(tenant, tdepth, 1):
            raise self.policy.shed(
                TENANT_LANE, 1, tdepth, self.metrics, self.events,
                self.node, tenant=tenant,
                high_water=self.policy.tenant_mark(tenant))
        with self._depth_lock:
            self._tenant_depth[tenant] = \
                self._tenant_depth.get(tenant, 0) + 1
        try:
            return self.inner.map.submit(
                (qualify(tenant, key), int(delta)),
                tenant=tenant).wait(timeout)[0]
        finally:
            with self._depth_lock:
                left = self._tenant_depth.get(tenant, 0) - 1
                if left > 0:
                    self._tenant_depth[tenant] = left
                else:
                    self._tenant_depth.pop(tenant, None)

    # ---- accounting & maintenance ----

    def tenant_depths(self) -> Dict[str, int]:
        with self._depth_lock:
            return dict(self._tenant_depth)

    def flush_all(self) -> int:
        if self.ks.mesh_active:
            return self.flush_all_fused()
        return sum(lane.flush() for lane in self.lanes)

    def flush_all_fused(self) -> int:
        """Drain EVERY shard lane through ONE mesh-plane step.

        Shard-aligned drains feed the mesh step: claim all lanes (drain
        slots, lane index ascending), mint seqs + host bookkeeping per
        shard (``add_commands_begin``, node locks index ascending —
        drain locks strictly before node locks, the same order every
        other path uses), fold all lanes in one ``MeshPlane.converge``
        step, then resolve every ticket with its idents.  Accounting
        (drains/admitted/latency, tenant ops, ks_births) is identical to
        S inline flushes — only the dispatch count changes."""
        plane = self.ks._plane()
        if plane is None:
            return sum(lane.flush() for lane in self.lanes)
        # drain slots, lane index ascending, built INCREMENTALLY so a claim
        # failing mid-sweep can fail (and release) every slot already held
        claims: List[Optional[Any]] = []
        try:
            for lane in self.lanes:
                claims.append(lane.claim())
        except BaseException as exc:
            for claim in claims:
                if claim is not None:
                    claim.fail(exc)
            raise
        if not any(c is not None for c in claims):
            return 0
        pendings: List[Any] = []
        per_shard: List[Tuple[Any, List[Any], Dict[str, int], Any]] = []
        for i, claim in enumerate(claims):
            items = [] if claim is None else claim.flat
            try:
                drained = self._pre_drain(items) if items else {}
                tss = [ts for ts, _, _ in items]
                cmds = [cmd for _, cmd, _ in items]
                idents, pending = \
                    self.ks.shards[i].add_commands_begin(cmds, tss)
            except BaseException as exc:
                # this lane's mint failed whole (e.g. out-of-window ts):
                # its tickets observe the error — exactly what an inline
                # flush does — and a zero-fresh pending rides along so
                # the fused step keeps its static lane layout
                if claim is not None:
                    claim.fail(exc)
                    claims[i] = None
                items, drained = [], {}
                idents, pending = \
                    self.ks.shards[i].add_commands_begin([], None)
            pendings.append(pending)
            per_shard.append((claims[i], items, drained, idents))
        try:
            plane.converge(pendings)  # commits (or inline-falls-back) + unlocks
        except BaseException as exc:
            # converge releases every node lock before re-raising, but the
            # drain slots are still held — fail every outstanding claim so
            # waiting tickets observe the error instead of hanging forever
            for claim, _, _, _ in per_shard:
                if claim is not None:
                    claim.fail(exc)
            raise
        total = 0
        for i, (claim, items, drained, idents) in enumerate(per_shard):
            if claim is None:
                continue
            if idents is None:  # shard down: every op in the drain 502s
                claim.resolve([None] * len(items))
            else:
                self._post_drain(i, items, idents, drained)
                claim.resolve(idents)
            total += len(items)
        return total

    def flush_expired(self) -> int:
        return sum(lane.flush_expired() for lane in self.lanes)


def keyspace_front_door_from_config(ks: ShardedKeyspace, inner=None,
                                    config=None, events=None,
                                    node: str = "?") -> KeyspaceFrontDoor:
    """Build the tenant door from ClusterConfig's ingest + keyspace
    knobs (defaults when config is None or predates them)."""
    get = (lambda k, d: getattr(config, k, d)) if config is not None \
        else (lambda k, d: d)
    policy = ShedPolicy(
        high_water=get("ingest_high_water", 4096),
        retry_after_s=get("ingest_retry_after_s", 0.05),
        tenant_high_water=get("keyspace_tenant_quota", None),
    )
    return KeyspaceFrontDoor(
        ks, inner=inner, max_batch=get("ingest_flush_ops", 64),
        flush_deadline_s=get("ingest_flush_ms", 2.0) / 1e3,
        policy=policy, metrics=None, events=events, node=node)
