"""Micro-batching admission queue (own copy of
``crdt_tpu.ingest.admission``).

Every write surface (single-op HTTP routes and decoded op pages) lands in
a bounded per-lane queue instead of writing at once; the queue drains as
ONE flush call per drain.  For the KV lane that is one
``ReplicaNode.add_commands``, so one device merge (one ``merge_dispatches``
increment) however many ops and submitters the drain fuses.  Drains keep
submission order, so each writer stream's ops mint seqs in arrival order.

Drain triggers (both on ``ClusterConfig``):

* **flush-on-size**: a submission that brings the pending depth to
  ``max_batch`` drains inline on the submitting thread;
* **flush-on-deadline**: a waiter whose ticket is still pending after
  ``flush_deadline_s`` drains the queue itself (cooperative: no
  background thread is needed, since every HTTP handler waits on its
  ticket; hosts may call :meth:`AdmissionQueue.flush_expired`).

Backpressure is :mod:`crdt_tpu_torch.ingest.shed`: a submission that would
push the depth past the high-water mark raises
:class:`~crdt_tpu_torch.ingest.shed.ShedError` before enqueueing anything.
"""
from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from crdt_tpu_torch.ingest import wire
from crdt_tpu_torch.ingest.shed import ShedPolicy
from crdt_tpu_torch.utils.metrics import Metrics


class Ticket:
    """Hands a submitter the drain result for its ops: ``wait`` blocks
    until the drain that included them completes (flushing the queue
    itself once the deadline passes), then returns the per-op results."""

    __slots__ = ("_queue", "_event", "_result", "_error")

    def __init__(self, queue: "AdmissionQueue"):
        self._queue = queue
        self._event = threading.Event()
        self._result: Optional[List[Any]] = None
        self._error: Optional[BaseException] = None

    def _resolve(self, result: Optional[List[Any]],
                 error: Optional[BaseException]) -> None:
        self._result = result
        self._error = error
        self._event.set()

    @property
    def done(self) -> bool:
        return self._event.is_set()

    def wait(self, timeout: Optional[float] = None) -> List[Any]:
        """Block until drained; the cooperative deadline flush keeps a
        lone submitter from waiting forever on an idle queue."""
        deadline = None if timeout is None else time.monotonic() + timeout
        while not self._event.is_set():
            if not self._event.wait(self._queue.flush_deadline_s):
                # deadline passed with no size-triggered drain: drain now
                self._queue.flush()
            if deadline is not None and time.monotonic() >= deadline \
                    and not self._event.is_set():
                raise TimeoutError("admission ticket timed out")
        if self._error is not None:
            raise self._error
        assert self._result is not None
        return self._result


class DrainClaim:
    """One claimed (popped but not yet drained) lane batch.

    Produced by :meth:`AdmissionQueue.claim` with the lane's drain slot
    HELD — it stays held until :meth:`resolve` / :meth:`fail`, so late
    submissions queue behind this drain exactly as they do behind an
    inline :meth:`AdmissionQueue.flush`.  The resolve path carries the
    drain accounting (drains/admitted/batch-size/latency counters and
    per-group ticket slicing) that used to live inside flush()."""

    __slots__ = ("queue", "batch", "flat", "t0", "done")

    def __init__(self, queue: "AdmissionQueue",
                 batch: List[Tuple[List[Any], Ticket, float, Optional[str]]]):
        self.queue = queue
        self.batch = batch
        flat: List[Any] = []
        for items, _, _, _ in batch:
            flat.extend(items)
        self.flat = flat
        self.t0 = time.monotonic()
        self.done = False

    def fail(self, exc: BaseException) -> int:
        """The drain errored before results existed: every ticket in the
        batch observes the error (same all-or-nothing the inline flush
        has) and the drain slot is released."""
        q = self.queue
        try:
            q.metrics.registry.inc(
                "ingest_drain_errors", lane=q.name, node=q.node)
            if q.events is not None:
                q.events.emit("ingest_drain_error", lane=q.name,
                              n_ops=len(self.flat), error=repr(exc))
            for _, ticket, _, _ in self.batch:
                ticket._resolve(None, exc)
        finally:
            self.done = True
            q._drain_lock.release()
        return len(self.flat)

    def resolve(self, results: Optional[List[Any]]) -> int:
        """Account the completed drain and hand each group its result
        slice; releases the drain slot."""
        q = self.queue
        flat = self.flat
        try:
            t1 = time.monotonic()
            if results is None:
                results = [None] * len(flat)
            assert len(results) == len(flat), (
                f"lane {q.name!r} flush_fn returned {len(results)} "
                f"results for {len(flat)} items")
            reg = q.metrics.registry
            reg.inc("ingest_drains", lane=q.name, node=q.node)
            reg.inc("ingest_ops_admitted", float(len(flat)),
                    lane=q.name, node=q.node)
            reg.observe("ingest_batch_size", float(len(flat)),
                        lane=q.name, node=q.node)
            # admit latency = enqueue -> drain completion, per group
            for _, _, t_enq, tenant in self.batch:
                reg.observe("ingest_admit_latency", t1 - t_enq,
                            lane=q.name, node=q.node)
                if tenant is not None:
                    # a separate per-tenant series, so the {lane,node}
                    # one keeps its label set
                    reg.observe("ks_admit_latency", t1 - t_enq,
                                tenant=tenant, node=q.node)
            reg.observe("ingest_drain_seconds", t1 - self.t0,
                        lane=q.name, node=q.node)
            off = 0
            for items, ticket, _, _ in self.batch:
                ticket._resolve(results[off:off + len(items)], None)
                off += len(items)
        finally:
            self.done = True
            q._drain_lock.release()
        return len(flat)


class AdmissionQueue:
    """One bounded micro-batch lane.

    ``flush_fn(items)`` performs the drain: it receives every pending
    item in submission order and returns one result per item.  The KV
    lane's flush_fn is the node's batched write path (one device merge);
    the map and composite lanes batch under one lock acquisition (their
    per-op writes index the planes in place, with no merge to fuse, but
    the shared queue
    gives every surface the same backpressure and accounting).
    """

    def __init__(self, name: str, flush_fn: Callable[[List[Any]], List[Any]],
                 *, max_batch: int = 64, flush_deadline_s: float = 0.002,
                 policy: Optional[ShedPolicy] = None,
                 metrics: Optional[Metrics] = None,
                 events=None, node: str = "?"):
        self.name = name
        self.flush_fn = flush_fn
        self.max_batch = max(1, int(max_batch))
        self.flush_deadline_s = max(1e-4, float(flush_deadline_s))
        self.policy = policy or ShedPolicy()
        self.metrics = metrics or Metrics()
        self.events = events
        self.node = str(node)
        self._lock = threading.Lock()          # queue state
        self._drain_lock = threading.Lock()    # serializes flush_fn calls
        # (items, ticket, enqueue time, tenant-or-None) per group
        self._pending: List[Tuple[List[Any], Ticket, float,
                                  Optional[str]]] = []
        self._depth = 0
        self._oldest: Optional[float] = None

    # ---- submission side ----

    @property
    def depth(self) -> int:
        """Pending (undrained) op count — the ingest_queue_depth gauge.
        Read under the queue lock: writers are submitter/drain threads
        and a torn read here feeds the shed policy and the gauge."""
        with self._lock:
            return self._depth

    def submit_many(self, items: Sequence[Any],
                    tenant: Optional[str] = None) -> Ticket:
        """Enqueue a group of ops atomically (one page = one group =
        all-or-nothing vs the shed policy); returns the group's ticket.
        ``tenant`` is provenance only: it labels the shed counters and
        event."""
        items = list(items)
        if not items:
            t = Ticket(self)
            t._resolve([], None)
            return t
        now = time.monotonic()
        with self._lock:
            if self.policy.would_shed(self._depth, len(items)):
                raise self.policy.shed(self.name, len(items), self._depth,
                                       self.metrics, self.events, self.node,
                                       tenant=tenant)
            ticket = Ticket(self)
            self._pending.append((items, ticket, now, tenant))
            self._depth += len(items)
            if self._oldest is None:
                self._oldest = now
            drain_now = self._depth >= self.max_batch
            self.metrics.registry.set_gauge(
                "ingest_queue_depth", float(self._depth),
                lane=self.name, node=self.node)
        if drain_now:
            self.flush()
        return ticket

    def submit(self, item: Any, tenant: Optional[str] = None) -> Ticket:
        return self.submit_many([item], tenant=tenant)

    # ---- drain side ----

    def claim(self) -> Optional["DrainClaim"]:
        """Pop everything pending WITHOUT running flush_fn, holding this
        lane's drain slot until the claim resolves or fails (the same
        accounting and ticket semantics as :meth:`flush`).  Returns None
        (nothing pending, slot released) or a claim the caller MUST
        resolve or fail."""
        self._drain_lock.acquire()
        try:
            with self._lock:
                batch = self._pending
                if not batch:
                    self._drain_lock.release()
                    return None
                self._pending = []
                self._depth = 0
                self._oldest = None
                self.metrics.registry.set_gauge(
                    "ingest_queue_depth", 0.0,
                    lane=self.name, node=self.node)
            return DrainClaim(self, batch)
        except BaseException:
            # gauge plumbing or claim construction failed: the drain slot
            # must not leak (a leaked slot deadlocks every future drain
            # of this lane)
            self._drain_lock.release()
            raise

    def flush(self) -> int:
        """Drain everything pending in ONE flush_fn call; returns the op
        count drained.  Concurrent callers serialize; late arrivals land
        in the next drain."""
        claim = self.claim()
        if claim is None:
            return 0
        try:
            results = self.flush_fn(claim.flat)
        except BaseException as exc:
            return claim.fail(exc)
        return claim.resolve(results)

    def flush_expired(self, now: Optional[float] = None) -> int:
        """Drain only if the oldest pending group has been waiting past
        the flush deadline (host-loop hook; waiters self-flush anyway)."""
        now = time.monotonic() if now is None else now
        with self._lock:
            expired = (self._oldest is not None
                       and now - self._oldest >= self.flush_deadline_s)
        return self.flush() if expired else 0


class IngestFrontDoor:
    """Per-node bundle of admission lanes plus the page door.

    One front door serves one node's write surfaces: the KV lane feeds
    ``ReplicaNode.add_commands`` (one device merge per drain), the map
    and composite lanes ``MapNode.upd_many`` and
    ``CompositeNode.upd_many``.  Page admission (decode → dedup → KV lane)
    lives here so the HTTP shim stays a thin router.
    """

    def __init__(self, node, map_node=None, composite_node=None, *,
                 max_batch: int = 64, flush_deadline_s: float = 0.002,
                 high_water: int = 4096, retry_after_s: float = 0.05,
                 events=None):
        self.node = node
        self.map_node = map_node
        self.composite_node = composite_node
        self.events = events if events is not None \
            else getattr(node, "events", None)
        policy = ShedPolicy(high_water=high_water,
                            retry_after_s=retry_after_s)
        label = str(getattr(node, "rid", "?"))
        common = dict(max_batch=max_batch, flush_deadline_s=flush_deadline_s,
                      policy=policy, metrics=node.metrics,
                      events=self.events, node=label)
        self.kv = AdmissionQueue("kv", self._flush_kv, **common)
        self.map = AdmissionQueue("map", self._flush_map, **common) \
            if map_node is not None else None
        self.composite = AdmissionQueue(
            "composite", self._flush_composite, **common) \
            if composite_node is not None else None
        # per-origin page-seq watermark: retried pages (shed or timed out
        # client side AFTER admission) are duplicate-dropped, not
        # double-applied.  Only ADMITTED pages advance it, so a shed page
        # retries cleanly under the same page_seq.
        self._page_watermark: Dict[int, int] = {}
        self._wm_lock = threading.Lock()

    # ---- lane flush functions (one call per drain) ----

    def _flush_kv(self, items: List[Tuple[Optional[int], Dict[str, str]]]):
        tss = [ts for ts, _ in items]
        cmds = [cmd for _, cmd in items]
        idents = self.node.add_commands(cmds, tss)
        if idents is None:  # node down: every op in the drain 502s
            return [None] * len(items)
        return idents

    def _flush_map(self, items: List[Tuple[str, int]]):
        return self.map_node.upd_many(items)

    def _flush_composite(self, items: List[Tuple[str, int]]):
        return self.composite_node.upd_many(items)

    # ---- admission surfaces ----

    def admit_kv(self, cmd: Dict[str, str], ts: Optional[int] = None,
                 timeout: Optional[float] = 30.0,
                 tenant: Optional[str] = None):
        """Single-op /data route: returns the op's (rid, seq) ident, or
        None when the node is down.  Raises ShedError under overload
        (tenant-labeled when the caller supplied provenance)."""
        return self.kv.submit((ts, dict(cmd)), tenant=tenant).wait(timeout)[0]

    def admit_map_upd(self, key: str, delta: int,
                      timeout: Optional[float] = 30.0):
        if self.map is None:
            raise RuntimeError("no map lane on this front door")
        return self.map.submit((str(key), int(delta))).wait(timeout)[0]

    def admit_composite_upd(self, key: str, delta: int,
                            timeout: Optional[float] = 30.0):
        if self.composite is None:
            raise RuntimeError("no composite lane on this front door")
        return self.composite.submit((str(key), int(delta))).wait(timeout)[0]

    def admit_page(self, raw: bytes, timeout: Optional[float] = 30.0,
                   tenant: Optional[str] = None) -> Dict[str, Any]:
        """POST /ingest/page: decode + validate (PageFormatError on ANY
        defect — the caller 400s and the page is quarantined whole),
        dedup on (origin, page_seq), then submit every op to the KV lane
        as one group.  Returns {"admitted", "dup", "page_seq"}.
        ``tenant`` (the X-CRDT-Tenant header) labels the quarantine/shed
        provenance — who sent the bad/oversized page, not just how big
        it was."""
        reg = self.node.metrics.registry
        label = self.kv.node
        reg.inc("ingest_pages", node=label)
        try:
            page = wire.decode_page(raw)
        except wire.PageFormatError:
            qlabels = dict(node=label)
            if tenant is not None:
                qlabels["tenant"] = tenant
            reg.inc("ingest_pages_quarantined", **qlabels)
            if self.events is not None:
                ev = dict(n_bytes=len(raw))
                if tenant is not None:
                    ev["tenant"] = tenant
                self.events.emit("ingest_page_quarantine", **ev)
            raise
        with self._wm_lock:
            wm = self._page_watermark.get(page.origin)
            if wm is not None and page.page_seq <= wm:
                reg.inc("ingest_pages_duplicate", node=label)
                return {"admitted": 0, "dup": True,
                        "page_seq": page.page_seq}
        # ShedError propagates (tenant-labeled when provenance is known)
        ticket = self.kv.submit_many(page.rows(), tenant=tenant)
        with self._wm_lock:
            prev = self._page_watermark.get(page.origin)
            if prev is None or page.page_seq > prev:
                self._page_watermark[page.origin] = page.page_seq
        idents = ticket.wait(timeout)
        admitted = sum(1 for i in idents if i is not None)
        return {"admitted": admitted, "dup": False,
                "page_seq": page.page_seq}

    # ---- maintenance ----

    @property
    def lanes(self) -> List[AdmissionQueue]:
        return [q for q in (self.kv, self.map, self.composite)
                if q is not None]

    def flush_all(self) -> int:
        return sum(q.flush() for q in self.lanes)

    def flush_expired(self) -> int:
        return sum(q.flush_expired() for q in self.lanes)


def front_door_from_config(node, map_node=None, composite_node=None,
                           config=None, events=None) -> IngestFrontDoor:
    """Build a front door from ClusterConfig's ingest knobs (defaults
    when config is None or predates them)."""
    get = (lambda k, d: getattr(config, k, d)) if config is not None \
        else (lambda k, d: d)
    return IngestFrontDoor(
        node, map_node=map_node, composite_node=composite_node,
        max_batch=get("ingest_flush_ops", 64),
        flush_deadline_s=get("ingest_flush_ms", 2.0) / 1e3,
        high_water=get("ingest_high_water", 4096),
        retry_after_s=get("ingest_retry_after_s", 0.05),
        events=events,
    )
