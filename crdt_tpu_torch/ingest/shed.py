"""Backpressure for the ingest front door (own copy of
``crdt_tpu.ingest.shed``).

The admission queue is BOUNDED: a submission that would push a lane's
pending-op depth past the high-water mark is shed whole, before any of its
ops enter the queue (a half-admitted page would break the page's
all-or-nothing contract).  Shedding is explicit (the HTTP surface answers
``429 Too Many Requests`` with ``Retry-After``), deterministic (a pure
threshold on queue depth) and loud (``ingest_shed_total`` and
``ingest_shed_ops_total`` per lane, and an ``ingest_shed`` event): an op
either drains to the merge or shows in the shed accounting.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Mapping, Optional


class ShedError(Exception):
    """A submission was rejected by backpressure.  Carries the advisory
    retry delay the HTTP surface serves as Retry-After (seconds) and the
    submitter's tenant label, when it gave one."""

    def __init__(self, lane: str, n_ops: int, depth: int, high_water: int,
                 retry_after_s: float, tenant: Optional[str] = None):
        self.lane = lane
        self.n_ops = n_ops
        self.depth = depth
        self.high_water = high_water
        self.retry_after_s = retry_after_s
        self.tenant = tenant
        who = f" (tenant {tenant!r})" if tenant is not None else ""
        super().__init__(
            f"ingest lane {lane!r}{who} over high-water mark: depth {depth}"
            f" + {n_ops} ops > {high_water}; retry after {retry_after_s}s")


@dataclass(frozen=True)
class ShedPolicy:
    """Deterministic depth-threshold shed policy.

    ``high_water`` bounds PENDING OPS per lane (not submissions): a
    100-op page counts 100 toward the mark.  ``retry_after_s`` is the
    advisory client backoff: one flush deadline is enough for a drain to
    clear the queue under normal service, so the default tracks it.

    ``tenant_high_water`` carves per-tenant quota SLICES out of the
    global mark (:mod:`crdt_tpu_torch.keyspace`): a tenant listed here
    sheds on its own pending-op count before the lane fills, so one noisy
    tenant backs off alone while everyone else keeps writing.  Tenants not
    in the map share the lane mark.
    """
    high_water: int = 4096
    retry_after_s: float = 0.05
    tenant_high_water: Optional[Mapping[str, int]] = field(default=None)

    def would_shed(self, depth: int, n_ops: int) -> bool:
        """True when admitting ``n_ops`` more onto ``depth`` pending ops
        would exceed the high-water mark.  A single submission larger
        than the whole mark always sheds (it could never be admitted)."""
        return depth + n_ops > self.high_water

    def tenant_mark(self, tenant: Optional[str]) -> Optional[int]:
        """The tenant's quota slice, or None when it rides the lane mark."""
        if tenant is None or not self.tenant_high_water:
            return None
        return self.tenant_high_water.get(tenant)

    def would_shed_tenant(self, tenant: Optional[str], tenant_depth: int,
                          n_ops: int) -> bool:
        """True when the TENANT's own pending ops would exceed its quota
        slice (never for an unlisted tenant: the lane mark still applies
        through ``would_shed``)."""
        mark = self.tenant_mark(tenant)
        return mark is not None and tenant_depth + n_ops > mark

    def shed(self, lane: str, n_ops: int, depth: int, metrics, events,
             node: str, tenant: Optional[str] = None,
             high_water: Optional[int] = None) -> ShedError:
        """Account one shed (counters and the event log) and build the
        error; the caller raises it.  ``tenant`` labels the counters and
        the event; ``high_water`` overrides the recorded mark (the
        tenant's quota slice when a slice, not the lane, did the
        shedding)."""
        reg = metrics.registry
        mark = self.high_water if high_water is None else int(high_water)
        labels = dict(lane=lane, node=node)
        if tenant is not None:
            labels["tenant"] = tenant
        reg.inc("ingest_shed", **labels)
        reg.inc("ingest_shed_ops", float(n_ops), **labels)
        if events is not None:
            ev = dict(lane=lane, n_ops=int(n_ops), depth=int(depth),
                      high_water=mark)
            if tenant is not None:
                ev["tenant"] = tenant
            events.emit("ingest_shed", **ev)
        return ShedError(lane, n_ops, depth, mark, self.retry_after_s,
                         tenant=tenant)
