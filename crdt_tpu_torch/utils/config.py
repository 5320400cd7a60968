"""The cluster's and the network daemon's configuration (own copy of the
part of ``crdt_tpu.utils.config.ClusterConfig`` that the port's nodes,
cluster, workload, daemon and audit watchdog read).

Defaults reproduce the reference deployment: 5 replicas on ports
8080-8084 (its main.go:319), a friend list 8080-8089 that includes self
and five never-started ports (main.go:220-222), a 1500 ms gossip period
(main.go:229), the 62-character key alphabet and deltas in [-20, -11]
(main.go:274-276), a 300 ms bootstrap stagger (main.go:320).

``keyspace_mesh`` accepts the JAX package's three modes; "auto" and
"off" both take the keyspace's host path (on one card that is what the
JAX package's "auto" selects too), and a keyspace built with "on" raises:
the device-mesh shard plane is ROADMAP Queue 1 item 6.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

ALPHABET = "abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ1234567890"


@dataclasses.dataclass
class ClusterConfig:
    n_replicas: int = 5
    base_port: int = 8080
    friend_range: int = 10          # friends = base_port .. base_port+range-1
    gossip_period_ms: int = 1500
    write_period_ms: int = 300      # the demo workload's period
    bootstrap_stagger_ms: int = 300
    key_alphabet: str = ALPHABET
    delta_min: int = -20            # rand.Intn(10) + 2*(-10) in [-20, -11]
    delta_max: int = -11
    log_capacity: int = 1024        # per-replica op-tensor capacity (grows 2x)
    seed: int = 0
    # first writer id of this cluster: disjoint [rid_base, rid_base +
    # n_replicas) ranges keep version vectors and op identities unique
    # across clusters that gossip with each other
    rid_base: int = 0
    # the reference's gossip topology: the friend list includes self and
    # friend_range - n_replicas dead ports; False pulls from live peers only
    reference_topology: bool = False
    # pullers send their version vector and receive only the ops they miss
    # (the reference re-ships its entire log every round, main.go:159)
    delta_gossip: bool = True
    # a compaction barrier every N ticks (0 = never, the reference's
    # never-pruned log, main.go:75); not wire-compatible with a Go peer
    compact_every: int = 0
    # the typed siblings' barriers, every N ticks (0 = never): a set GC
    # floor, a sequence GC floor and a full-fleet map reset
    set_collect_every: int = 0
    seq_collect_every: int = 0
    map_reset_every: int = 0
    # full-dump gossip with the reference's bare integer-ms keys, so a Go
    # peer can pull from this fleet; needs compact_every=0 and delta_gossip
    go_compat_gossip: bool = False
    # pull min(k, peers) distinct peers a round and merge every payload in
    # one device merge (1 = the reference's one-random-peer round)
    fuse_pull_k: int = 1
    # per-peer HTTP timeout of the network agent's RemotePeer clients
    peer_timeout_s: float = 5.0
    # after a TRANSPORT failure (connection refused, socket timeout) the
    # peer is skipped, counted under net_peer_backoff_skips, for a window
    # drawn with decorrelated jitter, min(cap, U(base, 3*prev)); a peer that
    # answers any HTTP status (a served 502 included) is not backed off
    peer_backoff_base_s: float = 0.5
    peer_backoff_cap_s: float = 30.0
    # consecutive transport failures that open a peer's circuit breaker;
    # an expired window admits one half-open probe (1 = trip at once)
    peer_failure_threshold: int = 1
    # ---- the ingest front door (crdt_tpu_torch.ingest) ----
    # flush-on-size: a drain triggers when this many ops are pending
    ingest_flush_ops: int = 64
    # flush-on-deadline: a waiter drains the queue itself after this many
    # milliseconds even if the size trigger never fires
    ingest_flush_ms: float = 2.0
    # backpressure high-water mark (PENDING OPS per lane): a submission
    # that would exceed it is shed whole (429 + Retry-After)
    ingest_high_water: int = 4096
    # advisory Retry-After (seconds) served with a shed
    ingest_retry_after_s: float = 0.05

    # ---- the sharded keyspace tier (crdt_tpu_torch.keyspace) ----
    # number of hash shards (independent CRDT planes) behind the front
    # door; 0 = tier disabled, the single-plane layout above
    keyspace_shards: int = 0
    # per-SHARD op-tensor capacity (each shard grows 2x independently)
    keyspace_capacity: int = 1024
    # per-tenant quota slices for ShedPolicy.tenant_high_water: a listed
    # tenant sheds on its OWN pending-op depth before the lane fills
    keyspace_tenant_quota: Optional[Dict[str, int]] = None
    # the JAX package's device-mesh fold knob: "auto" and "off" take the
    # host path here; "on" is refused by the keyspace (Queue 1 item 6)
    keyspace_mesh: str = "auto"

    # ---- stability-frontier GC (crdt_tpu_torch.consistency.stability) ----
    # gossip rounds between stability-GC attempts on the coordinator; 0
    # disables it.  The frontier is minted from summaries that rode the
    # gossip responses' headers: no extra round trips
    stability_gc_every: int = 0
    # a member whose last summary is older than this (tracker-clock
    # seconds) stalls the frontier: GC freezes loudly instead of passing a
    # partitioned or dead peer
    stability_max_staleness_s: float = 30.0

    # acks required by linearizable reads / CAS; 0 = majority of the
    # fleet (peers + self)
    strong_quorum: int = 0
    # deadline for one strong operation (quorum round + catch-up pulls)
    strong_timeout_s: float = 5.0
    # deadline for a session read's dominance wait, and its poll cadence
    session_wait_s: float = 5.0
    session_poll_s: float = 0.02
    # ---- coordinator leases (crdt_tpu_torch.consistency.leases) ----
    # routing slots for key -> coordinator rendezvous routing; each slot
    # carries its own quorum-granted lease and fence epoch
    lease_slots: int = 8
    # lease validity window on the plane's injectable clock; holders
    # renew at half-life, voters refuse a second holder until expiry
    lease_duration_s: float = 5.0
    # max forward hops for a CAS landing on a non-coordinator before it
    # 503s loudly (forward_hops_exhausted)
    cas_forward_hops: int = 2
    # default staleness budget for level="bounded" reads: the summed
    # per-writer op lag the local vv may trail the quorum max by
    bounded_staleness_ops: int = 64
    # advisory Retry-After (seconds) served with consistency 503s
    consistency_retry_after_s: float = 0.05

    # ---- the live divergence audit (crdt_tpu_torch.obs.audit) ----
    # the AuditWatchdog's evaluators (store scrub cadence, frontier stall,
    # convergence-lag breach) run every N background gossip rounds; 0 =
    # only explicit watchdog.evaluate() calls.  Digest upkeep and peer
    # comparison ride every gossip round regardless
    audit_eval_every: int = 8

    def __post_init__(self) -> None:
        # the JAX config's checks: a bad value fails the boot with a
        # named fix, not the first write
        if int(self.keyspace_shards) < 0:
            raise ValueError(
                f"keyspace_shards={self.keyspace_shards} is negative; "
                "use 0 to disable the keyspace tier or a positive shard "
                "count")
        if self.keyspace_shards and int(self.keyspace_capacity) < 1:
            raise ValueError(
                f"keyspace_capacity={self.keyspace_capacity} must be a "
                "positive per-shard op-tensor capacity when "
                f"keyspace_shards={self.keyspace_shards} enables the tier")
        if self.keyspace_tenant_quota is not None:
            if not isinstance(self.keyspace_tenant_quota, dict):
                kind = type(self.keyspace_tenant_quota).__name__
                raise ValueError(
                    "keyspace_tenant_quota must be a {tenant: max "
                    f"pending ops}} dict, got {kind}")
            from crdt_tpu_torch.keyspace.routing import validate_tenant
            for t, q in self.keyspace_tenant_quota.items():
                validate_tenant(t)
                if not isinstance(q, int) or isinstance(q, bool) or q < 1:
                    raise ValueError(
                        f"keyspace_tenant_quota[{t!r}]={q!r} must be a "
                        "positive int (max pending ops for the tenant's "
                        "quota slice)")
        if self.keyspace_mesh not in ("auto", "on", "off"):
            raise ValueError(
                f"keyspace_mesh={self.keyspace_mesh!r} must be one of "
                "auto|on|off (auto = fuse shard merges on the device mesh "
                "when >= 2 devices are available)")
        if int(self.lease_slots) < 1:
            raise ValueError(
                f"lease_slots={self.lease_slots} must be a positive "
                "routing-slot count (every key needs a coordinator slot)")
        if float(self.lease_duration_s) <= 0:
            raise ValueError(
                f"lease_duration_s={self.lease_duration_s} must be a "
                "positive lease validity window")
        if int(self.cas_forward_hops) < 1:
            raise ValueError(
                f"cas_forward_hops={self.cas_forward_hops} must allow at "
                "least one forward hop (non-coordinators must be able to "
                "reach the leaseholder)")
        if int(self.bounded_staleness_ops) < 0:
            raise ValueError(
                f"bounded_staleness_ops={self.bounded_staleness_ops} is "
                "negative; use 0 for exact-quorum freshness or a positive "
                "op budget")
        if float(self.consistency_retry_after_s) < 0:
            raise ValueError(
                f"consistency_retry_after_s={self.consistency_retry_after_s}"
                " must be a non-negative advisory backoff")
        if int(self.audit_eval_every) < 0:
            raise ValueError(
                f"audit_eval_every={self.audit_eval_every} is negative; "
                "use 0 to leave watchdog ticks to explicit drivers or a "
                "positive gossip-round cadence")

    def ports(self) -> List[int]:
        return [self.base_port + i for i in range(self.n_replicas)]

    def friend_ports(self) -> List[int]:
        return [self.base_port + i for i in range(self.friend_range)]
