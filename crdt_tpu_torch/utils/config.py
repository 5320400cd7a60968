"""The cluster's and the network daemon's configuration (own copy of the
part of ``crdt_tpu.utils.config.ClusterConfig`` that the port's nodes,
cluster, workload, daemon and audit watchdog read).

Defaults reproduce the reference deployment: 5 replicas on ports
8080-8084 (its main.go:319), a friend list 8080-8089 that includes self
and five never-started ports (main.go:220-222), a 1500 ms gossip period
(main.go:229), the 62-character key alphabet and deltas in [-20, -11]
(main.go:274-276), a 300 ms bootstrap stagger (main.go:320).

The JAX package's keyspace, lease and consistency knobs are not carried:
their tier is not ported (ROADMAP Queue 1 item 3).  ``keyspace_shards``
is, accepted at 0 only by the daemon, so a config that asks for shards
fails the boot with the item named rather than run without them.
"""
from __future__ import annotations

import dataclasses
from typing import List

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

    # ---- the sharded keyspace tier: not ported (ROADMAP Queue 1 item 3) ----
    # 0 = the single-plane layout; the daemon refuses anything above 0
    keyspace_shards: int = 0

    # ---- stability-frontier GC (crdt_tpu_torch.consistency.stability) ----
    # gossip rounds between stability-GC attempts on the coordinator; 0
    # disables it.  The frontier is minted from summaries that rode the
    # gossip responses' headers: no extra round trips
    stability_gc_every: int = 0
    # a member whose last summary is older than this (tracker-clock
    # seconds) stalls the frontier: GC freezes loudly instead of passing a
    # partitioned or dead peer
    stability_max_staleness_s: float = 30.0

    # ---- the live divergence audit (crdt_tpu_torch.obs.audit) ----
    # the AuditWatchdog's evaluators (store scrub cadence, frontier stall,
    # convergence-lag breach) run every N background gossip rounds; 0 =
    # only explicit watchdog.evaluate() calls.  Digest upkeep and peer
    # comparison ride every gossip round regardless
    audit_eval_every: int = 8

    def __post_init__(self) -> None:
        # the JAX config's checks for the fields carried here: a bad value
        # fails the boot with a named fix
        if int(self.keyspace_shards) < 0:
            raise ValueError(
                f"keyspace_shards={self.keyspace_shards} is negative; "
                "use 0 to disable the keyspace tier or a positive shard "
                "count")
        if int(self.audit_eval_every) < 0:
            raise ValueError(
                f"audit_eval_every={self.audit_eval_every} is negative; "
                "use 0 to leave watchdog ticks to explicit drivers or a "
                "positive gossip-round cadence")

    def ports(self) -> List[int]:
        return [self.base_port + i for i in range(self.n_replicas)]

    def friend_ports(self) -> List[int]:
        return [self.base_port + i for i in range(self.friend_range)]
