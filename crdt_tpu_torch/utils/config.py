"""The in-process cluster's configuration (own copy of the part of
``crdt_tpu.utils.config.ClusterConfig`` that the port's nodes, cluster and
workload read).

Defaults reproduce the reference deployment: 5 replicas on ports
8080-8084 (its main.go:319), a friend list 8080-8089 that includes self
and five never-started ports (main.go:220-222), a 1500 ms gossip period
(main.go:229), the 62-character key alphabet and deltas in [-20, -11]
(main.go:274-276).
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

    def friend_ports(self) -> List[int]:
        return [self.base_port + i for i in range(self.friend_range)]
