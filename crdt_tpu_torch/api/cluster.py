"""LocalCluster: N in-process replicas and the anti-entropy scheduler
(counterpart of ``crdt_tpu.api.cluster``), the answer to the reference's
bootstrap (its main.go:217-271, 316-327), with every replica's log on the
one CUDA card.

Two ways to run the gossip:

* ``tick()``: deterministic manual rounds (tests, the chip smoke);
* ``start()/stop()``: background threads pulling a random friend every
  gossip_period_ms, the reference's live topology (optionally including
  its self-and-dead-ports friend list).

Peers are drawn from ``random.Random(config.seed)`` in the JAX package's
sequence.  The JAX cluster's sibling set, sequence and map nodes and its
ingest front doors are not ported: a non-zero ``set_collect_every``,
``seq_collect_every`` or ``map_reset_every`` is refused.
"""
from __future__ import annotations

import random
import threading
from typing import Dict, List, Optional

from crdt_tpu_torch import default_device
from crdt_tpu_torch.api.node import (
    ReplicaNode,
    fused_pull_round,
    pull_round,
    stable_frontier_host,
)
from crdt_tpu_torch.obs.trace import mint_trace_id
from crdt_tpu_torch.utils.clock import HostClock
from crdt_tpu_torch.utils.config import ClusterConfig
from crdt_tpu_torch.utils.metrics import Metrics

_SIBLING_KNOBS = ("set_collect_every", "seq_collect_every", "map_reset_every")


class LocalCluster:
    def __init__(self, config: Optional[ClusterConfig] = None, device=None):
        self.config = config or ClusterConfig()
        if self.config.go_compat_gossip and (
            self.config.compact_every or not self.config.delta_gossip
        ):
            raise ValueError(
                "go_compat_gossip requires delta_gossip=True and compact_every=0"
            )
        asked = [k for k in _SIBLING_KNOBS if getattr(self.config, k)]
        if asked:
            raise ValueError(
                f"{', '.join(asked)}: the sibling set, sequence and map nodes are "
                "not ported; leave these barriers at 0")
        device = default_device(device)
        self.metrics = Metrics()
        clock = HostClock()
        self.nodes: List[ReplicaNode] = [
            ReplicaNode(
                rid=self.config.rid_base + i,
                capacity=self.config.log_capacity,
                clock=clock,
                metrics=self.metrics,
                go_compat_gossip=self.config.go_compat_gossip,
                device=device,
            )
            for i in range(self.config.n_replicas)
        ]
        self._rng = random.Random(self.config.seed)
        self._ticks = 0
        self._threads: List[threading.Thread] = []
        self._stop = threading.Event()
        # serializes compaction barriers: two racing barriers could compute
        # frontiers over different alive sets (incomparable, off the chain)
        self._barrier_lock = threading.Lock()
        # background-gossip failures, re-raised by stop(): a dead loop is
        # always surfaced (the reference's gossip goroutine died silently)
        self._err_lock = threading.Lock()
        self.errors: List[Exception] = []

    # ---- addressing (the reference's topology: ports) ----

    def node_by_port(self, port: int) -> Optional[ReplicaNode]:
        idx = port - self.config.base_port
        if 0 <= idx < len(self.nodes):
            return self.nodes[idx]
        return None  # a never-started friend port

    def _friend_pool(self, idx: int) -> List[Optional[ReplicaNode]]:
        if self.config.reference_topology:
            # self + all friend ports, live or not (main.go:220-222)
            return [self.node_by_port(p) for p in self.config.friend_ports()]
        return [n for n in self.nodes if n is not self.nodes[idx]]

    # ---- deterministic gossip rounds ----

    def gossip_once(self, idx: int) -> bool:
        """One pull by the idx-th replica from a random friend; True if a
        merge happened (dead/missing peers are skipped, main.go:235-239).
        With ``config.fuse_pull_k > 1`` the round pulls k distinct friends
        and merges every payload in ONE device merge."""
        node = self.nodes[idx]
        if min(self.config.fuse_pull_k, len(self._friend_pool(idx))) > 1:
            return self._gossip_once_fused(idx)
        peer = self._rng.choice(self._friend_pool(idx))
        if peer is None or peer is node or not peer.alive:
            self.metrics.inc("gossip_skipped")
            return False
        tid = mint_trace_id(node.rid)

        def fetch(since):
            payload = peer.gossip_payload(since=since)
            if payload is not None:
                # the in-process serve side of the round: the same trace ID
                # on both event logs
                peer.events.emit("gossip_serve", trace=tid, peer=str(node.rid),
                                 delta=since is not None)
            return payload

        return pull_round(node, fetch, self.metrics, delta=self.config.delta_gossip,
                          peer=str(peer.rid), trace=tid)

    def _gossip_once_fused(self, idx: int) -> bool:
        """One k-way fused pull round by the idx-th replica: sample k
        DISTINCT friends, fetch each one's payload against the same
        pre-round version vector, merge every response in one dispatch."""
        node = self.nodes[idx]
        pool = self._friend_pool(idx)
        chosen = self._rng.sample(pool, min(self.config.fuse_pull_k, len(pool)))
        tid = mint_trace_id(node.rid)
        since = node.version_vector() if self.config.delta_gossip else None
        fetched = []
        for peer in chosen:
            if peer is None or peer is node or not peer.alive:
                fetched.append((None if peer is None else str(peer.rid), None))
                continue
            payload = peer.gossip_payload(since=since)
            if payload is not None:
                peer.events.emit("gossip_serve", trace=tid, peer=str(node.rid),
                                 delta=since is not None)
            fetched.append((str(peer.rid), payload))
        return fused_pull_round(node, fetched, self.metrics,
                                delta=self.config.delta_gossip, trace=tid)

    def tick(self) -> int:
        """One gossip round for every replica; returns merges performed.
        Every config.compact_every-th tick also runs a compaction barrier."""
        merges = sum(self.gossip_once(idx) for idx in range(len(self.nodes)))
        self._ticks += 1
        every = self.config.compact_every
        if every and self._ticks % every == 0:
            self.compact()
        return merges

    def compact(self) -> Dict[int, int]:
        """One swarm-wide compaction barrier: fold everything every alive
        node already holds (the elementwise min of the alive nodes' version
        vectors).

        Chain rule: the new barrier must dominate EVERY node's existing
        frontier, dead nodes included: a dead node's fold has to stay on the
        chain for its revival merge to be lossless.  If the alive set lacks
        ops some dead node already folded, the barrier is SKIPPED (returns
        {}) until that node revives and gossip spreads its fold."""
        with self._barrier_lock:
            alive = [n for n in self.nodes if n.alive]
            if not alive:
                return {}
            frontier = stable_frontier_host([n.version_vector() for n in alive],
                                            [n.frontier for n in self.nodes])
            if not frontier:
                self.metrics.inc("compact_skipped")
                return {}
            for n in alive:
                n.compact(frontier)
            return frontier

    def converged(self) -> bool:
        states = [n.get_state() for n in self.nodes if n.alive]
        return all(s == states[0] for s in states[1:]) if states else True

    def states(self) -> List[Optional[Dict[str, str]]]:
        return [n.get_state() for n in self.nodes]

    # ---- background scheduler (the reference's live mode) ----

    def start(self) -> None:
        self._stop.clear()
        for idx in range(len(self.nodes)):
            t = threading.Thread(target=self._loop, args=(idx,), daemon=True)
            t.start()
            self._threads.append(t)

    def stop(self) -> None:
        self._stop.set()
        for t in self._threads:
            t.join(timeout=5)
        self._threads.clear()
        with self._err_lock:
            n_dead = len(self.errors)
            first = self.errors[0] if self.errors else None
        if first is not None:
            raise RuntimeError(f"{n_dead} background gossip loop(s) died") from first

    def _loop(self, idx: int) -> None:
        """Background pull loop for one replica.  The 0th replica's loop
        doubles as the compaction scheduler (one designated scheduler, so
        barriers never race each other)."""
        period = self.config.gossip_period_ms / 1000.0
        rounds = 0
        while not self._stop.wait(period):
            try:
                self.gossip_once(idx)
                rounds += 1
                every = self.config.compact_every
                if idx == 0 and every and rounds % every == 0:
                    self.compact()
            except Exception as e:  # noqa: BLE001 — surfaced via stop()
                self.metrics.inc("gossip_loop_errors")
                with self._err_lock:
                    self.errors.append(e)
                raise
