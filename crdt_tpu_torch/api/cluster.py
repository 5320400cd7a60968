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
sequence.  Beside the KV nodes each replica holds its typed siblings — a
``SetNode``, a ``SeqNode`` and a ``MapNode`` — pulled from the same peer in
the same round, with their own barriers every ``set_collect_every``,
``seq_collect_every`` and ``map_reset_every`` ticks.  Each replica also
has an ingest front door (``ingests``, :mod:`crdt_tpu_torch.ingest`): the
HTTP surface (``api.http_shim``) sends every write through its admission
lanes, so a served cluster batches writes into one device merge a drain;
in-process drivers keep calling ``add_command`` / ``add_commands``.
"""
from __future__ import annotations

import random
import threading
from typing import Dict, List, Optional

from crdt_tpu_torch import default_device
from crdt_tpu_torch.api.mapnode import MapNode
from crdt_tpu_torch.api.node import (
    ReplicaNode,
    fused_pull_round,
    pull_round,
    stable_frontier_host,
)
from crdt_tpu_torch.api.seqnode import SeqNode, seq_barrier
from crdt_tpu_torch.api.setnode import SetNode, set_barrier
from crdt_tpu_torch.ingest import front_door_from_config
from crdt_tpu_torch.obs.trace import mint_trace_id
from crdt_tpu_torch.utils.clock import HostClock
from crdt_tpu_torch.utils.config import ClusterConfig
from crdt_tpu_torch.utils.metrics import Metrics


class LocalCluster:
    def __init__(self, config: Optional[ClusterConfig] = None, device=None):
        self.config = config or ClusterConfig()
        if self.config.go_compat_gossip and (
            self.config.compact_every or not self.config.delta_gossip
        ):
            raise ValueError(
                "go_compat_gossip requires delta_gossip=True and compact_every=0"
            )
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
        # the typed siblings, gossiped alongside the KV surface (cheap until
        # first used)
        rids = [self.config.rid_base + i for i in range(self.config.n_replicas)]
        self.set_nodes = [SetNode(rid=r, metrics=self.metrics, device=device) for r in rids]
        self.seq_nodes = [SeqNode(rid=r, metrics=self.metrics, device=device) for r in rids]
        self.map_nodes = [MapNode(rid=r, metrics=self.metrics, device=device) for r in rids]
        # per-replica ingest front doors: the KV lane drains into
        # add_commands, the map lane into the map sibling's upd_many
        self.ingests = [
            front_door_from_config(self.nodes[i], map_node=self.map_nodes[i],
                                   config=self.config)
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

        merged = pull_round(node, fetch, self.metrics, delta=self.config.delta_gossip,
                            peer=str(peer.rid), trace=tid)
        self._sibling_pulls(idx, self.nodes.index(peer))
        return merged

    def _gossip_once_fused(self, idx: int) -> bool:
        """One k-way fused pull round by the idx-th replica: sample k
        DISTINCT friends, fetch each one's payload against the same
        pre-round version vector, merge every response in one dispatch."""
        node = self.nodes[idx]
        pool = self._friend_pool(idx)
        chosen = self._rng.sample(pool, min(self.config.fuse_pull_k, len(pool)))
        tid = mint_trace_id(node.rid)
        since = node.version_vector() if self.config.delta_gossip else None
        fetched, live = [], []
        for peer in chosen:
            if peer is None or peer is node or not peer.alive:
                fetched.append((None if peer is None else str(peer.rid), None))
                continue
            payload = peer.gossip_payload(since=since)
            if payload is not None:
                peer.events.emit("gossip_serve", trace=tid, peer=str(node.rid),
                                 delta=since is not None)
                live.append(peer)
            fetched.append((str(peer.rid), payload))
        merged = fused_pull_round(node, fetched, self.metrics,
                                  delta=self.config.delta_gossip, trace=tid)
        for peer in live:
            self._sibling_pulls(idx, self.nodes.index(peer))
        return merged

    def _sibling_pulls(self, idx: int, peer_idx: int) -> None:
        """The typed siblings' delta pulls riding the KV round (each
        surface's freshness counted apart)."""
        for kind, nodes in (("set", self.set_nodes), ("seq", self.seq_nodes),
                            ("map", self.map_nodes)):
            mine, theirs = nodes[idx], nodes[peer_idx]
            if mine.alive and theirs.alive:
                fresh = mine.receive(theirs.gossip_payload(since=mine.version_vector()))
                self.metrics.inc(f"{kind}_gossip_rounds" if fresh else f"{kind}_gossip_noop")

    def tick(self) -> int:
        """One gossip round for every replica; returns merges performed.
        Every config.compact_every-th tick also runs a compaction barrier,
        and the siblings' barriers run at their own cadences."""
        merges = sum(self.gossip_once(idx) for idx in range(len(self.nodes)))
        self._ticks += 1
        for every, barrier in ((self.config.compact_every, self.compact),
                               (self.config.set_collect_every, self.set_collect),
                               (self.config.seq_collect_every, self.seq_collect),
                               (self.config.map_reset_every, self.map_reset)):
            if every and self._ticks % every == 0:
                barrier()
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

    def _floor_collect(self, kind: str, nodes, barrier) -> Dict[int, int]:
        """One swarm-wide set or sequence GC barrier from the 0th sibling:
        the min over every member's vv, chain-ruled; any dead member skips
        it (stability cannot be proven without it)."""
        with self._barrier_lock:
            coord = nodes[0]
            if not coord.alive:
                return {}
            floor = barrier(coord, [n.vv_snapshot() if n.alive else None for n in nodes[1:]])
            if not floor:
                self.metrics.inc(f"{kind}_collect_skipped")
                return {}
            for n in nodes:
                if n.alive:
                    n.collect(floor)
            return floor

    def set_collect(self) -> Dict[int, int]:
        """One swarm-wide set GC barrier (setnode.set_barrier)."""
        return self._floor_collect("set", self.set_nodes, set_barrier)

    def seq_collect(self) -> Dict[int, int]:
        """One swarm-wide sequence GC barrier (seqnode.seq_barrier)."""
        return self._floor_collect("seq", self.seq_nodes, seq_barrier)

    def map_reset(self) -> Dict[str, int]:
        """One swarm-wide map reset barrier.  Full-fleet rule: any dead
        member skips it; otherwise converge the map siblings into the
        coordinator, mint the reset there, adopt everywhere."""
        with self._barrier_lock:
            if not all(mn.alive for mn in self.map_nodes):
                self.metrics.inc("map_reset_skipped")
                return {}
            coord = self.map_nodes[0]
            for mn in self.map_nodes[1:]:
                coord.receive(mn.gossip_payload(since=coord.version_vector()))
            epochs = coord.mint_reset()
            if not epochs:
                return {}
            for mn in self.map_nodes[1:]:
                mn.adopt_epochs(epochs)
            self.metrics.inc("map_resets_scheduled")
            return epochs

    @staticmethod
    def _all_equal(views) -> bool:
        views = [v for v in views if v is not None]
        return all(v == views[0] for v in views[1:])

    def map_converged(self) -> bool:
        return self._all_equal([mn.items() for mn in self.map_nodes if mn.alive])

    def seq_converged(self) -> bool:
        return self._all_equal([qn.items() for qn in self.seq_nodes if qn.alive])

    def set_converged(self) -> bool:
        return self._all_equal([sn.members() for sn in self.set_nodes if sn.alive])

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
        doubles as the compaction and set/sequence GC scheduler (one
        designated scheduler, so barriers never race each other)."""
        period = self.config.gossip_period_ms / 1000.0
        rounds = 0
        while not self._stop.wait(period):
            try:
                self.gossip_once(idx)
                rounds += 1
                for every, barrier in ((self.config.compact_every, self.compact),
                                       (self.config.set_collect_every, self.set_collect),
                                       (self.config.seq_collect_every, self.seq_collect)):
                    if idx == 0 and every and rounds % every == 0:
                        barrier()
            except Exception as e:  # noqa: BLE001 — surfaced via stop()
                self.metrics.inc("gossip_loop_errors")
                with self._err_lock:
                    self.errors.append(e)
                raise
