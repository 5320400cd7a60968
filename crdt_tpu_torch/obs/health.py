"""Replication-health gauges (own copy of the parts of
``crdt_tpu.obs.health`` the port's nodes, front doors and ``/metrics``
use).

Set on the pull path:

* ``peer_ops_behind{peer=}`` / ``convergence_lag_ops``: in delta mode a
  pull's payload size IS how many ops this node was behind that peer; its
  EWMA estimates the standing convergence lag;
* ``last_merge_unixtime``: stamped on every fresh merge;
* ``pull_round_peers_fused`` / ``pull_fused_fanout``: peers merged in one
  device dispatch by a k-way fused pull round.

Sampled at scrape time (``render_node_metrics``, the ``GET /metrics``
body), so the gauges are always fresh and an idle node pays nothing: the
KV node's population and frontier (``vv_ops_known``,
``frontier_folded_ops``, ``oplog_capacity``, ``commands_retained``,
``summary_keys``, ``node_alive``, ``seconds_since_last_merge``), the
siblings' GC debt, the ingest lanes' depth and mark, the union-engine
tallies, and on a network daemon the agent's peer circuits, the stability
tracker's frontier and lag, the sharded keyspace's shards, lanes, tenants
and reshard state, the coordinator leases' slots, and the audit
watchdog's state.
"""
from __future__ import annotations

import time

# EWMA weight of the newest pull-round lag observation (~last 5 rounds)
LAG_ALPHA = 0.2

# net_peer_circuit_state gauge values, by the breaker's state name
CIRCUIT_STATE_VALUE = {"closed": 0, "half_open": 1, "open": 2}


def observe_pull_lag(registry, node_label: str, peer: str, ops_behind: int) -> None:
    """Record one pull round's lag observation."""
    registry.set_gauge("peer_ops_behind", ops_behind, node=node_label, peer=peer)
    prev = registry.gauge_value("convergence_lag_ops", node=node_label)
    ewma = (ops_behind if prev is None
            else (1 - LAG_ALPHA) * prev + LAG_ALPHA * ops_behind)
    registry.set_gauge("convergence_lag_ops", round(ewma, 3), node=node_label)


def mark_merge(registry, node_label: str) -> None:
    """Stamp a fresh merge."""
    registry.set_gauge("last_merge_unixtime", time.time(), node=node_label)


def observe_fused_pull(registry, node_label: str, n_peers: int) -> None:
    """Record one k-way fused pull round: peers merged in a single device
    dispatch, and the latest round's width."""
    registry.inc("pull_round_peers_fused", n_peers, node=node_label)
    registry.set_gauge("pull_fused_fanout", n_peers, node=node_label)


def observe_pipeline(registry, pipeline: str, occupancy: float,
                     stripes: int, stage_s: float, wait_s: float) -> None:
    """Record one double-buffered stripe-pipeline run
    (``crdt_tpu_torch.parallel.pipeline.run_striped``):
    ``pipeline_occupancy`` is the share of the dispatch-to-block window the
    host spent staging the next stripe instead of waiting on the device
    (0.0 = serial), plus the raw stage/wait second counters it comes
    from."""
    registry.set_gauge("pipeline_occupancy", round(occupancy, 4),
                       pipeline=pipeline)
    registry.inc("pipeline_stripes", stripes, pipeline=pipeline)
    registry.inc("pipeline_stage_seconds", round(stage_s, 6),
                 pipeline=pipeline)
    registry.inc("pipeline_wait_seconds", round(wait_s, 6),
                 pipeline=pipeline)


def sample_kv_node(registry, node) -> None:
    """KV replica population and frontier gauges."""
    lab = str(node.rid)
    vv, frontier = node.vv_snapshot()
    registry.set_gauge("vv_ops_known", sum(s + 1 for s in vv.values()), node=lab)
    registry.set_gauge("frontier_folded_ops", sum(s + 1 for s in frontier.values()), node=lab)
    registry.set_gauge("oplog_capacity", node.log.capacity, node=lab)
    registry.set_gauge("commands_retained", len(node._commands), node=lab)
    registry.set_gauge("summary_keys", len(node._summary), node=lab)
    registry.set_gauge("node_alive", int(node.alive), node=lab)
    # ring evictions so far (the counter events_dropped is inc'd at
    # eviction time)
    registry.set_gauge("events_ring_dropped", node.events.dropped, node=lab)
    last = registry.gauge_value("last_merge_unixtime", node=lab)
    if last is not None:
        registry.set_gauge("seconds_since_last_merge", round(time.time() - last, 3), node=lab)


def sample_set_node(registry, sn) -> None:
    lab = str(sn.rid)
    registry.set_gauge("set_ops_retained", len(sn._ops), node=lab)
    registry.set_gauge("set_tombstones", len(sn._tombstoned), node=lab)
    registry.set_gauge("set_floor_folded_ops", sum(s + 1 for s in sn._floor.values()), node=lab)


def sample_seq_node(registry, qn) -> None:
    lab = str(qn.rid)
    registry.set_gauge("seq_ops_retained", len(qn._ops), node=lab)
    registry.set_gauge("seq_tombstones", len(qn._tombstoned), node=lab)
    registry.set_gauge("seq_floor_folded_ops", sum(s + 1 for s in qn._floor.values()), node=lab)


def sample_map_node(registry, mn) -> None:
    registry.set_gauge("map_records", mn.n_records(), node=str(mn.rid))


def sample_composite_node(registry, cn) -> None:
    lab = str(cn.rid)
    items = cn.items()
    registry.set_gauge("composite_keys", 0 if items is None else len(items), node=lab)
    # interned keys may exceed live keys (removed entries keep history):
    # the gap is the composite's tombstone pressure
    registry.set_gauge("composite_keys_interned", len(cn.keys), node=lab)
    registry.set_gauge("composite_writers", len(cn._writers), node=lab)


def sample_ingest(registry, front_door) -> None:
    """Ingest front-door gauges: each lane's pending-op depth and the
    high-water mark it sheds against.  The shed and admit counters and the
    batch-size and admit-latency histograms are recorded at drain time by
    the lane itself."""
    for lane in front_door.lanes:
        registry.set_gauge("ingest_queue_depth", float(lane.depth), lane=lane.name, node=lane.node)
        registry.set_gauge("ingest_high_water", float(lane.policy.high_water),
                           lane=lane.name, node=lane.node)


def sample_keyspace(registry, node_label: str, keyspace,
                    ks_door=None) -> None:
    """Sharded-keyspace gauges (crdt_tpu_torch.keyspace), scrape-fresh:
    per-shard ``keyspace_shard_ops`` (live op-log rows) and
    ``keyspace_shard_keys`` (live keys) show routing balance and where
    the log debt sits; per-shard ``keyspace_shard_depth`` (pending ops
    in the shard's admission lane) shows which shard is hot RIGHT NOW;
    per-tenant ``keyspace_tenant_depth`` shows who is filling it.  The
    companion ``crdt_keyspace_tenant_ops_total`` counter (ops admitted
    per tenant) is inc'd at drain time by the keyspace door.
    ``ks_reshard_state``/``ks_reshard_epoch`` track the online-reshard
    lifecycle (keyspace/reshard.py)."""
    # reshard lifecycle: phase gauge (0 idle / 1 migrate, the mapping in
    # reshard.PHASE_GAUGE) plus the monotone epoch every wire surface is
    # fenced on — renders as crdt_ks_reshard_state / crdt_ks_reshard_epoch
    registry.set_gauge("ks_reshard_state",
                       float(keyspace.reshard.phase_gauge()),
                       node=node_label)
    registry.set_gauge("ks_reshard_epoch", float(keyspace.epoch),
                       node=node_label)
    for i, stat in enumerate(keyspace.shard_stats()):
        registry.set_gauge("keyspace_shard_ops", float(stat["ops"]),
                           shard=str(i), node=node_label)
        registry.set_gauge("keyspace_shard_keys", float(stat["keys"]),
                           shard=str(i), node=node_label)
    if ks_door is not None:
        for i, lane in enumerate(ks_door.lanes):
            registry.set_gauge("keyspace_shard_depth", float(lane.depth),
                               shard=str(i), node=node_label)
        for tenant, depth in ks_door.tenant_depths().items():
            registry.set_gauge("keyspace_tenant_depth", float(depth),
                               tenant=tenant, node=node_label)
        # quota slices, so the fleet rollup (obs/fleet) can report shed
        # ratio AGAINST the mark that did the shedding
        quotas = getattr(ks_door.policy, "tenant_high_water", None) or {}
        for tenant, mark in quotas.items():
            registry.set_gauge("keyspace_tenant_quota", float(mark),
                               tenant=tenant, node=node_label)


def sample_peer_circuits(registry, node_label: str, peers) -> None:
    """Partition-state gauges from the agent's RemotePeer circuit
    breakers: each peer's breaker state (0 closed / 1 half-open / 2
    open), the consecutive transport failures behind it, and the rollup
    ``net_peers_unreachable`` over ``net_peers_total``."""
    peers = list(peers)
    unreachable = 0
    for p in peers:
        state = p.circuit_state()
        registry.set_gauge("net_peer_circuit_state", CIRCUIT_STATE_VALUE.get(state, 2),
                           node=node_label, peer=p.url)
        registry.set_gauge("net_peer_failures", p.failure_count(), node=node_label, peer=p.url)
        if state != "closed":
            unreachable += 1
    registry.set_gauge("net_peers_unreachable", unreachable, node=node_label)
    registry.set_gauge("net_peers_total", len(peers), node=node_label)


def sample_stability(registry, node_label: str, tracker) -> None:
    """Stability-frontier gauges: ops under the last minted fleet
    frontier, the local vv's ops above it (the GC debt; it grows while GC
    is stalled), and the members blocking a mint."""
    registry.set_gauge("stability_frontier_ops",
                       sum(s + 1 for s in tracker.last_frontier.values()), node=node_label)
    registry.set_gauge("stability_lag_ops", tracker.lag_ops(), node=node_label)
    registry.set_gauge("stability_stale_peers", len(tracker.stale_members()), node=node_label)


def sample_leases(registry, node_label: str, leases) -> None:
    """Coordinator-lease gauges (crdt_tpu_torch.consistency.leases),
    scrape-fresh: per-slot ``lease_state`` (0 follower / 1 held /
    2 expired-unhandedoff — the zombie-risk window worth alerting on)
    and ``lease_fence_epoch`` (highest fence this node knows for the
    slot; a fleet-wide max that stops advancing while CAS traffic flows
    means leases stopped handing off).  The companion counters —
    ``crdt_cas_forwarded_total``, ``crdt_lease_grants_total``,
    ``crdt_cas_fenced_rejects_total`` — are inc'd at the plane/manager
    and render from the registry without sampling here."""
    for slot, st in sorted(leases.slot_states().items()):
        registry.set_gauge("lease_state", float(st["state"]),
                           slot=str(slot), node=node_label)
        registry.set_gauge("lease_fence_epoch", float(st["fence"]),
                           slot=str(slot), node=node_label)


def max_convergence_lag(registry):
    """The worst ``convergence_lag_ops`` EWMA across every node label in
    this registry, or None before the first pull-round observation (the
    watchdog's lag-breach evaluator thresholds on it)."""
    worst = None
    for key, val in registry.snapshot().items():
        if key == "convergence_lag_ops" or key.startswith("convergence_lag_ops{"):
            v = float(val)
            if worst is None or v > worst:
                worst = v
    return worst


def sample_audit(registry, watchdog) -> None:
    """Divergence-audit gauges: ``audit_state`` (0 no data / 1 all
    comparisons agree / 2 divergence latched), ``audit_evals`` (watchdog
    ticks so far) and each plane's winner rows under digest.  The
    ``audit_agreement`` gauge and the ``audit_*`` counters are recorded by
    the watchdog when it compares."""
    registry.set_gauge("audit_state", float(watchdog.state))
    registry.set_gauge("audit_evals", float(watchdog.evals))
    for plane, node in watchdog.planes():
        dig = getattr(node, "digest", None)
        if dig is not None:
            registry.set_gauge("audit_plane_keys", float(len(dig.winner)), plane=plane)


def sample_union_paths(registry) -> None:
    """Delta-converge the process-global union-engine tallies
    (``ops.union_engine``: which engine served each join, and refused
    truncations) into THIS registry's monotone counters: each registry
    inc's only the delta since its own last sample, so
    ``union_path_total{path=...}`` stays monotone with several nodes
    scraping one process."""
    from crdt_tpu_torch.ops import union_engine

    counts = union_engine.union_path_counts()
    counts.setdefault("sort", 0)  # the series exists from the first scrape
    for path, total in sorted(counts.items()):
        registry.inc("union_path", 0, path=path)
        seen = registry.gauge_value("union_path_sampled", path=path) or 0
        if total > seen:
            registry.inc("union_path", total - seen, path=path)
            registry.set_gauge("union_path_sampled", total, path=path)
    trunc = union_engine.truncation_count()
    registry.inc("union_truncations_refused", 0)
    seen = registry.gauge_value("union_truncations_sampled") or 0
    if trunc > seen:
        registry.inc("union_truncations_refused", trunc - seen)
        registry.set_gauge("union_truncations_sampled", trunc)


def sample_all(registry, node, set_node=None, seq_node=None, map_node=None,
               composite_node=None, agent=None, ingest=None, stability=None,
               keyspace=None, ks_door=None, leases=None, watchdog=None) -> None:
    """Every sampler of this node's planes, in the JAX package's order."""
    sample_kv_node(registry, node)
    sample_union_paths(registry)
    if set_node is not None:
        sample_set_node(registry, set_node)
    if seq_node is not None:
        sample_seq_node(registry, seq_node)
    if map_node is not None:
        sample_map_node(registry, map_node)
    if composite_node is not None:
        sample_composite_node(registry, composite_node)
    if agent is not None:
        sample_peer_circuits(registry, str(node.rid), agent.peers)
    if ingest is not None:
        sample_ingest(registry, ingest)
    if stability is not None:
        sample_stability(registry, str(node.rid), stability)
    if keyspace is not None:
        sample_keyspace(registry, str(node.rid), keyspace, ks_door=ks_door)
    if leases is not None:
        sample_leases(registry, str(node.rid), leases)
    if watchdog is not None:
        sample_audit(registry, watchdog)


def render_node_metrics(node, set_node=None, seq_node=None, map_node=None,
                        composite_node=None, agent=None, ingest=None, stability=None,
                        keyspace=None, ks_door=None, leases=None, watchdog=None) -> str:
    """The GET /metrics body: sample the health gauges into the node's
    registry, then render the whole registry as Prometheus text."""
    registry = node.metrics.registry
    sample_all(registry, node, set_node=set_node, seq_node=seq_node, map_node=map_node,
               composite_node=composite_node, agent=agent, ingest=ingest,
               stability=stability, keyspace=keyspace, ks_door=ks_door, leases=leases,
               watchdog=watchdog)
    return registry.render_prometheus()
