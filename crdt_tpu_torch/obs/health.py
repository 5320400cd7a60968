"""Replication-health gauges set on the pull path (own copy of the part of
``crdt_tpu.obs.health`` that the node's pull rounds call).

* ``peer_ops_behind{peer=}`` / ``convergence_lag_ops``: in delta mode a
  pull's payload size IS how many ops this node was behind that peer; its
  EWMA estimates the standing convergence lag;
* ``last_merge_unixtime``: stamped on every fresh merge;
* ``pull_round_peers_fused`` / ``pull_fused_fanout``: peers merged in one
  device dispatch by a k-way fused pull round.
"""
from __future__ import annotations

import time

# EWMA weight of the newest pull-round lag observation (~last 5 rounds)
LAG_ALPHA = 0.2


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
