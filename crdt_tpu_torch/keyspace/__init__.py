"""Sharded multi-tenant keyspace tier (own copy of ``crdt_tpu.keyspace``;
its README documents the design).

``routing`` — rendezvous (HRW) hashing, shared-shaped for reuse;
``shards`` — S independent CRDT plane shards behind one router;
``frontdoor`` — per-shard admission lanes with per-tenant quota slices;
``reshard`` — online S -> S' resharding behind the epoch fence.
"""
from crdt_tpu_torch.keyspace.frontdoor import (KeyspaceFrontDoor, TENANT_HEADER,
                                         TENANT_LANE,
                                         keyspace_front_door_from_config)
from crdt_tpu_torch.keyspace.reshard import (ReshardCoordinator, migration_plan,
                                       next_router)
from crdt_tpu_torch.keyspace.routing import (RendezvousRouter, ranked_members,
                                       route_key, validate_tenant)
from crdt_tpu_torch.keyspace.shards import (ShardedKeyspace, keyspace_from_config,
                                      qualify, split_qualified)

__all__ = [
    "KeyspaceFrontDoor",
    "TENANT_HEADER",
    "RendezvousRouter",
    "ReshardCoordinator",
    "ShardedKeyspace",
    "TENANT_LANE",
    "keyspace_from_config",
    "keyspace_front_door_from_config",
    "migration_plan",
    "next_router",
    "qualify",
    "ranked_members",
    "route_key",
    "split_qualified",
    "validate_tenant",
]
