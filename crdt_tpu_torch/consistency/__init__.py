"""Consistency plane (own copy of ``crdt_tpu.consistency``): session
guarantees, quorum strong reads and CAS under coordinator leases, and
stability-frontier coordinated GC."""
from crdt_tpu_torch.consistency.leases import (
    LEASE_STATE,
    LeaseManager,
    slot_of_key,
)
from crdt_tpu_torch.consistency.plane import (
    LEVELS,
    CasConflict,
    ConsistencyPlane,
    ConsistencyUnavailable,
)
from crdt_tpu_torch.consistency.session import (
    SESSION_TOKEN_HEADER,
    decode_token,
    encode_token,
    mint_token,
    token_join,
    vv_dominates,
    wait_for_dominance,
)
from crdt_tpu_torch.consistency.stability import (
    STABILITY_HEADER,
    StabilityTracker,
    decode_summary,
    encode_summary,
)

__all__ = [
    "LEASE_STATE",
    "LEVELS",
    "CasConflict",
    "LeaseManager",
    "slot_of_key",
    "ConsistencyPlane",
    "ConsistencyUnavailable",
    "SESSION_TOKEN_HEADER",
    "STABILITY_HEADER",
    "StabilityTracker",
    "decode_summary",
    "decode_token",
    "encode_summary",
    "encode_token",
    "mint_token",
    "token_join",
    "vv_dominates",
    "wait_for_dominance",
]
