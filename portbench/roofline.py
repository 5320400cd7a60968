"""The yardstick of the rooflines: the card's peak and the least bytes each
swarm call must move, from the call's shapes.

Each input byte is counted read once and each output byte written once
(int32 planes of C rows by R lanes, and the per-lane unique count), as
``chip_smoke.py``'s kernel table counts them.  The bytes bound these
calls: their int32 compares at the card's int32 rate take at most a
fifth of the time the bytes do.
"""
from __future__ import annotations

# NVIDIA H100 SXM5 80 GB, HBM3 (NVIDIA's data sheet), at its 700 W limit
PEAK_BYTES_PER_S = 3.35e12


def gossip_round_bytes(capacity: int, replicas: int) -> int:
    """One pull round of the KV swarm (kernel 1 at two key words and two
    value planes): 8 planes read (each lane's own and its peer's four),
    4 written, and the unique count a lane."""
    return 12 * capacity * replicas * 4 + 4 * replicas


def set_join_bytes(capacity: int, replicas: int) -> int:
    """One OR-Set columnar join (kernel 2): 4 planes read (keys and
    tombstones of both sides), 2 written, and the unique count a lane."""
    return (6 * capacity * replicas + replicas) * 4


def bound_s(n_bytes: int) -> float:
    return n_bytes / PEAK_BYTES_PER_S
