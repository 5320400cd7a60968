"""Swarm reduction helpers (the slice of ``crdt_tpu.ops.joins`` that the
OpLog swarm path needs: ``pad_to_pow2`` and ``tree_reduce_join`` with an
explicit batched join and neutral element)."""
from __future__ import annotations

from typing import Any, Callable

import torch

from crdt_tpu_torch.utils.tree import leaves, tree_map


def _leading_dim(state: Any) -> int:
    return leaves(state)[0].shape[0]


def pad_to_pow2(state: Any, neutral: Any) -> Any:
    """Pad the leading replica axis up to a power of two with copies of the
    join identity element `neutral` (a single-instance state)."""
    r = _leading_dim(state)
    p = 1
    while p < r:
        p *= 2
    if p == r:
        return state
    return tree_map(
        lambda x, n: torch.cat([x, n[None].expand((p - r,) + n.shape)], dim=0),
        state,
        neutral,
    )


def tree_reduce_join(join_batched: Callable, state: Any, neutral: Any) -> Any:
    """Reduce a stacked swarm state (leading axis = replicas) to the join of
    all replicas, in log2(R) batched join steps.  ``join_batched`` joins two
    stacked states; ``neutral`` is the single-instance join identity."""
    with torch.profiler.record_function("crdt.tree_reduce_join"):
        state = pad_to_pow2(state, neutral)
        p = _leading_dim(state)
        while p > 1:
            p //= 2
            lo = tree_map(lambda x: x[:p], state)
            hi = tree_map(lambda x: x[p : 2 * p], state)
            state = join_batched(lo, hi)
        return tree_map(lambda x: x[0], state)
