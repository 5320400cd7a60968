"""Engine auto-selection for OpLog swarms (counterpart of
``crdt_tpu.models.oplog_engine``): the fused columnar kernel by default,
the generic row-major path as the loud exception.

``plan()`` inspects a batched row-major swarm ONCE (host-side), picks the
columnar engine whenever the layout allows, and falls back LOUDLY
(``EngineFallback`` warning + recorded reason) to row-major otherwise.

Columnar eligibility — all checked host-side at plan time:

* capacity is a power of two (the kernel requires it);
* every (rid, seq, key) fits an order-preserving 31-bit pack;
* ts and payload are non-negative (their sign bits carry the SENTINEL
  padding and the is_num flag respectively).

The returned :class:`OpLogSwarm` keeps the state RESIDENT in its engine's
layout — repeated converge/gossip calls re-stack nothing; ``rows()`` is
the only transposing accessor.
"""
from __future__ import annotations

import warnings
from typing import Optional

import torch

from crdt_tpu_torch.models import oplog, oplog_columnar as oc
from crdt_tpu_torch.ops import joins
from crdt_tpu_torch.parallel import swarm as swarm_mod
from crdt_tpu_torch.utils.constants import SENTINEL_PY
from crdt_tpu_torch.utils.tree import tree_map


class EngineFallback(UserWarning):
    """The swarm layout cannot ride the columnar fused kernel; the generic
    row-major engine was selected instead.  The message says exactly which
    budget failed."""


def _field_range(x: torch.Tensor, valid: torch.Tensor):
    if not bool(valid.any()):
        return 0, 0
    vals = x[valid]
    return int(vals.min()), int(vals.max())


def columnar_plan(state: oplog.OpLog):
    """Host-side eligibility check for the columnar engine over a batched
    [R, C] swarm.  Returns (bits, None) when eligible, (None, reason) when
    the generic path must serve."""
    cap = state.capacity
    if cap & (cap - 1):
        return None, f"capacity {cap} is not a power of two (bitonic network)"
    valid = state.ts != SENTINEL_PY
    ts_min, _ = _field_range(state.ts, valid)
    if ts_min < 0:
        return None, f"negative ts {ts_min} cannot carry the SENTINEL sign bit"
    pay_min, _ = _field_range(state.payload, valid)
    if pay_min < 0:
        return None, f"negative payload id {pay_min} cannot carry the is_num bit"
    rid_min, rid_max = _field_range(state.rid, valid)
    seq_min, seq_max = _field_range(state.seq, valid)
    key_min, key_max = _field_range(state.key, valid)
    if min(rid_min, seq_min, key_min) < 0:
        return None, (
            f"negative identity field (rid>={rid_min}, seq>={seq_min}, "
            f"key>={key_min}) cannot bit-pack order-preservingly"
        )
    rid_bits = max(1, rid_max.bit_length())
    key_bits = max(1, key_max.bit_length())
    seq_bits = max(1, seq_max.bit_length())
    if rid_bits + seq_bits + key_bits > 31:
        return None, (
            f"identity ranges (rid<{rid_max + 1}, seq<{seq_max + 1}, "
            f"key<{key_max + 1}) need {rid_bits + seq_bits + key_bits} bits "
            "> the 31-bit pack budget"
        )
    # give seq the whole slack: it is the axis that grows as history does
    return (rid_bits, 31 - rid_bits - key_bits, key_bits), None


class OpLogSwarm:
    """A swarm of R op logs resident in the fastest engine its layout
    allows.  Build with :func:`plan`; ``engine`` is ``"columnar"`` or
    ``"generic"``, ``fallback_reason`` records why when generic."""

    def __init__(self, *, col=None, rows=None, alive, fallback_reason=None):
        if (col is None) == (rows is None):
            raise ValueError("OpLogSwarm holds exactly one of col / rows")
        self._col = col
        self._rows = rows
        self.alive = alive
        self.fallback_reason = fallback_reason

    # ---- introspection ----

    @property
    def engine(self) -> str:
        return "generic" if self._col is None else "columnar"

    @property
    def n_replicas(self) -> int:
        return self.alive.shape[0]

    @property
    def capacity(self) -> int:
        return self._rows.capacity if self._col is None else self._col.capacity

    @property
    def columnar(self) -> Optional[oc.ColumnarOpLog]:
        """The resident columnar planes (None on the generic engine)."""
        return self._col

    def rows(self) -> oplog.OpLog:
        """The swarm as a batched [R, C] row-major OpLog (transposes on the
        columnar engine — an accessor, not the hot path)."""
        return self._rows if self._col is None else oc.unstack(self._col)

    def _wrap(self, col=None, rows=None, alive=None):
        return OpLogSwarm(
            col=col, rows=rows,
            alive=self.alive if alive is None else alive,
            fallback_reason=self.fallback_reason,
        )

    # ---- swarm ops (one call = the reference's many-round gossip) ----

    def converge_checked(self):
        """Drive every alive replica to the alive-set LUB; returns
        (OpLogSwarm, max_n_unique).  max_n_unique > capacity means some
        pairwise union truncated — same contract on both engines."""
        if self._col is not None:
            col, nu = oc.converge_checked(self._col, self.alive)
            return self._wrap(col=col), nu
        state, nu = _generic_converge_checked(self._rows, self.alive)
        return self._wrap(rows=state), nu

    def converge(self) -> "OpLogSwarm":
        out, _ = self.converge_checked()
        return out

    def gossip_round(self, peers) -> "OpLogSwarm":
        """One pull round: replica j joins peers[j]'s log, gated on both
        endpoints alive."""
        if self._col is not None:
            return self._wrap(col=oc.gossip_round(self._col, peers, self.alive))
        s = swarm_mod.Swarm(state=self._rows, alive=self.alive)
        s = swarm_mod.gossip_round(s, peers, oplog.merge)
        return self._wrap(rows=s.state)

    def set_alive(self, rid, alive_status) -> "OpLogSwarm":
        alive = self.alive.clone()
        alive[rid] = alive_status
        return self._wrap(col=self._col, rows=self._rows, alive=alive)

    def rebuild(self, n_keys: int) -> oplog.KVState:
        """Per-replica materialized views (batched over the replica axis)."""
        if self._col is not None:
            return oc.rebuild(self._col, n_keys)
        return oplog.rebuild(self._rows, n_keys)


def plan(
    state: oplog.OpLog,
    alive: torch.Tensor | None = None,
    bits: tuple | None = None,
    force_generic: bool = False,
) -> OpLogSwarm:
    """Build the swarm engine for a batched [R, C] row-major OpLog, on its
    device.

    Columnar (the fused kernel) is the DEFAULT: it is selected whenever
    :func:`columnar_plan` finds a valid layout (or the caller pins
    ``bits``).  The generic row-major engine is the exception, and falling
    back to it warns ``EngineFallback`` with the precise reason."""
    r = state.ts.shape[0]
    if alive is None:
        alive = torch.ones((r,), dtype=torch.bool, device=state.ts.device)
    if force_generic:
        return OpLogSwarm(rows=state, alive=alive, fallback_reason="forced by caller")
    if bits is None:
        bits, reason = columnar_plan(state)
        if bits is None:
            warnings.warn(
                f"OpLog swarm fell back to the generic engine: {reason}",
                EngineFallback,
                stacklevel=2,
            )
            return OpLogSwarm(rows=state, alive=alive, fallback_reason=reason)
    return OpLogSwarm(col=oc.stack(state, bits=bits), alive=alive)


def _generic_converge_checked(state: oplog.OpLog, alive: torch.Tensor):
    """The row-major fallback of converge_checked: alive-masked log-depth
    tree reduction through the generic sorted_union, overflow tracked level
    by level (mirrors oc.lub_lane so both engines share one contract)."""
    neutral = oplog.empty(state.capacity, device=state.ts.device)
    work = joins.pad_to_pow2(
        swarm_mod.mask_dead_with_neutral(state, alive, neutral), neutral
    )
    max_nu = torch.zeros((), dtype=torch.int32, device=state.ts.device)
    p = work.ts.shape[0]
    while p > 1:
        p //= 2
        lo = tree_map(lambda x: x[:p], work)
        hi = tree_map(lambda x: x[p : 2 * p], work)
        work, nu = oplog.merge_checked(lo, hi)
        max_nu = torch.maximum(max_nu, nu.max())
    top = tree_map(lambda x: x[0], work)
    return swarm_mod.broadcast_where_alive(state, alive, top), max_nu
