"""Tombstone GC for tag-identified lattices (OR-Set, RSeq): reclaim the
capacity that removed rows pin, without breaking convergence
(counterpart of ``crdt_tpu.models.tomb_gc``).

* every row carries a writer identity ``(rid, seq)`` with per-writer
  contiguous seqs;
* a replica's knowledge watermark is ``received_vv`` = per-writer max seq
  over its table ∨ its floor;
* a GC barrier (:func:`gc_round`) first CONVERGES the alive replicas (only
  then do they agree on the removed flags), then agrees on the swarm's
  stable floor (``swarm.stable_frontier``, chain-ruled against every
  existing floor) and drops every row that is removed AND covered;
* the floor travels with the state.  The join invariant it keeps: a row
  covered by a replica's floor that is absent from its table was removed
  and collected there, so :func:`join_checked` drops a row that only one
  side holds whenever the OTHER side's floor covers it.  Matched rows are
  never suppressed, so a straggler's tombstone still ORs in.

Capacity-overflow truncation would break per-writer seq contiguity (it
drops by key order, not seq order): use the ``*_checked`` joins and treat
overflow as an error (:class:`GcOverflow`).

The machinery is generic over an ``adapter`` describing the wrapped
lattice's table (key columns, value planes, identity columns):
``orset.GC_ADAPTER`` and ``rseq.GC_ADAPTER``.  Where the JAX package vmaps
a single-instance function over replicas, these functions take leading
batch dimensions: a batched state ``[R, ...]`` with floors ``[R, W]``
goes through them as one state with floor ``[W]`` does.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from crdt_tpu_torch import default_device
from crdt_tpu_torch.ops import sorted_union as su
from crdt_tpu_torch.utils.constants import SENTINEL_PY
from crdt_tpu_torch.utils.tracing import trace_region
from crdt_tpu_torch.utils.tree import leaves, tree_map


@dataclasses.dataclass
class Gc:
    """A tag-identified lattice plus its per-writer GC floor."""

    inner: Any            # the wrapped state (ORSet, RSeq, …)
    floor: torch.Tensor   # int32[..., W]  per-writer collected watermark (-1 = none)

    @property
    def n_writers(self) -> int:
        return self.floor.shape[-1]


def wrap(inner: Any, n_writers: int, device=None) -> Gc:
    """Wrap a plain lattice state (nothing collected yet: floor = -1)."""
    return Gc(inner=inner, floor=torch.full((n_writers,), -1, dtype=torch.int32,
                                            device=default_device(device)))


def _covered(rid, seq, valid, floor):
    """bool[..., C]: rows whose identity the floor covers (a rid out of
    range — e.g. a foreign peer's — is never covered)."""
    w = floor.shape[-1]
    in_range = (rid >= 0) & (rid < w)
    rid_safe = rid.clamp(0, w - 1).long()
    floor = floor.expand(rid.shape[:-1] + (w,))
    return valid & in_range & (seq <= floor.gather(-1, rid_safe))


def received_vv(g: Gc, adapter) -> torch.Tensor:
    """Per-writer knowledge watermark: table max-seq ∨ floor."""
    rid, seq = adapter.rid_seq(g.inner)
    valid = adapter.valid(g.inner)
    w = g.n_writers
    rid_safe = torch.where(valid & (rid >= 0) & (rid < w), rid, w).long()
    table = torch.full(rid.shape[:-1] + (w + 1,), -1, dtype=torch.int32,
                       device=rid.device)
    table.scatter_reduce_(-1, rid_safe, torch.where(valid, seq, -1).to(torch.int32),
                          reduce="amax")
    return torch.maximum(g.floor, table[..., :w])


def next_seq(g: Gc, adapter, rid: int) -> int:
    """First safe seq for writer ``rid`` to mint on this replica: above
    everything observed OR collected (re-minting a collected identity would
    be suppressed at the next join)."""
    return int(received_vv(g, adapter)[rid]) + 1


def _sorted_keys_vals(keys, vals):
    """Stable lexicographic sort of the key columns carrying ``vals`` (the
    JAX package's ``lax.sort(num_keys=len(keys), is_stable=True)``)."""
    return su._sort_by_keys(list(keys), vals, len(keys))


def join_checked(a: Gc, b: Gc, adapter):
    """GC-aware CRDT join (see the module docstring for the suppression
    rule).  Returns (Gc, n_unique): n_unique counts post-suppression unique
    rows; > capacity means truncation broke the state."""
    ka, kb = adapter.key_cols(a.inner), adapter.key_cols(b.inner)
    if len(ka) != len(kb) or any(x.shape != y.shape for x, y in zip(ka, kb)):
        raise ValueError(
            f"GC join requires identical key layouts: "
            f"{[tuple(x.shape) for x in ka]} vs {[tuple(y.shape) for y in kb]} "
            "(mixed-depth RSeq states must be widened to a common depth "
            "before joining)"
        )
    if adapter.capacity_of(a.inner) != adapter.capacity_of(b.inner):
        raise ValueError(
            f"GC join requires equal capacities ({adapter.capacity_of(a.inner)}"
            f" vs {adapter.capacity_of(b.inner)}) — the output is sliced to "
            "one capacity, so unequal tables would make the join asymmetric; "
            "grow() the smaller state first"
        )
    if a.floor.shape != b.floor.shape:
        raise ValueError(
            f"GC join requires equal writer counts: floor shapes "
            f"{tuple(a.floor.shape)} vs {tuple(b.floor.shape)}"
        )
    # src marker rides the value planes: 1 = only a, 2 = only b, 3 = both
    valid_a, valid_b = adapter.valid(a.inner), adapter.valid(b.inner)
    va = {"v": adapter.vals(a.inner), "src": torch.ones_like(valid_a, dtype=torch.int32)}
    vb = {"v": adapter.vals(b.inner), "src": torch.full_like(valid_b, 2, dtype=torch.int32)}

    def combine(x, y):
        return {"v": adapter.combine(x["v"], y["v"]), "src": x["src"] | y["src"]}

    # lossless union first; suppression and the capacity slice come after,
    # so a suppressed row never evicts a real one
    keys, vals, _ = su.sorted_union(ka, va, kb, vb, combine=combine, out_size=None)
    full = adapter.from_union(keys, vals["v"])
    rid, seq = adapter.rid_seq(full)
    valid = adapter.valid(full)
    drop = ((vals["src"] == 1) & _covered(rid, seq, valid, b.floor)) | (
        (vals["src"] == 2) & _covered(rid, seq, valid, a.floor)
    )
    keys2 = [k.masked_fill(drop, SENTINEL_PY) for k in keys]
    keys3, vals3 = _sorted_keys_vals(keys2, adapter.vals_zero_like(full, drop))
    n_unique = (keys3[0] != SENTINEL_PY).sum(dim=-1, dtype=torch.int32)
    cap = adapter.capacity_of(a.inner)
    inner = adapter.from_union([k[..., :cap] for k in keys3],
                               tree_map(lambda x: x[..., :cap], vals3))
    return Gc(inner=inner, floor=torch.maximum(a.floor, b.floor)), n_unique


class GcOverflow(RuntimeError):
    """A GC-barrier join truncated the union at table capacity.  Truncation
    drops by key order, not seq order, so it breaks the per-writer seq
    contiguity the coverage proofs rest on; the barrier refuses instead."""


def join(a: Gc, b: Gc, adapter) -> Gc:
    """Join that REFUSES capacity overflow (GcOverflow) instead of silently
    truncating.  GC joins are pinned to the sort path (recorded on the
    union_path tally): the suppression rule needs the full row union with
    per-row provenance, which the bitmap/bucket layouts do not carry."""
    from crdt_tpu_torch.ops import union_engine

    union_engine.record_union_path("sort")
    out, n_unique = join_checked(a, b, adapter)
    cap = adapter.capacity_of(a.inner)
    n = int(n_unique.max())
    if n > cap:
        union_engine.record_truncation()
        raise GcOverflow(f"GC join needs {n} rows but capacity is {cap}")
    return out


def collect(g: Gc, new_floor: torch.Tensor, adapter) -> Gc:
    """Advance the floor and drop every row that is removed AND covered.
    ``new_floor`` must come from a swarm-agreed barrier over CONVERGED
    alive replicas (gc_round); the advance is clamped to this replica's own
    received watermark."""
    floor = torch.maximum(g.floor, torch.minimum(new_floor, received_vv(g, adapter)))
    rid, seq = adapter.rid_seq(g.inner)
    valid = adapter.valid(g.inner)
    drop = _covered(rid, seq, valid, floor) & adapter.removed_of(g.inner)
    keys = [k.masked_fill(drop, SENTINEL_PY) for k in adapter.key_cols(g.inner)]
    keys, vals = _sorted_keys_vals(keys, adapter.vals_zero_like(g.inner, drop))
    return Gc(inner=adapter.from_union(keys, vals), floor=floor)


def gc_round(sw, adapter, neutral_inner, engine: str = "auto"):
    """One swarm-wide GC barrier over a Swarm of Gc states (leading axis =
    replicas): converge the alive replicas (flag agreement), then agree on
    the stable floor (chain-ruled against every existing floor, dead
    replicas' included) and collect it everywhere alive.  Dead replicas
    keep their state and floor; one GC-aware join catches them up on
    revival.

    The whole barrier rides the adapter's columnar engine by DEFAULT when
    it declares one (``adapter.columnar_barrier``: rseq.GC_ADAPTER does;
    the hook warns EngineFallback and returns None when the layout is
    ineligible, and the generic path serves).  ``engine="generic"`` pins
    the generic path.  Raises GcOverflow if any pairwise union of the
    convergence truncated."""
    if engine not in ("auto", "generic"):
        raise ValueError(f"unknown GC engine {engine!r}")
    cap = adapter.capacity_of(neutral_inner)

    with trace_region("tomb_gc.barrier"):
        hook = getattr(adapter, "columnar_barrier", None)
        if engine != "generic" and hook is not None:
            res = hook(sw)
            if res is not None:
                out, max_nu = res
                _refuse_overflow(max_nu, cap)
                return out
        converged, max_nu = generic_converge(sw, adapter, neutral_inner)
        _refuse_overflow(max_nu, cap)
        return collect_swarm(converged, adapter)


def _refuse_overflow(max_nu: int, cap: int) -> None:
    if max_nu > cap:
        raise GcOverflow(f"GC barrier union needs {max_nu} rows but capacity is {cap}")


def generic_converge(sw, adapter, neutral_inner):
    """The convergence phase of :func:`gc_round` on the generic joins: the
    log-depth tree reduction of joins.tree_reduce_join over the alive
    replicas, unrolled so each level's n_unique is observable, broadcast
    over the alive replicas.  Returns (Swarm, max n_unique as an int);
    raises nothing on overflow (the caller decides)."""
    from crdt_tpu_torch.ops import joins as joins_mod
    from crdt_tpu_torch.parallel import swarm as swarm_mod

    neutral = wrap(neutral_inner, sw.state.floor.shape[-1], device=sw.state.floor.device)
    state = joins_mod.pad_to_pow2(
        swarm_mod.mask_dead_with_neutral(sw.state, sw.alive, neutral), neutral)
    max_nu = 0
    p = leaves(state)[0].shape[0]
    while p > 1:
        p //= 2
        lo = tree_map(lambda x: x[:p], state)
        hi = tree_map(lambda x: x[p: 2 * p], state)
        state, nu = join_checked(lo, hi, adapter)
        max_nu = max(max_nu, int(nu.max()))
    top = tree_map(lambda x: x[0], state)
    return dataclasses.replace(
        sw, state=swarm_mod.broadcast_where_alive(sw.state, sw.alive, top)), max_nu


def collect_swarm(converged, adapter):
    """The collection phase of :func:`gc_round` over a converged Swarm: the
    stable floor (``swarm.stable_frontier``) and :func:`collect` on every
    alive replica."""
    from crdt_tpu_torch.parallel import swarm as swarm_mod

    return swarm_mod.compaction_round(
        converged,
        received_vv=lambda st: received_vv(st, adapter),
        compact=lambda st, f: collect(st, f, adapter),
        frontier_of=lambda st: st.floor,
    )
