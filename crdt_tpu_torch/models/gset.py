"""G-Set and 2P-Set: grow-only and two-phase set lattices as fixed-shape
tensors (counterpart of ``crdt_tpu.models.gset``).

Sorted, SENTINEL-padded, fixed-capacity element arrays, the conventions of
every sorted lattice here (``crdt_tpu_torch.ops.sorted_union``); the 2P-Set
adds a monotone tombstone plane (join = OR on duplicates: remove wins
forever, no re-add).  Joins whose true union exceeds capacity drop the
largest elements; ``*_checked`` report the unique count and ``*_strict``
refuse.
"""
from __future__ import annotations

import dataclasses

import torch

from crdt_tpu_torch import default_device
from crdt_tpu_torch.ops import sorted_union as su
from crdt_tpu_torch.ops import union_engine
from crdt_tpu_torch.utils.constants import SENTINEL_PY
from crdt_tpu_torch.utils.tree import tree_map


@dataclasses.dataclass
class GSet:
    elem: torch.Tensor  # int32[C] sorted ascending, SENTINEL padding

    @property
    def capacity(self) -> int:
        return self.elem.shape[-1]


@dataclasses.dataclass
class TwoPSet:
    elem: torch.Tensor     # int32[C] sorted ascending, SENTINEL padding
    removed: torch.Tensor  # bool[C]  tombstone (monotone: no re-add, ever)

    @property
    def capacity(self) -> int:
        return self.elem.shape[-1]


def g_empty(capacity: int, device=None) -> GSet:
    device = default_device(device)
    return GSet(elem=torch.full((capacity,), SENTINEL_PY, dtype=torch.int32, device=device))


def tp_empty(capacity: int, device=None) -> TwoPSet:
    device = default_device(device)
    return TwoPSet(
        elem=torch.full((capacity,), SENTINEL_PY, dtype=torch.int32, device=device),
        removed=torch.zeros((capacity,), dtype=torch.bool, device=device),
    )


def _logical_or(a, b):
    return tree_map(torch.logical_or, a, b)


def _insert(elem_col, vals, new_elem, new_vals, capacity):
    """Insert one element (a duplicate keeps the existing row, its values
    OR-ed with the new row's)."""
    kb = torch.full((1,), SENTINEL_PY, dtype=torch.int32, device=elem_col.device)
    kb[0] = new_elem
    keys, vals, _ = su.sorted_union((elem_col,), vals, (kb,), new_vals,
                                    combine=_logical_or, out_size=capacity)
    return keys[0], vals


def g_add(s: GSet, elem) -> GSet:
    out, _ = _insert(s.elem, {}, elem, {}, s.capacity)
    return GSet(elem=out)


def g_join(a: GSet, b: GSet) -> GSet:
    out, _ = g_join_checked(a, b)
    return out


def g_join_checked(a: GSet, b: GSet):
    keys, _, n = su.sorted_union((a.elem,), {}, (b.elem,), {}, out_size=a.capacity)
    return GSet(elem=keys[0]), n


def g_join_strict(a: GSet, b: GSet) -> GSet:
    """Join refusing capacity overflow: raises UnionOverflow instead of
    dropping the largest elements (grow-only means a drop un-adds forever)
    and records the refusal on the truncation tally."""
    out, n_unique = g_join_checked(a, b)
    n = int(n_unique.max())
    if n > a.capacity:
        union_engine.record_truncation()
        raise union_engine.UnionOverflow(
            f"G-Set join needs {n} rows > capacity {a.capacity}")
    return out


def g_join_auto(a: GSet, b: GSet, universe=None, registry=None) -> GSet:
    """Join through the union-engine planner: a declared dense element
    universe rides the bitmap path (elements ARE keys here, no packing),
    everything else the generic join; the path lands on the
    ``union_path`` tally either way."""
    plan = union_engine.plan_union(a.capacity, universe=universe)
    union_engine.record_union_path(plan.path, registry=registry)
    if plan.path == "bitmap":
        pa, _ = union_engine.sorted_to_bitmap(
            a.elem[:, None], torch.zeros_like(a.elem)[:, None], universe)
        pb, _ = union_engine.sorted_to_bitmap(
            b.elem[:, None], torch.zeros_like(b.elem)[:, None], universe)
        keys, _, _ = union_engine.bitmap_to_sorted(pa | pb, torch.zeros_like(pa), a.capacity)
        return GSet(elem=keys[:, 0])
    out, _ = g_join_checked(a, b)
    return out


def g_contains(s: GSet, elem) -> torch.Tensor:
    return (s.elem == elem).any(dim=-1)


def g_size(s: GSet) -> torch.Tensor:
    return (s.elem != SENTINEL_PY).sum(dim=-1, dtype=torch.int32)


def tp_add(s: TwoPSet, elem) -> TwoPSet:
    """Add is a no-op for an element ever removed (two-phase rule)."""
    out, vals = _insert(
        s.elem, {"removed": s.removed}, elem,
        {"removed": torch.zeros((1,), dtype=torch.bool, device=s.elem.device)},
        s.capacity,
    )
    return TwoPSet(elem=out, removed=vals["removed"])


def tp_remove(s: TwoPSet, elem) -> TwoPSet:
    """Tombstone every present copy; removing an absent element inserts its
    tombstone (so a later add cannot resurrect it — remove wins)."""
    out, vals = _insert(
        s.elem, {"removed": s.removed}, elem,
        {"removed": torch.ones((1,), dtype=torch.bool, device=s.elem.device)},
        s.capacity,
    )
    return TwoPSet(elem=out, removed=vals["removed"])


def tp_join(a: TwoPSet, b: TwoPSet) -> TwoPSet:
    out, _ = tp_join_checked(a, b)
    return out


def tp_join_checked(a: TwoPSet, b: TwoPSet):
    keys, vals, n = su.sorted_union(
        (a.elem,), {"removed": a.removed},
        (b.elem,), {"removed": b.removed},
        combine=_logical_or, out_size=a.capacity,
    )
    return TwoPSet(elem=keys[0], removed=vals["removed"]), n


def tp_join_strict(a: TwoPSet, b: TwoPSet) -> TwoPSet:
    """Join refusing capacity overflow (see g_join_strict)."""
    out, n_unique = tp_join_checked(a, b)
    n = int(n_unique.max())
    if n > a.capacity:
        union_engine.record_truncation()
        raise union_engine.UnionOverflow(
            f"2P-Set join needs {n} rows > capacity {a.capacity}")
    return out


def tp_contains(s: TwoPSet, elem) -> torch.Tensor:
    return ((s.elem == elem) & ~s.removed).any(dim=-1)


def tp_size(s: TwoPSet) -> torch.Tensor:
    return ((s.elem != SENTINEL_PY) & ~s.removed).sum(dim=-1, dtype=torch.int32)
