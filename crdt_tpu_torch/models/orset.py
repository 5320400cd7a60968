"""OR-Set: the observed-remove set lattice as fixed-shape tensors
(counterpart of ``crdt_tpu.models.orset``).

BASELINE.json names it the hardest target configuration: 1M replicas × 1K
elements, a sorted-segment union.  A set is a capacity-bounded table of
*add-tags*: each ``add(elem)`` creates a globally unique tag ``(rid, seq)``
attached to ``elem``; ``remove(elem)`` tombstones every currently observed
tag of ``elem`` (a concurrent re-add with a fresh tag survives).  Rows are
sorted by (elem, rid, seq); padding rows hold SENTINEL in all three key
columns.  join = sorted union of the tag tables with tombstone-OR on
duplicates; tombstoning is monotone, so the join is a lattice join.

Capacity contract: a set holds at most ``capacity`` tags; a join whose
true union exceeds it drops the largest (elem, rid, seq) keys.
``join_checked`` reports the unique count, ``join_strict`` refuses.

Single-instance functions work along the last dimension, so a batched
``[R, C]`` set goes through ``join`` as one ``[C]`` set does.  The swarm
fast path packs tags into one int32 key (``crdt_tpu_torch.ops.pack``) and
puts the replica axis on the lanes of ``(C, R)`` planes, joined through the
union-engine dispatcher on the hand-written kernels.
"""
from __future__ import annotations

import dataclasses

import torch

from crdt_tpu_torch import default_device
from crdt_tpu_torch.ops import hopper_union, pack, union_engine
from crdt_tpu_torch.ops import sorted_union as su
from crdt_tpu_torch.utils.constants import SENTINEL_PY
from crdt_tpu_torch.utils.tables import grow_into
from crdt_tpu_torch.utils.tracing import trace_region


@dataclasses.dataclass
class ORSet:
    elem: torch.Tensor     # int32[..., C]  interned element id
    rid: torch.Tensor      # int32[..., C]  tag: creating replica
    seq: torch.Tensor      # int32[..., C]  tag: per-replica sequence number
    removed: torch.Tensor  # bool[..., C]   tombstone flag (monotone)

    @property
    def capacity(self) -> int:
        return self.elem.shape[-1]


def empty(capacity: int, device=None) -> ORSet:
    device = default_device(device)
    s = torch.full((capacity,), SENTINEL_PY, dtype=torch.int32, device=device)
    return ORSet(elem=s, rid=s.clone(), seq=s.clone(),
                 removed=torch.zeros((capacity,), dtype=torch.bool, device=device))


def size(s: ORSet) -> torch.Tensor:
    """Number of tag rows (live or tombstoned)."""
    return (s.elem != SENTINEL_PY).sum(dim=-1, dtype=torch.int32)


def add(s: ORSet, elem, rid, seq) -> ORSet:
    """Insert a fresh add-tag.  Requires a free slot (the last row must be
    padding, else the largest key is evicted — see the capacity contract)."""
    def put(col, x):
        col = col.clone()
        col[..., -1] = x
        return col

    keys, vals = su._sort_by_keys(
        [put(s.elem, elem), put(s.rid, rid), put(s.seq, seq)],
        [put(s.removed, False)], 3)
    return ORSet(elem=keys[0], rid=keys[1], seq=keys[2], removed=vals[0])


def remove(s: ORSet, elem) -> ORSet:
    """Tombstone every currently observed tag of ``elem``."""
    hit = (s.elem == elem) & (s.elem != SENTINEL_PY)
    return dataclasses.replace(s, removed=s.removed | hit)


def join(a: ORSet, b: ORSet) -> ORSet:
    out, _ = join_checked(a, b)
    return out


def join_checked(a: ORSet, b: ORSet):
    """Join returning (set, n_unique) so callers can detect capacity
    overflow (n_unique > capacity ⇒ tags were dropped)."""
    keys, removed, n_unique = su.sorted_union(
        (a.elem, a.rid, a.seq), a.removed,
        (b.elem, b.rid, b.seq), b.removed,
        combine=lambda x, y: x | y, out_size=a.capacity,
    )
    return ORSet(elem=keys[0], rid=keys[1], seq=keys[2], removed=removed), n_unique


def join_strict(a: ORSet, b: ORSet) -> ORSet:
    """Join that REFUSES capacity overflow: raises
    :class:`union_engine.UnionOverflow` instead of dropping the largest
    tags, and records the refusal on the truncation tally."""
    out, n_unique = join_checked(a, b)
    n = int(n_unique.max())
    if n > a.capacity:
        union_engine.record_truncation()
        raise union_engine.UnionOverflow(
            f"OR-Set join needs {n} rows > capacity {a.capacity}; "
            "grow() both replicas before joining"
        )
    return out


def contains(s: ORSet, elem) -> torch.Tensor:
    hit = (s.elem == elem) & (s.elem != SENTINEL_PY)
    return (hit & ~s.removed).any(dim=-1)


def _mask_rows(idx: torch.Tensor, n: int) -> torch.Tensor:
    """Row of a (n + 1)-row mask table for each element id, by JAX's
    ``.at[]`` rules: a negative id counts from the end, an id still outside
    the table lands on the spare row n, which the caller cuts off."""
    row = torch.where(idx < 0, idx + (n + 1), idx)
    return torch.where((row < 0) | (row > n), n, row).long()


def member_mask(s: ORSet, n_universe: int) -> torch.Tensor:
    """bool[..., n_universe]: which element ids have at least one live tag."""
    valid = s.elem != SENTINEL_PY
    rows = _mask_rows(torch.where(valid, s.elem, n_universe), n_universe)
    live = (valid & ~s.removed).to(torch.int32)
    mask = torch.zeros(s.elem.shape[:-1] + (n_universe + 1,), dtype=torch.int32,
                       device=s.elem.device)
    mask.scatter_reduce_(-1, rows, live, reduce="amax")
    return mask[..., :n_universe] > 0


def grow(s: ORSet, new_capacity: int) -> ORSet:
    """Capacity migration: padding sits at the tail, so growth is more tail
    padding — contents, order and join results are unchanged."""
    if new_capacity < s.capacity:
        raise ValueError(f"cannot shrink capacity {s.capacity} -> {new_capacity}")
    return grow_into(s, empty(new_capacity, device=s.elem.device))


# ---- tombstone GC adapter (for the tomb_gc module) ----


class GC_ADAPTER:
    """Table-layout adapter wiring ORSet into the generic tombstone-GC
    machinery; identity = the (rid, seq) add-tag."""

    @staticmethod
    def key_cols(s: ORSet):
        return (s.elem, s.rid, s.seq)

    @staticmethod
    def vals(s: ORSet):
        return s.removed

    @staticmethod
    def combine(a, b):
        return a | b

    @staticmethod
    def from_union(keys, vals) -> ORSet:
        return ORSet(elem=keys[0], rid=keys[1], seq=keys[2], removed=vals)

    @staticmethod
    def rid_seq(s: ORSet):
        return s.rid, s.seq

    @staticmethod
    def valid(s: ORSet):
        return s.elem != SENTINEL_PY

    @staticmethod
    def capacity_of(s: ORSet) -> int:
        return s.capacity

    @staticmethod
    def removed_of(s: ORSet):
        return s.removed

    @staticmethod
    def vals_zero_like(s: ORSet, mask):
        return torch.where(mask, False, s.removed)


# ---- columnar swarm path ----
#
# A swarm of OR-Sets as (packed_keys[C, R], removed[C, R]) planes: tags
# bit-packed into one int32 key, the removed flag on the value plane, the
# replica axis on the lanes.


def _packed(s: ORSet):
    """(packed keys with SENTINEL padding, valid mask) of a set's rows,
    raising when a valid tag's field is over its bit budget."""
    valid = s.elem != SENTINEL_PY
    packed = pack.pack_tags_checked(s.elem, s.rid, s.seq, valid=valid)
    return torch.where(valid, packed, SENTINEL_PY), valid


def stack_to_columnar(sets):
    """Stack ORSets (a list of single sets, one set, or a batched [R, C]
    set) into (packed_keys[C, R], removed[C, R]) int32 planes."""
    if not isinstance(sets, ORSet):
        sets = ORSet(*(torch.stack([getattr(s, f) for s in sets])
                       for f in ("elem", "rid", "seq", "removed")))
    if sets.elem.dim() == 1:  # one set -> one lane
        sets = ORSet(*(x[None] for x in (sets.elem, sets.rid, sets.seq, sets.removed)))
    packed, valid = _packed(sets)
    removed = (valid & sets.removed).to(torch.int32)
    return packed.T.contiguous(), removed.T.contiguous()


def columnar_join(packed_a, removed_a, packed_b, removed_b, out_size=None,
                  engine: str = "sort", universe=None, registry=None):
    """Swarm-wide OR-Set join in the columnar layout.  Returns (packed,
    removed, n_unique); n_unique[j] > out_size means lane j overflowed.

    ``engine`` picks the union engine ("sort", the default, "bucket",
    "bitmap", or "auto" for the planner; see
    ``crdt_tpu_torch.ops.union_engine``).  Every call records its path on
    the ``union_path`` tally (and on ``registry`` when given).  All engines
    are bit-identical here."""
    out = out_size if out_size is not None else packed_a.shape[0]
    with trace_region("orset.columnar_join"):
        keys, vals, n, _path = union_engine.dispatch_union(
            packed_a, removed_a, packed_b, removed_b, out,
            engine=engine, universe=universe, registry=registry,
        )
    return keys, vals, n


def columnar_member_mask(packed, removed, n_universe: int):
    """bool[n_universe, R]: per-lane element membership (≥1 live tag).

    A CUDA tensor runs the hand-written kernel (``csrc/set_member.cu``, one
    pass over the planes), a CPU tensor the plain twin; there is no
    fallback from one to the other."""
    with trace_region("orset.columnar_member_mask"):
        if hopper_union._route("member_mask", packed.device):
            return _columnar_member_mask_plain(packed, removed, n_universe)
        with trace_region("orset.columnar_member_mask.decode"):
            mask = hopper_union.member_mask_empty(packed, removed, n_universe)
        with trace_region("orset.columnar_member_mask.scatter"):
            return hopper_union.member_mask_launch(packed, removed, mask)


def _columnar_member_mask_plain(packed, removed, n_universe: int):
    """The member mask's plain twin: JAX's ``.at[].max`` as a
    ``scatter_reduce_`` over every row."""
    with trace_region("orset.columnar_member_mask.decode"):
        valid = packed != SENTINEL_PY
        # the elem field alone (padding rows are masked next): at a swarm's
        # size each int32 plane is GBs, so the rid and seq planes are not made
        elem = (packed >> (pack.RID_BITS + pack.SEQ_BITS)) & ((1 << pack.ELEM_BITS) - 1)
        rows = _mask_rows(torch.where(valid, elem, n_universe), n_universe)
        live = (valid & (removed == 0)).to(torch.int32)
        mask = torch.zeros((n_universe + 1, packed.shape[1]), dtype=torch.int32,
                           device=packed.device)
    with trace_region("orset.columnar_member_mask.scatter"):
        mask.scatter_reduce_(0, rows, live, reduce="amax")
        return mask[:n_universe] > 0


# ---- resident restructured layouts ----
#
# The bucket and bitmap engines pay layout conversions at the sorted
# boundary; a set that STAYS in the restructured layout keeps only the
# cheap part.  Single-instance planes are 1-D; a swarm adds a lane axis.


@dataclasses.dataclass
class ORSetBitmap:
    """Dense-universe OR-Set: two int32 bit planes over the packed-tag
    universe (tag t ↔ bit t % 32 of word t // 32).  join = elementwise OR."""

    present: torch.Tensor  # int32[W] (or int32[W, R] for a swarm)
    removed: torch.Tensor  # int32[W]

    @property
    def universe(self) -> int:
        return self.present.shape[0] * 32


def bitmap_empty(universe: int, device=None) -> ORSetBitmap:
    device = default_device(device)
    z = torch.zeros((union_engine.bitmap_words(universe),), dtype=torch.int32,
                    device=device)
    return ORSetBitmap(present=z, removed=z.clone())


def bitmap_join(a: ORSetBitmap, b: ORSetBitmap) -> ORSetBitmap:
    return ORSetBitmap(present=a.present | b.present, removed=a.removed | b.removed)


def bitmap_size(s: ORSetBitmap) -> torch.Tensor:
    """Observed tag count (live + tombstoned): popcount of ``present``."""
    return union_engine._popcount(s.present).sum(dtype=torch.int32)


def _unpack_set(keys, vals) -> ORSet:
    valid = keys != SENTINEL_PY
    elem, rid, seq = pack.unpack_tags(torch.where(valid, keys, 0))
    return ORSet(elem=torch.where(valid, elem, SENTINEL_PY),
                 rid=torch.where(valid, rid, SENTINEL_PY),
                 seq=torch.where(valid, seq, SENTINEL_PY),
                 removed=valid & (vals != 0))


def to_bitmap(s: ORSet, universe: int) -> ORSetBitmap:
    """ORSet → bitmap layout.  Packed tags must be < ``universe`` (the
    caller declares the dense tag space; checked)."""
    packed, valid = _packed(s)
    top = int(torch.where(valid, packed, -1).max()) if packed.numel() else -1
    if top >= universe:
        raise ValueError(f"packed tag {top} >= declared universe {universe}")
    p, r = union_engine.sorted_to_bitmap(
        packed[:, None], (valid & s.removed).to(torch.int32)[:, None], universe)
    return ORSetBitmap(present=p[:, 0], removed=r[:, 0])


def from_bitmap(s: ORSetBitmap, capacity: int) -> ORSet:
    """Bitmap layout → canonical ORSet (tags unpacked, sorted, padded)."""
    keys, vals, _ = union_engine.bitmap_to_sorted(
        s.present[:, None], s.removed[:, None], capacity)
    return _unpack_set(keys[:, 0], vals[:, 0])


@dataclasses.dataclass
class ORSetBucketed:
    """Bucket-resident OR-Set: packed tags range-partitioned into
    ``n_buckets`` segments of C/n_buckets rows (bucket = key >> shift), each
    ascending with its own SENTINEL tail.  join = bucket-local unions.

    Capacity contract: each BUCKET holds at most Wb tags; a join whose
    per-bucket union exceeds Wb drops that bucket's largest keys
    (``bucketed_join_checked`` reports it)."""

    keys: torch.Tensor     # int32[C]  packed tags in the bucketed layout
    removed: torch.Tensor  # int32[C]
    n_buckets: int
    key_bits: int = 31

    @property
    def capacity(self) -> int:
        return self.keys.shape[0]


def bucketed_empty(capacity: int, n_buckets: int, key_bits: int = 31,
                   device=None) -> ORSetBucketed:
    device = default_device(device)
    return ORSetBucketed(
        keys=torch.full((capacity,), SENTINEL_PY, dtype=torch.int32, device=device),
        removed=torch.zeros((capacity,), dtype=torch.int32, device=device),
        n_buckets=n_buckets, key_bits=key_bits)


def bucketed_join(a: ORSetBucketed, b: ORSetBucketed) -> ORSetBucketed:
    out, _ = bucketed_join_checked(a, b)
    return out


def bucketed_join_checked(a: ORSetBucketed, b: ORSetBucketed):
    """Returns (joined, bucket_max): ``bucket_max`` is the fullest bucket's
    pre-truncation unique count — > Wb means that bucket overflowed and
    dropped its largest tags.  Runs the bucketed union kernel on a CUDA
    set, its plain twin on a CPU one."""
    if a.n_buckets != b.n_buckets or a.capacity != b.capacity:
        raise ValueError(
            f"bucketed join needs equal layouts: {a.n_buckets} vs {b.n_buckets} "
            f"buckets, capacity {a.capacity} vs {b.capacity}")
    ko, vo, _, bmax = hopper_union.bucketed_union_columnar(
        a.keys[:, None], a.removed[:, None], b.keys[:, None], b.removed[:, None],
        n_buckets=a.n_buckets)
    return ORSetBucketed(keys=ko[:, 0], removed=vo[:, 0], n_buckets=a.n_buckets,
                         key_bits=a.key_bits), bmax[0]


def to_bucketed(s: ORSet, n_buckets: int, key_bits: int = 31) -> ORSetBucketed:
    """ORSet → bucket-resident layout.  Raises UnionOverflow when a bucket
    cannot hold its share of tags (the layout would drop rows)."""
    packed, valid = _packed(s)
    order = torch.argsort(packed, stable=True)
    keys, vals, dropped = union_engine.sorted_to_bucketed(
        packed[order][:, None],
        (valid & s.removed)[order][:, None].to(torch.int32),
        n_buckets, key_bits)
    n_dropped = int(dropped[0])
    if n_dropped != 0:
        union_engine.record_truncation()
        raise union_engine.UnionOverflow(
            f"{n_dropped} tags overflow their bucket "
            f"(capacity {s.capacity} / {n_buckets} buckets)")
    return ORSetBucketed(keys=keys[:, 0], removed=vals[:, 0],
                         n_buckets=n_buckets, key_bits=key_bits)


def from_bucketed(s: ORSetBucketed) -> ORSet:
    """Bucket-resident layout → canonical ORSet (same capacity)."""
    keys, vals, _ = union_engine.bucketed_to_sorted(s.keys[:, None], s.removed[:, None])
    return _unpack_set(keys[:, 0], vals[:, 0])
