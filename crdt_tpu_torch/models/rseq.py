"""RSeq: the replicated sequence (list) CRDT as fixed-shape tensors
(counterpart of ``crdt_tpu.models.rseq``).

Every element carries a flat-sortable variable-depth path key: a path of
up to ``D = depth`` levels, each a ``(pos, rid, seq)`` triple (a 60-bit
virtual coordinate as two 30-bit words plus the writer identity), flattened
into a ``4*D``-column key row.  Levels past an element's real depth are
stamped ``(MID, own rid, own seq)``; real allocations never use ``MID``, so
lexicographic row order is the tree order — children sort right after their
parent and before the parent's next sibling (RGA's insert-after rule).

The state is a sorted, SENTINEL-padded fixed-capacity table; join is the
4·D-column sorted union with tombstone-OR, delete is a monotone tombstone,
and read is the live payloads in row order (the table is the list).
Identities are allocated on the host (:func:`alloc_key`,
:class:`SeqWriter`), plain Python copied from the JAX package.

Single-instance functions work along the row dimension, so a batched
``[R, C, 4D]`` table goes through ``join`` as one ``[C, 4D]`` table does.
The swarm fast path is ``crdt_tpu_torch.models.rseq_columnar``.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from crdt_tpu_torch import default_device
from crdt_tpu_torch.ops import sorted_union as su
from crdt_tpu_torch.utils.constants import SENTINEL_PY
from crdt_tpu_torch.utils.tables import grow_into

POS_BITS = 60
POS_MAX = 1 << POS_BITS          # exclusive virtual-coordinate bound
MID = POS_MAX // 2               # reserved stamp coordinate (never allocated)
HALF_BITS = 30
HALF_MASK = (1 << HALF_BITS) - 1
APPEND_STRIDE = 1 << 20          # gap left by open-ended (chain) allocations
DEPTH = 6                        # default path depth cap (table width 4*D+2)


class GapExhausted(ValueError):
    """No representable position remains between the two neighbours at any
    level — every level's integer gap was bisected to exhaustion."""


class CapacityExceeded(ValueError):
    """The fixed-capacity table has no free row (tombstones count: they
    occupy slots until compaction/GC reclaims them)."""


def split_pos(pos: int):
    if not 0 <= pos < POS_MAX:
        raise ValueError(f"position {pos} outside [0, 2^{POS_BITS})")
    return pos >> HALF_BITS, pos & HALF_MASK


def join_pos(hi: int, lo: int) -> int:
    return (int(hi) << HALF_BITS) | int(lo)


@dataclasses.dataclass
class RSeq:
    """Rows sorted lexicographically by the flattened path-key columns;
    padding rows have every key column = SENTINEL."""

    keys: torch.Tensor     # int32[..., C, 4*D]  (p_hi, p_lo, rid, seq) x D
    elem: torch.Tensor     # int32[..., C]       payload id (host-interned)
    removed: torch.Tensor  # bool[..., C]        tombstone (monotone)

    @property
    def capacity(self) -> int:
        return self.keys.shape[-2]

    @property
    def depth(self) -> int:
        return self.keys.shape[-1] // 4


def empty(capacity: int, depth: int = DEPTH, device=None) -> RSeq:
    device = default_device(device)
    return RSeq(
        keys=torch.full((capacity, 4 * depth), SENTINEL_PY, dtype=torch.int32,
                        device=device),
        elem=torch.zeros((capacity,), dtype=torch.int32, device=device),
        removed=torch.zeros((capacity,), dtype=torch.bool, device=device),
    )


def size(s: RSeq) -> torch.Tensor:
    """Live (non-tombstoned, non-padding) element count."""
    return ((s.keys[..., 0] != SENTINEL_PY) & ~s.removed).sum(dim=-1, dtype=torch.int32)


def n_rows(s: RSeq) -> torch.Tensor:
    """Occupied rows (live + tombstoned) — the capacity-pressure metric."""
    return (s.keys[..., 0] != SENTINEL_PY).sum(dim=-1, dtype=torch.int32)


def _key_cols(s: RSeq):
    return tuple(s.keys[..., i] for i in range(s.keys.shape[-1]))


def _vals(s: RSeq):
    return {"elem": s.elem, "removed": s.removed}


def _combine(a, b):
    # identical identity => identical element payload; tombstones OR
    return {"elem": a["elem"], "removed": a["removed"] | b["removed"]}


def _from_union(keys, vals) -> RSeq:
    return RSeq(keys=torch.stack(list(keys), dim=-1),
                elem=vals["elem"], removed=vals["removed"])


def join(a: RSeq, b: RSeq) -> RSeq:
    out, _ = join_checked(a, b)
    return out


def join_checked(a: RSeq, b: RSeq):
    """CRDT join: path-key union with tombstone-OR.  Same capacity contract
    as every sorted lattice: a union exceeding capacity drops the largest
    keys — check the returned count where that matters."""
    # zipping mismatched column counts in sorted_union would silently
    # truncate the deeper levels and merge distinct elements as duplicates
    if a.keys.shape != b.keys.shape:
        raise ValueError(
            f"RSeq shapes differ ({tuple(a.keys.shape)} vs {tuple(b.keys.shape)}): "
            "states must share capacity and path depth to join"
        )
    keys, vals, n = su.sorted_union(
        _key_cols(a), _vals(a), _key_cols(b), _vals(b),
        combine=_combine, out_size=a.capacity,
    )
    return _from_union(keys, vals), n


def insert(s: RSeq, key, elem) -> RSeq:
    """Insert one identified element (the flattened ``key`` row is allocated
    on the host by SeqWriter/alloc_key).  Requires a free slot — callers
    (SeqWriter) check capacity and raise CapacityExceeded.  The length-1
    case of insert_batch."""
    return insert_batch(s, np.array(key, dtype=np.int32).reshape(1, -1), [elem])


def insert_batch(s: RSeq, key_rows, elems) -> RSeq:
    """Insert a pre-allocated RUN of elements in one union.  ``key_rows``:
    int32[N, 4*D]; all-SENTINEL rows are padding."""
    key_rows = torch.as_tensor(np.array(key_rows, dtype=np.int32), device=s.keys.device)
    if key_rows.shape[-1] != s.keys.shape[-1]:
        raise ValueError(
            f"key rows have {key_rows.shape[-1]} columns, state expects "
            f"{s.keys.shape[-1]} (depth mismatch)"
        )
    n = key_rows.shape[0]
    batch = RSeq(
        keys=key_rows,
        elem=torch.as_tensor(np.array(elems, dtype=np.int32).reshape(n), device=s.keys.device),
        removed=torch.zeros((n,), dtype=torch.bool, device=s.keys.device),
    )
    keys, vals, _ = su.sorted_union(
        _key_cols(s), _vals(s), _key_cols(batch), _vals(batch),
        combine=_combine, out_size=s.capacity,
    )
    return _from_union(keys, vals)


def delete(s: RSeq, key) -> RSeq:
    """Tombstone one element by identity (RGA delete: the position stays)."""
    key = torch.as_tensor(np.array(key, dtype=np.int32), device=s.keys.device)
    hit = (s.keys == key).all(dim=-1)
    return dataclasses.replace(s, removed=s.removed | hit)


def to_list(s: RSeq):
    """Host decode: live payload ids in sequence order."""
    keys0 = s.keys[..., 0].cpu().numpy()
    live = (keys0 != SENTINEL_PY) & ~s.removed.cpu().numpy()
    return [int(e) for e in s.elem.cpu().numpy()[live]]


def grow(s: RSeq, new_capacity: int) -> RSeq:
    """Capacity migration (the recovery path for CapacityExceeded): rows
    are sorted with padding at the tail, so growth is more tail padding."""
    if new_capacity < s.capacity:
        raise ValueError(f"cannot shrink capacity {s.capacity} -> {new_capacity}")
    return grow_into(s, empty(new_capacity, s.depth, device=s.keys.device))


def widen(s: RSeq, new_depth: int) -> RSeq:
    """Order-preserving depth migration: extend every row's path to
    ``new_depth`` levels by appending its own (MID, rid, seq) stamp — the
    stamping rule elements are born with, so order, identities and
    rendered lists are unchanged.  The recovery path for a depth-cap
    GapExhausted; a fleet migrates together (join rejects mixed depths)."""
    d = s.depth
    if new_depth < d:
        raise ValueError(f"cannot narrow depth {d} -> {new_depth}")
    if new_depth == d:
        return s
    valid = s.keys[..., 0] != SENTINEL_PY
    own_rid = s.keys[..., -2]
    own_seq = s.keys[..., -1]
    mid_hi, mid_lo = split_pos(MID)
    stamp = torch.stack(
        [
            torch.where(valid, mid_hi, SENTINEL_PY).to(torch.int32),
            torch.where(valid, mid_lo, SENTINEL_PY).to(torch.int32),
            own_rid,
            own_seq,
        ],
        dim=-1,
    )
    ext = stamp.repeat((1,) * (stamp.dim() - 1) + (new_depth - d,))
    return dataclasses.replace(s, keys=torch.cat([s.keys, ext], dim=-1))


# ---- tombstone GC adapter (crdt_tpu_torch.models.tomb_gc) ----


class GC_ADAPTER:
    """Wire RSeq into the generic tombstone-GC machinery.  Identity = the
    deepest-level (rid, seq): the (MID, own-identity) stamping puts the
    element's own writer identity in the LAST level's identity columns,
    whatever its real depth.  Collecting a row is safe for descendants:
    children embed copies of ancestor coordinates, not references."""

    @staticmethod
    def key_cols(s: RSeq):
        return _key_cols(s)

    @staticmethod
    def vals(s: RSeq):
        return _vals(s)

    @staticmethod
    def combine(a, b):
        return _combine(a, b)

    @staticmethod
    def from_union(keys, vals) -> RSeq:
        return _from_union(keys, vals)

    @staticmethod
    def rid_seq(s: RSeq):
        return s.keys[..., -2], s.keys[..., -1]

    @staticmethod
    def valid(s: RSeq):
        return s.keys[..., 0] != SENTINEL_PY

    @staticmethod
    def capacity_of(s: RSeq) -> int:
        return s.capacity

    @staticmethod
    def removed_of(s: RSeq):
        return s.removed

    @staticmethod
    def vals_zero_like(s: RSeq, mask):
        return {
            "elem": torch.where(mask, 0, s.elem),
            "removed": torch.where(mask, False, s.removed),
        }

    @staticmethod
    def columnar_converge(sw):
        """The barrier's convergence phase alone on the lexN kernels
        (crdt_tpu_torch.models.rseq_engine).  Returns (converged swarm,
        max_n_unique) or None after a loud EngineFallback warning when the
        layout is ineligible."""
        from crdt_tpu_torch.models import rseq_engine

        return rseq_engine.gc_converge_swarm(sw)

    @staticmethod
    def columnar_barrier(sw):
        """gc_round's engine hook: the whole barrier on the columnar GC
        engine (crdt_tpu_torch.models.rseq_engine), the DEFAULT for RSeq
        swarms.  Returns (swarm after the barrier, max_n_unique) or None
        after a loud EngineFallback warning when the layout is ineligible
        (tomb_gc.gc_round then runs the generic path)."""
        from crdt_tpu_torch.models import rseq_engine

        return rseq_engine.gc_barrier_swarm(sw)


# ---- host-side identity allocation ------------------------------------------
#
# Plain Python, the JAX package's own rules (crdt_tpu/models/rseq.py).


def _triples(row, depth):
    """[(pos, rid, seq)] levels from a flattened 4*D-int key row."""
    return tuple(
        (join_pos(row[4 * k], row[4 * k + 1]), int(row[4 * k + 2]),
         int(row[4 * k + 3]))
        for k in range(depth)
    )


def _flatten(levels):
    out = []
    for pos, rid, seq in levels:
        hi, lo = split_pos(pos)
        out.extend((hi, lo, rid, seq))
    return tuple(out)


def _stamp(levels, rid, seq, depth):
    """Pad real levels out to ``depth`` with the (MID, own-identity) stamp."""
    return _flatten(tuple(levels) + ((MID, rid, seq),) * (depth - len(levels)))


def real_depth(triples) -> int:
    """Deepest level whose coordinate is a real allocation (never MID)."""
    d = 1
    for k, (pos, _, _) in enumerate(triples, start=1):
        if pos != MID:
            d = k
    return d


def _alloc_between(lo: int, hi: int, *, open_lo: bool, open_hi: bool) -> int:
    """An integer strictly between lo and hi, never exactly MID.  Open ends
    stride (APPEND_STRIDE) instead of bisecting; a doubly-open gap takes
    the midpoint."""
    if hi - lo < 2:
        raise GapExhausted(f"no position left between {lo} and {hi}")
    if open_lo and open_hi:
        cand = (lo + hi) // 2
    elif open_hi:
        cand = lo + APPEND_STRIDE if lo + APPEND_STRIDE < hi else (lo + hi) // 2
    elif open_lo:
        cand = hi - APPEND_STRIDE if hi - APPEND_STRIDE > lo else (lo + hi) // 2
    else:
        cand = (lo + hi) // 2
    if cand == MID:  # MID is reserved for the stamp rows
        cand = MID + 1 if MID + 1 < hi else MID - 1
        if not lo < cand < hi:
            raise GapExhausted(f"only MID remains between {lo} and {hi}")
    return cand


def _row_cmp_key(row):
    return tuple(int(x) for x in row)


def alloc_key(left, right, rid: int, seq: int, depth: int = DEPTH):
    """Allocate the flattened path key for an element strictly between
    ``left`` and ``right`` (flattened key rows, or None for begin/end).

    Level preference: (1) sibling continuation of my own chain at left's
    depth; (2) descend under left (the RGA anchor) at depth(left) + 1;
    (3) re-anchor sweep over every level, deepest first, gaps then
    identity-tiebreak escapes."""
    if left is None and right is None:
        p = _alloc_between(-1, POS_MAX, open_lo=True, open_hi=True)
        return _stamp([(p, rid, seq)], rid, seq, depth)
    if left is None:
        rt = _triples(right, depth)
        p = _alloc_between(-1, rt[0][0], open_lo=True, open_hi=False)
        return _stamp([(p, rid, seq)], rid, seq, depth)

    lt = _triples(left, depth)
    rt = _triples(right, depth) if right is not None else None
    d = real_depth(lt)

    def bounds(k):
        lo = lt[k - 1][0] if k <= d else MID
        hi = rt[k - 1][0] if rt is not None and rt[: k - 1] == lt[: k - 1] \
            else POS_MAX
        return lo, hi

    def try_gap(k):
        lo, hi = bounds(k)
        try:
            p = _alloc_between(
                lo, hi,
                open_lo=(lo == MID if k > 1 else lo == -1),
                open_hi=(hi == POS_MAX),
            )
        except GapExhausted:
            return None
        return lt[: k - 1] + ((p, rid, seq),)

    def try_escape(k):
        """Identity-tiebreak escape: sit AT a neighbour's coordinate when
        the own (rid, seq) sorts strictly between the neighbours' triples;
        never at the MID stamp coordinate."""
        lo, hi = bounds(k)
        if k <= d and lo != MID and (rid, seq) > lt[k - 1][1:]:
            if not (
                rt is not None
                and rt[: k - 1] == lt[: k - 1]
                and (lo, rid, seq) >= rt[k - 1]
            ):
                return lt[: k - 1] + ((lo, rid, seq),)
        if (
            rt is not None
            and rt[: k - 1] == lt[: k - 1]
            and hi != POS_MAX
            and hi != MID
            and (rid, seq) < rt[k - 1][1:]
            and (k > d or (hi, rid, seq) > lt[k - 1])
        ):
            return lt[: k - 1] + ((hi, rid, seq),)
        return None

    def gap_empty(k):
        lo, hi = bounds(k)
        return hi - lo < 2

    own = lt[d - 1][1] == rid
    protected = d >= 2 and lt[d - 2][1] == rid
    candidates = []
    if own and protected:
        candidates.append(("gap", d))      # sibling inside my own subtree
    # collision sites (empty integer gap) prefer the depth-free escape
    candidates += [("esc", k) for k in range(d, 0, -1) if gap_empty(k)]
    if d + 1 <= depth:
        candidates.append(("gap", d + 1))  # descend under left
    candidates += [("gap", k) for k in range(depth, 0, -1)]
    candidates += [("esc", k) for k in range(depth, 0, -1)]

    seen = set()
    for cand in candidates:
        if cand in seen:
            continue
        seen.add(cand)
        kind, k = cand
        levels = try_gap(k) if kind == "gap" else try_escape(k)
        if levels is not None:
            row = _stamp(levels, rid, seq, depth)
            # a misordered identity could never be repaired: fail loudly
            if not _row_cmp_key(row) > _row_cmp_key(left) or not (
                right is None or _row_cmp_key(row) < _row_cmp_key(right)
            ):
                raise AssertionError(
                    f"allocated key not strictly between its neighbours "
                    f"(level {k}): {row}"
                )
            return row
    raise GapExhausted(
        f"every level of the {depth}-deep gap between {lt[:d]} and "
        f"{rt if rt is None else rt[:real_depth(rt)]} is bisected to "
        "exhaustion (~58 adversarial collisions per level)"
    )


class SeqWriter:
    """Host-side editing cursor for one writer: the caller edits by INDEX
    (insert_at / delete_at) like a normal list, while the CRDT below works
    on immutable position identities.

    ``seq`` numbers are per-writer contiguous (the tombstone-GC floor
    relies on it) and are never re-minted.  By default the counter resumes
    above the largest seq this writer has in ``state``; given a
    ``tomb_gc.Gc`` wrapper the resume is floor-aware (max(table, floor) +
    1 = ``tomb_gc.next_seq``).  ``.state`` tracks the plain RSeq."""

    def __init__(self, state, rid: int, seq_start: int | None = None):
        floor = None
        if hasattr(state, "inner") and hasattr(state, "floor"):
            # tomb_gc.Gc wrapper (duck-typed: rseq must not import tomb_gc)
            floor = state.floor
            state = state.inner
        if not isinstance(state, RSeq):
            raise TypeError(f"SeqWriter needs an RSeq or Gc[RSeq], got {type(state)}")
        self.state = state
        self.rid = rid
        if seq_start is None:
            # own identity rides the LAST level's (rid, seq) columns
            keys = state.keys.cpu().numpy()
            rids, seqs = keys[:, -2], keys[:, -1]
            mine = (keys[:, 0] != SENTINEL_PY) & (rids == rid)
            seq_start = int(seqs[mine].max(initial=-1)) + 1
            if floor is not None:
                # rows at/under the floor may have been collected; re-minting
                # their (rid, seq) would be join-suppressed as already-GC'd
                seq_start = max(seq_start, int(floor.cpu().numpy()[rid]) + 1)
        self._seq = seq_start

    def _snapshot(self):
        """One host transfer of the key table: (np keys, occupied mask,
        live row indices in order)."""
        keys = self.state.keys.cpu().numpy()
        occupied = keys[:, 0] != SENTINEL_PY
        live = occupied & ~self.state.removed.cpu().numpy()
        return keys, occupied, np.nonzero(live)[0]

    @staticmethod
    def _row(keys, idx):
        return tuple(int(x) for x in keys[idx])

    def _rows(self):
        """Ordered list of live flattened key rows (tests/debug helper)."""
        keys, _, live_idx = self._snapshot()
        return [self._row(keys, i) for i in live_idx]

    def insert_at(self, index: int | None, elem: int) -> None:
        """Insert before position ``index`` (None = append)."""
        keys, occupied, live_idx = self._snapshot()
        if int(occupied.sum()) >= self.state.capacity:
            raise CapacityExceeded(
                f"RSeq table full ({int(occupied.sum())}/"
                f"{self.state.capacity} rows, tombstones included) — grow "
                "the capacity or run tombstone GC"
            )
        if index is None:
            index = len(live_idx)
        left = self._row(keys, live_idx[index - 1]) if index > 0 else None
        right = self._row(keys, live_idx[index]) if index < len(live_idx) else None
        # mint the seq only AFTER allocation succeeds (per-writer contiguity)
        key = alloc_key(left, right, self.rid, self._seq, self.state.depth)
        self._seq += 1
        self.state = insert(self.state, key, elem)

    def append(self, elem: int) -> None:
        self.insert_at(None, elem)

    def insert_run(self, index: int | None, elems) -> None:
        """Insert a left-to-right run before ``index`` (None = append) in
        ONE union: all keys allocate first, each chained after the previous,
        and the seq counter commits only after every allocation succeeds."""
        elems = list(elems)
        if not elems:
            return
        keys, occupied, live_idx = self._snapshot()
        if int(occupied.sum()) + len(elems) > self.state.capacity:
            raise CapacityExceeded(
                f"run of {len(elems)} won't fit "
                f"({int(occupied.sum())}/{self.state.capacity} rows used)"
            )
        if index is None:
            index = len(live_idx)
        left = self._row(keys, live_idx[index - 1]) if index > 0 else None
        right = self._row(keys, live_idx[index]) if index < len(live_idx) else None
        rows = []
        for i in range(len(elems)):
            row = alloc_key(left, right, self.rid, self._seq + i, self.state.depth)
            rows.append(row)
            left = row  # chain: the next element types after this one
        self._seq += len(elems)
        self.state = insert_batch(self.state, rows, elems)

    def delete_at(self, index: int) -> None:
        keys, _, live_idx = self._snapshot()
        self.state = delete(self.state, self._row(keys, live_idx[index]))

    def to_list(self):
        return to_list(self.state)
