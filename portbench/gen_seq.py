"""The sequence CRDT's seeded inputs: frozen copies of the port's
generators, and the GC'd swarm snapshot the ``seq-swarm-10k`` cells start
from.

Copied from ``crdt_tpu_torch/models/rseq.py`` (``alloc_key`` and the
plain-Python helpers it needs) and ``crdt_tpu_torch/workload.py``
(``seq_pool``, ``seq_swarm``), with the mix's sizes as parameters, so that
nothing here imports the port and every later run draws the same inputs
from the same seed.  :func:`gc_snapshot` is the benchmark's own: a swarm
after an earlier GC barrier, drawn as masks over the pool.

A replica's state is three things over the pool, which is sorted by key
(the document order, which is the table's row order): the elements it
holds, those of them it has seen removed, and its per-writer floor.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from portbench.gen import SENTINEL, device_generator

# ---- rseq.alloc_key, frozen ----

POS_BITS = 60
POS_MAX = 1 << POS_BITS          # exclusive virtual-coordinate bound
MID = POS_MAX // 2               # reserved stamp coordinate (never allocated)
HALF_BITS = 30
HALF_MASK = (1 << HALF_BITS) - 1
APPEND_STRIDE = 1 << 20          # gap left by open-ended (chain) allocations


class GapExhausted(ValueError):
    """No representable position remains between the two neighbours."""


def split_pos(pos: int):
    if not 0 <= pos < POS_MAX:
        raise ValueError(f"position {pos} outside [0, 2^{POS_BITS})")
    return pos >> HALF_BITS, pos & HALF_MASK


def join_pos(hi: int, lo: int) -> int:
    return (int(hi) << HALF_BITS) | int(lo)


def _triples(row, depth):
    return tuple((join_pos(row[4 * k], row[4 * k + 1]), int(row[4 * k + 2]),
                  int(row[4 * k + 3])) for k in range(depth))


def _flatten(levels):
    out = []
    for pos, rid, seq in levels:
        hi, lo = split_pos(pos)
        out.extend((hi, lo, rid, seq))
    return tuple(out)


def _stamp(levels, rid, seq, depth):
    return _flatten(tuple(levels) + ((MID, rid, seq),) * (depth - len(levels)))


def real_depth(triples) -> int:
    d = 1
    for k, (pos, _, _) in enumerate(triples, start=1):
        if pos != MID:
            d = k
    return d


def _alloc_between(lo: int, hi: int, *, open_lo: bool, open_hi: bool) -> int:
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
    if cand == MID:
        cand = MID + 1 if MID + 1 < hi else MID - 1
        if not lo < cand < hi:
            raise GapExhausted(f"only MID remains between {lo} and {hi}")
    return cand


def alloc_key(left, right, rid: int, seq: int, depth: int):
    """The flattened path key of an element strictly between ``left`` and
    ``right`` (key rows, or None for either end): ``rseq.alloc_key``."""
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
        hi = rt[k - 1][0] if rt is not None and rt[: k - 1] == lt[: k - 1] else POS_MAX
        return lo, hi

    def try_gap(k):
        lo, hi = bounds(k)
        try:
            p = _alloc_between(lo, hi, open_lo=(lo == MID if k > 1 else lo == -1),
                               open_hi=(hi == POS_MAX))
        except GapExhausted:
            return None
        return lt[: k - 1] + ((p, rid, seq),)

    def try_escape(k):
        lo, hi = bounds(k)
        if k <= d and lo != MID and (rid, seq) > lt[k - 1][1:]:
            if not (rt is not None and rt[: k - 1] == lt[: k - 1]
                    and (lo, rid, seq) >= rt[k - 1]):
                return lt[: k - 1] + ((lo, rid, seq),)
        if (rt is not None and rt[: k - 1] == lt[: k - 1] and hi != POS_MAX and hi != MID
                and (rid, seq) < rt[k - 1][1:] and (k > d or (hi, rid, seq) > lt[k - 1])):
            return lt[: k - 1] + ((hi, rid, seq),)
        return None

    def gap_empty(k):
        lo, hi = bounds(k)
        return hi - lo < 2

    own = lt[d - 1][1] == rid
    protected = d >= 2 and lt[d - 2][1] == rid
    candidates = []
    if own and protected:
        candidates.append(("gap", d))
    candidates += [("esc", k) for k in range(d, 0, -1) if gap_empty(k)]
    if d + 1 <= depth:
        candidates.append(("gap", d + 1))
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
            if not tuple(row) > tuple(left) or not (right is None or tuple(row) < tuple(right)):
                raise AssertionError(f"allocated key not strictly between its neighbours: {row}")
            return row
    raise GapExhausted(f"every level of the {depth}-deep gap is bisected to exhaustion")


# ---- workload.seq_pool and seq_swarm, frozen ----


@dataclasses.dataclass
class SeqPool:
    """The elements every replica draws from, numpy rows sorted by key."""

    keys: np.ndarray       # int32[P, 4*D]  flattened path keys
    elem: np.ndarray       # int32[P]       payload id (the creation index)
    removable: np.ndarray  # bool[P]        the element's remove happened somewhere

    def __len__(self) -> int:
        return len(self.elem)

    @property
    def rid(self) -> np.ndarray:
        """Each element's writer: the last level's identity (the stamp)."""
        return self.keys[:, -2]

    @property
    def seq(self) -> np.ndarray:
        return self.keys[:, -1]


def seq_pool(seed: int, *, depth: int, writers: int, run_max: int, elements: int,
             removable: float) -> SeqPool:
    """``workload.seq_pool``: one shared document typed in rounds by
    ``writers`` writers (rids 0 up, seqs contiguous from 0).  At the start
    of a round each writer snapshots the document, picks a seeded index
    of it and types a run of 1 to ``run_max`` elements there; the history
    stops at ``elements``.  A seeded ``removable`` share of the elements
    has been removed somewhere."""
    rng = np.random.default_rng(seed)
    doc: list = []
    elem: dict = {}
    next_seq = [0] * writers
    while len(doc) < elements:
        snapshot, typed = list(doc), []
        for w in range(writers):
            run = int(rng.integers(1, run_max + 1))
            at = int(rng.integers(0, len(snapshot) + 1))
            run = min(run, elements - len(doc) - len(typed))
            left = snapshot[at - 1] if at > 0 else None
            right = snapshot[at] if at < len(snapshot) else None
            for _ in range(run):
                key = alloc_key(left, right, w, next_seq[w], depth)
                next_seq[w] += 1
                elem[key] = len(elem)
                typed.append(key)
                left = key
        doc = sorted(doc + typed)
    dead = np.zeros(len(doc), bool)
    dead[rng.choice(len(doc), int(round(removable * len(doc))), replace=False)] = True
    return SeqPool(keys=np.asarray(doc, np.int32),
                   elem=np.asarray([elem[k] for k in doc], np.int32), removable=dead)


def tables(pool: SeqPool, held: torch.Tensor, seen: torch.Tensor, capacity: int) -> dict:
    """The replicas' RSeq tables from their masks (``held`` already within
    ``capacity``): per replica its held elements in key order, then
    padding (SENTINEL keys, elem 0, not removed).  {keys: int32[R, C, 4D],
    elem: int32[R, C], removed: bool[R, C]}."""
    device = held.device
    r, p = held.shape
    row = torch.cumsum(held, dim=1, dtype=torch.int32) - 1
    dest = torch.where(held, row, capacity).long()
    idx = torch.full((r, capacity + 1), p, dtype=torch.long, device=device)
    idx.scatter_(1, dest, torch.arange(p, device=device).expand(r, p))
    idx = idx[:, :capacity]
    width = pool.keys.shape[1]
    keys = torch.cat([torch.as_tensor(pool.keys, device=device),
                      torch.full((1, width), SENTINEL, dtype=torch.int32, device=device)])
    elem = torch.cat([torch.as_tensor(pool.elem, device=device),
                      torch.zeros(1, dtype=torch.int32, device=device)])
    removed = torch.zeros((r, capacity + 1), dtype=torch.bool, device=device)
    removed.scatter_(1, dest, seen & held)
    return {"keys": keys[idx], "elem": elem[idx], "removed": removed[:, :capacity]}


def seq_swarm(pool: SeqPool, n_replicas: int, capacity: int, seed: int, *, hold: float,
              seen_remove: float, device) -> tuple:
    """``workload.seq_swarm``: each replica holds a ``hold`` share of the
    pool (its first ``capacity`` in key order) and has seen the remove of
    each removable element it holds with probability ``seen_remove``.
    Returns (tables, held, seen)."""
    gen = device_generator(device, seed)
    p = len(pool)
    removable = torch.as_tensor(pool.removable, device=device)
    held = torch.rand((n_replicas, p), generator=gen, device=device) < hold
    held &= torch.cumsum(held, dim=1, dtype=torch.int32) - 1 < capacity
    seen = held & removable & (torch.rand((n_replicas, p), generator=gen, device=device)
                               < seen_remove)
    return tables(pool, held, seen, capacity), held, seen


# ---- the GC'd swarm a seq-swarm-10k epoch starts from ----


@dataclasses.dataclass
class GcSnapshot:
    """A swarm after an earlier GC barrier, as masks over the pool."""

    held: torch.Tensor   # bool[R, P]
    seen: torch.Tensor   # bool[R, P]: seen removed (within held)
    floor: torch.Tensor  # int32[R, W]: per tracked writer, the highest seq collected
    alive: torch.Tensor  # bool[R]
    stale: torch.Tensor  # bool[R]: down at the earlier barrier


def writer_cuts(pool: SeqPool, share: float, writers: int) -> np.ndarray:
    """int[writers and up]: for each writer that typed, and each tracked
    one, the last seq of the first ``share`` of its seqs (-1 where that is
    none)."""
    counts = np.bincount(pool.rid, minlength=writers)
    return np.floor(share * counts).astype(np.int64) - 1


def gc_snapshot(pool: SeqPool, n_replicas: int, capacity: int, seed: int, *, writers: int,
                prior_floor: float, stale_fraction: float, hold: float, spread: float,
                seen_remove: float, down: int, device) -> GcSnapshot:
    """The swarm after one earlier barrier, which collected the first
    ``prior_floor`` of each tracked writer's (rid < ``writers``) seqs.

    * Replicas up at that barrier carry its floor and hold every element
      under it that it did not collect: all but the tracked writers'
      removed ones.  (A writer the floor does not track keeps its removed
      elements, seen removed; the cells have none.)
    * A seeded ``stale_fraction`` of the replicas were down then: they
      keep the floor from before it, which collected nothing (-1), and
      hold each element under the new floor with probability ``spread``
      (the share of the replicas that held an element when that barrier
      ran), their own draw, removed ones included.
    * Every later element starts at a seeded ``hold`` share of the
      replicas.  Each replica has seen the remove of each removable
      element it holds outside what its barrier converged with
      probability ``seen_remove``.
    * ``down`` seeded replicas are down now.

    Each replica keeps its first ``capacity`` held elements in key order."""
    gen = device_generator(device, seed)
    r, p = n_replicas, len(pool)

    def col(x, dtype):
        return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)[None]

    rid, seq = pool.rid.astype(np.int64), pool.seq.astype(np.int64)
    cut = writer_cuts(pool, prior_floor, writers)
    under = col(seq <= cut[rid], torch.bool)
    removable = col(pool.removable, torch.bool)
    # what the barrier converged and kept: every element but a tracked writer's removed one
    kept = ~(col(rid < writers, torch.bool) & removable)

    stale = torch.zeros(r, dtype=torch.bool, device=device)
    stale[torch.randperm(r, generator=gen, device=device)[:int(round(stale_fraction * r))]] = True
    u = torch.rand((r, p), generator=gen, device=device)
    sees = torch.rand((r, p), generator=gen, device=device) < seen_remove
    s = stale[:, None]
    converged = under & ~s
    held = (converged & kept) | (s & under & (u < spread)) | (~under & (u < hold))
    held &= torch.cumsum(held, dim=1, dtype=torch.int32) <= capacity
    seen = held & removable & (converged | sees)
    floor = torch.where(s, -1, torch.as_tensor(cut[:writers], dtype=torch.int32, device=device))
    alive = torch.ones(r, dtype=torch.bool, device=device)
    alive[torch.randperm(r, generator=gen, device=device)[:down]] = False
    return GcSnapshot(held=held, seen=seen, floor=floor, alive=alive, stale=stale)
