"""The set-union engines and their observable auto-dispatcher
(counterpart of ``crdt_tpu.ops.union_engine``).

Three engines take the SAME canonical sorted-columnar operands
(keys int32[C, L] ascending with a SENTINEL tail, 0/1 tombstone values)
and return bit-identical (keys, vals, n_unique) — including under
``out_size`` truncation, where all three keep the smallest ``out_size``
keys and report the pre-truncation unique count:

* **sort** — the fused single-key union kernel
  (``hopper_union.sorted_union_columnar``), always correct, the fallback;
* **bucket** — packed tags range-partitioned into B static buckets of
  Wb = C/B rows per lane (bucket = key >> shift, an order-preserving
  partition); the union runs bucket-locally
  (``hopper_union.bucketed_union_columnar``).  A bucket can overflow while
  the table has room: the conversion reports it and the engine falls back
  to the sort path, tallied as ``bucket_fallback_sort``;
* **bitmap** — over a declared dense tag universe U, a set is two int32
  bit planes of ceil(U/32) words per lane (``present`` / ``removed``) and
  the union is a bitwise OR.

Every dispatch records its path in a process-global, thread-safe tally
(``union_path_counts``); strict joins that refuse to truncate record on a
truncation tally.  A registry passed to ``record_union_path`` (anything
with ``inc``, ``gauge_value`` and ``set_gauge``, as the JAX package's
``MetricsRegistry``) gets the ``union_path{path=...}`` counter directly.

The tensors' device decides what runs: the kernels on a CUDA tensor, their
plain twins on a CPU tensor.  The JAX package padded the sort and bucket
paths to a multiple of 128 lanes, the TPU kernel's tile; the port needs no
padding and gives the same results without it.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Dict, Optional

import numpy as np
import torch

from crdt_tpu_torch.ops import hopper_union
from crdt_tpu_torch.utils.constants import SENTINEL_PY

# packed OR-Set tags span 31 bits (crdt_tpu_torch.ops.pack: elem|rid|seq
# with the sign bit clear), so bucket shifts default off that width
PACKED_KEY_BITS = 31

# default bucket width (rows per bucket per lane)
DEFAULT_BUCKET_ROWS = 16

# below this capacity the bucketed layout has too few buckets to pay for
# its conversions, and the planner takes the sort path
MIN_BUCKET_CAPACITY = 64


class UnionOverflow(RuntimeError):
    """A strict set join needed more rows than the table capacity.  The
    silent alternative (truncation to out_size) drops the largest keys —
    permanent data loss that also breaks the per-writer seq contiguity GC
    floors rest on — so the strict variants refuse instead."""


# ---- union-path / truncation tallies ---------------------------------------

_TALLY_LOCK = threading.Lock()
_PATH_TALLY: Dict[str, int] = {}
_TRUNCATION_TALLY = 0


def record_union_path(path: str, n: int = 1, registry=None) -> None:
    """Count one dispatch decision (``path`` in sort/bucket/bitmap, or
    bucket_fallback_sort).  With ``registry`` the counter is also recorded
    directly as ``union_path{path=...}``, and the registry's
    ``union_path_sampled`` gauge advances by the same amount so a
    scrape-time sampler does not count the event twice.  The registry is
    bumped before the global tally, so a concurrent scrape can only
    under-read."""
    if registry is not None:
        registry.inc("union_path", n, path=path)
        seen = registry.gauge_value("union_path_sampled", path=path) or 0
        registry.set_gauge("union_path_sampled", seen + n, path=path)
    with _TALLY_LOCK:
        _PATH_TALLY[path] = _PATH_TALLY.get(path, 0) + n


def union_path_counts() -> Dict[str, int]:
    with _TALLY_LOCK:
        return dict(_PATH_TALLY)


def record_truncation(n: int = 1) -> None:
    """Count a refused (or detected) capacity truncation: every overflow
    must surface as a raised UnionOverflow, never a silent drop."""
    global _TRUNCATION_TALLY
    with _TALLY_LOCK:
        _TRUNCATION_TALLY += n


def truncation_count() -> int:
    with _TALLY_LOCK:
        return _TRUNCATION_TALLY


def reset_tallies() -> None:
    """Test/soak isolation: zero the process tallies."""
    global _PATH_TALLY, _TRUNCATION_TALLY
    with _TALLY_LOCK:
        _PATH_TALLY = {}
        _TRUNCATION_TALLY = 0


# ---- dispatcher -------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class UnionPlan:
    """One dispatch decision: which engine serves a join and why."""

    path: str                      # "bitmap" | "bucket" | "sort"
    reason: str
    universe: Optional[int] = None   # bitmap: declared tag universe
    n_buckets: Optional[int] = None  # bucket: static bucket count
    key_bits: int = PACKED_KEY_BITS


def bitmap_words(universe: int) -> int:
    """int32 words per lane a presence bitmap over ``universe`` tags needs."""
    return (int(universe) + 31) // 32


def plan_union(capacity: int, *, universe: Optional[int] = None,
               key_bits: int = PACKED_KEY_BITS,
               bucket_rows: int = DEFAULT_BUCKET_ROWS) -> UnionPlan:
    """The heuristic behind ``engine="auto"``:

    * **dense → bitmap**: a declared universe whose bitmap (ceil(U/32)
      words) fits within ``capacity`` rows moves no more bytes than the
      sorted table (traffic parity: U ≤ 32·C);
    * **key-budget sparse → bucket**: packed keys of a known bit width,
      at a power-of-two capacity of at least MIN_BUCKET_CAPACITY;
    * **otherwise → sort**.
    """
    if universe is not None and bitmap_words(universe) <= capacity:
        return UnionPlan(
            path="bitmap",
            reason=f"universe {universe} fits {bitmap_words(universe)} "
                   f"words <= capacity {capacity} (traffic parity)",
            universe=int(universe), key_bits=key_bits)
    if (key_bits <= PACKED_KEY_BITS and capacity >= MIN_BUCKET_CAPACITY
            and capacity & (capacity - 1) == 0):
        nb = max(2, capacity // bucket_rows)
        return UnionPlan(
            path="bucket",
            reason=f"{nb} buckets x {capacity // nb} rows over a "
                   f"{key_bits}-bit key space",
            n_buckets=nb, key_bits=key_bits)
    why = ("universe undeclared or over the 32*capacity traffic-parity "
           "bound" if universe is None or bitmap_words(universe) > capacity
           else "capacity below the bucketed minimum")
    return UnionPlan(path="sort", reason=why, key_bits=key_bits)


# ---- bitmap layout ----------------------------------------------------------
#
# A set over a declared tag universe U is two int32 bit planes of
# ceil(U/32) words per lane: ``present`` (tag observed) and ``removed``
# (tombstone; removed ⊆ present in any reachable state).  Tag t is bit
# t % 32 of word t // 32; bit 31 makes a word negative.

# 1 << b as int32 (bit 31 wraps to INT_MIN)
_BIT = np.left_shift(np.uint32(1), np.arange(32, dtype=np.uint32)).view(np.int32)


def _popcount(x: torch.Tensor) -> torch.Tensor:
    """Set bits of each int32 word (SWAR; torch has no int32 popcount).  The
    first two steps mask away what an arithmetic shift drags in from bit 31,
    and after the third every byte holds a count ≤ 8, so the rest is
    non-negative."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    x = x + (x >> 8)
    x = x + (x >> 16)
    return x & 0x3F


def sorted_to_bitmap(keys: torch.Tensor, vals: torch.Tensor, universe: int):
    """Canonical sorted planes (keys int32[C, L] + SENTINEL padding, vals
    0/1 int32[C, L]) → (present, removed) int32[W, L] bit planes.  Keys
    must be < ``universe``; the checked model wrappers validate that."""
    w = bitmap_words(universe)
    lanes = keys.shape[1]
    valid = keys != SENTINEL_PY
    # padding goes to a spare row w that is cut off; a key past the
    # universe follows JAX's .at[] rules (negative rows count from the end,
    # rows still outside the table are dropped), where torch would raise
    word = torch.where(valid, keys >> 5, w)
    word = torch.where(word < 0, word + (w + 1), word)
    word = torch.where((word < 0) | (word > w), w, word).long()
    bit = torch.as_tensor(_BIT, device=keys.device)[(keys & 31).long()]
    one = torch.where(valid, bit, 0)
    # unique keys per lane => distinct bits, so scatter-add == scatter-or
    # (int32 adds wrap, so bit 31 lands as INT_MIN)
    zeros = torch.zeros((w + 1, lanes), dtype=torch.int32, device=keys.device)
    present = zeros.scatter_add(0, word, one)
    removed = zeros.scatter_add(0, word, torch.where(vals != 0, one, 0))
    return present[:w], removed[:w]


def bitmap_union(present_a, removed_a, present_b, removed_b):
    """The bitmap engine's union: bitwise OR of both planes."""
    return present_a | present_b, removed_a | removed_b


def bitmap_count(present: torch.Tensor) -> torch.Tensor:
    """int32[L]: observed tag count per lane (popcount over the words)."""
    return _popcount(present).sum(dim=0, dtype=torch.int32)


def bitmap_to_sorted(present: torch.Tensor, removed: torch.Tensor, out_size: int):
    """Bit planes → canonical sorted planes, bit-identical to the sort
    path's output at the same ``out_size``: ascending keys, the smallest
    kept on truncation, SENTINEL / 0 past the tag count (also when the
    universe is smaller than ``out_size``), n_unique before truncation.

    The JAX package expands every bit to a (32·W, L) key plane and takes a
    bottom-k with ``top_k``; here each set bit's row is computed directly —
    the tags below it are the popcounts of the words before its word plus
    the set bits below it in its word — and scattered, one bit position at
    a time, so nothing of the universe's size is materialised per lane."""
    w, lanes = present.shape
    device = present.device
    counts = _popcount(present)
    below = torch.cumsum(counts, dim=0, dtype=torch.int32) - counts
    keys = torch.full((out_size + 1, lanes), SENTINEL_PY, dtype=torch.int32, device=device)
    vals = torch.zeros((out_size + 1, lanes), dtype=torch.int32, device=device)
    word_tag = (torch.arange(w, dtype=torch.int32, device=device) * 32)[:, None]
    for b in range(32):
        is_set = ((present >> b) & 1) != 0
        # rows past out_size (and unset bits) go to the spare row out_size
        row = torch.where(is_set & (below < out_size), below, out_size).long()
        keys.scatter_(0, row, (word_tag + b).expand(w, lanes))
        vals.scatter_(0, row, (removed >> b) & 1)
        below = below + is_set.to(torch.int32)
    return keys[:out_size], vals[:out_size], counts.sum(dim=0, dtype=torch.int32)


# ---- bucketed layout --------------------------------------------------------
#
# The (C, L) planes grouped into B segments of Wb = C/B rows; segment b
# holds only keys whose top bits equal b (bucket = key >> (key_bits -
# log2 B)), each segment ascending with its own SENTINEL tail.  The
# partition preserves key order, so the concatenated segments stay globally
# sorted with interior padding runs, and one stable sort restores the
# canonical form.


def bucket_shift(n_buckets: int, key_bits: int = PACKED_KEY_BITS) -> int:
    lb = n_buckets.bit_length() - 1
    if 1 << lb != n_buckets:
        raise ValueError(f"n_buckets {n_buckets} must be a power of 2")
    if lb > key_bits:
        raise ValueError(f"{n_buckets} buckets exceed a {key_bits}-bit key")
    return key_bits - lb


def sorted_to_bucketed(keys: torch.Tensor, vals: torch.Tensor, n_buckets: int,
                       key_bits: int = PACKED_KEY_BITS):
    """Canonical sorted planes → bucketed planes + per-lane dropped-row
    count (rows whose bucket was already full, or whose key exceeds the
    declared bit budget).  ``dropped`` must be ZERO for the layout to be
    faithful — the engine falls back to the sort path otherwise."""
    c, lanes = keys.shape
    wb = c // n_buckets
    if wb * n_buckets != c:
        raise ValueError(f"{n_buckets} buckets must divide C={c}")
    shift = bucket_shift(n_buckets, key_bits)
    device = keys.device
    valid = keys != SENTINEL_PY
    bucket = torch.where(valid, keys >> shift, n_buckets)
    # rows of one bucket are contiguous (keys sorted); the index within a
    # bucket is the distance from the start of its run
    i = torch.arange(c, dtype=torch.int32, device=device)[:, None].expand(c, lanes)
    prev_b = torch.cat([torch.full((1, lanes), -1, dtype=bucket.dtype, device=device),
                        bucket[:-1]], dim=0)
    run_start = torch.cummax(torch.where(bucket != prev_b, i, 0), dim=0).values
    idx = i - run_start
    ok = valid & (bucket < n_buckets) & (idx < wb)
    target = torch.where(ok, bucket * wb + idx, c).long()
    # dropped rows all land on the spare row c, which is cut off
    out_keys = torch.full((c + 1, lanes), SENTINEL_PY, dtype=torch.int32,
                          device=device).scatter_(0, target, keys)
    out_vals = torch.zeros((c + 1, lanes), dtype=torch.int32,
                           device=device).scatter_(0, target, torch.where(ok, vals, 0))
    dropped = (valid & ~ok).sum(dim=0, dtype=torch.int32)
    return out_keys[:c], out_vals[:c], dropped


def bucketed_to_sorted(keys: torch.Tensor, vals: torch.Tensor):
    """Bucketed planes → canonical sorted planes (+ n_unique[L]): one
    stable single-key sort sinks the interior padding runs."""
    keys, order = torch.sort(keys, dim=0, stable=True)
    pad = keys == SENTINEL_PY
    vals = vals.gather(0, order).masked_fill(pad, 0)
    return keys, vals, (~pad).sum(dim=0, dtype=torch.int32)


# ---- boundary-level engine wrappers ----------------------------------------
#
#   engine(keys_a, vals_a, keys_b, vals_b, out_size, **plan_kwargs)
#       -> (keys[out, L], vals[out, L], n_unique[L])
#
# bit-identical across engines.  The bucket and bitmap engines pay their
# conversions here; they win by staying resident in their layout across
# chained joins (orset.ORSetBucketed / ORSetBitmap), not per call.


def engine_sort(keys_a, vals_a, keys_b, vals_b, out_size, **_kw):
    return hopper_union.sorted_union_columnar(
        keys_a, vals_a, keys_b, vals_b, out_size=out_size)


def engine_bucket(keys_a, vals_a, keys_b, vals_b, out_size, *,
                  n_buckets: Optional[int] = None,
                  key_bits: int = PACKED_KEY_BITS, **_kw):
    """Sorted → bucketed → bucket-local union (lossless: each bucket keeps
    2·Wb rows) → sorted, cut to ``out_size`` globally — the sort path's
    truncation rule.  When an operand holds more than Wb keys of one bucket
    the conversion drops rows; this wrapper then serves the sort path
    (a host-side check, one device sync) and tallies
    ``bucket_fallback_sort``."""
    c = keys_a.shape[0]
    nb = n_buckets if n_buckets is not None else max(2, c // DEFAULT_BUCKET_ROWS)
    wb = c // nb
    ka, va, da = sorted_to_bucketed(keys_a, vals_a, nb, key_bits)
    kb, vb, db = sorted_to_bucketed(keys_b, vals_b, nb, key_bits)
    if bool(((da != 0) | (db != 0)).any()):
        record_union_path("bucket_fallback_sort")
        return engine_sort(keys_a, vals_a, keys_b, vals_b, out_size)
    ko, vo, nu, _ = hopper_union.bucketed_union_columnar(
        ka, va, kb, vb, n_buckets=nb, out_bucket_rows=2 * wb)
    keys, vals, _ = bucketed_to_sorted(ko, vo)
    return keys[:out_size].contiguous(), vals[:out_size].contiguous(), nu


def engine_bitmap(keys_a, vals_a, keys_b, vals_b, out_size, *,
                  universe: Optional[int] = None, **_kw):
    if universe is None:
        raise ValueError("the bitmap engine needs a declared universe")
    pa, ra = sorted_to_bitmap(keys_a, vals_a, universe)
    pb, rb = sorted_to_bitmap(keys_b, vals_b, universe)
    p, r = bitmap_union(pa, ra, pb, rb)
    return bitmap_to_sorted(p, r, out_size)


ENGINES = {
    "sort": engine_sort,
    "bucket": engine_bucket,
    "bitmap": engine_bitmap,
}


def get_engine(name: str):
    if name not in ENGINES:
        raise KeyError(f"unknown union engine {name!r}; known: "
                       f"{sorted(ENGINES)}")
    return ENGINES[name]


def dispatch_union(keys_a, vals_a, keys_b, vals_b, out_size, *,
                   engine: str = "auto", universe: Optional[int] = None,
                   registry=None):
    """Plan + record + run one boundary-level union over canonical sorted
    operands.  ``engine="auto"`` consults :func:`plan_union`; a named
    engine pins the path (still recorded) but passes the same
    preconditions plan_union applies — a pin that cannot be served raises a
    descriptive ValueError instead of failing inside the engine.
    Returns (keys, vals, n_unique, path)."""
    capacity = keys_a.shape[0]
    if engine == "auto":
        plan = plan_union(capacity, universe=universe)
    else:
        get_engine(engine)  # unknown names raise before anything tallies
        if engine == "bitmap" and universe is None:
            raise ValueError(
                "engine='bitmap' is pinned but no tag universe was "
                "declared; pass universe=<dense tag space> or use "
                "engine='auto'")
        if engine == "bucket" and (capacity < MIN_BUCKET_CAPACITY
                                   or capacity & (capacity - 1) != 0):
            raise ValueError(
                f"engine='bucket' needs a power-of-two capacity >= "
                f"{MIN_BUCKET_CAPACITY}, got {capacity}; use "
                f"engine='auto' for the sort fallback")
        plan = UnionPlan(path=engine, reason="caller-pinned",
                         universe=universe,
                         n_buckets=(max(2, capacity // DEFAULT_BUCKET_ROWS)
                                    if engine == "bucket" else None))
    record_union_path(plan.path, registry=registry)
    keys, vals, n = get_engine(plan.path)(
        keys_a, vals_a, keys_b, vals_b, out_size,
        universe=plan.universe, n_buckets=plan.n_buckets, key_bits=plan.key_bits)
    return keys, vals, n, plan.path
