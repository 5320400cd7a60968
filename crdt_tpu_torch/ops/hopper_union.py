"""Columnar sorted-set unions and merges: the hand-written Hopper kernels and
their plain PyTorch twins.

Counterpart of ``crdt_tpu.ops.pallas_union``.  Two CUDA sources:

* ``csrc/lexn_union.cu`` — the lexN family over N-word lexicographic keys:
  the fused union (``sorted_union_columnar_fused_lexn`` / ``_lex2``, the
  OpLog and RSeq swarm merges), the merge alone (``lexn_merge_columnar``)
  and the punch-and-compact alone (``lexn_compact_columnar``), duplicates
  OR-combined into the kept copy (OR-combine-then-keep-first); the host
  functions ``sorted_union_columnar_striped_lexn`` and
  ``sorted_union_columnar_lexn_auto`` serve capacities whose fused union
  does not fit a block's shared memory; and the fused union's GC instance
  (``gc_union_columnar_lexn``), which runs ``tomb_gc``'s floor rule in
  the wide body's flag pass for the GC join of ``models.rseq_engine`` and
  has no CPU twin of its own (the engine's composition is its twin);
* ``csrc/set_union.cu`` — the single-key OR-Set union
  (``sorted_union_columnar_fused``), its merge stage alone
  (``bitonic_merge_columnar``) and the bucket-local union
  (``bucketed_union_columnar``).

Beside them ``csrc/set_member.cu`` holds the OR-Set member mask, a kernel
of the port's own with no Pallas counterpart (``member_mask_plan``,
``member_mask_empty``, ``member_mask_launch``; its entry point and plain
twin are ``models.orset.columnar_member_mask``).

The single-key union, its merge (in the body's keep-all mode) and the
fused lexN union at narrow keys (the OpLog's (hi, lo)) share one body, the
lane tile of ``csrc/tile_union.cuh``; the fused lexN union at wide keys
(RSeq's 18 words) runs the wide body of ``csrc/lexn_union.cu``, 8-CTA
clusters like the merge's; the bucket-local union runs a wide-lane segment
body of ``csrc/set_union.cu``.  Each body's plan and shared memory are
worked out here from the shape (``set_union_plan``, ``merge_plan``,
``bucketed_union_plan``, ``lexn_union_body``) and passed to the launch.

The host contract is the JAX one: planes are ``(C, L)`` int32 with lane j
holding one replica's rows, per-lane sorted ascending over the key words,
padding rows SENTINEL in every key word and 0 in every value plane; C is a
power of two.  A union returns the smallest ``out_size`` rows of the union
(SENTINEL / 0 past the unique count) and the pre-truncation ``n_unique``
per lane.  The lexN family takes its operands' planes as sequences (or
(P, C, L) tensors) and returns them as one contiguous (P, out, L) tensor a
side, keys and values, so a caller that holds planes stacked needs no
copy.  A row whose key is SENTINEL is padding, value included.  Lane
counts need no multiple of 128: that tile was the TPU's.

Dispatch: a CUDA tensor launches the kernel (or raises); a CPU tensor runs
the plain twin.  There is no fallback from one to the other.  ``LAUNCHES``
counts kernel launches by kernel name.
"""
from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from crdt_tpu_torch import _build
from crdt_tpu_torch.ops import pack
from crdt_tpu_torch.ops.sorted_union import _sort_by_keys
from crdt_tpu_torch.utils.constants import SENTINEL_PY
from crdt_tpu_torch.utils.tracing import trace_region

LAUNCHES = {"lexn_union": 0, "set_union": 0, "merge": 0, "bucketed_union": 0,
            "lexn_merge": 0, "lexn_compact": 0, "floor_union": 0,
            "bucketed_floor_union": 0, "member_mask": 0, "lexn_gc_union": 0}

# key + value planes a side that one lexN launch takes (csrc/lexn_union.cu
# kMaxPlanes): RSeq at depth 9 with its GC join's three value planes
MAX_PLANES = 32
# shared memory a block may opt in to on an H100 (sm_90); the CPU path
# plans with it so that the tests see the card's dispatch
HOPPER_SMEM_OPTIN = 232_448


def _check_planes(planes: Sequence[torch.Tensor], shape, device) -> None:
    shape = torch.Size(shape)
    for p in planes:
        if not isinstance(p, torch.Tensor):
            raise TypeError(f"plane is {type(p).__name__}, not a tensor")
        if p.dtype != torch.int32:
            raise TypeError(f"plane dtype {p.dtype} is not int32")
        if p.shape != shape:
            raise ValueError(f"plane shape {tuple(p.shape)} != {tuple(shape)}")
        if p.device != device:
            raise ValueError(f"plane on {p.device}, expected {device}")
        if not p.is_contiguous():
            raise ValueError("planes must be contiguous (C, L) int32; call "
                             ".contiguous() on sliced or broadcast planes")


def _route(name: str, device: torch.device) -> bool:
    """True for the CPU twin, False for the CUDA kernel; raises otherwise."""
    if device.type == "cpu":
        return True
    if device.type != "cuda":
        raise ValueError(f"no {name} kernel for device {device}")
    return False


# ---- the lexN family: envelopes ----
#
# Each kernel's shared memory per block, by csrc/lexn_union.cu's layouts
# (the launchers take these byte counts), against the card's opt-in limit.
# Pure functions of the shape and the limit, so the CPU tests plan with
# HOPPER_SMEM_OPTIN.


# the lane-tile union (csrc/tile_union.cuh), the body of kernel 2 and of
# kernel 1 at narrow keys: threads a CTA, key words it takes, rows of an
# operand whose source fits its map's 15 bits
_TILE_THREADS = 512
TILE_MAX_KEYS = 4
TILE_MAX_ROWS = 16_384
# lanes a tile, widest first: 8 make each row of a plane one 32 B sector
TILE_LANES = (8, 4, 2, 1)


def tile_union_smem_bytes(n_keys: int, n_vals: int, c: int, out: int,
                          plan: tuple[int, int, int], keep_all: bool = False) -> int:
    """The tile body, per CTA, under ``plan`` = (lane tile, key stages,
    values staged): the key-word buffers of both operands, one buffer of
    their value planes when staged, the map (a word an output row a lane,
    or half a word in the keep-all mode of the merge), and the scan's warp
    sums and the lanes' totals."""
    lt, stages, stage_vals = plan
    map_bytes = 2 if keep_all else 4
    return (4 * lt * (stages * 2 * n_keys * c + stage_vals * 2 * n_vals * c
                      + _TILE_THREADS // 32 + 1)
            + map_bytes * out * lt)


# the tile body's (key stages, values staged), best first: the next
# tile's keys load while this one works, and the values stage as whole
# sectors
_TILE_STAGINGS = ((2, 1), (1, 1), (2, 0), (1, 0))


def _tile_plan(n_keys: int, n_vals: int, c: int, out: int, lane_tiles,
               limit: int, keep_all: bool = False) -> tuple[int, int, int] | None:
    """The first (lane tile, stages, values staged) of ``lane_tiles`` x
    ``_TILE_STAGINGS`` whose shared memory fits ``limit`` bytes."""
    for lt in lane_tiles:
        for stages, stage_vals in _TILE_STAGINGS:
            plan = (lt, stages, stage_vals)
            if tile_union_smem_bytes(n_keys, n_vals, c, out, plan, keep_all) <= limit:
                return plan
    return None


# the wide body of the fused union (csrc/lexn_union.cu wide_union_kernel):
# clusters of 8 CTAs a tile of 8 lanes, each CTA one lane's staged keys.
# Its plan is (8, 0, k): 8 lanes a cluster, no key stages of the tile's
# kind, and k CTAs of 1,024 / k threads an SM, the most of 1, 2, 4 and 8
# whose shared memory fits the SM
WIDE_LANES = 8
_WIDE_WARPS = 1024 // 32
# shared memory of an H100 SM (228 KB) and what it reserves for each CTA
HOPPER_SMEM_PER_SM = 233_472
_SMEM_PER_CTA_RESERVED = 1024


def _key_stride(n_keys: int) -> int:
    """Words of a staged key row: ``n_keys`` rounded up to 16 B."""
    return (n_keys + 3) & ~3


def lexn_wide_smem_bytes(n_keys: int, c: int) -> int:
    """The wide body, per CTA: its lane's key rows of both operands (C rows
    of ``n_keys`` rounded up to 4 words each), the map (a word a merged
    row), the scan's warp sums and a flag byte a merged row."""
    return 4 * (2 * c * _key_stride(n_keys) + 2 * c + _WIDE_WARPS) + 2 * c


def wide_threads(plan: tuple[int, int, int]) -> int:
    """Threads a CTA of the wide body's ``plan``."""
    return 1024 // plan[2]


def _wide_plan(smem: int) -> tuple[int, int, int]:
    """The wide body's plan (8, 0, CTAs an SM) at ``smem`` bytes a CTA."""
    per_cta = smem + _SMEM_PER_CTA_RESERVED
    ctas = next((k for k in (8, 4, 2) if k * per_cta <= HOPPER_SMEM_PER_SM), 1)
    return WIDE_LANES, 0, ctas


def lexn_union_body(n_keys: int, n_vals: int, c: int, out: int,
                    limit: int) -> tuple[int, int, int]:
    """The fused union's body: (lane tile, key stages, values staged) of
    the tile body at 8 lanes where it fits ``limit`` bytes, else the wide
    body's (8, 0, CTAs an SM)."""
    if n_keys <= TILE_MAX_KEYS and c <= TILE_MAX_ROWS:
        plan = _tile_plan(n_keys, n_vals, c, out, (8,), limit)
        if plan is not None:
            return plan
    return _wide_plan(lexn_wide_smem_bytes(n_keys, c))


# merged rows a wide-body thread ranks at most (csrc/lexn_union.cu
# kWideRankRows): 2C may not pass that many times the CTA's threads
_WIDE_RANK_ROWS = 8


def lexn_gc_union_smem_bytes(n_keys: int, c: int, n_writers: int) -> int:
    """The wide body's GC instance, per CTA: the wide body's layout and
    the owner lane's floor column of each side (a word a writer)."""
    return lexn_wide_smem_bytes(n_keys, c) + 4 * 2 * n_writers


def lexn_gc_union_plan(n_keys: int, n_vals: int, c: int, n_writers: int,
                       limit: int) -> tuple[int, int, int] | None:
    """The wide body's plan for the GC join's union (the floor rule in its
    flag pass) on a card with ``limit`` bytes of shared memory a block, or
    None where the GC instance cannot take the shape: its shared memory past
    ``limit`` (RSeq's 18 words at C = 2048, or floors too wide), more
    planes than a launch takes, or 2C rows past its threads' reach."""
    smem = lexn_gc_union_smem_bytes(n_keys, c, n_writers)
    if n_keys + n_vals > MAX_PLANES or smem > limit:
        return None
    plan = _wide_plan(smem)
    return plan if 2 * c <= _WIDE_RANK_ROWS * wide_threads(plan) else None


def lexn_union_smem_bytes(n_keys: int, n_vals: int, c: int, out: int | None = None,
                          limit: int = HOPPER_SMEM_OPTIN) -> int:
    """The fused union's shared memory a CTA in the body that the shape
    takes on a card with ``limit`` bytes a block (``out`` defaults to
    2C)."""
    out = 2 * c if out is None else out
    plan = lexn_union_body(n_keys, n_vals, c, out, limit)
    if plan[1] == 0:
        return lexn_wide_smem_bytes(n_keys, c)
    return tile_union_smem_bytes(n_keys, n_vals, c, out, plan)


def lexn_merge_smem_bytes(n_keys: int, s: int) -> int:
    """The merge, per CTA of its 8-CTA cluster: the CTA's lane's key words
    of both operands, row by row at a stride of ``n_keys`` rounded up to 4
    words, and its merge map (one word an output row)."""
    return 4 * (2 * s * _key_stride(n_keys) + 2 * s)


# the compaction's gather-map window (csrc/lexn_union.cu kWindowWords) and
# scan sums (kCompactWarps x kTile), in words
_COMPACT_FIXED_WORDS = 8192 + 64
# lanes a compaction CTA takes, widest first: 8 fill a 32 B sector a row
COMPACT_LANE_TILES = (8, 4, 2, 1)


def lexn_compact_smem_bytes(n_rows: int, lane_tile: int) -> int:
    """The compaction, per CTA of ``lane_tile`` lanes: one flag byte a row
    a lane, the gather-map window and the scan's sums."""
    return 4 * _COMPACT_FIXED_WORDS + lane_tile * n_rows


def lexn_compact_tile(n_rows: int, limit: int) -> int:
    """The widest lane tile whose compaction over ``n_rows``-row planes
    fits ``limit`` bytes (0 when not even one lane does)."""
    for lt in COMPACT_LANE_TILES:
        if lexn_compact_smem_bytes(n_rows, lt) <= limit:
            return lt
    return 0


def lexn_fits(c: int, n_keys: int, n_vals: int, limit: int) -> bool:
    """Whether one fused union at capacity ``c`` (untruncated) fits a
    block's ``limit`` bytes of shared memory in either body."""
    return lexn_union_smem_bytes(n_keys, n_vals, c, limit=limit) <= limit


def lexn_compact_fits(n_rows: int, limit: int) -> bool:
    """Whether one compaction over ``n_rows``-row planes (2C for a union
    epilogue) fits ``limit`` bytes, at any lane tile."""
    return lexn_compact_tile(n_rows, limit) > 0


def _lexn_stripe_for(c: int, n_keys: int, limit: int) -> int:
    """The largest power-of-two stripe ``s <= c`` whose merge fits ``limit``
    bytes (0 when not even one row does)."""
    s = c
    while s >= 1 and lexn_merge_smem_bytes(n_keys, s) > limit:
        s //= 2
    return s


def lexn_plan(c: int, n_keys: int, n_vals: int, limit: int) -> int | None:
    """The union's route on a card with ``limit`` bytes of shared memory a
    block: None for the fused kernel, else the stripe of the striped path
    (merge kernels, then one compaction over 2C rows).  Raises ValueError
    with the figures when neither fits.  Fused wherever a body fits: at
    RSeq's 18 words and C = 1024 the wide body took 3.05 ms against the
    stripe's 6.00 at (18, 2), out = C, and 3.85 against 6.64 at (18, 3),
    out = 2C (device time, L = 10,240, NVIDIA H100 80GB HBM3 at 700 W)."""
    if lexn_fits(c, n_keys, n_vals, limit):
        return None
    s = _lexn_stripe_for(c, n_keys, limit)
    if s < 1 or not lexn_compact_fits(2 * c, limit):
        raise ValueError(
            f"lexN union at C={c} with {n_keys} key words does not fit {limit} B "
            f"of shared memory a block: the merge needs "
            f"{lexn_merge_smem_bytes(n_keys, 1)} B at a stripe of one row, the "
            f"compaction {lexn_compact_smem_bytes(2 * c, 1)} B over 2C rows at one lane "
            f"a block"
        )
    return s


def smem_limit(device: torch.device) -> int:
    """Shared memory a block may opt in to on ``device``'s card; the H100's
    for a CPU tensor, whose twins stand in for the kernels."""
    if _route("lexn_union", device):
        return HOPPER_SMEM_OPTIN
    return torch.cuda.get_device_properties(device).shared_memory_per_block_optin


# ---- the lexN family: entry points ----


def _lexn_shape(keys_a, vals_a, keys_b=None, vals_b=None):
    """(n_keys, n_vals, rows, lanes, device) of matching lexN operands,
    validated; the B side is optional (the compaction has one operand)."""
    keys_a, vals_a = tuple(keys_a), tuple(vals_a)
    n_keys, n_vals = len(keys_a), len(vals_a)
    if keys_b is not None and (len(keys_b) != n_keys or len(vals_b) != n_vals):
        raise ValueError(
            f"plane counts differ: keys {n_keys}/{len(keys_b)}, "
            f"vals {n_vals}/{len(vals_b)}"
        )
    if n_keys < 1:
        raise ValueError("a lexN key needs at least one word")
    first = keys_a[0]
    if first.dim() != 2:
        raise ValueError(f"planes must be (C, L), got shape {tuple(first.shape)}")
    rows, lanes = first.shape
    if rows < 1 or rows & (rows - 1):
        raise ValueError(f"capacity {rows} must be a power of two")
    planes = keys_a + vals_a
    if keys_b is not None:
        planes += tuple(keys_b) + tuple(vals_b)
    _check_planes(planes, (rows, lanes), first.device)
    return n_keys, n_vals, rows, lanes, first.device


def _lexn_out(c: int, out_size: int | None) -> int:
    out = 2 * c if out_size is None else out_size
    if not 0 <= out <= 2 * c:
        raise ValueError(f"out_size {out} outside [0, 2C={2 * c}]")
    return out


def sorted_union_columnar_fused_lexn(
    keys_a, vals_a, keys_b, vals_b, out_size: int | None = None,
):
    """Fused batched sorted-set union with an N-word lexicographic key.
    Returns (keys[n_keys, out, L], vals[n_vals, out, L], n_unique[L]);
    n_unique is the pre-truncation unique count, so overflow (n_unique >
    out_size) stays detectable."""
    keys_a, vals_a, keys_b, vals_b = map(tuple, (keys_a, vals_a, keys_b, vals_b))
    _, _, c, _, device = _lexn_shape(keys_a, vals_a, keys_b, vals_b)
    out = _lexn_out(c, out_size)
    if _route("lexn_union", device):
        return _lexn_union_plain(keys_a, vals_a, keys_b, vals_b, out)
    return _lexn_union_cuda(keys_a, vals_a, keys_b, vals_b, out, smem_limit(device))


def sorted_union_columnar_fused_lex2(
    keys_a, vals_a, keys_b, vals_b, out_size: int | None = None,
):
    """The two-word special case — the OpLog swarm merge
    (``crdt_tpu_torch.models.oplog_columnar``).  Returns
    ((hi, lo), vals[n_vals, out, L], n_unique[L])."""
    keys, vals, nu = sorted_union_columnar_fused_lexn(
        keys_a, vals_a, keys_b, vals_b, out_size=out_size
    )
    return (keys[0], keys[1]), vals, nu


def lexn_merge_columnar(keys_a, vals_a, keys_b, vals_b):
    """Merge only (kernel #4): lane j of the (2S, L) output planes is the
    sorted merge of lane j of both (S, L) operands — the exact multiset,
    every value plane carried, padding rows sorted to the tail.  Of two
    equal keys A's copy comes first (the TPU's bitonic network left that
    order open).  Returns (keys[n_keys, 2S, L], vals[n_vals, 2S, L])."""
    keys_a, vals_a, keys_b, vals_b = map(tuple, (keys_a, vals_a, keys_b, vals_b))
    _, _, _, _, device = _lexn_shape(keys_a, vals_a, keys_b, vals_b)
    if _route("lexn_merge", device):
        return _lexn_merge_plain(keys_a, vals_a, keys_b, vals_b)
    return _lexn_merge_cuda(keys_a, vals_a, keys_b, vals_b)


def lexn_compact_columnar(keys, vals, out_size: int):
    """Duplicate punch + compaction + truncation (kernel #5) over (n, L)
    planes sorted per lane (n = 2C for a union epilogue): adjacent
    duplicates OR their values into the first copy and the second becomes a
    hole, the kept rows move to the head, ``out_size`` rows are kept.
    Returns (keys[n_keys, out, L], vals[n_vals, out, L], n_unique[L]),
    n_unique before truncation."""
    keys, vals = tuple(keys), tuple(vals)
    _, _, n, _, device = _lexn_shape(keys, vals)
    if not 0 <= out_size <= n:
        raise ValueError(f"out_size {out_size} outside [0, {n}]")
    if _route("lexn_compact", device):
        return _lexn_compact_plain(keys, vals, out_size)
    return _lexn_compact_cuda(keys, vals, out_size)


def sorted_union_columnar_striped_lexn(
    keys_a, vals_a, keys_b, vals_b, out_size: int | None = None,
    stripe: int | None = None,
):
    """Capacity-striped lexN union: the contract of
    :func:`sorted_union_columnar_fused_lexn` at capacities whose fused
    kernel does not fit a block's shared memory.

    1. each operand's C sorted rows are M = C/S stripes of S rows, sorted
       across stripe boundaries (the sorted-with-tail-padding invariant);
    2. a block-level bitonic merge network over the 2M stripes — A's in
       order, then B's in reverse order — with :func:`lexn_merge_columnar`
       as the merge-split: M·log2(2M) merge launches.  The merge keeps the
       exact multiset, so the scalar bitonic-merge theorem carries over;
    3. the stripes are concatenated back into (2C, L) planes (one more pass
       over them; at M = 1 the merge's own output goes on), then one
       :func:`lexn_compact_columnar`.

    ``stripe`` defaults to the largest that the card's shared memory takes
    (:func:`_lexn_stripe_for`).  Returns (keys[n_keys, out, L],
    vals[n_vals, out, L], n_unique[L]), n_unique before truncation."""
    keys_a, vals_a, keys_b, vals_b = map(tuple, (keys_a, vals_a, keys_b, vals_b))
    n_keys, _, c, _, device = _lexn_shape(keys_a, vals_a, keys_b, vals_b)
    out = _lexn_out(c, out_size)
    s = stripe if stripe is not None else _lexn_stripe_for(c, n_keys, smem_limit(device))
    if s < 1 or s & (s - 1) or c % s:
        raise ValueError(f"stripe {s} must be a power-of-two divisor of capacity {c}")
    return _striped_lexn(keys_a, vals_a, keys_b, vals_b, out, s)


def _striped_lexn(keys_a, vals_a, keys_b, vals_b, out: int, s: int):
    """The striped union over validated operands at stripe ``s``."""
    n_keys, n_vals, c = len(keys_a), len(vals_a), keys_a[0].shape[0]
    m = c // s
    if m == 1:  # one merge: its (P, 2C, L) blocks are the compaction's input
        keys, vals = lexn_merge_columnar(keys_a, vals_a, keys_b, vals_b)
        return lexn_compact_columnar(keys, vals, out)

    def rows(planes, lo, hi):
        return tuple(p[lo:hi] for p in planes)

    blocks = (
        [(rows(keys_a, i * s, (i + 1) * s), rows(vals_a, i * s, (i + 1) * s))
         for i in range(m)]
        + [(rows(keys_b, i * s, (i + 1) * s), rows(vals_b, i * s, (i + 1) * s))
           for i in reversed(range(m))]
    )

    def merge_split(x, y):
        ko, vo = lexn_merge_columnar(x[0], x[1], y[0], y[1])
        return (rows(ko, 0, s), rows(vo, 0, s)), (rows(ko, s, 2 * s), rows(vo, s, 2 * s))

    def bmerge(bs):
        if len(bs) == 1:
            return bs
        half = len(bs) // 2
        for i in range(half):
            bs[i], bs[i + half] = merge_split(bs[i], bs[i + half])
        return bmerge(bs[:half]) + bmerge(bs[half:])

    blocks = bmerge(blocks)
    keys = tuple(torch.cat([b[0][i] for b in blocks], dim=0) for i in range(n_keys))
    vals = tuple(torch.cat([b[1][i] for b in blocks], dim=0) for i in range(n_vals))
    return lexn_compact_columnar(keys, vals, out)


def sorted_union_columnar_lexn_auto(
    keys_a, vals_a, keys_b, vals_b, out_size: int | None = None,
):
    """The lexN union by the card's envelope (:func:`lexn_plan`): the fused
    kernel where it fits a block's shared memory, the striped path with the
    largest stripe that fits beyond it (RSeq's 18 key words at C = 2048).
    A CPU tensor always takes the fused union's twin, as the JAX package's
    interpret mode always takes the monolith; the results are the same.
    The operands are validated once, here."""
    with trace_region("crdt.union_lexn"):
        keys_a, vals_a, keys_b, vals_b = map(tuple, (keys_a, vals_a, keys_b, vals_b))
        n_keys, n_vals, c, _, device = _lexn_shape(keys_a, vals_a, keys_b, vals_b)
        out = _lexn_out(c, out_size)
        if _route("lexn_union", device):
            return _lexn_union_plain(keys_a, vals_a, keys_b, vals_b, out)
        limit = smem_limit(device)
        stripe = lexn_plan(c, n_keys, n_vals, limit)
        if stripe is None:
            return _lexn_union_cuda(keys_a, vals_a, keys_b, vals_b, out, limit)
        return _striped_lexn(keys_a, vals_a, keys_b, vals_b, out, stripe)


def gc_union_columnar_lexn(keys_a, vals_a, floor_a, keys_b, vals_b, floor_b,
                           seq_bits: int):
    """Kernel 1's GC instance: the fused lexN union with ``tomb_gc``'s
    floor rule in its flag pass, the row work of the GC join.  A kept row
    with no equal key on the other side whose identity word (the last key
    word, ``rid << seq_bits | seq``) the OTHER side's floor covers (``0 <=
    rid < W`` and ``seq <= floor[rid]``, floors (W, L) int32) is dropped
    before the compaction and the truncation to C rows, the joined lane's
    capacity.  Returns (keys[n_keys, C, L], vals[n_vals, C, L], n_unique[L],
    dropped[L]): the kept rows after the rule and before truncation, and
    the rows the rule took out.  CUDA tensors only, in a shape that
    :func:`lexn_gc_union_plan` takes; the plain twin is the lossless union's
    followed by the rule (``models.rseq_engine``)."""
    with trace_region("crdt.union_lexn"):
        keys_a, vals_a, keys_b, vals_b = map(tuple, (keys_a, vals_a, keys_b, vals_b))
        n_keys, n_vals, c, lanes, device = _lexn_shape(keys_a, vals_a, keys_b, vals_b)
        if _route("lexn_gc_union", device):
            raise ValueError("the GC union's kernel takes CUDA tensors; its plain twin is "
                             "the lossless union followed by the floor rule")
        if floor_a.dim() != 2:
            raise ValueError(f"floors must be (W, L), got shape {tuple(floor_a.shape)}")
        _check_planes((floor_a, floor_b), (floor_a.shape[0], lanes), device)
        if not 0 <= seq_bits < 32:
            raise ValueError(f"seq_bits {seq_bits} outside [0, 32)")
        n_writers = floor_a.shape[0]
        limit = smem_limit(device)
        plan = lexn_gc_union_plan(n_keys, n_vals, c, n_writers, limit)
        if plan is None:
            raise ValueError(
                f"the GC union at C={c} with {n_keys} key words and {n_writers} writers "
                f"does not fit the wide body ({lexn_gc_union_smem_bytes(n_keys, c, n_writers)} "
                f"B of shared memory a block, {limit} B allowed)")
        dropped = torch.empty((lanes,), dtype=torch.int32, device=device)
        keys, vals, nu = _lexn_launch(
            "lexn_gc_union", n_keys, n_vals, c, lanes, device,
            lexn_gc_union_smem_bytes(n_keys, c, n_writers),
            lambda lib, o, nu, smem, st: lib.lexn_gc_union(
                n_keys, n_vals, _ptrs(keys_a + vals_a), _ptrs(keys_b + vals_b),
                floor_a.data_ptr(), floor_b.data_ptr(), _block_ptrs(o), nu.data_ptr(),
                dropped.data_ptr(), c, lanes, n_writers, seq_bits, plan[0], plan[2], smem, st))
        return keys, vals, nu, dropped


# ---- the lexN family: launches ----

_P = ctypes.c_void_p
_I = ctypes.c_int
_PP = ctypes.POINTER(_P)
# the C entry points of each csrc/<name>.cu: (argtypes, restype)
_SIGNATURES = {
    "lexn_union": {
        "lexn_union": ([_I, _I, _PP, _PP, _PP, _P, _I, _I, _I, _I, _I, _I, _I, _P], _I),
        "lexn_merge": ([_I, _I, _PP, _PP, _PP, _I, _I, _I, _P], _I),
        "lexn_compact": ([_I, _I, _PP, _PP, _P, _I, _I, _I, _I, _I, _P], _I),
        "lexn_gc_union": ([_I, _I, _PP, _PP, _P, _P, _PP, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                           _P], _I),
        "lexn_merge_clusters": ([_I], _I),
        "lexn_union_error_string": ([_I], ctypes.c_char_p),
    },
    "set_union": {
        "set_union": ([_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P], _I),
        "set_merge": ([_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P], _I),
        "bucketed_union": ([_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                            _P], _I),
        "set_union_error_string": ([_I], ctypes.c_char_p),
    },
    "set_floor": {
        "floor_union": ([_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P], _I),
        "bucketed_floor_walk": ([_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P], _I),
        "set_floor_error_string": ([_I], ctypes.c_char_p),
    },
    "set_member": {
        "member_mask": ([_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P], _I),
        "set_member_error_string": ([_I], ctypes.c_char_p),
    },
}


def _lib(name: str) -> ctypes.CDLL:
    """The built library of ``csrc/<name>.cu`` with its C signatures bound."""
    lib = _build.load(name)
    if not getattr(lib, "_crdt_bound", False):
        for fn, (args, res) in _SIGNATURES[name].items():
            getattr(lib, fn).argtypes = args
            getattr(lib, fn).restype = res
        lib._crdt_bound = True
    return lib


def _ptrs(ts):
    return (ctypes.c_void_p * len(ts))(*[t.data_ptr() for t in ts])


def _block_ptrs(block: torch.Tensor):
    """The plane pointers of a contiguous (P, rows, L) int32 block."""
    base, step = block.data_ptr(), 4 * block.stride(0)
    return (ctypes.c_void_p * block.shape[0])(*(base + i * step for i in range(block.shape[0])))


def _lexn_launch(name, n_keys, n_vals, rows_out, lanes, device, smem, launch):
    """Allocate the outputs of one lexN launch as one (n_keys + n_vals,
    rows_out, L) block, run ``launch(lib, outs, nu, smem, stream)`` with
    ``smem`` bytes of shared memory a block and check its error code.
    Returns (keys block, vals block, nu)."""
    n_planes = n_keys + n_vals
    if n_planes > MAX_PLANES:
        raise ValueError(
            f"{name}: {n_planes} key and value planes a side exceed the "
            f"kernel's {MAX_PLANES} (csrc/lexn_union.cu kMaxPlanes)"
        )
    outs = torch.empty((n_planes, rows_out, lanes), dtype=torch.int32, device=device)
    nu = torch.empty((lanes,), dtype=torch.int32, device=device)
    if lanes > 0:
        lib = _lib("lexn_union")
        with torch.cuda.device(device):
            err = launch(lib, outs, nu, smem, torch.cuda.current_stream(device).cuda_stream)
        if err != 0:
            # a shape whose shared memory passes the card's opt-in limit
            # (227 KB on Hopper) fails here, at cudaFuncSetAttribute; a
            # merge cluster the card cannot place, at the occupancy query
            raise RuntimeError(
                f"{name} launch failed: {lib.lexn_union_error_string(err).decode()} "
                f"(L={lanes}, {smem} B of shared memory per block, "
                f"{smem_limit(device)} B allowed)"
            )
        LAUNCHES[name] += 1
    return outs[:n_keys], outs[n_keys:], nu


def _lexn_union_cuda(keys_a, vals_a, keys_b, vals_b, out, limit=None):
    n_keys, n_vals = len(keys_a), len(vals_a)
    c, lanes = keys_a[0].shape
    limit = smem_limit(keys_a[0].device) if limit is None else limit
    plan = lexn_union_body(n_keys, n_vals, c, out, limit)
    return _lexn_launch(
        "lexn_union", n_keys, n_vals, out, lanes, keys_a[0].device,
        lexn_union_smem_bytes(n_keys, n_vals, c, out, limit),
        lambda lib, o, nu, smem, st: lib.lexn_union(
            n_keys, n_vals, _ptrs(keys_a + vals_a), _ptrs(keys_b + vals_b),
            _block_ptrs(o), nu.data_ptr(), c, lanes, out, *plan, smem, st))


def _lexn_merge_cuda(keys_a, vals_a, keys_b, vals_b):
    n_keys, n_vals = len(keys_a), len(vals_a)
    s, lanes = keys_a[0].shape
    keys, vals, _ = _lexn_launch(
        "lexn_merge", n_keys, n_vals, 2 * s, lanes, keys_a[0].device,
        lexn_merge_smem_bytes(n_keys, s),
        lambda lib, o, nu, smem, st: lib.lexn_merge(
            n_keys, n_vals, _ptrs(keys_a + vals_a), _ptrs(keys_b + vals_b),
            _block_ptrs(o), s, lanes, smem, st))
    return keys, vals


def _lexn_compact_cuda(keys, vals, out):
    n_keys, n_vals = len(keys), len(vals)
    n, lanes = keys[0].shape
    device = keys[0].device
    lt = lexn_compact_tile(n, smem_limit(device)) or 1
    return _lexn_launch(
        "lexn_compact", n_keys, n_vals, out, lanes, device,
        lexn_compact_smem_bytes(n, lt),
        lambda lib, o, nu, smem, st: lib.lexn_compact(
            n_keys, n_vals, _ptrs(keys + vals), _block_ptrs(o), nu.data_ptr(), n,
            lanes, out, lt, smem, st))


def lexn_merge_clusters(n_keys: int, s: int) -> int:
    """How many of the merge's 8-CTA clusters the current card holds at
    once at stripe ``s`` (``cudaOccupancyMaxActiveClusters``); 0 means the
    card cannot place one and the merge's launch raises."""
    lib = _lib("lexn_union")
    got = lib.lexn_merge_clusters(lexn_merge_smem_bytes(n_keys, s))
    if got < 0:
        raise RuntimeError(f"lexn_merge cluster query failed: "
                           f"{lib.lexn_union_error_string(-got).decode()}")
    return got


# ---- the lexN family: plain twins ----
#
# They work on (L, rows) views, rows along the last dimension.


def _block(rows, like):
    """(L, n) row tensors as one contiguous (P, n, L) block of planes (the
    kernels' output layout); ``like`` shapes an empty block."""
    if not rows:
        return like.new_empty((0, like.shape[1], like.shape[0]))
    return torch.stack([r.T for r in rows])


def _merged_rows(keys_a, vals_a, keys_b, vals_b):
    """Stable lexicographic sort of A's rows then B's, per lane: (keys,
    vals) lists of (L, 2C) tensors, A's copy of an equal key first."""
    keys = [torch.cat([a, b], dim=0).T for a, b in zip(keys_a, keys_b)]
    vals = [torch.cat([a, b], dim=0).T for a, b in zip(vals_a, vals_b)]
    return _sort_by_keys(keys, vals, len(keys))


def _compacted_rows(keys, vals, out):
    """Duplicate punch (OR-combine-then-keep-first), compaction by a stable
    sort of the hole flags and truncation to ``out`` rows, over (L, n)
    rows; returns (keys, vals) blocks of (out, L) planes and n_unique."""
    dup = keys[0] != SENTINEL_PY
    for k in keys:
        prev = torch.cat([torch.full_like(k[:, :1], SENTINEL_PY), k[:, :-1]], dim=1)
        dup = dup & (k == prev)
    next_dup = torch.cat([dup[:, 1:], torch.zeros_like(dup[:, :1])], dim=1)
    vals = [torch.where(next_dup, v | torch.roll(v, -1, dims=1), v) for v in vals]
    keys = [k.masked_fill(dup, SENTINEL_PY) for k in keys]

    hole = keys[0] == SENTINEL_PY
    n_unique = (~hole).sum(dim=1, dtype=torch.int32)
    order = torch.sort(hole.to(torch.uint8), dim=1, stable=True).indices
    hole = hole.gather(1, order)
    keys = [k.gather(1, order).masked_fill(hole, SENTINEL_PY) for k in keys]
    vals = [v.gather(1, order).masked_fill(hole, 0) for v in vals]
    keys = [k[:, :out] for k in keys]
    return _block(keys, keys[0]), _block([v[:, :out] for v in vals], keys[0]), n_unique


def _lexn_union_plain(keys_a, vals_a, keys_b, vals_b, out):
    """The fused union's plain twin: the merge twin, then the compaction
    twin."""
    return _compacted_rows(*_merged_rows(keys_a, vals_a, keys_b, vals_b), out)


def _lexn_merge_plain(keys_a, vals_a, keys_b, vals_b):
    """Kernel #4's plain twin: a stable lexicographic sort of the 2S rows
    per lane, A's rows first."""
    keys, vals = _merged_rows(keys_a, vals_a, keys_b, vals_b)
    return _block(keys, keys[0]), _block(vals, keys[0])


def _lexn_compact_plain(keys, vals, out):
    """Kernel #5's plain twin: the punch and the stable sort of the hole
    flags, over (n, L) planes."""
    return _compacted_rows([k.T for k in keys], [v.T for v in vals], out)


# ---- single-key OR-Set union, its merge stage, the bucket-local union ----
#
# csrc/set_union.cu's three entries: set_union (the whole lane, cut to
# `out` rows) and set_merge on the lane tile, bucketed_union (each bucket
# of Wb rows cut to `out_r` rows) on the segment body.  Values are
# OR-combined on duplicate keys (the OR-Set tombstone rule); the TPU
# kernels took values < 2^15 only, the port any int32.


def _check_columnar(keys_a, vals_a, keys_b, vals_b, pow2: bool = True):
    """(C, L) of four matching planes; C must be a power of two for the
    full-lane union and merge (the bucketed layout needs only a
    power-of-two bucket width)."""
    if not isinstance(keys_a, torch.Tensor) or keys_a.dim() != 2:
        raise ValueError("planes must be (C, L) int32 tensors")
    c, lanes = keys_a.shape
    if pow2 and (c < 1 or c & (c - 1)):
        raise ValueError(f"capacity {c} must be a power of two")
    _check_planes((keys_a, vals_a, keys_b, vals_b), (c, lanes), keys_a.device)
    return c, lanes


def _out_rows(c: int, out_size) -> int:
    out = 2 * c if out_size is None else out_size
    if not 0 <= out <= 2 * c:
        raise ValueError(f"out_size {out} outside [0, 2C={2 * c}]")
    return out


def set_union_plan(c: int, out: int, limit: int) -> tuple[int, int, int]:
    """(lane tile, key stages, values staged) of kernel 2's tile body on a
    card with ``limit`` bytes of shared memory a block: the widest tile,
    then the best staging, that fits; (1, 1, 0) when nothing fits (the
    launch is then refused with that figure)."""
    plan = _tile_plan(1, 1, c, out, TILE_LANES, limit) if c <= TILE_MAX_ROWS else None
    return plan or (1, 1, 0)


def set_union_smem_bytes(c: int, out: int, limit: int = HOPPER_SMEM_OPTIN) -> int:
    """Kernel 2's shared memory a CTA at capacity ``c`` and ``out`` output
    rows, in the plan of :func:`set_union_plan`."""
    return tile_union_smem_bytes(1, 1, c, out, set_union_plan(c, out, limit))


def merge_plan(c: int, limit: int) -> tuple[int, int, int]:
    """(lane tile, key stages, values staged) of kernel 6, the tile body's
    keep-all mode at one key word and one value plane, 2C output rows: the
    widest tile, then the best staging, that fits ``limit`` bytes; (1, 1,
    0) when nothing fits (the launch is then refused with that figure)."""
    plan = (_tile_plan(1, 1, c, 2 * c, TILE_LANES, limit, keep_all=True)
            if c <= TILE_MAX_ROWS else None)
    return plan or (1, 1, 0)


def merge_smem_bytes(c: int, limit: int = HOPPER_SMEM_OPTIN) -> int:
    """Kernel 6's shared memory a CTA at capacity ``c``, in the plan of
    :func:`merge_plan`."""
    return tile_union_smem_bytes(1, 1, c, 2 * c, merge_plan(c, limit), keep_all=True)


# the segment body of kernel 3 (csrc/set_union.cu): lanes a CTA, widest
# first (256 lanes make a row request 1 KB), and the most input buffers of
# its ring
SEGMENT_WIDTHS = (256, 128, 64, 32, 16, 8, 4, 2, 1)
SEGMENT_MAX_STAGES = 4


def segment_union_smem_bytes(wb: int, out_r: int, width: int, stages: int) -> int:
    """The segment body, per CTA of ``width`` lanes: ``stages`` buffers of
    one bucket of the four input planes (Wb rows each) and one buffer of
    the bucket's two output planes (``out_r`` rows each)."""
    return 4 * width * (stages * 4 * wb + 2 * out_r)


def bucketed_union_plan(c: int, n_buckets: int, out_r: int,
                        limit: int) -> tuple[int, int, int]:
    """(lanes a CTA, input buffers, shared-memory bytes) of kernel 3's
    segment body on a card with ``limit`` bytes a block: the widest lane
    count that fits with at least two buffers (the next bucket loads while
    this one is united), with the most buffers up to
    ``SEGMENT_MAX_STAGES`` (never more than the buckets); else the widest
    with one; else one lane and one buffer, whose figure (past the limit)
    the refused launch reports."""
    wb = c // n_buckets
    most = min(SEGMENT_MAX_STAGES, n_buckets)
    for least in (min(2, most), 1):
        for width in SEGMENT_WIDTHS:
            for stages in range(most, least - 1, -1):
                smem = segment_union_smem_bytes(wb, out_r, width, stages)
                if smem <= limit:
                    return width, stages, smem
    return 1, 1, segment_union_smem_bytes(wb, out_r, 1, 1)


def sorted_union_columnar_fused(keys_a, vals_a, keys_b, vals_b,
                                out_size: int | None = None):
    """Batched single-key sorted-set union, values OR-combined on duplicate
    keys (kernel #2's contract).  Returns (keys[out, L], vals[out, L],
    n_unique[L]); n_unique is counted before truncation."""
    c, _ = _check_columnar(keys_a, vals_a, keys_b, vals_b)
    out = _out_rows(c, out_size)
    if _route("set_union", keys_a.device):
        return _set_union_plain(keys_a, vals_a, keys_b, vals_b, out)
    return _set_union_cuda("set_union", keys_a, vals_a, keys_b, vals_b, c, out)


def sorted_union_columnar(keys_a, vals_a, keys_b, vals_b,
                          out_size: int | None = None):
    """The OR-Set columnar union (the ``sort`` engine): the fused kernel."""
    return sorted_union_columnar_fused(keys_a, vals_a, keys_b, vals_b,
                                       out_size=out_size)


def bitonic_merge_columnar(keys_a, vals_a, keys_b, vals_b):
    """Merge only (kernel #6): lane j of the (2C, L) output is the sorted
    merge of a[:, j] and b[:, j], nothing dropped; of two equal keys A's
    copy comes first (the TPU's bitonic network left that order open).
    Returns (keys, vals)."""
    c, _ = _check_columnar(keys_a, vals_a, keys_b, vals_b)
    if _route("merge", keys_a.device):
        return _merge_plain(keys_a, vals_a, keys_b, vals_b)
    return _set_union_cuda("merge", keys_a, vals_a, keys_b, vals_b, c, 2 * c)


def sorted_union_columnar_unfused(keys_a, vals_a, keys_b, vals_b,
                                  out_size: int | None = None):
    """Two-pass union: the merge kernel, then the dedupe-and-compact
    epilogue in plain torch — the A/B reference for the fused union."""
    c, _ = _check_columnar(keys_a, vals_a, keys_b, vals_b)
    out = _out_rows(c, out_size)
    ko, vo = bitonic_merge_columnar(keys_a, vals_a, keys_b, vals_b)
    return _dedupe_and_compact(ko, vo, out)


def _bucketed_check(keys_a, n_buckets: int, out_bucket_rows):
    c, lanes = keys_a.shape
    wb = c // n_buckets
    if wb * n_buckets != c:
        raise ValueError(f"{n_buckets} buckets must divide C={c}")
    if wb & (wb - 1):
        raise ValueError(f"bucket width {wb} must be a power of two")
    out_r = out_bucket_rows if out_bucket_rows is not None else wb
    if not 0 <= out_r <= 2 * wb:
        raise ValueError(
            f"out_bucket_rows {out_r} exceeds the lossless 2·Wb={2 * wb} bound")
    return wb, out_r, lanes


def bucketed_union_columnar(keys_a, vals_a, keys_b, vals_b, n_buckets: int,
                            out_bucket_rows: int | None = None):
    """Bucket-local union (kernel #3): operands and output in the bucketed
    layout (B segments of Wb rows, each ascending with its own SENTINEL
    tail); each bucket's union is cut to ``out_bucket_rows`` (default Wb).
    Returns (keys[B·out, L], vals[B·out, L], n_unique[L], bucket_max[L]):
    the per-lane sum and maximum of the buckets' unique counts before
    truncation."""
    _check_columnar(keys_a, vals_a, keys_b, vals_b, pow2=False)
    wb, out_r, _ = _bucketed_check(keys_a, n_buckets, out_bucket_rows)
    if _route("bucketed_union", keys_a.device):
        return _bucketed_union_plain(keys_a, vals_a, keys_b, vals_b, n_buckets, out_r)
    return _set_union_cuda("bucketed_union", keys_a, vals_a, keys_b, vals_b, wb, out_r)


def _set_union_cuda(name, keys_a, vals_a, keys_b, vals_b, seg, out_seg):
    """Launch csrc/set_union.cu: ``name`` is "set_union" (the lane tile),
    "merge" (its keep-all mode; ``out_seg`` = 2C) or "bucketed_union" (the
    segment body over buckets of ``seg`` rows, with bucket_max), each in the
    host's plan for the shape."""
    device = keys_a.device
    c, lanes = keys_a.shape
    limit = smem_limit(device)
    rows_out = c // seg * out_seg

    def empty(*shape):
        return torch.empty(shape, dtype=torch.int32, device=device)

    ko, vo = empty(rows_out, lanes), empty(rows_out, lanes)
    ins = [t.data_ptr() for t in (keys_a, vals_a, keys_b, vals_b, ko, vo)]
    if name == "set_union":
        plan = set_union_plan(c, out_seg, limit)
        smem = tile_union_smem_bytes(1, 1, c, out_seg, plan)
        outs = (ko, vo, empty(lanes))
        args = (*ins, outs[2].data_ptr(), c, lanes, out_seg, *plan, smem)
        what = f"lane tile {plan[0]}, {plan[1]} key stages, values staged {plan[2]}"
    elif name == "merge":
        plan = merge_plan(c, limit)
        smem = tile_union_smem_bytes(1, 1, c, 2 * c, plan, keep_all=True)
        outs = (ko, vo)
        args = (*ins, c, lanes, *plan, smem)
        what = (f"keep-all lane tile {plan[0]}, {plan[1]} key stages, values staged "
                f"{plan[2]}")
    else:
        width, stages, smem = bucketed_union_plan(c, c // seg, out_seg, limit)
        outs = (ko, vo, empty(lanes), empty(lanes))
        args = (*ins, outs[2].data_ptr(), outs[3].data_ptr(), c, lanes, seg, out_seg,
                width, stages, smem)
        what = f"{width} lanes a CTA, {stages} input buffers"
    if lanes == 0:
        return outs

    lib = _lib("set_union")
    entry = {"set_union": lib.set_union, "merge": lib.set_merge,
             "bucketed_union": lib.bucketed_union}[name]
    with torch.cuda.device(device):
        err = entry(*args, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        # a plan past the card's shared-memory opt-in (227 KB on Hopper)
        # is refused at cudaFuncSetAttribute, a lane tile past 16,384 rows
        # an operand by the launcher
        raise RuntimeError(
            f"{name} launch failed: {lib.set_union_error_string(err).decode()} "
            f"(C={c}, L={lanes}; {what}: {smem} B of shared memory per block, "
            f"{limit} B allowed)"
        )
    LAUNCHES[name] += 1
    return outs


def _set_union_plain(keys_a, vals_a, keys_b, vals_b, out):
    """Kernel #2's plain twin: the lexN union's twin at one key word and one
    value plane."""
    keys, vals, nu = _lexn_union_plain((keys_a,), (vals_a,), (keys_b,), (vals_b,), out)
    return keys[0], vals[0], nu


def _merge_plain(keys_a, vals_a, keys_b, vals_b):
    """Kernel #6's plain twin: a stable sort of the 2C rows per lane (A's
    rows first, so A's copy of an equal key stays first), values carried."""
    keys, order = torch.sort(torch.cat([keys_a, keys_b], dim=0), dim=0, stable=True)
    return keys, torch.cat([vals_a, vals_b], dim=0).gather(0, order)


def _bucketed_union_plain(keys_a, vals_a, keys_b, vals_b, n_buckets, out_r):
    """Kernel #3's plain twin: each (bucket, lane) pair is one lane of the
    union twin, cut to ``out_r`` rows."""
    c, lanes = keys_a.shape
    wb = c // n_buckets

    def as_lanes(x):  # (C, L) -> (Wb, B·L): column b·L + j is bucket b of lane j
        return x.reshape(n_buckets, wb, lanes).permute(1, 0, 2).reshape(wb, -1)

    def as_planes(x):  # (out_r, B·L) -> (B·out_r, L)
        return x.reshape(out_r, n_buckets, lanes).permute(1, 0, 2).reshape(-1, lanes)

    keys, vals, nu = _set_union_plain(*map(as_lanes, (keys_a, vals_a, keys_b, vals_b)), out_r)
    nu = nu.reshape(n_buckets, lanes)
    return (as_planes(keys), as_planes(vals), nu.sum(dim=0, dtype=torch.int32),
            nu.amax(dim=0))


def _dedupe_and_compact(keys, vals, out_size):
    """Plain epilogue on merged-sorted (2C, L) columns: OR each adjacent
    duplicate's values into the first copy, punch the second copy to
    SENTINEL, sink the punched rows with one stable sort."""
    above = torch.cat([keys[:1] - 1, keys[:-1]], dim=0)
    dup = keys == above
    below_dup = torch.cat([dup[1:], torch.zeros_like(dup[:1])], dim=0)
    vals_below = torch.cat([vals[1:], vals[:1]], dim=0)
    vals = torch.where(below_dup, vals | vals_below, vals)
    keys, order = torch.sort(keys.masked_fill(dup, SENTINEL_PY), dim=0, stable=True)
    pad = keys == SENTINEL_PY
    vals = vals.gather(0, order).masked_fill(pad, 0)
    n_unique = (~pad).sum(dim=0, dtype=torch.int32)
    return keys[:out_size].contiguous(), vals[:out_size].contiguous(), n_unique


# ---- csrc/set_member.cu: the OR-Set member mask ----
#
# One thread a lane, a bitmap of min(n_universe, 2^ELEM_BITS) bits a lane in
# shared memory: the plan is the lanes a block, a multiple of 32 up to
# MEMBER_MASK_LANES, whose bitmaps fit the shared-memory limit.

MEMBER_MASK_LANES = 1024


def member_mask_id_rows(n_universe: int) -> int:
    """Mask rows that an element id can reach: ids have ELEM_BITS bits, so
    rows from 2^ELEM_BITS on are all false."""
    return min(n_universe, 1 << pack.ELEM_BITS)


def member_mask_plan(n_universe: int, limit: int) -> tuple[int, int]:
    """(lanes a block, shared bytes a block) of the member-mask kernel for
    ``n_universe`` element ids on a card with ``limit`` bytes a block."""
    words = (member_mask_id_rows(n_universe) + 31) // 32
    lanes = min(MEMBER_MASK_LANES, limit // (4 * 32 * max(words, 1)) * 32)
    if lanes < 32:
        raise ValueError(f"the member mask's bitmaps of {n_universe} ids for 32 lanes "
                         f"exceed {limit} B of shared memory")
    return lanes, 4 * words * lanes


def member_mask_empty(packed: torch.Tensor, removed: torch.Tensor,
                      n_universe: int) -> torch.Tensor:
    """The member-mask kernel's output for ``packed`` and ``removed``,
    checked: an uninitialised bool (n_universe, L) plane on their card."""
    if packed.dim() != 2:
        raise ValueError(f"planes must be (C, L), got shape {tuple(packed.shape)}")
    if n_universe < 0:
        raise ValueError(f"n_universe {n_universe} is negative")
    _check_planes((packed, removed), packed.shape, packed.device)
    return torch.empty((n_universe, packed.shape[1]), dtype=torch.bool, device=packed.device)


def member_mask_launch(packed: torch.Tensor, removed: torch.Tensor,
                       mask: torch.Tensor) -> torch.Tensor:
    """Launch csrc/set_member.cu into ``mask`` (from
    :func:`member_mask_empty`), which every launch writes whole."""
    c, lanes = packed.shape
    n_universe = mask.shape[0]
    if n_universe == 0 or lanes == 0:
        return mask
    device = packed.device
    limit = smem_limit(device)
    lanes_per_block, smem = member_mask_plan(n_universe, limit)
    lib = _lib("set_member")
    with torch.cuda.device(device):
        err = lib.member_mask(packed.data_ptr(), removed.data_ptr(), mask.data_ptr(), c,
                              lanes, n_universe, member_mask_id_rows(n_universe),
                              pack.RID_BITS + pack.SEQ_BITS, (1 << pack.ELEM_BITS) - 1,
                              lanes_per_block, smem,
                              torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(
            f"member_mask launch failed: {lib.set_member_error_string(err).decode()} "
            f"(C={c}, L={lanes}, n_universe={n_universe}; {lanes_per_block} lanes a "
            f"block: {smem} B of shared memory per block, {limit} B allowed)"
        )
    LAUNCHES["member_mask"] += 1
    return mask
