"""Columnar swarm layout for RSeq — the lexN kernel path (counterpart of
``crdt_tpu.models.rseq_columnar``).

A swarm of R RSeq tables is held as ``(·, C, R)`` planes, lane j = replica
j's table, with the 4·D path-key columns bit-packed into 3 int32 words a
level, so every merge runs the lexN union of
``crdt_tpu_torch.ops.hopper_union.sorted_union_columnar_lexn_auto`` at
3·D key words and two value planes.

Per-level pack (order-preserving; no field straddles a word):

* word 0: ``p_hi`` — the position's top 30 bits (< 2^30, so a real row's
  head word never equals SENTINEL);
* word 1: ``p_lo`` — the position's low 30 bits;
* word 2: ``rid << seq_bits | seq`` — the writer identity, sign bit clear,
  budgets fitted at stack time (an out-of-budget field would bleed across
  its bit boundary and corrupt the sort order; stack raises instead).

Value planes: ``elem`` (identical on both copies of a duplicate key) and
``removed`` (monotone 0/1).  The kernels' duplicate rule is
OR-combine-then-keep-first, so ``elem`` passes unchanged and ``removed``
gets join semantics.

All planes stay contiguous: the kernel wrappers reject strided planes, so
lane slices and broadcasts here are materialised before the next merge.
Lane counts need no padding to 128 (the TPU's tile).
"""
from __future__ import annotations

import dataclasses
import warnings

import torch

from crdt_tpu_torch import default_device
from crdt_tpu_torch.models import rseq
from crdt_tpu_torch.models.oplog_engine import EngineFallback
from crdt_tpu_torch.ops import hopper_union
from crdt_tpu_torch.utils.constants import SENTINEL_PY
from crdt_tpu_torch.utils.tracing import trace_region
from crdt_tpu_torch.utils.tree import tree_map

HALF_BITS = rseq.HALF_BITS  # 30: both position words stay under 2^30


@dataclasses.dataclass
class ColumnarRSeq:
    """A swarm of R sequence tables as (·, C, R) planes: lane j = replica
    j's table, per-lane sorted ascending by the packed key words; padding
    rows have every key word = SENTINEL, elem = removed = 0."""

    keys: torch.Tensor     # int32[3*D, C, R]  packed path-key words
    elem: torch.Tensor     # int32[C, R]       payload id
    removed: torch.Tensor  # int32[C, R]       tombstone (0/1; monotone)
    seq_bits: int = 20

    @property
    def depth(self) -> int:
        return self.keys.shape[0] // 3

    @property
    def capacity(self) -> int:
        return self.keys.shape[1]

    @property
    def lanes(self) -> int:
        return self.keys.shape[2]


def fit_seq_bits(n_writers: int, max_seq: int) -> int:
    """Seq-field width for the identity word: rid gets what it needs, seq
    the rest; raises when the pair cannot share 31 bits."""
    rid_bits = max(1, (max(n_writers, 1) - 1).bit_length())
    seq_bits = 31 - rid_bits
    if max_seq >= 1 << seq_bits:
        raise ValueError(
            f"(rid < {n_writers}, seq <= {max_seq}) needs more than the "
            "31-bit identity-word budget"
        )
    return seq_bits


def key_ranges(keys: torch.Tensor) -> dict:
    """{field: (min, max)} of rid, seq, p_hi and p_lo over the valid rows
    of [..., C, 4D] key tables (padding rows read as 0, as in the JAX
    package), computed on the tables' device and read back in one
    transfer."""
    valid = (keys[..., 0] != SENTINEL_PY)[..., None]
    stats = []
    for start in (2, 3, 0, 1):
        col = keys[..., start::4].masked_fill(~valid, 0)
        if col.numel():
            stats += [col.amin(), col.amax()]
        else:
            stats += [col.new_zeros(()), col.new_zeros(())]
    lo_hi = torch.stack(stats).tolist()
    return {name: (lo_hi[2 * i], lo_hi[2 * i + 1])
            for i, name in enumerate(("rid", "seq", "p_hi", "p_lo"))}


def plan(states: rseq.RSeq, seq_bits: int | None = None):
    """Engine choice for RSeq swarms: stage into the columnar lexN engine
    whenever the identity budgets allow, fall back LOUDLY (an
    ``EngineFallback`` warning naming the violated budget) otherwise.
    Returns ``(ColumnarRSeq, None)`` on the fast path or ``(None, reason)``
    on fallback — callers keep the batched row-major state and drive it
    through ``rseq.join`` / swarm.converge."""
    try:
        cap = states.keys.shape[-2]
        if cap & (cap - 1):
            raise ValueError(f"capacity {cap} is not a power of two (bitonic network)")
        return stack(states, seq_bits=seq_bits), None
    except ValueError as e:
        warnings.warn(
            f"RSeq swarm fell back to the generic engine: {e}",
            EngineFallback,
            stacklevel=2,
        )
        return None, str(e)


def stack(states: rseq.RSeq, seq_bits: int | None = None) -> ColumnarRSeq:
    """Stage a batched [R, C, 4D] RSeq (or a single [C, 4D] state) into
    columnar planes on its device.  Validates every identity field against
    the pack budget with one transfer of the ranges; with ``seq_bits=None``
    the split is fitted from the observed ranges (rid gets what the data
    needs, seq the rest).  Rows are already sorted in path-key order, which
    the pack preserves."""
    keys = states.keys
    elem, removed = states.elem, states.removed
    if keys.dim() == 2:
        keys, elem, removed = keys[None], elem[None], removed[None]
    w = keys.shape[-1]
    if w % 4:
        raise ValueError(f"key width {w} is not 4*depth")
    d = w // 4
    r = key_ranges(keys)
    (rid_min, rid_max), (seq_min, seq_max) = r["rid"], r["seq"]
    if rid_min < 0 or seq_min < 0:
        raise ValueError(
            f"negative identity field (rid>={rid_min}, seq>={seq_min}) "
            "cannot bit-pack order-preservingly"
        )
    if seq_bits is None:
        seq_bits = fit_seq_bits(rid_max + 1, seq_max)
    rid_bits = 31 - seq_bits
    if rid_max >= 1 << rid_bits or seq_max >= 1 << seq_bits:
        raise ValueError(
            f"identity range (rid<={rid_max}, seq<={seq_max}) exceeds the "
            f"(rid:{rid_bits}, seq:{seq_bits}) split"
        )
    for name in ("p_hi", "p_lo"):
        lo, hi = r[name]
        if lo < 0 or hi >= 1 << HALF_BITS:
            raise ValueError(f"{name} range [{lo}, {hi}] outside the 30-bit position word")

    kt = keys.permute(2, 1, 0)                     # (4D, C, R) view
    vt = (kt[0] != SENTINEL_PY)[None]              # (1, C, R)
    ident = (kt[2::4] << seq_bits) | kt[3::4]      # (D, C, R)
    planes = torch.stack([kt[0::4], kt[1::4], ident], dim=1).reshape(3 * d, *kt.shape[1:])
    return ColumnarRSeq(
        keys=planes.masked_fill(~vt, SENTINEL_PY).contiguous(),
        elem=elem.T.masked_fill(~vt[0], 0).to(torch.int32).contiguous(),
        removed=removed.T.masked_fill(~vt[0], 0).to(torch.int32).contiguous(),
        seq_bits=int(seq_bits),
    )


def unstack(col: ColumnarRSeq) -> rseq.RSeq:
    """Back to the batched [R, C, 4D] row-major RSeq (exact inverse of
    stack)."""
    d = col.depth
    valid = col.keys[0] != SENTINEL_PY  # (C, R)
    words = col.keys.reshape(d, 3, *col.keys.shape[1:])
    ident = words[:, 2]
    cols = torch.stack([words[:, 0], words[:, 1], ident >> col.seq_bits,
                        ident & ((1 << col.seq_bits) - 1)], dim=1)
    keys = cols.reshape(4 * d, *col.keys.shape[1:]).masked_fill(~valid[None], SENTINEL_PY)
    return rseq.RSeq(
        keys=keys.permute(2, 1, 0).contiguous(),
        elem=col.elem.masked_fill(~valid, 0).T.contiguous(),
        removed=((col.removed != 0) & valid).T.contiguous(),
    )


def empty(capacity: int, lanes: int, depth: int = rseq.DEPTH, seq_bits: int = 20,
          device=None) -> ColumnarRSeq:
    device = default_device(device)
    z = torch.zeros((capacity, lanes), dtype=torch.int32, device=device)
    return ColumnarRSeq(
        keys=torch.full((3 * depth, capacity, lanes), SENTINEL_PY, dtype=torch.int32,
                        device=device),
        elem=z, removed=z.clone(), seq_bits=seq_bits)


def _pad_lanes(col: ColumnarRSeq, lanes: int) -> ColumnarRSeq:
    """Append empty-table lanes up to ``lanes`` (the join identity)."""
    pad = lanes - col.lanes
    if pad == 0:
        return col
    e = empty(col.capacity, pad, col.depth, col.seq_bits, device=col.keys.device)
    return tree_map(lambda x, y: torch.cat([x, y], dim=-1), col, e)


def _slice_lanes(col: ColumnarRSeq, lo: int, hi: int) -> ColumnarRSeq:
    return tree_map(lambda x: x[..., lo:hi].contiguous(), col)


def _union(a: ColumnarRSeq, b: ColumnarRSeq, extra_a=(), extra_b=(), out_size=None):
    """The lexN union of two same-layout columnar swarms, value planes
    (elem, removed, *extra): (keys[3D, out, L], vals[2 + extra, out, L],
    n_unique), each block as the union returns it (no copy)."""
    if a.keys.shape[0] != b.keys.shape[0]:
        raise ValueError(
            f"depths differ ({a.depth} vs {b.depth}): widen to a common "
            "depth before joining (rseq.widen)"
        )
    if a.seq_bits != b.seq_bits:
        raise ValueError(f"pack layouts differ (seq_bits {a.seq_bits} vs {b.seq_bits})")
    if a.capacity != b.capacity:
        raise ValueError(f"capacities differ ({a.capacity} vs {b.capacity})")
    if a.lanes != b.lanes:
        raise ValueError(f"lane counts differ ({a.lanes} vs {b.lanes})")
    return hopper_union.sorted_union_columnar_lexn_auto(
        a.keys, (a.elem, a.removed, *extra_a),
        b.keys, (b.elem, b.removed, *extra_b),
        out_size=out_size,
    )


def merge_checked(a: ColumnarRSeq, b: ColumnarRSeq):
    """Lane-wise CRDT join through the lexN kernels: lane j of the result
    is the capacity-bounded union of lane j of ``a`` and ``b`` with
    tombstone-OR on duplicates.  Returns (ColumnarRSeq, n_unique[R]);
    n_unique[j] > capacity means lane j's true union overflowed and the
    largest keys were dropped (the contract of rseq.join_checked)."""
    keys, (elem, removed), nu = _union(a, b, out_size=a.capacity)
    return ColumnarRSeq(keys=keys, elem=elem, removed=removed, seq_bits=a.seq_bits), nu


def merge(a: ColumnarRSeq, b: ColumnarRSeq) -> ColumnarRSeq:
    out, _ = merge_checked(a, b)
    return out


def mask_dead(col: ColumnarRSeq, alive: torch.Tensor) -> ColumnarRSeq:
    """Dead replicas' lanes become empty tables (the join identity)."""
    a = alive[None, :]
    return ColumnarRSeq(
        keys=torch.where(a[None], col.keys, SENTINEL_PY),
        elem=torch.where(a, col.elem, 0),
        removed=torch.where(a, col.removed, 0),
        seq_bits=col.seq_bits,
    )


def lub_lane(col: ColumnarRSeq, alive: torch.Tensor | None = None):
    """Log-depth lane-halving tree reduction to a SINGLE-lane least upper
    bound of the alive lanes (lanes padded to a power of two with empty
    tables).  Returns (one-lane ColumnarRSeq, max n_unique):
    ceil(log2 R) unions."""
    work = col if alive is None else mask_dead(col, alive)
    p = 1
    while p < col.lanes:
        p *= 2
    work = _pad_lanes(work, p)
    max_nu = torch.zeros((), dtype=torch.int32, device=col.keys.device)
    while p > 1:
        p //= 2
        work, nu = merge_checked(_slice_lanes(work, 0, p), _slice_lanes(work, p, 2 * p))
        max_nu = torch.maximum(max_nu, nu.max())
    return work, max_nu


def _broadcast_top(col: ColumnarRSeq, top: ColumnarRSeq,
                   alive: torch.Tensor | None) -> ColumnarRSeq:
    """Broadcast a one-lane LUB over the alive lanes of ``col`` (dead lanes
    keep their stale tables), materialised contiguous."""
    if alive is None:
        return tree_map(lambda t, x: t[..., :1].expand(x.shape).contiguous(), top, col)
    return tree_map(lambda t, x: torch.where(alive, t[..., :1], x), top, col)


def converge_checked(col: ColumnarRSeq, alive: torch.Tensor | None = None):
    """Drive every alive lane to the least upper bound of alive lanes'
    tables — swarm.converge for the sequence CRDT on the lexN kernels.
    Returns (ColumnarRSeq, max_n_unique); max_n_unique > capacity means
    some pairwise union truncated."""
    with trace_region("rseq_columnar.converge"):
        work, max_nu = lub_lane(col, alive)
        return _broadcast_top(col, work, alive), max_nu


def converge(col: ColumnarRSeq, alive: torch.Tensor | None = None) -> ColumnarRSeq:
    out, _ = converge_checked(col, alive)
    return out


def gossip_round(col: ColumnarRSeq, peers: torch.Tensor,
                 alive: torch.Tensor | None = None) -> ColumnarRSeq:
    """One pull round in the columnar layout: lane j fetches lane peers[j]
    and joins it, gated on both endpoints being alive."""
    peers = peers.to(device=col.keys.device, dtype=torch.long)
    peer = tree_map(lambda x: x[..., peers], col)
    merged = merge(col, peer)
    if alive is None:
        return merged
    ok = alive & alive[peers]
    return tree_map(lambda m, x: torch.where(ok, m, x), merged, col)


def sharded_converge(mesh, depth: int = rseq.DEPTH, seq_bits: int = 20):
    """Multi-card columnar RSeq convergence: the lane (replica) axis split
    over the ranks of ``mesh`` (``parallel.mesh``), kernel 1 doing every
    merge; the sequence sibling of ``oplog_columnar.sharded_converge``,
    with the same three phases:

      1. each rank tree-reduces its lane shard to a one-lane LUB;
      2. one ``all_gather`` of the P one-lane LUBs along the lane axis in
         rank order: the ONLY collective, (3·D + 2) planes x C rows x P
         lanes;
      3. each rank reduces the gathered lanes to the global LUB and
         broadcasts it over its alive lanes.

    Every rank calls ``step(col_shard, alive_shard)``, which returns
    ``(col_shard, max_n_unique)`` with ``max_n_unique`` made equal on
    every rank by ``all_reduce(MAX)``."""
    from crdt_tpu_torch.parallel import mesh as mesh_lib

    def step(col: ColumnarRSeq, alive: torch.Tensor):
        if col.seq_bits != seq_bits or col.depth != depth:
            raise ValueError(
                f"state (depth={col.depth}, seq_bits={col.seq_bits}) does "
                f"not match this step (depth={depth}, seq_bits={seq_bits})")
        local_lub, nu_local = lub_lane(col, alive)
        keys, elem, removed = mesh_lib.gather_lanes(
            mesh, (local_lub.keys, local_lub.elem, local_lub.removed))
        top, nu_global = lub_lane(ColumnarRSeq(keys=keys, elem=elem, removed=removed,
                                               seq_bits=seq_bits))
        out = _broadcast_top(col, top, alive)
        return out, mesh_lib.all_reduce_max(mesh, torch.maximum(nu_local, nu_global))

    return step
