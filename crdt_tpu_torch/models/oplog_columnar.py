"""Columnar swarm layout for the flagship OpLog — the fused-kernel path
(counterpart of ``crdt_tpu.models.oplog_columnar``).

A swarm of R op logs is held as four ``(C, R)`` int32 planes, lane j =
replica j's log, and every merge runs the hand-written fused lexN union
kernel at two key words and two value planes
(``crdt_tpu_torch.ops.hopper_union.sorted_union_columnar_fused_lex2``).

Key encoding: the op identity (ts, rid, seq, key) as a lexicographic
two-word key:

* ``hi``  = ts (int32 ms offset, non-negative, < SENTINEL);
* ``lo``  = rid | seq | key bit-packed, order-preserving, sign bit clear —
  budgets are explicit per layout and checked host-side at stack time.

Value planes: ``val`` (numeric delta) and ``pay`` = payload | is_num<<31
(the payload intern id is non-negative, so the sign bit carries is_num).

Duplicates resolve OR-combine-then-keep-first inside the kernel; identical
(ts, rid, seq, key) is the same op carrying identical values, so this is
keep-first for every log the layout can hold.

All planes stay contiguous: the kernel wrapper rejects strided planes, so
lane slices and broadcasts here are materialised before the next merge.
"""
from __future__ import annotations

import dataclasses

import torch

from crdt_tpu_torch import default_device
from crdt_tpu_torch.models import oplog
from crdt_tpu_torch.ops import hopper_union
from crdt_tpu_torch.utils.constants import SENTINEL_PY
from crdt_tpu_torch.utils.tables import grow_into
from crdt_tpu_torch.utils.tracing import trace_region
from crdt_tpu_torch.utils.tree import tree_map

# Default lo-word split: 256 writers x 64K ops/writer x 128 interned keys.
DEFAULT_BITS = (8, 16, 7)


@dataclasses.dataclass
class ColumnarOpLog:
    """A swarm of R op logs as (C, R) planes: lane j = replica j's log,
    per-lane sorted ascending by (hi, lo); padding rows have
    hi = lo = SENTINEL, val = pay = 0."""

    hi: torch.Tensor   # int32[C, R]  ts
    lo: torch.Tensor   # int32[C, R]  rid | seq | key (order-preserving pack)
    val: torch.Tensor  # int32[C, R]  numeric delta
    pay: torch.Tensor  # int32[C, R]  payload intern id | is_num << 31
    bits: tuple = DEFAULT_BITS

    @property
    def capacity(self) -> int:
        return self.hi.shape[0]

    @property
    def lanes(self) -> int:
        return self.hi.shape[1]


def check_bits(bits) -> None:
    rid_bits, seq_bits, key_bits = bits
    if min(rid_bits, seq_bits, key_bits) < 1:
        raise ValueError(
            f"pack split {bits} has a non-positive field width — the fields "
            "would overlap and silently corrupt the packed sort order"
        )
    if rid_bits + seq_bits + key_bits > 31:
        raise ValueError(
            f"pack split {bits} exceeds 31 bits (sign bit must stay clear)"
        )


def fit_bits(n_writers: int, n_keys: int) -> tuple:
    """A lo-word split for a known layout: rid/key get exactly what they
    need, seq takes the rest (the axis that actually grows over time)."""
    rid_bits = max(1, (n_writers - 1).bit_length())
    key_bits = max(1, (n_keys - 1).bit_length())
    bits = (rid_bits, 31 - rid_bits - key_bits, key_bits)
    check_bits(bits)
    return bits


def pack_id(rid, seq, key, bits):
    _, seq_bits, key_bits = bits
    return ((rid << (seq_bits + key_bits)) | (seq << key_bits) | key).to(torch.int32)


def unpack_id(lo, bits):
    rid_bits, seq_bits, key_bits = bits
    key = lo & ((1 << key_bits) - 1)
    seq = (lo >> key_bits) & ((1 << seq_bits) - 1)
    rid = (lo >> (seq_bits + key_bits)) & ((1 << rid_bits) - 1)
    return rid, seq, key


def empty(capacity: int, lanes: int, bits=DEFAULT_BITS, device=None) -> ColumnarOpLog:
    device = default_device(device)
    s = torch.full((capacity, lanes), SENTINEL_PY, dtype=torch.int32, device=device)
    z = torch.zeros((capacity, lanes), dtype=torch.int32, device=device)
    return ColumnarOpLog(hi=s, lo=s.clone(), val=z, pay=z.clone(), bits=tuple(bits))


def stack(logs: oplog.OpLog, bits=DEFAULT_BITS) -> ColumnarOpLog:
    """Stage a batched [R, C] OpLog (or a single [C] log) into the columnar
    planes, on the logs' device.  Validates every field against the pack
    budget — out-of-budget ids would silently corrupt the kernel's sort
    order.  Rows must already be in the oplog sort order (ts, rid, seq,
    key), which every OpLog constructor guarantees; the packed (hi, lo)
    order is identical because the pack is order-preserving."""
    check_bits(bits)
    rid_bits, seq_bits, key_bits = bits
    ts, rid, seq, key, val, payload, is_num = (
        torch.atleast_2d(getattr(logs, f)) for f in oplog._FIELDS
    )
    valid = ts != SENTINEL_PY

    def _field_max(x):
        return int(torch.where(valid, x, 0).max()) if x.numel() else 0

    def _field_min(x):
        return int(torch.where(valid, x, 0).min()) if x.numel() else 0

    for name, x, limit in (
        ("rid", rid, 1 << rid_bits),
        ("seq", seq, 1 << seq_bits),
        ("key", key, 1 << key_bits),
    ):
        lo_v, hi_v = _field_min(x), _field_max(x)
        if lo_v < 0 or hi_v >= limit:
            raise ValueError(
                f"{name} range [{lo_v}, {hi_v}] exceeds the packed budget "
                f"[0, {limit}) for bits={bits}; use a wider split or the "
                "generic row-major path (crdt_tpu_torch.models.oplog.merge)"
            )
    if _field_min(ts) < 0:
        raise ValueError("negative ts cannot ride the columnar layout")
    if _field_min(payload) < 0:
        raise ValueError("negative payload id cannot carry the is_num bit")

    hi = torch.where(valid, ts, SENTINEL_PY)
    lo = torch.where(valid, pack_id(rid, seq, key, bits), SENTINEL_PY)
    pay = torch.where(valid, payload | (is_num.to(torch.int32) << 31), 0)
    val = torch.where(valid, val, 0)
    return ColumnarOpLog(
        hi=hi.T.contiguous(), lo=lo.T.contiguous(), val=val.T.contiguous(),
        pay=pay.T.contiguous(), bits=tuple(bits),
    )


def unstack(col: ColumnarOpLog) -> oplog.OpLog:
    """Back to the batched [R, C] row-major OpLog (exact inverse of stack)."""
    hi, lo = col.hi.T, col.lo.T
    valid = hi != SENTINEL_PY
    rid, seq, key = unpack_id(torch.where(valid, lo, 0), col.bits)
    pay = torch.where(valid, col.pay.T, 0)
    return oplog.OpLog(
        ts=hi.contiguous(),
        rid=torch.where(valid, rid, SENTINEL_PY),
        seq=torch.where(valid, seq, SENTINEL_PY),
        key=torch.where(valid, key, SENTINEL_PY),
        val=torch.where(valid, col.val.T, 0),
        payload=pay & 0x7FFFFFFF,
        is_num=pay < 0,
    )


def grow(col: ColumnarOpLog, new_capacity: int) -> ColumnarOpLog:
    """Capacity migration in the columnar layout: append tail padding ROWS
    (per-lane sorted order keeps padding last).  new_capacity must stay a
    power of two (the kernel requires it)."""
    if new_capacity < col.capacity:
        raise ValueError(f"cannot shrink capacity {col.capacity} -> {new_capacity}")
    if new_capacity & (new_capacity - 1):
        raise ValueError(f"capacity {new_capacity} must be a power of two")
    return grow_into(col, empty(new_capacity, col.lanes, col.bits, device=col.hi.device))


def _pad_lanes(col: ColumnarOpLog, lanes: int) -> ColumnarOpLog:
    """Append empty-log lanes up to ``lanes`` (lub_lane's power-of-two
    tree needs them; they are the join identity)."""
    pad = lanes - col.lanes
    if pad == 0:
        return col
    e = empty(col.capacity, pad, col.bits, device=col.hi.device)
    return tree_map(lambda x, y: torch.cat([x, y], dim=1), col, e)


def _slice_lanes(col: ColumnarOpLog, lo: int, hi: int) -> ColumnarOpLog:
    return tree_map(lambda x: x[:, lo:hi].contiguous(), col)


def merge_checked(a: ColumnarOpLog, b: ColumnarOpLog):
    """Lane-wise CRDT join through the fused kernel: lane j of the result is
    the capacity-bounded union of lane j of ``a`` and ``b``.  Returns
    (ColumnarOpLog, n_unique[R]); n_unique[j] > capacity means lane j's true
    union overflowed and the newest ops were dropped."""
    if a.bits != b.bits:
        raise ValueError(f"pack layouts differ: {a.bits} vs {b.bits}")
    if a.capacity != b.capacity:
        raise ValueError(f"capacities differ ({a.capacity} vs {b.capacity})")
    if a.lanes != b.lanes:
        raise ValueError(f"lane counts differ ({a.lanes} vs {b.lanes})")
    (hi, lo), (val, pay), nu = hopper_union.sorted_union_columnar_fused_lex2(
        (a.hi, a.lo), (a.val, a.pay), (b.hi, b.lo), (b.val, b.pay),
        out_size=a.capacity,
    )
    return ColumnarOpLog(hi=hi, lo=lo, val=val, pay=pay, bits=a.bits), nu


def merge(a: ColumnarOpLog, b: ColumnarOpLog) -> ColumnarOpLog:
    out, _ = merge_checked(a, b)
    return out


def mask_dead(col: ColumnarOpLog, alive: torch.Tensor) -> ColumnarOpLog:
    """Dead replicas' lanes become empty logs (the join identity), exactly
    like swarm.mask_dead_with_neutral — an unreachable peer contributes
    nothing."""
    a = alive[None, :]
    return ColumnarOpLog(
        hi=torch.where(a, col.hi, SENTINEL_PY),
        lo=torch.where(a, col.lo, SENTINEL_PY),
        val=torch.where(a, col.val, 0),
        pay=torch.where(a, col.pay, 0),
        bits=col.bits,
    )


def lub_lane(col: ColumnarOpLog, alive: torch.Tensor | None = None):
    """Log-depth lane-halving tree reduction to a SINGLE-lane least upper
    bound of the alive lanes (dead lanes contribute the join identity).
    Returns (one-lane ColumnarOpLog, max_n_unique across the reduction):
    ceil(log2 R) kernel launches."""
    work = col if alive is None else mask_dead(col, alive)
    p = 1
    while p < col.lanes:
        p *= 2
    work = _pad_lanes(work, p)
    max_nu = torch.zeros((), dtype=torch.int32, device=col.hi.device)
    while p > 1:
        p //= 2
        work, nu = merge_checked(_slice_lanes(work, 0, p), _slice_lanes(work, p, 2 * p))
        max_nu = torch.maximum(max_nu, nu.max())
    return work, max_nu


def converge_checked(col: ColumnarOpLog, alive: torch.Tensor | None = None):
    """Drive every alive lane to the least upper bound of alive lanes' logs:
    a lane-halving tree reduction computes the LUB, then it broadcasts back
    over the alive lanes; dead lanes keep their stale state.  Returns
    (ColumnarOpLog, max_n_unique): max_n_unique > capacity means some
    pairwise union overflowed (newest ops dropped)."""
    lanes = col.lanes
    with trace_region("oplog_columnar.converge"):
        work, max_nu = lub_lane(col, alive)
        # the broadcast is a stride-0 view: materialise it (the kernel
        # wrapper rejects non-contiguous planes)
        top = tree_map(lambda x: x[:, :1].expand(col.capacity, lanes), work)
        if alive is None:
            top = tree_map(lambda t: t.contiguous(), top)
        else:
            a = alive[None, :]
            top = tree_map(lambda t, x: torch.where(a, t, x), top, col)
        return top, max_nu


def converge(col: ColumnarOpLog, alive: torch.Tensor | None = None) -> ColumnarOpLog:
    out, _ = converge_checked(col, alive)
    return out


def gossip_round(
    col: ColumnarOpLog, peers: torch.Tensor, alive: torch.Tensor | None = None
) -> ColumnarOpLog:
    """One pull round in the columnar layout: lane j fetches lane peers[j]
    and joins it (the join is gated on both endpoints being alive)."""
    peers = peers.to(device=col.hi.device, dtype=torch.long)
    peer = tree_map(lambda x: x[:, peers], col)
    merged = merge(col, peer)
    if alive is None:
        return merged
    ok = (alive & alive[peers])[None, :]
    return tree_map(lambda m, x: torch.where(ok, m, x), merged, col)


def rebuild(col: ColumnarOpLog, n_keys: int) -> oplog.KVState:
    """Per-lane materialized view (batched KVState over the lane axis):
    unpack + the two-scatter rebuild, one batched scatter over all lanes."""
    return oplog.rebuild(unstack(col), n_keys)


def sharded_converge(mesh, bits=DEFAULT_BITS):
    """Multi-card columnar convergence: the lane (replica) axis split over
    the ranks of ``mesh`` (``parallel.mesh``), kernel 1 doing every merge.

    Build once per mesh; every rank calls the returned
    ``step(col_shard, alive_shard)`` with its own lanes, and it returns
    ``(col_shard, max_n_unique)`` after one global anti-entropy fixpoint:

      1. each rank tree-reduces its lane shard to a one-lane LUB
         (:func:`lub_lane`: every merge on the kernel, no traffic);
      2. one ``all_gather`` of the P one-lane LUBs along the lane axis,
         in rank order (JAX's ``tiled=True``): the ONLY collective,
         4 planes x C rows x P lanes;
      3. each rank reduces the gathered lanes to the global LUB and
         broadcasts it over its alive lanes.

    ``max_n_unique`` is made equal on every rank by ``all_reduce(MAX)``
    (JAX's ``pmax``).  The shard's device picks the kernel's route."""
    from crdt_tpu_torch.parallel import mesh as mesh_lib

    bits = tuple(bits)

    def step(col: ColumnarOpLog, alive: torch.Tensor):
        if col.bits != bits:
            raise ValueError(
                f"state packed with bits={col.bits} but this step was built "
                f"for bits={bits}: the output would be relabeled and "
                "unpack to garbage")
        local_lub, nu_local = lub_lane(col, alive)
        hi, lo, val, pay = mesh_lib.gather_lanes(
            mesh, (local_lub.hi, local_lub.lo, local_lub.val, local_lub.pay))
        top, nu_global = lub_lane(ColumnarOpLog(hi=hi, lo=lo, val=val, pay=pay,
                                                bits=bits))
        a = alive[None, :]
        out = tree_map(lambda t, x: torch.where(a, t[:, :1], x), top, col)
        return out, mesh_lib.all_reduce_max(mesh, torch.maximum(nu_local, nu_global))

    return step
