"""GC-aware columnar engine for RSeq swarms: the lexN kernels as the
DEFAULT under tomb_gc barriers and pairwise GC joins, generic as the loud
exception (counterpart of ``crdt_tpu.models.rseq_engine``).

The generic GC join (``tomb_gc.join_checked``) is a lossless union with a
per-row source marker (1 = only a, 2 = only b, 3 = both) followed by the
floor-suppression rule: a one-sided row covered by the OTHER side's floor
was removed and collected there, so it is dropped.  The lexN kernels'
duplicate rule is OR-combine-then-keep-first, which gives the marker for
free: side a carries a ``src = 1`` value plane, side b ``src = 2``, a
matched row's copies OR into 3.  (A kernel that kept the first copy of a
value plane would break the suppression silently.)  Then:

1. a lossless lexN union at ``out_size = 2C`` with value planes
   ``(elem, removed, src)`` — nothing truncates, so a suppressed row never
   evicts a real one;
2. each row's writer identity is the LAST level's packed identity word
   (``rid << seq_bits | seq``); per-lane floors are (W, R) planes, so
   coverage is one gather per side;
3. dropped rows are punched to SENTINEL/0 and compacted by a stable
   single-key sort of the hole flag in plain torch (the JAX package does
   it in XLA, outside Pallas): kept rows are already in key order;
4. ``n_unique`` = kept rows a lane (post-suppression, pre-capacity-slice).
"""
from __future__ import annotations

import dataclasses
import warnings

import torch

from crdt_tpu_torch.models import rseq, rseq_columnar as rc, tomb_gc
from crdt_tpu_torch.models.oplog_engine import EngineFallback
from crdt_tpu_torch.utils.constants import SENTINEL_PY
from crdt_tpu_torch.utils.tree import tree_map


@dataclasses.dataclass
class ColumnarGc:
    """A swarm of GC-wrapped RSeq states in the columnar layout: lane j =
    replica j's table + per-writer floor column."""

    col: rc.ColumnarRSeq
    floor: torch.Tensor  # int32[W, R]  per-lane per-writer collected watermark

    @property
    def lanes(self) -> int:
        return self.col.lanes

    @property
    def capacity(self) -> int:
        return self.col.capacity


def fit_joint_seq_bits(*states) -> int:
    """One (rid, seq) split that fits EVERY operand — pairwise joins must
    share a pack layout (rc.merge_checked rejects mismatched seq_bits)."""
    rid_max, seq_max = 0, 0
    for s in states:
        r = rc.key_ranges(s.keys)
        rid_max, seq_max = max(rid_max, r["rid"][1]), max(seq_max, r["seq"][1])
    return rc.fit_seq_bits(rid_max + 1, seq_max)


def stack(states, seq_bits: int | None = None) -> ColumnarGc:
    """Stage a batched Gc[RSeq] ([R, C, 4D] inner + [R, W] floor) — or a
    single Gc — into the columnar layout on its device; raises ValueError
    when the layout is ineligible (non-pow2 capacity, pack-budget
    overflow)."""
    cap = states.inner.keys.shape[-2]
    if cap & (cap - 1):
        raise ValueError(f"capacity {cap} is not a power of two (bitonic network)")
    col = rc.stack(states.inner, seq_bits=seq_bits)
    floor = torch.atleast_2d(states.floor).to(torch.int32)
    return ColumnarGc(col=col, floor=floor.T.contiguous())


def unstack(cg: ColumnarGc) -> tomb_gc.Gc:
    """Back to the batched row-major Gc[RSeq] (exact inverse of stack)."""
    return tomb_gc.Gc(inner=rc.unstack(cg.col), floor=cg.floor.T.contiguous())


def _pad_lanes(cg: ColumnarGc, lanes: int) -> ColumnarGc:
    pad = lanes - cg.lanes
    if pad == 0:
        return cg
    fill = torch.full((cg.floor.shape[0], pad), -1, dtype=torch.int32,
                      device=cg.floor.device)
    return ColumnarGc(col=rc._pad_lanes(cg.col, lanes),
                      floor=torch.cat([cg.floor, fill], dim=1))


def _slice_lanes(cg: ColumnarGc, lo: int, hi: int) -> ColumnarGc:
    return tree_map(lambda x: x[..., lo:hi].contiguous(), cg)


def mask_dead(cg: ColumnarGc, alive: torch.Tensor) -> ColumnarGc:
    """Dead lanes become the join identity: empty table + floor -1 (the
    neutral the generic gc_round pads with)."""
    return ColumnarGc(col=rc.mask_dead(cg.col, alive),
                      floor=torch.where(alive[None, :], cg.floor, -1))


def _covered(ident, valid, floor, seq_bits):
    """bool[N, R]: rows whose packed identity the per-lane floor covers —
    tomb_gc's rule on the lanes' transposed views."""
    rid, seq = ident >> seq_bits, ident & ((1 << seq_bits) - 1)
    return tomb_gc._covered(rid.T, seq.T, valid.T, floor.T).T


def gc_merge_checked(a: ColumnarGc, b: ColumnarGc):
    """Lane-wise GC-aware CRDT join on the lexN kernels: exactly
    ``tomb_gc.join_checked(·, ·, rseq.GC_ADAPTER)`` per lane (union, floor
    suppression, capacity slice, floor max).  Returns (ColumnarGc,
    n_unique[R]); n_unique counts post-suppression rows — > capacity means
    truncation broke the state (tomb_gc.GcOverflow)."""
    if a.floor.shape != b.floor.shape:
        raise ValueError(
            f"writer counts differ (floor shapes {tuple(a.floor.shape)} vs "
            f"{tuple(b.floor.shape)})"
        )
    nk = a.col.keys.shape[0]
    seq_bits = a.col.seq_bits
    cap = a.capacity
    src_a = (a.col.keys[0] != SENTINEL_PY).to(torch.int32)
    src_b = (b.col.keys[0] != SENTINEL_PY).to(torch.int32) * 2
    # lossless union (2C rows): suppression happens BEFORE the capacity
    # slice, so a suppressed row never evicts a real one
    keys, (elem, removed, src), _ = rc._union(a.col, b.col, (src_a,), (src_b,))
    valid = keys[0] != SENTINEL_PY
    ident = keys[nk - 1]  # last level's identity word = own (rid, seq)
    drop = ((src == 1) & _covered(ident, valid, b.floor, seq_bits)) | (
        (src == 2) & _covered(ident, valid, a.floor, seq_bits))
    hole = drop | ~valid
    order = torch.sort(hole.to(torch.uint8), dim=0, stable=True).indices[:cap]
    merged = ColumnarGc(
        col=rc.ColumnarRSeq(
            keys=keys.masked_fill(drop[None], SENTINEL_PY).gather(
                1, order[None].expand(nk, -1, -1)),
            elem=elem.masked_fill(drop, 0).gather(0, order),
            removed=removed.masked_fill(drop, 0).gather(0, order),
            seq_bits=seq_bits,
        ),
        floor=torch.maximum(a.floor, b.floor),
    )
    return merged, (~hole).sum(dim=0, dtype=torch.int32)


def _gc_lub_lane(work: ColumnarGc):
    """Log-depth lane-halving tree reduction of a (pre-masked) columnar GC
    swarm to ONE lane: (1-lane ColumnarGc, max n_unique over all levels)."""
    p = 1
    while p < work.lanes:
        p *= 2
    work = _pad_lanes(work, p)
    max_nu = torch.zeros((), dtype=torch.int32, device=work.floor.device)
    while p > 1:
        p //= 2
        work, nu = gc_merge_checked(_slice_lanes(work, 0, p), _slice_lanes(work, p, 2 * p))
        max_nu = torch.maximum(max_nu, nu.max())
    return work, max_nu


def _finish_broadcast(cg: ColumnarGc, top: ColumnarGc, alive: torch.Tensor):
    """Broadcast the reduced LUB lane (table + floor plane) over the alive
    lanes; dead lanes keep their stale state AND floor."""
    return tree_map(lambda t, x: torch.where(alive, t[..., :1], x), top, cg)


def gc_converge_checked(cg: ColumnarGc, alive: torch.Tensor):
    """Alive-masked log-depth tree reduction to the GC-aware LUB, broadcast
    over the alive lanes (dead lanes keep their stale state AND floor) —
    the convergence phase of tomb_gc.gc_round on the lexN kernels.
    Returns (ColumnarGc, max n_unique)."""
    with torch.profiler.record_function("rseq_engine.gc_converge"):
        work, max_nu = _gc_lub_lane(mask_dead(cg, alive))
        return _finish_broadcast(cg, work, alive), max_nu



def sharded_gc_converge(mesh, depth: int = rseq.DEPTH, seq_bits: int = 20):
    """Multi-card GC-AWARE columnar RSeq convergence: the lane (replica)
    axis split over the ranks of ``mesh`` (``parallel.mesh``) with the
    per-lane (W, R) floor planes riding the same split, every merge the
    GC-aware join (:func:`gc_merge_checked`, kernel 1 on a CUDA shard), so
    floor suppression crosses the all-gather exactly as it crosses a
    single-device barrier.  The three phases of
    ``rseq_columnar.sharded_converge``:

      1. each rank masks its dead lanes to the join identity (empty
         table + floor -1) and tree-reduces its shard to a one-lane GC LUB;
      2. one ``all_gather`` of the P one-lane LUBs, table planes AND floor
         plane, along the lane axis in rank order (the ONLY collective);
      3. each rank reduces the gathered lanes to the global GC LUB and
         broadcasts table + floor over its alive lanes.

    Every rank calls ``step(cg_shard, alive_shard)``, which returns
    ``(ColumnarGc, max_n_unique)`` with ``max_n_unique`` made equal on
    every rank by ``all_reduce(MAX)``: the checked-overflow contract of
    :func:`gc_converge_checked`."""
    from crdt_tpu_torch.parallel import mesh as mesh_lib

    def step(cg: ColumnarGc, alive: torch.Tensor):
        if cg.col.seq_bits != seq_bits or cg.col.depth != depth:
            raise ValueError(
                f"state (depth={cg.col.depth}, seq_bits={cg.col.seq_bits}) "
                f"does not match this step (depth={depth}, seq_bits={seq_bits})")
        local_lub, nu_local = _gc_lub_lane(mask_dead(cg, alive))
        keys, elem, removed, floor = mesh_lib.gather_lanes(
            mesh, (local_lub.col.keys, local_lub.col.elem, local_lub.col.removed,
                   local_lub.floor))
        top, nu_global = _gc_lub_lane(ColumnarGc(
            col=rc.ColumnarRSeq(keys=keys, elem=elem, removed=removed,
                                seq_bits=seq_bits),
            floor=floor))
        out = _finish_broadcast(cg, top, alive)
        return out, mesh_lib.all_reduce_max(mesh, torch.maximum(nu_local, nu_global))

    return step

# ---- host-level selectors (the consumers' entry points) ----


def _stack_pair(a: tomb_gc.Gc, b: tomb_gc.Gc):
    """Both single states staged into one columnar layout; raises
    ValueError when the pair is ineligible (the only refusal the loud
    fallback serves)."""
    if a.inner.keys.shape != b.inner.keys.shape:
        raise ValueError(
            f"GC join requires identical key layouts: "
            f"{tuple(a.inner.keys.shape)} vs {tuple(b.inner.keys.shape)} "
            "(mixed-depth RSeq states must be widened to a common depth "
            "before joining)"
        )
    if a.floor.shape != b.floor.shape:
        raise ValueError(
            f"GC join requires equal writer counts: floor shapes "
            f"{tuple(a.floor.shape)} vs {tuple(b.floor.shape)}"
        )
    bits = fit_joint_seq_bits(a.inner, b.inner)
    return stack(a, seq_bits=bits), stack(b, seq_bits=bits)


def _join_pair(ca: ColumnarGc, cb: ColumnarGc):
    out, nu = gc_merge_checked(ca, cb)
    return tree_map(lambda x: x[0], unstack(out)), nu[0]


def gc_join_checked(a: tomb_gc.Gc, b: tomb_gc.Gc):
    """Pairwise GC-aware join on the columnar engine — drop-in for
    ``tomb_gc.join_checked(a, b, rseq.GC_ADAPTER)`` on single states (same
    (Gc, n_unique) contract, bit-identical result).  Raises ValueError when
    the layout is ineligible; :func:`gc_join_checked_auto` falls back
    loudly instead."""
    return _join_pair(*_stack_pair(a, b))


def gc_join_checked_auto(a: tomb_gc.Gc, b: tomb_gc.Gc):
    """gc_join_checked with the loud-fallback contract: ineligible layouts
    warn EngineFallback and serve through the generic tomb_gc join.  Only
    the layout checks may fall back: a kernel that refuses to launch
    raises."""
    try:
        pair = _stack_pair(a, b)
    except ValueError as e:
        warnings.warn(
            f"RSeq GC join fell back to the generic engine: {e}",
            EngineFallback, stacklevel=2,
        )
        return tomb_gc.join_checked(a, b, rseq.GC_ADAPTER)
    return _join_pair(*pair)


def gc_converge_swarm(sw):
    """The gc_round barrier's convergence phase on the columnar engine:
    takes a Swarm of batched Gc[RSeq] states, returns (converged swarm,
    max_n_unique as a Python int) — or None (after an EngineFallback
    warning) when the layout is ineligible, in which case the caller runs
    the generic tree reduction."""
    try:
        cg = stack(sw.state)
    except ValueError as e:
        warnings.warn(
            f"RSeq GC barrier fell back to the generic engine: {e}",
            EngineFallback, stacklevel=2,
        )
        return None
    out, max_nu = gc_converge_checked(cg, sw.alive)
    return dataclasses.replace(sw, state=unstack(out)), int(max_nu)
