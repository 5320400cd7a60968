"""GC-aware columnar engine for RSeq swarms: the lexN kernels as the
DEFAULT under tomb_gc barriers and pairwise GC joins, generic as the loud
exception (counterpart of ``crdt_tpu.models.rseq_engine``).

The generic GC join (``tomb_gc.join_checked``) is a lossless union with a
per-row source marker (1 = only a, 2 = only b, 3 = both) followed by the
floor-suppression rule: a one-sided row covered by the OTHER side's floor
was removed and collected there, so it is dropped.  Each row's writer
identity is the LAST level's packed identity word (``rid << seq_bits |
seq``); per-lane floors are (W, R) planes.  Every GC join of this module
(the pull round, the barrier's halvings, the pairwise and sharded joins)
is :func:`_gc_join`, which takes one of two routes by device and shape:

* **fused** (a CUDA tensor whose shape the GC instance of kernel 1's wide
  body takes, ``hopper_union.lexn_gc_union_plan``): one launch of
  ``hopper_union.gc_union_columnar_lexn``, where the floor rule runs in
  the wide body's flag pass: a kept row whose next merged row is not its
  duplicate is one-sided, its side comes from the merge map, and it is
  dropped before the scan where the other side's floor covers it.  C rows
  come out, with ``n_unique`` (kept rows after the rule, before
  truncation) and the rows dropped a lane; no marker plane, no 2C
  intermediate, no sort;
* **composition** (the CPU, where it is the plain twin the JAX package is
  held against, and shapes the fused route does not take: RSeq's 18 words
  at C = 2048, where the union is striped, or floors past its shared
  memory):

  1. a lossless lexN union at ``out_size = 2C`` with value planes
     ``(elem, removed, src)``: the lexN kernels' duplicate rule is
     OR-combine-then-keep-first, so side a carries ``src = 1``, side b
     ``src = 2``, a matched row's copies OR into 3 (a kernel that kept the
     first copy of a value plane would break the suppression silently);
     nothing truncates, so a suppressed row never evicts a real one;
  2. coverage is one gather per side from the (W, R) floor planes;
  3. dropped rows are punched to SENTINEL/0 and compacted by a stable
     single-key sort of the hole flag in plain torch (the JAX package does
     it in XLA, outside Pallas): kept rows are already in key order;
  4. ``n_unique`` = kept rows a lane (post-suppression, pre-capacity-slice).

Both routes give the same planes, unique counts and dropped rows, and the
merged floor is the two floors' maximum.

A GC'd swarm lives in this layout for its whole life through
:func:`plan_gc` → :class:`GcSwarm`: its pull rounds
(:func:`gc_gossip_round`) and its barrier (:func:`gc_barrier_checked`, the
whole of ``tomb_gc.gc_round``: convergence, stable floor, collect) run on
the planes and the (W, R) floor plane, with no row-major round trip and
no key sort.
"""
from __future__ import annotations

import contextlib
import dataclasses
import warnings

import torch

from crdt_tpu_torch.models import rseq, rseq_columnar as rc, tomb_gc
from crdt_tpu_torch.models.oplog_engine import EngineFallback
from crdt_tpu_torch.ops import hopper_union
from crdt_tpu_torch.parallel import swarm as swarm_mod
from crdt_tpu_torch.utils.constants import SENTINEL_PY
from crdt_tpu_torch.utils.tracing import trace_region
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


def _gc_union(a: ColumnarGc, b: ColumnarGc):
    """The lossless lexN union (2C rows) of two same-layout columnar GC
    swarms, with the side marker as a third value plane: (keys[3D, 2C, R],
    (elem, removed, src)).  Suppression happens after it, before the
    capacity slice, so a suppressed row never evicts a real one."""
    src_a = (a.col.keys[0] != SENTINEL_PY).to(torch.int32)
    src_b = (b.col.keys[0] != SENTINEL_PY).to(torch.int32) * 2
    keys, vals, _ = rc._union(a.col, b.col, (src_a,), (src_b,))
    return keys, vals


def _compact(keys, elem, removed, drop, valid, cap: int, seq_bits: int):
    """Punch the ``drop`` rows to padding and move every hole below the
    kept rows by a stable sort of the hole flag (kept rows are already in
    key order): (the first ``cap`` rows a lane as a ColumnarRSeq, kept rows
    a lane)."""
    nk = keys.shape[0]
    hole = drop | ~valid
    order = torch.sort(hole.to(torch.uint8), dim=0, stable=True).indices[:cap]
    col = rc.ColumnarRSeq(
        keys=keys.masked_fill(drop[None], SENTINEL_PY).gather(
            1, order[None].expand(nk, -1, -1)),
        elem=elem.masked_fill(drop, 0).gather(0, order),
        removed=removed.masked_fill(drop, 0).gather(0, order),
        seq_bits=seq_bits,
    )
    return col, (~hole).sum(dim=0, dtype=torch.int32)


def _gc_suppress(a: ColumnarGc, b: ColumnarGc, keys, vals):
    """The floor rule on a union from :func:`_gc_union`, then the compaction
    to capacity: (ColumnarGc, n_unique[R], drop[2C, R])."""
    elem, removed, src = vals
    seq_bits = a.col.seq_bits
    valid = keys[0] != SENTINEL_PY
    ident = keys[keys.shape[0] - 1]  # last level's identity word = own (rid, seq)
    drop = ((src == 1) & _covered(ident, valid, b.floor, seq_bits)) | (
        (src == 2) & _covered(ident, valid, a.floor, seq_bits))
    col, n_unique = _compact(keys, elem, removed, drop, valid, a.capacity, seq_bits)
    return ColumnarGc(col=col, floor=torch.maximum(a.floor, b.floor)), n_unique, drop


def _fused(a: ColumnarGc) -> bool:
    """Whether the GC join of ``a``'s layout takes the fused route: a
    CUDA tensor in a shape kernel 1's GC instance takes."""
    device = a.floor.device
    return device.type == "cuda" and hopper_union.lexn_gc_union_plan(
        a.col.keys.shape[0], 2, a.capacity, a.floor.shape[0],
        hopper_union.smem_limit(device)) is not None


def _region(span: str | None, part: str):
    return trace_region(f"{span}.{part}") if span else contextlib.nullcontext()


def _gc_join(a: ColumnarGc, b: ColumnarGc, span: str | None = None):
    """The GC join of two same-layout columnar GC swarms, lane by lane, on
    the route the device and shape take (module docstring): (ColumnarGc,
    n_unique[R], dropped[R]), dropped the rows the floor rule took out of
    each lane.  Under ``span`` the row work opens ``<span>.union`` (the
    fused kernel, or the lossless union) and ``<span>.suppress`` (the floor
    maximum, and the composition's floor rule and compaction)."""
    if a.floor.shape != b.floor.shape:
        raise ValueError(
            f"writer counts differ (floor shapes {tuple(a.floor.shape)} vs "
            f"{tuple(b.floor.shape)})"
        )
    if not _fused(a):
        with _region(span, "union"):
            keys, vals = _gc_union(a, b)
        with _region(span, "suppress"):
            merged, n_unique, drop = _gc_suppress(a, b, keys, vals)
            return merged, n_unique, drop.sum(dim=0, dtype=torch.int32)
    with _region(span, "union"):
        rc.check_layouts(a.col, b.col)
        keys, (elem, removed), n_unique, dropped = hopper_union.gc_union_columnar_lexn(
            a.col.keys, (a.col.elem, a.col.removed), a.floor,
            b.col.keys, (b.col.elem, b.col.removed), b.floor, a.col.seq_bits)
    with _region(span, "suppress"):
        col = rc.ColumnarRSeq(keys=keys, elem=elem, removed=removed, seq_bits=a.col.seq_bits)
        return ColumnarGc(col=col, floor=torch.maximum(a.floor, b.floor)), n_unique, dropped


def gc_merge_checked(a: ColumnarGc, b: ColumnarGc):
    """Lane-wise GC-aware CRDT join on the lexN kernels: exactly
    ``tomb_gc.join_checked(·, ·, rseq.GC_ADAPTER)`` per lane (union, floor
    suppression, capacity slice, floor max).  Returns (ColumnarGc,
    n_unique[R]); n_unique counts post-suppression rows — > capacity means
    truncation broke the state (tomb_gc.GcOverflow)."""
    merged, n_unique, _ = _gc_join(a, b)
    return merged, n_unique


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
        lo, hi = _slice_lanes(work, 0, p), _slice_lanes(work, p, 2 * p)
        work, nu, _ = _gc_join(lo, hi)
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
    with trace_region("rseq_engine.gc_converge"):
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


# ---- the columnar GC swarm: pull rounds and the whole barrier on the planes ----


class GcRowCounts:
    """Rows the floor rule took out of the pull rounds that were kept,
    summed on the device, so no pull waits on the count.  Shared by every
    swarm one :func:`plan_gc` call leads to; the barrier's collected rows
    are its own return value."""

    def __init__(self, device):
        self._suppressed = torch.zeros((), dtype=torch.int64, device=device)

    def add(self, suppressed: torch.Tensor) -> None:
        self._suppressed += suppressed

    def read(self) -> dict:
        """{"suppressed": int} (waits for the device)."""
        return {"suppressed": int(self._suppressed)}


def _received_vv(cg: ColumnarGc) -> torch.Tensor:
    """int32[W, R]: each lane's per-writer knowledge watermark, its table's
    max seq ∨ its floor: ``tomb_gc.received_vv`` on the identity plane."""
    w, lanes = cg.floor.shape
    seq_bits = cg.col.seq_bits
    ident = cg.col.keys[cg.col.keys.shape[0] - 1]
    valid = cg.col.keys[0] != SENTINEL_PY
    rid, seq = ident >> seq_bits, ident & ((1 << seq_bits) - 1)
    rid_safe = torch.where(valid & (rid < w), rid, w).long()
    table = torch.full((w + 1, lanes), -1, dtype=torch.int32, device=ident.device)
    table.scatter_reduce_(0, rid_safe, torch.where(valid, seq, -1), reduce="amax")
    return torch.maximum(cg.floor, table[:w])


def _collect(col: rc.ColumnarRSeq, floor: torch.Tensor):
    """``tomb_gc.collect``'s drop on the planes: every row that is removed
    and that ``floor`` covers, compacted out by the hole flag (the rows
    stay in key order).  Returns (ColumnarRSeq, drop[C, R])."""
    keys = col.keys
    valid = keys[0] != SENTINEL_PY
    drop = _covered(keys[keys.shape[0] - 1], valid, floor, col.seq_bits) & (col.removed != 0)
    out, _ = _compact(keys, col.elem, col.removed, drop, valid, col.capacity, col.seq_bits)
    return out, drop


def gc_gossip_round(cg: ColumnarGc, peers: torch.Tensor, alive: torch.Tensor,
                    counts: GcRowCounts | None = None):
    """One GC pull round in the columnar layout: lane j fetches lane
    peers[j] (table and floor) and joins it as :func:`gc_merge_checked`
    does, kept only where both ends are up.  Exactly
    ``tomb_gc.join_checked(state, state[peers], rseq.GC_ADAPTER)`` gated on
    ``alive & alive[peers]``.  Returns (ColumnarGc, n_unique[R]), n_unique
    0 where the pull was gated off: > capacity means that lane's union
    truncated (GcOverflow)."""
    with trace_region("rseq_engine.gc_gossip_round"):
        with trace_region("rseq_engine.gc_gossip_round.gather"):
            peers = peers.to(device=cg.floor.device, dtype=torch.long)
            peer = tree_map(lambda x: x[..., peers], cg)
        merged, n_unique, dropped = _gc_join(cg, peer, span="rseq_engine.gc_gossip_round")
        with trace_region("rseq_engine.gc_gossip_round.gate"):
            ok = alive & alive[peers]
            out = tree_map(lambda m, x: torch.where(ok, m, x), merged, cg)
            n_unique = torch.where(ok, n_unique, 0)
            if counts is not None:
                counts.add((dropped * ok).sum())
        return out, n_unique


def gc_barrier_checked(cg: ColumnarGc, alive: torch.Tensor):
    """The whole of ``tomb_gc.gc_round`` without leaving the columnar
    layout: the alive lanes' GC least upper bound (:func:`_gc_lub_lane`),
    the stable floor (``swarm.stable_frontier``, chain-ruled against every
    lane's floor, dead lanes' included) and the collect of every row that
    is removed and covered, then the broadcast over the alive lanes; dead
    lanes keep their table and floor.  Every alive lane ends with the same
    table and floor, so the watermark, the floor and the collect are
    computed once on the bound's one lane, and its rows, already in key
    order, are compacted by the hole flag (no key sort).  Returns
    (ColumnarGc, max_n_unique, collected) as device scalars, with no wait:
    max_n_unique > capacity means the convergence truncated and the state
    must not be used (:meth:`GcSwarm.gc_barrier` raises GcOverflow);
    collected counts the rows dropped over the alive lanes."""
    with trace_region("rseq_engine.gc_barrier"):
        with trace_region("rseq_engine.gc_converge"):
            top, max_nu = _gc_lub_lane(mask_dead(cg, alive))
        with trace_region("rseq_engine.gc_barrier.floor"):
            received = _received_vv(top)
            frontier = swarm_mod.stable_frontier(
                received.T.expand(cg.lanes, -1), alive, cg.floor.T)
            floor = torch.maximum(top.floor, torch.minimum(frontier[:, None], received))
        with trace_region("rseq_engine.gc_barrier.collect"):
            col, drop = _collect(top.col, floor)
            collected = drop.sum() * alive.sum()
        with trace_region("rseq_engine.gc_barrier.broadcast"):
            out = _finish_broadcast(cg, ColumnarGc(col=col, floor=floor), alive)
        return out, max_nu, collected


def gc_barrier_swarm(sw):
    """gc_round's engine hook (``rseq.GC_ADAPTER.columnar_barrier``): the
    whole barrier over a Swarm of batched Gc[RSeq] states on the columnar
    engine; returns (swarm after the barrier, max_n_unique as a Python
    int), or None after an EngineFallback warning when the layout is
    ineligible, in which case the caller runs the generic path."""
    try:
        cg = stack(sw.state)
    except ValueError as e:
        warnings.warn(
            f"RSeq GC barrier fell back to the generic engine: {e}",
            EngineFallback, stacklevel=2,
        )
        return None
    out, max_nu, _ = gc_barrier_checked(cg, sw.alive)
    return dataclasses.replace(sw, state=unstack(out)), int(max_nu)


class GcSwarm:
    """A swarm of R GC'd RSeq replicas resident, for its whole life, in the
    engine its layout allows: the columnar planes with the (W, R) floor
    plane (``engine == "columnar"``, kernel 1 doing every join), or the
    batched row-major ``tomb_gc.Gc`` (``"generic"``, after a loud
    fallback; ``fallback_reason`` says why).  Build with :func:`plan_gc`;
    every call returns a new swarm.  Both engines give bit-identical
    states, unique counts and collected rows; ``counts`` (the columnar
    engine's :class:`GcRowCounts`) is None on the generic one."""

    def __init__(self, *, cg=None, rows=None, alive, fallback_reason=None, counts=None):
        if (cg is None) == (rows is None):
            raise ValueError("GcSwarm holds exactly one of cg / rows")
        self._cg = cg
        self._rows = rows
        self.alive = alive
        self.fallback_reason = fallback_reason
        self.counts = counts

    @property
    def engine(self) -> str:
        return "generic" if self._cg is None else "columnar"

    @property
    def capacity(self) -> int:
        return self._rows.inner.capacity if self._cg is None else self._cg.capacity

    @property
    def columnar(self) -> ColumnarGc | None:
        """The resident planes (None on the generic engine)."""
        return self._cg

    def rows(self) -> tomb_gc.Gc:
        """The swarm as a batched row-major Gc[RSeq] (transposes on the
        columnar engine: an accessor for reads and checks, not the hot
        path)."""
        return self._rows if self._cg is None else unstack(self._cg)

    def _wrap(self, cg=None, rows=None, alive=None) -> "GcSwarm":
        return GcSwarm(cg=cg, rows=rows, alive=self.alive if alive is None else alive,
                       fallback_reason=self.fallback_reason, counts=self.counts)

    def set_alive(self, rid, alive_status) -> "GcSwarm":
        alive = self.alive.clone()
        alive[rid] = alive_status
        return self._wrap(cg=self._cg, rows=self._rows, alive=alive)

    def gossip_round(self, peers):
        """One GC pull round: replica j joins replica peers[j]'s table and
        floor, kept only where both are up.  Returns (GcSwarm,
        n_unique[R]) with no wait; n_unique is 0 where the pull was gated
        off, and > capacity where the union truncated."""
        if self._cg is not None:
            cg, n_unique = gc_gossip_round(self._cg, peers, self.alive, self.counts)
            return self._wrap(cg=cg), n_unique
        peers = peers.to(device=self.alive.device, dtype=torch.long)
        joined, n_unique = tomb_gc.join_checked(
            self._rows, tree_map(lambda x: x[peers], self._rows), rseq.GC_ADAPTER)
        ok = self.alive & self.alive[peers]
        rows = tree_map(
            lambda j, x: torch.where(ok.reshape((-1,) + (1,) * (x.dim() - 1)), j, x),
            joined, self._rows)
        return self._wrap(rows=rows), torch.where(ok, n_unique, 0)

    def gc_barrier_checked(self):
        """The GC barrier (``tomb_gc.gc_round``) with no wait: returns
        (GcSwarm, max_n_unique, collected) as device scalars, where
        max_n_unique > capacity means the convergence truncated and the
        swarm must not be used."""
        if self._cg is not None:
            cg, max_nu, collected = gc_barrier_checked(self._cg, self.alive)
            return self._wrap(cg=cg), max_nu, collected
        sw = swarm_mod.make(self._rows, self.alive)
        neutral = rseq.empty(self.capacity, self._rows.inner.depth, device=self.alive.device)
        converged, max_nu = tomb_gc.generic_converge(sw, rseq.GC_ADAPTER, neutral)
        out = tomb_gc.collect_swarm(converged, rseq.GC_ADAPTER)
        before, after = (rseq.n_rows(s.state.inner) for s in (converged, out))
        collected = ((before - after) * self.alive).sum()
        return (self._wrap(rows=out.state),
                torch.tensor(max_nu, dtype=torch.int32, device=self.alive.device), collected)

    def gc_barrier(self):
        """The GC barrier, read back: (GcSwarm, max_n_unique, collected) as
        Python ints, in one wait.  Raises GcOverflow where
        ``tomb_gc.gc_round`` raises."""
        out, max_nu, collected = self.gc_barrier_checked()
        max_nu, collected = torch.stack([max_nu.to(torch.int64), collected]).tolist()
        tomb_gc._refuse_overflow(max_nu, self.capacity)
        return out, max_nu, collected


def plan_gc(states: tomb_gc.Gc, alive: torch.Tensor | None = None,
            force_generic: bool = False) -> GcSwarm:
    """Build the swarm engine for batched Gc[RSeq] states ([R, C, 4D] inner,
    [R, W] floors), on their device.  The columnar engine is the DEFAULT:
    it is chosen whenever the states stage (:func:`stack`: a power-of-two
    capacity, identities within the pack budget); otherwise the generic
    row-major engine serves, after an ``EngineFallback`` warning naming the
    violated budget."""
    r = states.floor.shape[0]
    if alive is None:
        alive = torch.ones((r,), dtype=torch.bool, device=states.floor.device)
    if force_generic:
        return GcSwarm(rows=states, alive=alive, fallback_reason="forced by caller")
    try:
        cg = stack(states)
    except ValueError as e:
        warnings.warn(f"RSeq GC swarm fell back to the generic engine: {e}",
                      EngineFallback, stacklevel=2)
        return GcSwarm(rows=states, alive=alive, fallback_reason=str(e))
    return GcSwarm(cg=cg, alive=alive, counts=GcRowCounts(cg.floor.device))
