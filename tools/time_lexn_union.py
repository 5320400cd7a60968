"""Time the union kernels on chip_smoke.py's inputs: at C=1024 rows x
L=10,240 lanes the union at the OpLog's split (2 key words, 2 value
planes; two seeded 40% subsets of the reference-shaped write pool) and
the RSeq merge and compaction on phase 9's ``workload.seq_swarm`` draw
(18 key words; 2 value planes, or 3 with the GC join's src marker); at
C=1024 x L=2^20 the single-key OR-Set union; at C=1024 x L=131,072 the
bucket-local union and the single-key merge on chip_smoke.py phase 8's
draws.

    python3 tools/time_lexn_union.py [--root CHECKOUT] [--reps N] [--cases ...]

Cases: ``oplog`` (lexn_union, out=C; the default), ``merge20`` and
``merge21`` (lexn_merge at (18, 2) and (18, 3)), ``compact20`` (lexn_compact
of the 20-plane merge, out=C), ``compact21`` (of the 21-plane merge,
out=2C, the GC join's shape) and ``set2m`` (set_union through
``sorted_union_columnar_fused`` at out=C on L=2^20 lanes: one 131,072-lane
``workload.set_swarm`` draw a side, as chip_smoke.py phase 6 draws it,
repeated 8 times along the lane axis), ``bucket16`` and ``bucket32``
(bucketed_union at out_bucket_rows = Wb, the resident chain's shape, and
2·Wb, the bucket engine's, on phase 8's strided draw converted by
``sorted_to_bucketed``: B=64 buckets of Wb=16 rows, 15 key bits) and
``merge131k`` (bitonic_merge_columnar on phase 8's 131,072-lane
set_swarm draw), ``floor131k`` and ``bfloor131k`` (the OR-Set floors
floor_union at out=C and bucketed_floor_union at B=64 on chip_smoke.py
phase 13's draw: C=1024, L=131,072, each column sorted uniform [0, 2^30)
with the first C/2 rows real, vals = the draw & 1).  Each compaction takes
its checkout's own merge of the same draw.  The RSeq unions go through
``sorted_union_columnar_lexn_auto``, so that each checkout takes its own
route (fused or striped): ``rseq512`` and ``rseq512gc`` ((18, 2) and
(18, 3) at C=512, out=C, L=10,240 on phase 9's C=512 draw), ``rseq1024``
((18, 2) at C=1024, out=C on phase 9's draw) and ``gc1024`` ((18, 3),
out=2C, the GC join's shape), and ``soak1`` ((18, 3) at one lane, out=2C:
the operands of the first join of phase 16's sequence soak at capacity
512, 4 replicas, seed 0); ``merge2k`` times ``lexn_merge`` at that soak's
C = 2048 shape: one lane, (18, 3), the stripe of 1,024 rows the striped
union merges (A's first stripe against B's second, as its first merge
pairs them) on the operands of its first join.  ``gossip``, ``converge`` and ``gcconverge`` time
the RSeq path's calls on chip_smoke.py phase 10's swarm (R=10,240,
C=1024, depth 6, replica 7 dead): ``rseq_columnar.gossip_round`` with its
first peer round, ``converge_checked``, and
``rseq_engine.gc_converge_checked`` of the converged swarm with empty
floors (16 writers), each through its checkout's own route; ``gcpull``
one GC pull round (``rseq_engine.gc_gossip_round``) of the swarm before
convergence with empty floors, through its checkout's own route, and
``gcunion1024`` kernel 1's GC instance alone
(``hopper_union.gc_union_columnar_lexn``, (18, 2), out=C) on phase 9's
draw with empty floors (16 writers).  ``pair2k``,
``pair4k`` and ``pair5`` time the fused union (out=C) on
``workload.lexn_pair`` draws at the other shapes kernel 1's wide body
took from the first one-lane body: (2, 2) at C=2048 and 4096, and (5, 2)
at C=64, on L=10,240 lanes; ``pair18x64``, ``pair18x128`` and
``pair18x256`` at (18, 2) and small capacities.

``--root`` picks the checkout whose ``crdt_tpu_torch`` is imported and
built (default: the one holding this script), so that two versions of the
kernel compare on one card in one session: unpack the other version with
``git archive`` into a git-ignored directory and run the two alternately
(parent, change, change, parent).  Prints one JSON line a case: the
card's name and power limit, the median ms a call over ``--reps``
CUDA-event-timed calls after two warm-up calls, every call's time, the
device time of a call's kernels (``device_ms``: torch.profiler over ten
more calls; the events also count the host's launch gap, which is a
visible share of a call under a millisecond), and a checksum of the
call's output, so that the versions can be seen to agree.  Exits 1
without a card.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

SEED = 20240           # chip_smoke.py's seed and shapes
R, C = 10_240, 1024
N_KEYS = 62
SENTINEL = 2**31 - 1
SET_L, SET_REPEAT = 131_072, 8   # the OR-Set draw's lanes, and its copies
N_BUCKETS, KEY_BITS = 64, 15     # phase 8's bucketed layout
FLOOR_SEED = SEED + 61           # phase 13's floor draw
# (key words, value planes, capacity) of the lexn_pair cases
PAIR_CASES = {"pair2k": (2, 2, 2048), "pair4k": (2, 2, 4096), "pair5": (5, 2, 64),
              "pair18x64": (18, 2, 64), "pair18x128": (18, 2, 128), "pair18x256": (18, 2, 256)}
CASES = ("oplog", "merge20", "merge21", "compact20", "compact21", "set2m", "bucket16",
         "bucket32", "merge131k", "floor131k", "bfloor131k", "rseq512", "rseq512gc",
         "soak1", "merge2k", "rseq1024", "gc1024", "gossip", "converge", "gcconverge",
         "gcpull", "gcunion1024", *PAIR_CASES)
PATH_CASES = ("gossip", "converge", "gcconverge", "gcpull")
# the union cases through the auto route: (capacity, GC join's src plane,
# out rows, the draws' seeds)
UNION_CASES = {"rseq512": (512, False, 512, (SEED + 43, SEED + 44)),
               "rseq512gc": (512, True, 512, (SEED + 43, SEED + 44)),
               "rseq1024": (C, False, C, (SEED + 41, SEED + 42)),
               "gc1024": (C, True, 2 * C, (SEED + 41, SEED + 42))}


def checksum(planes) -> int:
    """Sum over the planes of (index + 1) x the plane's sum in int64, taken
    in row blocks so that a 2^20-lane plane needs no int64 copy."""
    total = 0
    for i, p in enumerate(planes):
        rows = max(1, (1 << 26) // max(1, p[0].numel()))
        total += (i + 1) * sum(int(p[r:r + rows].long().sum())
                               for r in range(0, p.shape[0], rows))
    return total


def time_call(call, reps: int) -> list:
    call()
    call()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        call()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return times


def device_ms(call, reps: int = 10) -> float:
    """The mean device time of one call's kernels (and copies), from
    torch.profiler over ``reps`` calls."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            call()
        torch.cuda.synchronize()
    # a device copy of each host range shares its name with the host range
    averages = prof.key_averages()
    host_keys = {e.key for e in averages if e.device_type == DeviceType.CPU}
    return sum(e.self_device_time_total for e in averages
               if e.device_type == DeviceType.CUDA and e.key not in host_keys) / reps / 1e3


def oplog_call(workload, oc, hu):
    w = workload.reference_writes(C, R, SEED)

    def planes(seed):
        logs, _ = workload.subset_swarm(w.ops, R, C, 0.4, seed, device="cuda")
        col = oc.stack(logs, bits=oc.fit_bits(R, N_KEYS))
        return [col.hi, col.lo, col.val, col.pay]

    a, b = planes(SEED + 1), planes(SEED + 2)

    def call():
        return hu.sorted_union_columnar_fused_lexn(a[:2], a[2:], b[:2], b[2:], out_size=C)

    keys, vals, nu = call()
    return call, checksum((*keys, *vals, nu))


def rseq_sides(workload, rc, gc: bool, c: int = C, seeds=(SEED + 41, SEED + 42)):
    """chip_smoke.py phase 9's operands: two seq_swarm draws, 18 key words
    and (elem, removed), plus the GC join's src marker when ``gc``."""
    pool = workload.seq_pool(SEED)
    sides = []
    for k, seed in zip((1, 2), seeds):
        col = rc.stack(workload.seq_swarm(pool, R, c, seed, device="cuda").states)
        vals = (col.elem, col.removed)
        if gc:
            vals += ((col.keys[0] != SENTINEL).to(torch.int32) * k,)
        sides += [tuple(col.keys), vals]
    return sides


def rseq_call(case: str, workload, rc, hu):
    sides = rseq_sides(workload, rc, case.endswith("21"))
    if case.startswith("merge"):
        def call():
            return hu.lexn_merge_columnar(*sides)

        keys, vals = call()
        return call, checksum((*keys, *vals))
    mk, mv = hu.lexn_merge_columnar(*sides)
    out = 2 * C if case.endswith("21") else C
    del sides

    def call():
        return hu.lexn_compact_columnar(mk, mv, out)

    keys, vals, nu = call()
    return call, checksum((*keys, *vals, nu))


def union_call(case: str, workload, rc, hu):
    """The RSeq union through the auto route, at a shape of UNION_CASES."""
    c, gc, out, seeds = UNION_CASES[case]
    sides = rseq_sides(workload, rc, gc, c, seeds)

    def call():
        return hu.sorted_union_columnar_lexn_auto(*sides, out_size=out)

    keys, vals, nu = call()
    return call, checksum((*keys, *vals, nu))


def soak_sides(capacity: int) -> tuple:
    """The union operands of the first join of phase 16's sequence soak at
    ``capacity`` (4 replicas, seed 0): one lane, 18 key words, (elem,
    removed, src), as ``rseq_engine.gc_merge_checked`` passes them."""
    from crdt_tpu_torch.harness.seq_soak import SeqSoakRunner
    from crdt_tpu_torch.models import rseq_engine as reng

    runner = SeqSoakRunner(n=4, seed=0, capacity=capacity, device="cuda")
    real, seen = reng.gc_join_checked_auto, []

    def spy(a, b):
        seen.append((a, b))
        return real(a, b)

    reng.gc_join_checked_auto = spy
    try:
        while not seen:
            runner.step()
    finally:
        reng.gc_join_checked_auto = real
    ca, cb = reng._stack_pair(*seen[0])

    def side(col, k):
        return (tuple(col.keys), (col.elem, col.removed,
                                  (col.keys[0] != SENTINEL).to(torch.int32) * k))

    return (*side(ca.col, 1), *side(cb.col, 2))


def soak_call(hu):
    """The union of the first join of phase 16's sequence soak at capacity
    512, out=2C."""
    sides = soak_sides(512)

    def call():
        return hu.sorted_union_columnar_lexn_auto(*sides)

    keys, vals, nu = call()
    return call, checksum((*keys, *vals, nu))


def soak_merge_call(hu):
    """``lexn_merge`` at the capacity-2048 soak's stripe: A's first 1,024
    rows against B's second, one lane, (18, 3)."""
    ka, va, kb, vb = soak_sides(2048)
    s = 1024

    def rows(planes, lo):
        return tuple(p[lo:lo + s].contiguous() for p in planes)

    sides = (rows(ka, 0), rows(va, 0), rows(kb, s), rows(vb, s))

    def call():
        return hu.lexn_merge_columnar(*sides)

    keys, vals = call()
    return call, checksum((*keys, *vals))


def gc_union_call(workload, rc, hu):
    """Kernel 1's GC instance at (18, 2), out=C, on phase 9's draw with
    floors of -1 for 16 writers."""
    ka, va, kb, vb = rseq_sides(workload, rc, False)
    floor = torch.full((16, R), -1, dtype=torch.int32, device="cuda")

    def call():  # floors of -1 cover nothing, whatever the identity split
        return hu.gc_union_columnar_lexn(ka, va, floor, kb, vb, floor, 20)

    keys, vals, nu, dropped = call()
    return call, checksum((*keys, *vals, nu, dropped))


def pair_call(case: str, workload, hu):
    """The fused union at out=C on a ``workload.lexn_pair`` draw."""
    n_keys, n_vals, c = PAIR_CASES[case]
    sides = workload.lexn_pair(n_keys, n_vals, c, R, SEED + c, device="cuda")

    def call():
        return hu.sorted_union_columnar_fused_lexn(*sides, out_size=c)

    keys, vals, nu = call()
    return call, checksum((*keys, *vals, nu))


def path_call(case: str, workload, rc):
    """The RSeq path's call of ``case`` on phase 10's swarm."""
    from crdt_tpu_torch.models import rseq_engine as reng, tomb_gc
    from crdt_tpu_torch.parallel import swarm
    from crdt_tpu_torch.utils.tree import leaves

    pool = workload.seq_pool(SEED)
    sw = workload.seq_swarm(pool, R, C, SEED + 31, device="cuda")
    alive = torch.ones(R, dtype=torch.bool, device="cuda")
    alive[7] = False
    peers = swarm.random_peers(torch.Generator(device="cuda").manual_seed(SEED + 32), R,
                               device="cuda")
    col, _ = rc.plan(sw.states)
    del sw
    if case == "gossip":
        def call():
            return rc.gossip_round(col, peers, alive)
    elif case == "converge":
        def call():
            return rc.converge_checked(col, alive)
    elif case == "gcpull":
        cg = reng.ColumnarGc(col=col, floor=torch.full((16, R), -1, dtype=torch.int32,
                                                       device="cuda"))

        def call():
            return reng.gc_gossip_round(cg, peers, alive)
    else:
        conv = rc.unstack(rc.converge_checked(col, alive)[0])
        cg = reng.stack(tomb_gc.Gc(inner=conv, floor=torch.full(
            (R, 16), -1, dtype=torch.int32, device="cuda")))
        del col, conv

        def call():
            return reng.gc_converge_checked(cg, alive)

    return call, checksum([x if x.dim() > 1 else x[None] for x in leaves(call())])


def set_call(workload, orset, hu):
    """Kernel 2 at L=2^20: two set_swarm draws (chip_smoke.py phase 6's
    seeds) at 131,072 lanes, each repeated 8 times along the lanes."""
    pool = workload.set_pool(SEED)
    sides = []
    for seed in (SEED + 11, SEED + 12):
        planes = orset.stack_to_columnar(
            workload.set_swarm(pool, SET_L, C, seed, device="cuda").sets)
        sides += [torch.cat([p] * SET_REPEAT, dim=1) for p in planes]
        del planes
    torch.cuda.empty_cache()

    def call():
        return hu.sorted_union_columnar_fused(*sides, out_size=C)

    return call, checksum(call())


def bucket_call(case: str, workload, ue, hu):
    """Kernel 3 on phase 8's strided draws (seeds SEED+13, SEED+14: C/2
    live keys a lane over a 32·C universe) in the bucketed layout, at
    out_bucket_rows = Wb (``bucket16``) or 2·Wb (``bucket32``)."""
    sides = []
    for seed in (SEED + 13, SEED + 14):
        keys, vals = workload.strided_columns(C, SET_L, C // 2, 32 * C, seed, device="cuda")
        sides += ue.sorted_to_bucketed(keys, vals, N_BUCKETS, KEY_BITS)[:2]
    out_r = C // N_BUCKETS * (2 if case == "bucket32" else 1)

    def call():
        return hu.bucketed_union_columnar(*sides, n_buckets=N_BUCKETS, out_bucket_rows=out_r)

    return call, checksum(call())


def merge_call(workload, orset, hu):
    """Kernel 6 on phase 8's set_swarm draws (seeds SEED+11, SEED+12) at
    131,072 lanes."""
    pool = workload.set_pool(SEED)
    sides = []
    for seed in (SEED + 11, SEED + 12):
        sides += orset.stack_to_columnar(
            workload.set_swarm(pool, SET_L, C, seed, device="cuda").sets)

    def call():
        return hu.bitonic_merge_columnar(*sides)

    return call, checksum(call())


def floor_call(case: str, of):
    """Kernel 7 (``floor131k``, out=C) or 8 (``bfloor131k``, B=64) on
    chip_smoke.py phase 13's draw."""
    rng = np.random.default_rng(FLOOR_SEED)
    sides = []
    for _ in range(2):
        kk = torch.from_numpy(rng.integers(0, 1 << 30, (C, SET_L), dtype=np.int32)).cuda()
        kk = torch.sort(kk, dim=0).values
        real = torch.arange(C, device="cuda")[:, None] < C // 2
        sides += [torch.where(real, kk, SENTINEL).contiguous(), kk & 1]

    def call():
        if case == "floor131k":
            return of.floor_union(*sides, C)
        return of.bucketed_floor_union(*sides, N_BUCKETS)

    return call, checksum(call())


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parent.parent))
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--cases", nargs="+", choices=CASES, default=["oplog"])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("time_lexn_union: no CUDA device available", file=sys.stderr)
        return 1
    root = str(Path(args.root).resolve())
    sys.path.insert(0, root)
    from crdt_tpu_torch import workload
    from crdt_tpu_torch.models import oplog_columnar as oc, orset, rseq_columnar as rc
    from crdt_tpu_torch.ops import hopper_union as hu
    from crdt_tpu_torch.ops import orset_floor as of
    from crdt_tpu_torch.ops import union_engine as ue

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    for case in args.cases:
        if case == "oplog":
            call, total = oplog_call(workload, oc, hu)
        elif case == "set2m":
            call, total = set_call(workload, orset, hu)
        elif case.startswith("bucket"):
            call, total = bucket_call(case, workload, ue, hu)
        elif case == "merge131k":
            call, total = merge_call(workload, orset, hu)
        elif case.endswith("floor131k"):
            call, total = floor_call(case, of)
        elif case in UNION_CASES:
            call, total = union_call(case, workload, rc, hu)
        elif case == "soak1":
            call, total = soak_call(hu)
        elif case == "merge2k":
            call, total = soak_merge_call(hu)
        elif case in PATH_CASES:
            call, total = path_call(case, workload, rc)
        elif case in PAIR_CASES:
            call, total = pair_call(case, workload, hu)
        elif case == "gcunion1024":
            call, total = gc_union_call(workload, rc, hu)
        else:
            call, total = rseq_call(case, workload, rc, hu)
        times = time_call(call, args.reps)
        lanes = {"set2m": SET_L * SET_REPEAT, "bucket16": SET_L, "bucket32": SET_L,
                 "merge131k": SET_L, "floor131k": SET_L, "bfloor131k": SET_L,
                 "soak1": 1, "merge2k": 1}.get(case, R)
        c = (512 if case == "soak1" else 1024 if case == "merge2k" else PAIR_CASES[case][2] if case in PAIR_CASES
             else UNION_CASES.get(case, (C,))[0])
        print(json.dumps({"root": root, "card": card, "case": case, "C": c, "L": lanes,
                          "median_ms": statistics.median(times), "ms": times,
                          "device_ms": device_ms(call), "checksum": total}), flush=True)
        del call
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
