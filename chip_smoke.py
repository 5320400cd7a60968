"""Drive the PyTorch port's OpLog swarm path and its OR-Set swarm path on a
CUDA card and check them.

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result):

1. card and build — the card's name and power limit (nvidia-smi), then
   every kernel built from ``crdt_tpu_torch/csrc`` (one nvcc per source,
   all started together);
2. OpLog: the lexn_union kernel vs its plain twin on the card, bit-exact
   on every plane and n_unique: a mid-gossip swarm at C=1024, L=10,240, an
   overflow case, and ragged lane counts;
3. OpLog end to end at R=10,240 replicas x C=1024 log rows: ``plan``
   (must pick the columnar engine) → 3 ``gossip_round``s with one replica
   dead → ``converge_checked`` → ``rebuild`` → ``materialize``, checked
   against the port's generic engine, a plain fold of the write pool, and
   the predicted kernel launch count;
4. OpLog times on the card (CUDA events, median after warm-up);
5. one pass of the OpLog path under torch.profiler: device time by kernel
   and the device's busy share;
6. OR-Set: the set_union, merge and bucketed_union kernels vs their plain
   twins at C=1024, L=131,072 (an OR-Set swarm draw, and the JAX
   package's strided three-arm draw in the bucketed layout), with overflow
   cases and ragged lane counts, bit-exact on every output;
7. OR-Set end to end at BASELINE's R=1,048,576 replicas x C=1024 tag rows:
   ``stack_to_columnar`` of two seeded swarms → ``columnar_join`` (the
   sort engine: one set_union launch) → ``columnar_member_mask``, checked
   against the plain twin on the first and last 65,536 lanes and against a
   plain fold of the tag pool on 66 sampled lanes; then times at that size
   and one profiled ``columnar_join``;
8. OR-Set engines at L=131,072: the ``auto`` plan's bucket fallback, the
   three engines bit-identical on the strided draw, the bucket-resident
   chain and the unfused union (merge kernel + epilogue) against the sort
   path; then the merge, bucketed_union and auto-dispatch times.

The second-to-last line is the kernel table as JSON; the last line is
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time

import torch

SEED = 20240
R, C = 10_240, 1024          # replicas (BASELINE's 10K swarm) x log rows
N_WRITES = 1000              # the reference-shaped write pool
HOLD_FRACTION = 0.4          # each replica starts with a seeded subset
DEAD = 7                     # one replica down during the run
N_KEYS = 62                  # the reference's key alphabet
HBM_BYTES_PER_S = 3.35e12    # H100 SXM HBM3, NVIDIA data sheet
INT32_OPS_PER_S = 16.7e12    # H100 SXM: 132 SMs x 64 INT32 lanes x 1.98 GHz
SENTINEL = 2**31 - 1
KV_FIELDS = ("present", "is_num", "num", "num_count", "payload")

# the OR-Set slice: BASELINE.json configs[3], "OR-Set: 1M replicas x 1K
# elements" (workload.set_pool / set_swarm hold the draw's constants)
SET_R, SET_C = 1 << 20, 1024  # replicas x tag rows per replica
SET_L = 131_072               # lanes of the kernel checks and the engines phase
SET_UNIVERSE = 1024           # element ids
N_BUCKETS = 64                # the strided draw's bucketed layout, as
KEY_BITS = 15                 # benches/bench_orset.py runs it (space 32*C)
SLICE = 65_536                # lanes of each full-size kernel-vs-twin slice
N_SAMPLED = 64                # seeded lanes checked against the plain fold


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int, warmup: int = 2) -> float:
    """Median of ``reps`` single-call times, each bracketed by CUDA events."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def swarm_planes(w, c: int, lanes: int, fraction: float, seed: int) -> list:
    """(hi, lo, val, pay) planes on the card of a mid-gossip swarm over the
    write pool ``w``: each lane holds a seeded ``fraction`` of it (its first
    c held ops when it draws more), stacked into the columnar layout."""
    from crdt_tpu_torch import workload
    from crdt_tpu_torch.models import oplog_columnar as oc

    logs, _ = workload.subset_swarm(w.ops, lanes, c, fraction, seed, device="cuda")
    col = oc.stack(logs, bits=oc.fit_bits(lanes, N_KEYS))
    return [col.hi, col.lo, col.val, col.pay]


def check_kernel_vs_twin(hu, a, b, out_size, label) -> tuple:
    """Kernel and plain twin on the same tensors: every plane and n_unique
    bit-equal.  Returns (largest n_unique, largest |kernel - twin|)."""
    k_keys, k_vals, k_nu = hu.sorted_union_columnar_fused_lexn(
        a[:2], a[2:], b[:2], b[2:], out_size=out_size)
    t_keys, t_vals, t_nu = hu._lexn_union_plain(
        a[:2], a[2:], b[:2], b[2:], 2 * a[0].shape[0] if out_size is None else out_size)
    err = same(label, (*k_keys, *k_vals, k_nu), (*t_keys, *t_vals, t_nu))
    nu = int(k_nu.max())
    log(f"kernel vs twin [{label}]: bit-exact, C={a[0].shape[0]} "
        f"L={a[0].shape[1]} out={out_size} max_n_unique={nu}")
    return nu, err


def check_kernel(hu, c, lanes) -> int:
    """Phase 2 at (c, lanes): mid-gossip, overflow and ragged shapes, each
    two seeded subsets of one pool of reference-shaped writes.  Returns the
    largest |kernel - twin| seen (0 when bit-exact)."""
    from crdt_tpu_torch import workload

    err = 0
    w = workload.reference_writes(c, lanes, SEED)
    a = swarm_planes(w, c, lanes, 0.4, SEED + 1)
    b = swarm_planes(w, c, lanes, 0.4, SEED + 2)
    err = max(err, check_kernel_vs_twin(hu, a, b, c, "mid-gossip")[1])
    w = workload.reference_writes(2 * c, lanes, SEED)
    oa = swarm_planes(w, c, lanes, 0.6, SEED + 3)
    ob = swarm_planes(w, c, lanes, 0.6, SEED + 4)
    nu, e = check_kernel_vs_twin(hu, oa, ob, c, "overflow")
    if nu <= c:
        raise AssertionError("overflow case did not overflow")
    err = max(err, e)
    for n in (1, 127, 130):
        w = workload.reference_writes(16, n, SEED)
        ra = swarm_planes(w, 8, n, 0.5, SEED + 5)
        rb = swarm_planes(w, 8, n, 0.5, SEED + 6)
        err = max(err, check_kernel_vs_twin(hu, ra, rb, 8, f"ragged L={n}")[1])
        err = max(err, check_kernel_vs_twin(hu, ra, rb, None, f"ragged L={n} untruncated")[1])
    return err


def kv_equal(x, y) -> bool:
    return all(torch.equal(getattr(x, f), getattr(y, f)) for f in KV_FIELDS)


def kv_lane(oplog, kv, lane):
    return oplog.KVState(*(getattr(kv, f)[lane] for f in KV_FIELDS))


def run_slice(device, r, c, n_writes, dead, seed):
    """Phase 3: the port's main path through the entry points a user calls,
    then its checks.  Returns (columnar planes before the run, the swarm
    after it, alive mask, peer rounds, host seconds of the main path)."""
    from crdt_tpu_torch import workload
    from crdt_tpu_torch.models import oplog, oplog_engine as eng
    from crdt_tpu_torch.ops import hopper_union as hu
    from crdt_tpu_torch.parallel import swarm

    w = workload.reference_writes(n_writes, r, seed)
    logs, held = workload.subset_swarm(w.ops, r, c, HOLD_FRACTION, seed, device=device)
    alive = torch.ones(r, dtype=torch.bool, device=device)
    alive[dead] = False
    peer_gen = torch.Generator(device=device).manual_seed(seed + 1)
    rounds = [swarm.random_peers(peer_gen, r, device=device) for _ in range(3)]
    lanes = (0, 1, r // 2, r - 1, dead)
    sync(device)

    for name in hu.LAUNCHES:
        hu.LAUNCHES[name] = 0
    t0 = time.perf_counter()
    sw = eng.plan(logs, alive=alive)
    if sw.engine != "columnar":
        raise AssertionError(f"plan fell back: {sw.fallback_reason}")
    start_col = sw.columnar
    for peers in rounds:
        sw = sw.gossip_round(peers)
    sw, max_nu = sw.converge_checked()
    kv = sw.rebuild(N_KEYS)
    views = {lane: oplog.materialize(kv_lane(oplog, kv, lane), w.keys, w.values)
             for lane in lanes}
    sync(device)
    seconds = time.perf_counter() - t0
    launches = dict(hu.LAUNCHES)
    log(f"main path: plan -> 3 gossip rounds -> converge -> rebuild -> materialize "
        f"at R={r} C={c}: {seconds:.3f} s host wall, launches {launches}")

    max_nu = int(max_nu)
    if max_nu > c:
        raise AssertionError(f"max_n_unique {max_nu} > C={c}")
    live = alive.nonzero().squeeze(1)
    for f in KV_FIELDS:
        x = getattr(kv, f)[live]
        if not bool((x == x[:1]).all()):
            raise AssertionError(f"alive lanes disagree on KVState.{f}")
    for p in ("hi", "lo", "val", "pay"):
        if not torch.equal(getattr(sw.columnar, p)[:, dead], getattr(start_col, p)[:, dead]):
            raise AssertionError(f"dead lane {dead} changed on plane {p}")

    gsw = eng.plan(logs, alive=alive, force_generic=True)
    for peers in rounds:
        gsw = gsw.gossip_round(peers)
    gsw, g_nu = gsw.converge_checked()
    if not kv_equal(kv, gsw.rebuild(N_KEYS)) or int(g_nu) != max_nu:
        raise AssertionError("columnar engine != generic engine")
    want = workload.converged_view(w.ops, held[alive.cpu().numpy()].any(axis=0),
                                   w.keys, w.values)
    for lane, view in views.items():
        if lane != dead and view != want:
            raise AssertionError(f"lane {lane} materialized view != plain fold")
    if views[dead] != workload.converged_view(w.ops, held[dead], w.keys, w.values):
        raise AssertionError("dead lane's view changed")
    log(f"slice checks: alive lanes equal, == generic engine, == plain fold "
        f"({len(want)} keys), max_n_unique={max_nu} <= C, dead lane unchanged")
    return start_col, alive, rounds, launches


def profile(label: str, fn) -> None:
    """One call of ``fn`` under torch.profiler: device time by kernel and
    the device's busy share of the call's wall time (the profiler's own
    host overhead is inside the wall)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as torch_profile

    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # device-side events are the kernels and memcpys, plus a device copy of
    # each record_function range, which shares its name with the host range
    averages = prof.key_averages()
    host_keys = {e.key for e in averages if e.device_type == DeviceType.CPU}
    events = [e for e in averages if e.device_type == DeviceType.CUDA
              and e.key not in host_keys and e.self_device_time_total > 0]
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3
    if not events:
        log(f"profile [{label}]: torch.profiler recorded no device time; busy share "
            "not measured")
        return
    log(f"profile [{label}]: device busy {busy_ms:.4f} ms of {wall_ms:.4f} ms wall "
        f"(idle share {1 - busy_ms / wall_ms:.3f}, under the profiler)")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:8]:
        log(f"  {e.self_device_time_total / 1e3:9.4f} ms  x{e.count:<4d} {e.key[:90]}")


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def bound(n_bytes: int, n_ops: int) -> tuple:
    """(bound ms, "bytes" or "operations"): the larger of the bytes over the
    HBM rate and the int32 operations over the int32 rate."""
    bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    ops_ms = n_ops / INT32_OPS_PER_S * 1e3
    return max(bytes_ms, ops_ms), "bytes" if bytes_ms >= ops_ms else "operations"


def kernel_row(name, source, replaces, launches, err, ms, plain_ms, n_bytes, n_ops,
               library_ms, card) -> dict:
    bound_ms, bound_by = bound(n_bytes, n_ops)
    log(f"{name}: {ms:.4f} ms/launch, plain twin {plain_ms:.4f} ms, library "
        f"{library_ms:.4f} ms, bound {bound_ms:.4f} ms by {bound_by} "
        f"({n_bytes / 1e9:.3f} GB at 3.35 TB/s; {n_ops / 1e9:.3f} G int32 compares "
        f"at {INT32_OPS_PER_S / 1e12:.1f} T/s) [{card}]")
    return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library_ms}


def oplog_phases(card: str) -> dict:
    """Phases 2-5: the OpLog swarm path.  Returns lexn_union's table row."""
    from crdt_tpu_torch import workload
    from crdt_tpu_torch.models import oplog_columnar as oc
    from crdt_tpu_torch.ops import hopper_union as hu

    # ---- 2. kernel vs plain twin ----
    max_err = check_kernel(hu, C, R)

    # ---- 3. the slice end to end ----
    col, alive, rounds, launches = run_slice("cuda", R, C, N_WRITES, DEAD, SEED)
    expected = 3 + math.ceil(math.log2(R))
    if launches["lexn_union"] != expected:
        raise AssertionError(f"lexn_union launched {launches['lexn_union']} times "
                             f"on the main path, expected {expected}")

    # ---- 4. times on the card ----
    w = workload.reference_writes(C, R, SEED)
    a = swarm_planes(w, C, R, 0.4, SEED + 1)
    b = swarm_planes(w, C, R, 0.4, SEED + 2)
    ms = time_ms(lambda: hu.sorted_union_columnar_fused_lexn(
        a[:2], a[2:], b[:2], b[2:], out_size=C), reps=20)
    plain_ms = time_ms(lambda: hu._lexn_union_plain(a[:2], a[2:], b[:2], b[2:], C), reps=5)
    packed = [torch.cat([x, y], dim=0) for x, y in zip(a[:2], b[:2])]
    packed = packed[0].long() << 32 | packed[1].long()
    library_ms = time_ms(lambda: torch.sort(packed, dim=0), reps=10)
    # bytes: 8 input planes read once, 4 output planes + n_unique written once;
    # operations: the merge's key-word compares (2 words x log2 C binary-search
    # steps for each of the 2C rows)
    row = kernel_row(
        "lexn_union", "crdt_tpu_torch/csrc/lexn_union.cu",
        "crdt_tpu/ops/pallas_union.py:353", launches["lexn_union"], max_err, ms,
        plain_ms, 8 * C * R * 4 + 4 * C * R * 4 + 4 * R,
        2 * C * R * 2 * math.ceil(math.log2(C)), library_ms, card)
    log("lexn_union library yardstick: torch.sort of 2C packed int64 keys per lane")

    gossip_ms = time_ms(lambda: oc.gossip_round(col, rounds[0], alive), reps=5)
    converge_ms = time_ms(lambda: oc.converge_checked(col, alive), reps=3, warmup=1)
    rebuild_ms = time_ms(lambda: oc.rebuild(col, N_KEYS), reps=5)
    log(f"gossip_round (R={R}, C={C}): {gossip_ms:.4f} ms")
    log(f"converge_checked (R={R}, C={C}): {converge_ms:.4f} ms")
    log(f"rebuild (R={R}, C={C}, K={N_KEYS}): {rebuild_ms:.4f} ms")

    # ---- 5. where the device time goes ----
    def one_pass():
        c = col
        for peers in rounds:
            c = oc.gossip_round(c, peers, alive)
        c, _ = oc.converge_checked(c, alive)
        oc.rebuild(c, N_KEYS)

    profile("OpLog: 3 gossip rounds, converge, rebuild", one_pass)
    return row


# ---- the OR-Set slice ----


def same(label: str, got, want) -> int:
    """Kernel outputs vs twin outputs (or one path vs another), bit-equal
    on every tensor; returns the largest |got - want| (0 when equal)."""
    err = 0
    for i, (x, y) in enumerate(zip(got, want)):
        if x.shape != y.shape:
            raise AssertionError(f"{label}: output {i} shape {tuple(x.shape)} != "
                                 f"{tuple(y.shape)}")
        if x.numel():
            err = max(err, int((x.long() - y.long()).abs().max()))
        if not torch.equal(x, y):
            bad = (x != y).nonzero()[0].tolist()
            raise AssertionError(f"{label}: outputs differ on output {i} at {bad}")
    if len(got) != len(want):
        raise AssertionError(f"{label}: {len(got)} outputs != {len(want)}")
    return err


def set_planes(pool, lanes: int, seed: int):
    """(packed, removed) planes on the card of a set_swarm draw."""
    from crdt_tpu_torch import workload
    from crdt_tpu_torch.models import orset

    return orset.stack_to_columnar(workload.set_swarm(pool, lanes, SET_C, seed,
                                                      device="cuda").sets)


def strided_planes(lanes: int, seed: int):
    """(keys, vals) on the card of the strided three-arm draw: C/2 live keys
    a lane over a 32·C universe."""
    from crdt_tpu_torch import workload

    return workload.strided_columns(SET_C, lanes, SET_C // 2, 32 * SET_C, seed,
                                    device="cuda")


def check_set_kernels(pool) -> tuple:
    """Phase 6: set_union, merge and bucketed_union against their twins.
    Returns (max |err| by kernel, the set_swarm draw, the strided draw)."""
    from crdt_tpu_torch.ops import hopper_union as hu
    from crdt_tpu_torch.ops import union_engine as ue

    err = {"set_union": 0, "merge": 0, "bucketed_union": 0}
    wb = SET_C // N_BUCKETS

    def union(a, b, out, label):
        got = hu.sorted_union_columnar_fused(*a, *b, out_size=out)
        err["set_union"] = max(err["set_union"], same(
            f"set_union {label}", got, hu._set_union_plain(*a, *b, out)))
        return int(got[2].max())

    def merge(a, b, label):
        err["merge"] = max(err["merge"], same(
            f"merge {label}", hu.bitonic_merge_columnar(*a, *b), hu._merge_plain(*a, *b)))

    def bucketed(a, b, out_r, label):
        got = hu.bucketed_union_columnar(*a, *b, n_buckets=N_BUCKETS, out_bucket_rows=out_r)
        err["bucketed_union"] = max(err["bucketed_union"], same(
            f"bucketed_union {label}", got,
            hu._bucketed_union_plain(*a, *b, N_BUCKETS, out_r)))
        return int(got[3].max())

    def to_bucketed(keys, vals):
        k, v, dropped = ue.sorted_to_bucketed(keys, vals, N_BUCKETS, KEY_BITS)
        if int(dropped.max()) != 0:
            raise AssertionError("the strided draw must bucket without dropping rows")
        return k, v

    a = set_planes(pool, SET_L, SEED + 11)
    b = set_planes(pool, SET_L, SEED + 12)
    nu = union(a, b, SET_C, "OR-Set draw, out=C")
    union(a, b, None, "OR-Set draw, untruncated")
    if union(a, b, SET_C // 2, "overflow, out=C/2") <= SET_C // 2:
        raise AssertionError("the overflow case did not overflow")
    merge(a, b, "OR-Set draw")
    sa, sb = strided_planes(SET_L, SEED + 13), strided_planes(SET_L, SEED + 14)
    ba, bb = to_bucketed(*sa), to_bucketed(*sb)
    bucketed(ba, bb, wb, "strided draw, out_r=Wb")
    bucketed(ba, bb, 2 * wb, "strided draw, out_r=2Wb")
    if bucketed(ba, bb, wb // 4, "overflow, out_r=Wb/4") <= wb // 4:
        raise AssertionError("the bucketed overflow case did not overflow")
    for n in (1, 127, 130):
        ra, rb = set_planes(pool, n, SEED + 15), set_planes(pool, n, SEED + 16)
        union(ra, rb, SET_C, f"ragged L={n}")
        merge(ra, rb, f"ragged L={n}")
        bucketed(to_bucketed(*strided_planes(n, SEED + 17)),
                 to_bucketed(*strided_planes(n, SEED + 18)), wb, f"ragged L={n}")
    log(f"set kernels vs twins: bit-exact at C={SET_C} L={SET_L} (OR-Set draw max "
        f"n_unique {nu}), overflow and ragged L=1/127/130; max |err| {err}")
    return err, (a, b), (sa, sb)


def run_set_slice(pool) -> tuple:
    """Phase 7: the OR-Set main path at full size through the entry points a
    user calls, then its checks.  Returns (operand planes, launches, max
    |kernel - twin| on the slices)."""
    import numpy as np

    from crdt_tpu_torch import workload
    from crdt_tpu_torch.models import orset
    from crdt_tpu_torch.ops import hopper_union as hu
    from crdt_tpu_torch.ops import pack
    from crdt_tpu_torch.ops import union_engine as ue

    rng = np.random.default_rng(SEED)
    lanes = sorted({0, SET_R - 1, *rng.choice(SET_R, N_SAMPLED, replace=False).tolist()})
    swarms = [workload.set_swarm(pool, SET_R, SET_C, SEED + k, device="cuda")
              for k in (21, 22)]
    held = np.stack([sw.held[lanes].cpu().numpy() for sw in swarms], axis=1)
    seen = np.stack([sw.seen[lanes].cpu().numpy() for sw in swarms], axis=1)
    sets = [sw.sets for sw in swarms]
    del swarms
    torch.cuda.synchronize()

    for name in hu.LAUNCHES:
        hu.LAUNCHES[name] = 0
    ue.reset_tallies()
    steps = {}

    def step(name, fn):  # host wall of one step, ended by a synchronize
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        steps[name] = (time.perf_counter() - t) * 1e3
        return out

    pa, ra = step("stack_to_columnar A", lambda: orset.stack_to_columnar(sets.pop(0)))
    pb, rb = step("stack_to_columnar B", lambda: orset.stack_to_columnar(sets.pop(0)))
    keys, vals, nu = step("columnar_join", lambda: orset.columnar_join(
        pa, ra, pb, rb, engine="sort"))
    mask = step("columnar_member_mask", lambda: orset.columnar_member_mask(
        keys, vals, SET_UNIVERSE))
    launches = dict(hu.LAUNCHES)
    paths = ue.union_path_counts()
    log(f"OR-Set main path: stack_to_columnar x2 -> columnar_join -> columnar_member_mask "
        f"at R={SET_R} C={SET_C}: {sum(steps.values()) / 1e3:.3f} s host wall, launches "
        f"{launches}, union paths {paths}; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB")
    log("  host wall by step: " + ", ".join(f"{k} {v:.2f} ms" for k, v in steps.items()))

    max_nu = int(nu.max())
    if max_nu > SET_C:
        raise AssertionError(f"max n_unique {max_nu} > C={SET_C}: tags were dropped")
    if paths != {"sort": 1} or launches["set_union"] < 1:
        raise AssertionError(f"the join did not run the sort engine's kernel: {paths}, "
                             f"{launches}")
    err = 0
    for sl in (slice(0, SLICE), slice(SET_R - SLICE, SET_R)):
        planes = [x[:, sl].contiguous() for x in (pa, ra, pb, rb)]
        err = max(err, same(f"set_union lanes {sl.start}-{sl.stop}",
                            (keys[:, sl], vals[:, sl], nu[sl]),
                            hu._set_union_plain(*planes, SET_C)))
    k_cpu, v_cpu, m_cpu = keys[:, lanes].cpu(), vals[:, lanes].cpu(), mask[:, lanes].cpu()
    for i, lane in enumerate(lanes):
        want_tags, want_members = workload.set_view(pool, held[i], seen[i])
        live = k_cpu[:, i] != SENTINEL
        elem, rid, seq = pack.unpack_tags(k_cpu[live, i])
        got_tags = {(int(e), int(r), int(q)): bool(x) for e, r, q, x in
                    zip(elem, rid, seq, v_cpu[live, i])}
        if got_tags != want_tags:
            raise AssertionError(f"lane {lane}: joined tags != plain fold of the pool")
        if set(m_cpu[:, i].nonzero().flatten().tolist()) != want_members:
            raise AssertionError(f"lane {lane}: member mask != plain fold of the pool")
    log(f"OR-Set slice checks: max n_unique {max_nu} <= C, == twin on lanes 0-{SLICE} "
        f"and the last {SLICE}, {len(lanes)} sampled lanes == plain fold (tags, "
        f"tombstones, members; lane 0 holds {len(workload.set_view(pool, held[0], seen[0])[0])} tags)")
    return (pa, ra, pb, rb), launches, err


def set_times_full(planes, card: str) -> dict:
    """Phase 7 times at R=2^20: set_union, its twin, the library sort and
    the whole columnar_join; then one profiled columnar_join."""
    from crdt_tpu_torch.models import orset
    from crdt_tpu_torch.ops import hopper_union as hu

    pa, ra, pb, rb = planes
    ms = time_ms(lambda: hu.sorted_union_columnar_fused(pa, ra, pb, rb, out_size=SET_C),
                 reps=10)
    join_ms = time_ms(lambda: orset.columnar_join(pa, ra, pb, rb), reps=5)
    log(f"columnar_join (R={SET_R}, C={SET_C}, sort engine): {join_ms:.4f} ms")
    # the twin at 2^20 lanes holds several int64 (L, 2C) index planes (17 GB
    # each) and does not fit the card: it is timed over 8 lane blocks of
    # 131,072 and the block times summed
    plain_ms = 0.0
    for start in range(0, SET_R, SET_L):
        block = [x[:, start:start + SET_L].contiguous() for x in planes]
        plain_ms += time_ms(lambda: hu._set_union_plain(*block, SET_C), reps=3, warmup=1)
        del block
    both = torch.cat([pa, pb], dim=0)
    library_ms = time_ms(lambda: torch.sort(both, dim=0), reps=3, warmup=1)
    del both
    log("set_union plain twin: summed over 8 lane blocks of 131,072; library "
        "yardstick: one torch.sort of the 2C keys per lane (sorts, no dedupe)")
    real = int((pa != SENTINEL).sum()) + int((pb != SENTINEL).sum())
    # bytes: 4 planes read, 2 planes + n_unique written; operations: one
    # binary search (log2 C compares) for each live row of either side
    row = kernel_row("set_union", "crdt_tpu_torch/csrc/set_union.cu",
                     "crdt_tpu/ops/pallas_union.py:218", 0, 0, ms, plain_ms,
                     (4 * SET_C * SET_R + 2 * SET_C * SET_R + SET_R) * 4,
                     real * math.ceil(math.log2(SET_C)), library_ms, card)
    profile(f"OR-Set columnar_join at R={SET_R}",
            lambda: orset.columnar_join(pa, ra, pb, rb))
    return row


def run_set_engines(draw, strided) -> tuple:
    """Phase 8: the engines at L=131,072.  Returns the launches of the
    phase."""
    from crdt_tpu_torch.models import orset
    from crdt_tpu_torch.ops import hopper_union as hu
    from crdt_tpu_torch.ops import union_engine as ue

    a, b = draw
    (ka, va), (kb, vb) = strided
    wb = SET_C // N_BUCKETS
    for name in hu.LAUNCHES:
        hu.LAUNCHES[name] = 0
    ue.reset_tallies()
    auto = orset.columnar_join(*a, *b, engine="auto")
    auto_paths = ue.union_path_counts()
    sort_ref = ue.engine_sort(*a, *b, SET_C)
    ue.reset_tallies()
    engines = {
        "sort": ue.engine_sort(ka, va, kb, vb, SET_C),
        "bucket": ue.engine_bucket(ka, va, kb, vb, SET_C, n_buckets=N_BUCKETS,
                                   key_bits=KEY_BITS),
        "bitmap": ue.engine_bitmap(ka, va, kb, vb, SET_C, universe=32 * SET_C),
    }
    engine_paths = ue.union_path_counts()
    rka, rva, _ = ue.sorted_to_bucketed(ka, va, N_BUCKETS, KEY_BITS)
    rkb, rvb, _ = ue.sorted_to_bucketed(kb, vb, N_BUCKETS, KEY_BITS)
    ko, vo, rnu, bmax = hu.bucketed_union_columnar(rka, rva, rkb, rvb, n_buckets=N_BUCKETS,
                                                   out_bucket_rows=wb)
    rk, rv, _ = ue.bucketed_to_sorted(ko, vo)
    unfused = hu.sorted_union_columnar_unfused(*a, *b, out_size=SET_C)
    fused = hu.sorted_union_columnar_fused(*a, *b, out_size=SET_C)
    torch.cuda.synchronize()
    launches = dict(hu.LAUNCHES)
    log(f"OR-Set engines at L={SET_L}: launches {launches}")

    if auto_paths != {"bucket": 1, "bucket_fallback_sort": 1}:
        raise AssertionError(f"auto on the OR-Set draw did not plan bucket and fall "
                             f"back: {auto_paths}")
    same("auto (bucket fallback) vs sort", auto, sort_ref)
    if engine_paths:
        raise AssertionError(f"the strided draw fell back: {engine_paths}")
    for name in ("bucket", "bitmap"):
        same(f"engine {name} vs sort", engines[name], engines["sort"])
    if int(bmax.max()) > wb:
        raise AssertionError("a bucket of the resident chain was truncated")
    same("resident bucketed chain vs sort", (rk, rv, rnu), engines["sort"])
    same("unfused (merge + epilogue) vs fused", unfused, fused)
    for name, least in (("set_union", 1), ("merge", 1), ("bucketed_union", 2)):
        if launches[name] < least:
            raise AssertionError(f"{name} launched {launches[name]} times, expected "
                                 f">= {least}")
    log("OR-Set engine checks: auto planned bucket and fell back to sort (tallied), "
        "sort == bucket == bitmap on the strided draw with no fallback, the resident "
        "bucketed chain == sort, unfused == fused")
    return launches


def set_times_engines(draw, strided, card: str) -> tuple:
    """Phase 8 times at L=131,072: merge and bucketed_union with their twins
    and library yardsticks, and the auto dispatch."""
    from crdt_tpu_torch.models import orset
    from crdt_tpu_torch.ops import hopper_union as hu
    from crdt_tpu_torch.ops import union_engine as ue

    a, b = draw
    wb = SET_C // N_BUCKETS
    ms = time_ms(lambda: hu.bitonic_merge_columnar(*a, *b), reps=10)
    plain_ms = time_ms(lambda: hu._merge_plain(*a, *b), reps=5)
    keys, vals = torch.cat([a[0], b[0]], dim=0), torch.cat([a[1], b[1]], dim=0)
    library_ms = time_ms(lambda: vals.gather(0, torch.sort(keys, dim=0, stable=True).indices),
                         reps=5)
    del keys, vals
    merge = ("merge", "crdt_tpu_torch/csrc/set_union.cu", "crdt_tpu/ops/pallas_union.py:87",
             ms, plain_ms, (4 * SET_C * SET_L + 2 * 2 * SET_C * SET_L) * 4,
             2 * SET_C * SET_L * math.ceil(math.log2(SET_C)), library_ms)
    log("merge library yardstick: a stable torch.sort of the 2C keys per lane and a "
        "gather of the values")

    (ka, va), (kb, vb) = strided
    ba = ue.sorted_to_bucketed(ka, va, N_BUCKETS, KEY_BITS)[:2]
    bb = ue.sorted_to_bucketed(kb, vb, N_BUCKETS, KEY_BITS)[:2]
    ms = time_ms(lambda: hu.bucketed_union_columnar(*ba, *bb, n_buckets=N_BUCKETS,
                                                    out_bucket_rows=wb), reps=10)
    plain_ms = time_ms(lambda: hu._bucketed_union_plain(*ba, *bb, N_BUCKETS, wb), reps=5)

    def segments(x):  # (C, L) -> (L·B, Wb): one row per (lane, bucket)
        return x.reshape(N_BUCKETS, wb, SET_L).permute(2, 0, 1).reshape(-1, wb)

    seg_keys = torch.cat([segments(ba[0]), segments(bb[0])], dim=1)
    library_ms = time_ms(lambda: torch.sort(seg_keys, dim=1), reps=5)
    del seg_keys
    real = int((ba[0] != SENTINEL).sum()) + int((bb[0] != SENTINEL).sum())
    bucketed = ("bucketed_union", "crdt_tpu_torch/csrc/set_union.cu",
                "crdt_tpu/ops/pallas_union.py:1003", ms, plain_ms,
                (4 * SET_C * SET_L + 2 * N_BUCKETS * wb * SET_L + 2 * SET_L) * 4,
                real * math.ceil(math.log2(wb)), library_ms)
    log("bucketed_union library yardstick: one segmented torch.sort over the "
        f"(L·B, 2·Wb) = ({SET_L * N_BUCKETS}, {2 * wb}) bucket rows")

    auto_ms = time_ms(lambda: orset.columnar_join(*a, *b, engine="auto"), reps=5)
    log(f"columnar_join engine=auto (L={SET_L}, plans bucket, falls back to sort): "
        f"{auto_ms:.4f} ms")
    return merge, bucketed


def set_phases(card: str) -> list:
    """Phases 6-8: the OR-Set swarm path.  Returns the table rows of
    set_union, merge and bucketed_union."""
    from crdt_tpu_torch import workload

    pool = workload.set_pool(SEED)
    err, draw, strided = check_set_kernels(pool)

    planes, launches, slice_err = run_set_slice(pool)
    set_union = set_times_full(planes, card)
    set_union.update(launches=launches["set_union"],
                     max_abs_err=max(err["set_union"], slice_err))
    del planes
    torch.cuda.empty_cache()

    engine_launches = run_set_engines(draw, strided)
    rows = [set_union]
    for name, source, replaces, ms, plain_ms, n_bytes, n_ops, library_ms in \
            set_times_engines(draw, strided, card):
        rows.append(kernel_row(name, source, replaces, engine_launches[name], err[name],
                               ms, plain_ms, n_bytes, n_ops, library_ms, card))
    return rows


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    from crdt_tpu_torch import _build

    # ---- 1. card and build ----
    card = card_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    _build.build(_build.SOURCES)
    log(f"build: {time.perf_counter() - t0:.2f} s (nvcc, sm_90a, "
        f"{len(_build.SOURCES)} sources in parallel)")
    for name in _build.SOURCES:
        for line in _build.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas [{name}]: {line.strip()}")

    rows = [oplog_phases(card)]
    rows += set_phases(card)

    print(card, flush=True)
    log(json.dumps({"kernels": rows}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
