"""Drive the PyTorch port's OpLog swarm path on a CUDA card and check it.

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result):

1. card and build — the card's name and power limit (nvidia-smi), then
   the path's kernel built from ``crdt_tpu_torch/csrc``;
2. kernel vs plain twin on the card, bit-exact on every plane and
   n_unique: a mid-gossip swarm at C=1024, L=10,240, an overflow case, and
   ragged lane counts;
3. the slice end to end at R=10,240 replicas x C=1024 log rows:
   ``plan`` (must pick the columnar engine) → 3 ``gossip_round``s with one
   replica dead → ``converge_checked`` → ``rebuild`` → ``materialize``,
   checked against the port's generic engine, a plain fold of the write
   pool, and the predicted kernel launch count;
4. times on the card (CUDA events, median after warm-up);
5. one pass of the path under torch.profiler: device time by kernel and
   the device's busy share.

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
    err = 0
    for name, x, y in zip(("hi", "lo", "val", "pay", "n_unique"),
                          (*k_keys, *k_vals, k_nu), (*t_keys, *t_vals, t_nu)):
        if x.shape != y.shape:
            raise AssertionError(f"{label}: {name} shape {tuple(x.shape)} != {tuple(y.shape)}")
        if x.numel():
            err = max(err, int((x.long() - y.long()).abs().max()))
        if not torch.equal(x, y):
            bad = (x != y).nonzero()[0].tolist()
            raise AssertionError(f"{label}: kernel != twin on {name} at {bad}")
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


def profile_path(oc, col, rounds, alive) -> None:
    """Phase 5: one pass of the columnar path (3 gossip rounds, converge,
    rebuild) under torch.profiler — device time by kernel and the
    device's busy share of the pass's wall time (both with the profiler's
    own host overhead in the wall)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for peers in rounds:
            col = oc.gossip_round(col, peers, alive)
        col, _ = oc.converge_checked(col, alive)
        oc.rebuild(col, N_KEYS)
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
        log("profile: torch.profiler recorded no device time; busy share not measured")
        return
    log(f"profile: device busy {busy_ms:.4f} ms of {wall_ms:.4f} ms wall "
        f"(idle share {1 - busy_ms / wall_ms:.3f}, under the profiler)")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:8]:
        log(f"  {e.self_device_time_total / 1e3:9.4f} ms  x{e.count:<4d} {e.key[:90]}")


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    from crdt_tpu_torch import _build
    from crdt_tpu_torch.models import oplog_columnar as oc
    from crdt_tpu_torch.ops import hopper_union as hu

    # ---- 1. card and build ----
    card = card_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    _build.load("lexn_union")
    log(f"build: {time.perf_counter() - t0:.2f} s (nvcc, sm_90a)")
    for line in _build.build_log("lexn_union").splitlines():
        if "registers" in line or "spill" in line:
            log(f"  ptxas: {line.strip()}")

    # ---- 2. kernel vs plain twin ----
    max_err = check_kernel(hu, C, R)

    # ---- 3. the slice end to end ----
    col, alive, rounds, launches = run_slice("cuda", R, C, N_WRITES, DEAD, SEED)
    expected = 3 + math.ceil(math.log2(R))
    if launches["lexn_union"] != expected:
        raise AssertionError(f"lexn_union launched {launches['lexn_union']} times "
                             f"on the main path, expected {expected}")

    # ---- 4. times on the card ----
    from crdt_tpu_torch import workload
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
    n_bytes = 8 * C * R * 4 + 4 * C * R * 4 + 4 * R
    n_ops = 2 * C * R * 2 * math.ceil(math.log2(C))
    bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    ops_ms = n_ops / INT32_OPS_PER_S * 1e3
    bound_ms = max(bytes_ms, ops_ms)
    bound_by = "bytes" if bytes_ms >= ops_ms else "operations"
    log(f"lexn_union kernel (C={C}, L={R}): {ms:.4f} ms/launch [{card}]")
    log(f"lexn_union bound: {bound_ms:.4f} ms by {bound_by} ({n_bytes / 1e6:.1f} MB at "
        f"3.35 TB/s H100 SXM HBM3 = {bytes_ms:.4f} ms; {n_ops / 1e9:.2f} G int32 "
        f"compares at {INT32_OPS_PER_S / 1e12:.1f} T int32 op/s = {ops_ms:.4f} ms)")
    log(f"lexn_union plain twin: {plain_ms:.4f} ms")
    log(f"library yardstick torch.sort of 2C packed int64 keys per lane: "
        f"{library_ms:.4f} ms")

    gossip_ms = time_ms(lambda: oc.gossip_round(col, rounds[0], alive), reps=5)
    converge_ms = time_ms(lambda: oc.converge_checked(col, alive), reps=3, warmup=1)
    rebuild_ms = time_ms(lambda: oc.rebuild(col, N_KEYS), reps=5)
    log(f"gossip_round (R={R}, C={C}): {gossip_ms:.4f} ms")
    log(f"converge_checked (R={R}, C={C}): {converge_ms:.4f} ms")
    log(f"rebuild (R={R}, C={C}, K={N_KEYS}): {rebuild_ms:.4f} ms")

    # ---- 5. where the device time goes ----
    profile_path(oc, col, rounds, alive)

    print(card, flush=True)
    log(json.dumps({"kernels": [{
        "name": "lexn_union", "route": "cuda",
        "source": "crdt_tpu_torch/csrc/lexn_union.cu",
        "replaces": "crdt_tpu/ops/pallas_union.py:353",
        "launches": launches["lexn_union"], "max_abs_err": max_err,
        "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": library_ms,
    }]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
