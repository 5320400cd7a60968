"""Drive the PyTorch port's OpLog, OR-Set and RSeq swarm paths, the OR-Set
union floors, the counter and register family, the replica-node cluster,
the join registry, the typed sibling nodes, the reference's HTTP surface,
the network daemon, the keyspace tier, the fault plane's soaks, the
native host runtime, the mesh plane, the multi-device layer, the prover,
the race detector, the lint tiers and the telemetry opt-out on a CUDA card
and check them.

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result):

1. card and build — the card's name and power limit (nvidia-smi), then
   every kernel built from ``crdt_tpu_torch/csrc`` (one nvcc per source,
   all started together), then the native host runtime
   (``crdt_tpu_torch/native/ingest.cpp``, g++, timed);
2. OpLog: the lexn_union kernel vs its plain twin on the card, bit-exact
   on every plane and n_unique: a mid-gossip swarm at C=1024, L=10,240, an
   overflow case, ragged lane counts, and the tile body's edges (lane
   counts that split a tile of 8, the converge tree's narrow levels, planes
   off 16 B alignment, all-padding lanes beside B inside A, full-range and
   word-0-tied keys, out=C/2 and 2C; (18, 2) at C=512 on the wide
   body);
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
   cases and ragged lane counts, set_union's tile edges (lane counts
   that split a tile of 8, planes off 16 B alignment, all-padding lanes
   beside B inside A, full-range keys and values, out=C/2 and 2C), and the
   same edges for bucketed_union's segment body (out_r=0, odd, Wb and 2Wb,
   C=48 with 3 buckets, Wb=1 and 256, 16 lanes a CTA, flagged padding)
   and the merge's keep-all tile (C=8, 1024 and 4096, flagged padding),
   bit-exact on every output;
7. OR-Set end to end at BASELINE's R=1,048,576 replicas x C=1024 tag rows:
   ``stack_to_columnar`` of two seeded swarms → ``columnar_join`` (the
   sort engine: one set_union launch) → ``columnar_member_mask`` (one
   member_mask launch), both checked against their plain twins on the first
   and last 65,536 lanes and against a plain fold of the tag pool on 66
   sampled lanes; the member mask's kernel, twin and ``scatter_reduce_``
   timed beside its bound; then times at that size and one profiled
   ``columnar_join``;
8. OR-Set engines at L=131,072: the ``auto`` plan's bucket fallback, the
   three engines bit-identical on the strided draw, the bucket-resident
   chain and the unfused union (merge kernel + epilogue) against the sort
   path; then the merge, bucketed_union (out_r=Wb and 2Wb) and
   auto-dispatch times, and the bucket and unfused engines' times beside
   their kernels';
9. RSeq: the lexn_merge and lexn_compact kernels vs their twins at C=1024,
   L=10,240 on a ``workload.seq_swarm`` draw at 18 key words with 2 and 3
   value planes, lexn_union (the wide body) at those splits at C=512 and
   C=1024 (out=C/4, C, 2C), the striped path at a forced stripe of 256 and
   ``auto`` at C=2048 against the fused twin, overflow, lane counts that
   split a tile or cluster of 8 lanes (L=1, 2, 7, 9, 127, 130, 257),
   (2, 2) at C=2048 and 4096, (5, 2) and (18, 2) at C=64 and 256, planes
   off 16 B alignment, 32 planes,
   all-padding lanes and B inside A (``workload.lexn_pair``), the merge's
   resident clusters, 400 merges each at (18, 2), C=64 and 256 (two of its
   CTAs an SM: its staging waits for the cluster), the striped union at S=C handing the merge's blocks
   straight to the compaction, and the shared-memory refusals;
10. RSeq end to end at R=10,240 replicas x C=1024 rows x depth 6:
    ``rseq_columnar.plan`` (must pick the columnar engine) → 3
    ``gossip_round``s with one replica dead → ``converge_checked`` →
    ``unstack``, checked against the port's generic engine at full width,
    a plain fold of the editing history on 64 sampled lanes, and the
    predicted launch counts (the wide body's lexn_union, no stripe);
11. the RSeq GC barrier: ``tomb_gc.gc_round`` on the columnar engine ==
    ``engine="generic"``, exactly the removed rows under the frontier
    collected, live lists unchanged; then the dead replica revived by one
    GC-aware pull (``rseq_engine.gc_merge_checked``); and the GC join at
    the ``seq-swarm-10k.gc`` cell's shape with real floors on both sides (a
    seeded 1% of the collected replicas stale), fused (one lexn_gc_union
    launch) == the composition on every plane, n_unique, dropped and the
    floor, each stale/fresh pair dropping the collected rows from its side;
12. RSeq times (gossip, converge, GC converge, each kernel with its twin
    and bound, the wide body at C=512 and 1024 with its device time, its GC
    instance on phase 11's pair) and one profiled gossip round and
    converge;
13. the OR-Set floors (kernels 7 and 8) at benches/orset_floor.py's shape,
    C=1024, L=131,072, B=64 on its draw: one launch of each through its
    entry point, both against their twins (also out=C/2, B=2 and 128,
    full-range int32, C=64 and 2048, ragged lanes, and the edges: L=1, 7,
    9, 127, 130 and 4097, out=0, odd and 2C, B=1, 2, 64 and C, C=8 and
    8192, planes off 16 B, the refusal at C=16,384), the set_floor
    kernels' ptxas lines and plans, then their times (CUDA events and
    profiler device times) beside set_union's and bucketed_union's as one
    JSON line;
    ``floor_union`` also runs at L=2^20 on phase 7's OR-Set planes;
14. the counters and registers at BASELINE's sizes (plain torch joins):
    G-Counter 2^20 x 8 against 16 peers and the 8-slot pair, PN-Counter
    1,024 and 2^20 x 64, LWW 100,352 and 2^25 (and the packed join),
    EW/DW flags and the MV-register at 2^20 x 8 through seeded op
    scripts — each == a numpy fold or the port's CPU run, with
    replica-merges/s and p50/p99 beside the bytes bound;
15. the reference's own system: a ``LocalCluster`` of 5 ``ReplicaNode``s
    (ClusterConfig's defaults, delta gossip) takes 131,072
    ``WorkloadGenerator`` writes in 64 rounds of 2,048 (one
    ``add_commands`` batch per live replica, then one ``tick()``; replica 4
    down for rounds 16-31), ticks to convergence, twice: (a) the
    never-pruned log, (b) a compaction barrier every 8 ticks.  All 5 views
    == the oracle over the acknowledged writes in both, (b) == (a), (b)'s
    tails below (a)'s logs, every node tensor on the card, no hand kernel
    launched; a 4,096-command run of the parity mix (multi-key,
    non-numeric) == the oracle; then writes/s, tick() median and p99, the
    barrier, get_state(), ``oplog.merge_checked`` at capacity 2^17 beside
    its bound, one profiled tick and the peak memory, as one JSON line;
16. the join registry, the typed cluster and the soaks: (a) every
    registered join (21) on card states drawn by its own generator, 12
    trials: the four laws, == the join on the CPU copies, ``converge`` by
    name == on the CPU, ``bucketed_union`` launched; (b) a
    ``LocalCluster`` of 5 replicas with the siblings' barriers (set and
    sequence GC every 8 ticks, map reset every 16) takes 8,192 map, 8,192
    set, 4,096 sequence and 2,048 KV ops in 32 rounds (replica 4 down for
    rounds 8-15) and ticks to convergence: all four views equal on every
    replica and == the same schedule's CPU run (after the card's), the
    barriers ran, the map reset was skipped
    while replica 4 was down, no hand kernel launched; per-op, tick and
    barrier times, a profiled tick, peak memory; (c) the sequence soak
    (4 replicas, 400 steps) on the auto engine == the generic one at
    capacity 512 and 1024 (kernel 1's wide body on one lane) and 2048
    (kernels 4 and 5), each join's union == its twin with its event and
    device time and bound, the first auto join split by layer (staging,
    union, floor suppression, unstack), and the set and map soaks at their
    CLI defaults; one ``{"typed_nodes": ...}`` JSON line;
17. the reference's HTTP surface (budget 60 s): ``api.http_shim``'s
    ``HttpCluster`` over a ``LocalCluster()`` of 5 replicas on the card,
    on loopback: (a) 2,048 single-op ``POST /data`` from 8 client threads
    (replica 4 down for the second quarter, its 502s counted), (b) 129,024
    writes through ``/ingest/page`` in pages of 512 (429 back-off counted),
    one profiled burst of 256 concurrent posts, (c) 64 rounds of pulls
    over HTTP (``GET /gossip?vv=`` → ``POST /push``, each stability header
    into a ``StabilityTracker``) with a barrier over HTTP (``/vv`` →
    ``stable_frontier_host`` → ``/compact``) every 8; every acknowledged
    write read back from all 5 replicas (``GET /data`` == the oracle's
    fold), every ``GET /gossip`` body == ``gossip_payload_json``, the
    ``/metrics`` ingest counters == the client's counts, no 5xx but the
    planned 502s, no hand kernel launched (as predicted); (d) ``python -m
    crdt_tpu_torch --duration 10`` as a subprocess on the card exits 0
    converged; one ``{"http_surface": ...}`` JSON line;
18. the network daemon (budget 120 s): (a) five ``python -m crdt_tpu_torch
    --daemon`` processes on the card (rids 0-4 on loopback ports picked up
    front, each with its checkpoint dir and event log under
    ``build/daemons``, daemon 0 the coordinator with ``--compact-every
    8``, gossip every 1500 ms) take 2,048 single-op ``POST /data`` from 8
    threads and 129,024 writes in op pages of 512 (a client thread a
    daemon); at the halfway point daemon 3 takes ``POST
    /admin/checkpoint`` and a SIGKILL, and restarts on the same directory
    restored at incarnation 1 (rid 67), serving and taking writes; then
    ``POST /admin/pull`` rounds on every daemon (``/admin/barrier`` every
    8) until all five ``GET /data`` are equal: each == the oracle's fold of
    the 131,072 acknowledged writes, every ``/audit`` clean, the stability
    headers' digests equal at equal frontiers, each daemon's ``/metrics``
    ingest counter == the client's count for its boot and its
    ``net_gossip_*`` outcomes == the pull-round events in its JSONL log,
    no 5xx; writes/s, pull p50/p99, barrier, checkpoint ms and bytes,
    restart-to-serving, rounds and seconds to converge, card memory; (b)
    ``harness.soak.NetworkSoakRunner`` on the card (5 hosts, seed 0, 400
    steps, a quarter of the writes paged) healed and checked, no hand
    kernel launched (as predicted); (c) a node's snapshot on the card
    restores into a fresh node with equal state, vv, frontier, summary
    and digest, and a corrupted ``log.npz`` generation is quarantined and
    the one before it restored; one ``{"network_daemon": ...}`` JSON line;
19. the keyspace tier (budget 240 s): five ``python -m crdt_tpu_torch
    --daemon --keyspace-shards 64`` processes on the card (ports picked up
    front, daemon 0 coordinating with ``--compact-every 8``, gossip every
    1500 ms, checkpoint dirs and event logs under ``build/keyspace``): (a)
    31,250 writes with benches/bench_keyspace.py's shape (keys from the
    coprime walk, four tenants drawn with seed 0) in tenant op pages of
    512, a client thread a daemon, 429 back-offs counted; (b)
    ``/admin/ks_pull`` rounds until every daemon's ``GET
    /ks/data?tenant=`` == the client's fold for all four tenants, every
    shard's vv equal on all five, the shards' ops and keys == the writes,
    every key at one shard; (c) 512 reads at each level (eventual, session
    with the write's token, bounded, linearizable) with p50/p99, 8 threads
    of 64 CAS increments on 16 keys at random daemons (forwarded to the
    slot's coordinator): each key's value == its 200s, every 409 names the
    actual value, every 503 == a ``consistency_unavailable`` event, no
    (slot, fence) committed by two daemons, fences monotone; (d) an online
    reshard 64 -> 128 (start on every daemon, 4,096 writes through the
    window, a stream round each, cutover on every daemon), then
    convergence again: no key lost or duplicated, ownership disjoint, all
    five at epoch 1 with 128 shards; (e) daemon 3 checkpointed, SIGKILLed
    and restarted on its directory: 128 shards at epoch 1, the same fence
    floors, a ``/push`` stamped below a floor refused 409, every tenant ==
    the fold; (f) ``python -m crdt_tpu_torch.obs fleet`` over the five
    exits 0 and its per-tenant and per-shard, per-member numbers == each
    daemon's ``/metrics``; one ``{"keyspace_tier": ...}`` JSON line;
20. the nemesis soak (budget 150 s): in-process ``NodeHost`` fleets on the
    card through ``harness.nemesis_soak``'s seeded fault schedules
    (partitions, drops, delays, duplicates, reorders, truncations,
    corruptions, crashes with reboots, torn snapshots, fsync stalls, clock
    skew), each healed and held to its laws: (a) the default arm (3 nodes,
    120 steps, seed 0) with the assembly check, replayed with a
    byte-identical fault log, blame coverage >= 0.95, and its fault log,
    converged vv and state == a CPU run of the same seed; (b) one arm for
    each mode at 3 nodes: ``gc`` (100 steps, against its GC-off shadow),
    ``strong`` with ``crash_coordinator``, ``multitenant`` with
    ``reshard``, ``audit`` (against its plant-free arm), ``composite`` and
    ``overload`` (120 steps each); one ``{"nemesis": ...}`` JSON line;
21. the crash soak (budget 120 s): ``harness.crashsoak.CrashSoakRunner``
    drives three ``python -m crdt_tpu_torch --daemon --device cuda``
    processes through the CLI's schedule (200 steps, seed 0) with real
    SIGKILLs and restores, heals and checks every invariant (I1-I4,
    S1-S3, Q1-Q3, M1-M3, K1, the black boxes), then ``python -m
    crdt_tpu_torch.obs assemble`` over the three slots' event logs exits 0
    with a track for each slot; one ``{"crash_soak": ...}`` JSON line;
22. the host runtime, the mesh plane and tracing (budget 90 s): (a) one
    ``ReplicaNode`` on the native runtime and one on the Python path
    (``use_native=False``) take the same 65,536 writes in batches of 512
    (Python, native, native, Python): planes, n_unique, vv and state
    equal, the wire store's bytes == the payload's compact JSON, writes/s
    each way; then phase 15's never-pruned cluster mix once each way, every
    view == the oracle and the two equal, writes/s, ``tick()`` p50/p99
    and one profiled tick each; (b) F1: after a -500 ms clock skew a
    node's ``GET /gossip`` bytes keep each op's entry key, == the CPU
    run's; (c) ``ShardedKeyspace(0, 64)`` with ``mesh="on"`` and with
    ``"off"`` take the same 16,384 tenant writes (bench_keyspace's shape,
    four tenants, seed 0) through a ``KeyspaceFrontDoor`` in pages of
    512, one ``flush_all`` a page: every shard's state, vv, payload and
    digest equal, one fused merge a page, no fallback, an injected step
    failure landing every lane inline with no lock held, page p50/p99
    both ways; (d) ``trace_to`` around one OpLog swarm converge at phase
    2's shape: the trace holds the ``oplog_columnar.converge`` region and
    its ``lexn_union`` launches, traced == untraced; the nemesis
    ``multitenant`` arm with ``ks_mesh="on"`` (3 nodes, 120 steps, seed 0)
    on the card == on the CPU, no fused step falling back; one
    ``{"host_runtime": ...}`` JSON line;
23. several devices (budget 75 s), each held bit for bit against the
    single-device converge on the card: (a) a world of 1 over NCCL in this
    process runs ``oplog_columnar.sharded_converge`` at phase 3's shape
    (R=10,240, C=1024, one lane dead), ``rseq_columnar.sharded_converge``
    and ``rseq_engine.sharded_gc_converge`` at phase 10's (depth 6; the
    GC twin with floor -1), ``mesh.sharded_converge`` with the generic
    OpLog join and ``mesh.pmax_converge`` on a G-Counter swarm of 2^20 x
    8: planes and max_n_unique equal, kernel 1's launches, each step's ms
    beside the single converge's; (b) four ranks sharing the card at R = 4
    x 2,560 (``torch.multiprocessing.spawn``, a ``file://`` store under
    ``build/multidevice``): NCCL's refusal of two ranks on one device is
    printed, then the gloo world (every shard on the card, each collective
    staged through host memory) runs the same five steps, every rank's
    shard == its lanes of the single-device result; wall time split into
    start-up and steps; (c) ``pipeline.run_striped`` at
    benches/bench_pipeline.py's default shape (8 stripes, C=2^18, fill
    C/2, the port's ``sorted_union``, stripes copied from pinned memory):
    pipelined == serial, 8 dispatches each, occupancy, stage and wait
    seconds; (d) ``MeshPlane(engine="pjit")`` on the one-card mesh against
    the vmap engine at phase 22 (c)'s shape with 4,096 writes: every
    shard's state, vv, payload and digest equal, one fused merge a page,
    an injected group failure landing every lane inline with no lock held;
    one ``{"multidevice": ...}`` JSON line;
24. crdtprove and the race detector (budget 60 s): (a) ``prove_spec`` of
    every registered join with its states on the card == the port's
    committed ledger (verdicts, laws and spaces, domains), the launches of
    kernels 1-3 in the sweeps; (b) ``python -m crdt_tpu_torch.analysis
    verify --check-ledger`` exits 0; (c) the nemesis default arm under
    ``--race-check --device cuda`` (3 nodes, 120 steps, seed 0): 0
    witnesses over a non-zero count of watched accesses, and its crdtflow
    cross-check 0 witnesses mapped, 0 uncovered; one ``{"verify": ...}``
    JSON line.
25. the lint tiers (budget 45 s): (a) ``python -m crdt_tpu_torch.analysis
    --check-baseline --sarif build/lint/lint.sarif`` in a process of its own
    exits 0, its findings by rule (the SARIF's) == the committed
    ``analysis/baseline.json``'s, 0 errors, wall time; (b) ``--rules
    CRDT210,CRDT211,CRDT212,CRDT213 --check-baseline`` within the 60 s
    crdtflow budget; (c) ``fx_checks.check_registered_joins`` == [] in
    process on this machine's torch; (d) ``race.watch_from_static()``
    resolves the port's classes; (a) and (b) run in their processes while
    (c) and (d) run; one ``{"lint": ...}`` JSON line;
26. the telemetry opt-out (budget 45 s): benches/bench_obs_overhead.py's
    A/Bs on the card, 5 interleaved blocks an arm with the collector
    paused inside each, the best block's µs a round an arm and the
    overhead beside the JAX package's 5% bar (a measurement, not a gate):
    (a) ``_run_block`` (a writer and a puller, one command and one delta
    ``pull_round`` a round, a BirthLedger installed; 150 rounds) with a
    live registry against ``NULL_REGISTRY``, (b) ``_run_ks_block`` (two
    keyspaces of 2 shards, a tenant door draining each admit inline, a
    held lease; 75 rounds) the same way, (c) ``_run_audit_block`` (the
    audit plane on against off, a live registry in both, a frontier fold
    every 16 rounds; 150 rounds); after every block each view == the
    oracle's fold of its writes and == the first block's, node by node
    (vv and frontier too), the null arm recorded nothing (no series, rate
    mark or birth, the recorders off), a live arm's
    ``crdt_merge_dispatches_total`` == its merges (a write or admit each,
    and each pull that merged), the audited arm's watchdog in agreement;
    one ``{"optout": ...}`` JSON line.

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
from pathlib import Path

import numpy as np
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


def tile_pair(n_keys: int, n_vals: int, c: int, lanes: int, seed: int, *, ties=False,
              b_inside_a=False, empty_lanes=()) -> list:
    """Two operands on the card for the tile bodies' edge checks, as
    [keys_a, vals_a, keys_b, vals_b] lists of (c, lanes) int32 planes: each
    lane a seeded half of one universe of 2c distinct keys, ascending
    lexicographically, SENTINEL/0 padded.  Key words are full-range int32
    (negatives and INT32_MIN, never SENTINEL in word 0), or with ``ties``
    word 0 takes 4 values, so that many keys tie on it and differ after;
    values are full int32 words, bit 31 included.  With ``b_inside_a``
    each lane of B draws from that lane of A; the lanes of
    ``empty_lanes`` are all padding on both sides."""
    rng = np.random.default_rng(seed)
    words = rng.integers(-2**31, 2**31 - 1, (4 * c, n_keys))
    if ties:
        words[:, 0] = rng.integers(0, 4, 4 * c)
    else:
        words[: c // 4, 0] = -2**31
    universe = np.unique(words, axis=0)
    universe = universe[np.sort(rng.choice(len(universe), 2 * c, replace=False))]
    universe = torch.as_tensor(universe.T.astype(np.int32), device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def cut(held):  # a lane keeps its first c keys
        held[:, list(empty_lanes)] = False
        return held & (torch.cumsum(held, dim=0) <= c)

    def draw():
        return torch.rand((2 * c, lanes), generator=gen, device="cuda") < 0.5

    held_a = cut(draw())
    held_b = cut(held_a & draw() if b_inside_a else draw())

    def side(held):
        row = torch.cumsum(held, dim=0) - 1
        src, lane = held.nonzero(as_tuple=True)
        keys = torch.full((n_keys, c, lanes), SENTINEL, dtype=torch.int32, device="cuda")
        keys[:, row[src, lane], lane] = universe[:, src]
        vals = torch.randint(-2**31, 2**31 - 1, (n_vals, c, lanes), generator=gen,
                             dtype=torch.int32, device="cuda")
        return list(keys), list(vals.masked_fill(keys[0] == SENTINEL, 0))

    return [*side(held_a), *side(held_b)]


def off_alignment(planes: list) -> list:
    """The same planes, each a contiguous view one int32 into its own
    buffer, so that no plane is 16 B aligned."""
    out = []
    for p in planes:
        buf = torch.empty(p.numel() + 1, dtype=torch.int32, device=p.device)
        view = buf[1:].view(p.shape)
        view.copy_(p)
        out.append(view)
    if out[0].data_ptr() % 16 == 0:
        raise AssertionError("the offset planes are 16 B aligned")
    return out


def check_lexn_tile_edges(hu) -> int:
    """Phase 2, the tile body's edges: lane counts that split a tile of 8
    lanes, the converge tree's narrow levels, planes off 16 B alignment,
    all-padding lanes beside lanes whose B rows all lie in A, full-range
    keys, keys tied on word 0, out = C/2 and untruncated; and (18, 2) at
    C=512, which takes the wide body, in the same process.  Returns the
    largest |kernel - twin|."""
    from crdt_tpu_torch import workload

    limit = hu.smem_limit(torch.device("cuda"))
    err = 0

    def union(pair, n_keys, out, label, want_tile=True):
        nonlocal err
        ka, va, kb, vb = pair
        c = ka[0].shape[0]
        body = hu.lexn_union_body(n_keys, len(va), c, 2 * c if out is None else out, limit)
        if (body[1] > 0) != want_tile:
            raise AssertionError(f"lexn_union {label}: body {body}, tile expected {want_tile}")
        got = hu.sorted_union_columnar_fused_lexn(ka, va, kb, vb, out_size=out)
        want = hu._lexn_union_plain(ka, va, kb, vb, 2 * c if out is None else out)
        err = max(err, same(f"lexn_union {label}", (*got[0], *got[1], got[2]),
                            (*want[0], *want[1], want[2])))
        return int(got[2].max())

    for n in (1, 7, 9, 127, 130, 4097):
        union(tile_pair(2, 2, C, n, SEED + 60 + n), 2, C, f"full-range L={n}")
    union([off_alignment(x) for x in tile_pair(2, 2, C, 130, SEED + 61)], 2, C,
          "unaligned L=130")
    union(tile_pair(2, 2, C, 4097, SEED + 62, b_inside_a=True, empty_lanes=(0, 7, 8, 4096)),
          2, None, "B inside A, all-padding lanes, untruncated")
    ties = tile_pair(2, 2, C, 130, SEED + 63, ties=True)
    if union(ties, 2, C // 2, "word-0 ties, out=C/2") <= C // 2:
        raise AssertionError("the word-0 ties case did not overflow")
    union(ties, 2, None, "word-0 ties, untruncated")
    w = workload.reference_writes(C, 64, SEED)
    wide_a = swarm_planes(w, C, 64, 0.4, SEED + 64)
    wide_b = swarm_planes(w, C, 64, 0.4, SEED + 65)
    for n in (1, 2, 3, 5, 10, 20, 40):
        a, b = ([x[:, :n].contiguous() for x in side] for side in (wide_a, wide_b))
        union([a[:2], a[2:], b[:2], b[2:]], 2, C, f"converge level L={n}")
    union(tile_pair(18, 2, C // 2, 130, SEED + 66, ties=True), 18, C // 2,
          "(18, 2) C=512 (wide body)", want_tile=False)
    log(f"lexn_union tile edges vs twin: bit-exact at L=1/7/9/127/130/4097, unaligned, "
        f"B inside A with all-padding lanes, full-range and word-0-tied keys, out=C/2 and "
        f"2C, converge levels L=1-40; (18, 2) at C=512 on the wide body; tile plan at "
        f"C={C}: {hu.lexn_union_body(2, 2, C, C, limit)}, "
        f"{hu.lexn_union_smem_bytes(2, 2, C, C, limit)} B a CTA")
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


def profile(label: str, fn) -> dict | None:
    """One call of ``fn`` under torch.profiler: device time by kernel and
    the device's busy share of the call's wall time (the profiler's own
    host overhead is inside the wall).  Returns the busy and wall ms and
    the idle share, None when the profiler saw no device time."""
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
        return None
    log(f"profile [{label}]: device busy {busy_ms:.4f} ms of {wall_ms:.4f} ms wall "
        f"(idle share {1 - busy_ms / wall_ms:.3f}, under the profiler)")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:8]:
        log(f"  {e.self_device_time_total / 1e3:9.4f} ms  x{e.count:<4d} {e.key[:90]}")
    return {"busy_ms": busy_ms, "wall_ms": wall_ms, "idle_share": 1 - busy_ms / wall_ms,
            "device_ops": sum(e.count for e in events)}


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
    library = "—" if library_ms is None else f"{library_ms:.4f} ms"
    log(f"{name}: {ms:.4f} ms/launch, plain twin {plain_ms:.4f} ms, library "
        f"{library}, bound {bound_ms:.4f} ms by {bound_by} "
        f"({n_bytes / 1e9:.3f} GB at 3.35 TB/s; {n_ops / 1e9:.3f} G int32 operations "
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
    max_err = max(check_kernel(hu, C, R), check_lexn_tile_edges(hu))

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

    def bucketed(a, b, out_r, label, n_buckets=N_BUCKETS):
        got = hu.bucketed_union_columnar(*a, *b, n_buckets=n_buckets, out_bucket_rows=out_r)
        err["bucketed_union"] = max(err["bucketed_union"], same(
            f"bucketed_union {label}", got,
            hu._bucketed_union_plain(*a, *b, n_buckets, out_r)))
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
    check_set_tile_edges(pool, union)
    check_segment_and_merge_edges(pool, bucketed, merge, to_bucketed)
    log(f"set kernels vs twins: bit-exact at C={SET_C} L={SET_L} (OR-Set draw max "
        f"n_unique {nu}), overflow and ragged L=1/127/130; max |err| {err}")
    return err, (a, b), (sa, sb)


def check_set_tile_edges(pool, union) -> None:
    """Phase 6, set_union's tile body: lane counts that split a tile of 8
    lanes, planes off 16 B alignment, all-padding lanes beside lanes whose
    B keys all lie in A, full-range int32 keys and values (bit 31), out =
    C/2 and untruncated; ``union(a, b, out, label)`` checks one case."""
    from crdt_tpu_torch.ops import hopper_union as hu

    def pair(*args, **kw):
        ka, va, kb, vb = tile_pair(1, 1, *args, **kw)
        return (ka[0], va[0]), (kb[0], vb[0])

    for n in (7, 9, 4097):
        union(set_planes(pool, n, SEED + 19), set_planes(pool, n, SEED + 20), SET_C,
              f"OR-Set draw L={n}")
    for n in (1, 9, 130, 4097):
        a, b = pair(SET_C, n, SEED + 21 + n)
        union(a, b, SET_C, f"full-range L={n}")
        if union(a, b, SET_C // 2, f"full-range L={n}, out=C/2") <= SET_C // 2:
            raise AssertionError("the full-range overflow case did not overflow")
        union(a, b, None, f"full-range L={n}, untruncated")
    a, b = pair(SET_C, 130, SEED + 22)
    union(tuple(off_alignment(list(a))), tuple(off_alignment(list(b))), SET_C,
          "full-range, unaligned L=130")
    oa, ob = set_planes(pool, 130, SEED + 23), set_planes(pool, 130, SEED + 24)
    union(tuple(off_alignment(list(oa))), tuple(off_alignment(list(ob))), SET_C,
          "OR-Set draw, unaligned L=130")
    a, b = pair(SET_C, 4097, SEED + 25, b_inside_a=True, empty_lanes=(0, 7, 8, 4096))
    union(a, b, None, "B inside A, all-padding lanes, untruncated")
    limit = hu.smem_limit(torch.device("cuda"))
    log(f"set_union tile edges vs twin: bit-exact at L=1/7/9/130/4097, unaligned, B inside "
        f"A with all-padding lanes, full-range keys and values, out=C/2 and 2C; plan at "
        f"C={SET_C}, out=C: {hu.set_union_plan(SET_C, SET_C, limit)}, "
        f"{hu.set_union_smem_bytes(SET_C, SET_C, limit)} B a CTA")


def bucket_pair(c: int, n_buckets: int, lanes: int, seed: int, **kw) -> tuple:
    """Two operands on the card in the bucketed layout, ((keys, vals),
    (keys, vals)): each bucket of Wb = c / n_buckets rows drawn on its own
    by ``tile_pair`` at one key word (full-range keys and values; ``kw``
    as there)."""
    parts = [tile_pair(1, 1, c // n_buckets, lanes, seed + b, **kw) for b in range(n_buckets)]
    ka, va, kb, vb = (torch.cat([p[i][0] for p in parts]) for i in range(4))
    return (ka, va), (kb, vb)


def flag_padding(a, b) -> tuple:
    """The operands with A's padding values 1 and B's 2 (a tombstoned tag
    that packs to SENTINEL is padding too), so that the merge's order of the
    two padding tails shows."""
    return tuple((k, torch.where(k == SENTINEL, flag, v)) for (k, v), flag in ((a, 1), (b, 2)))


def check_segment_and_merge_edges(pool, bucketed, merge, to_bucketed) -> None:
    """Phase 6, kernel 3's segment body and kernel 6's keep-all tile: lane
    counts that split a CTA's lanes or a 16 B chunk, planes off 16 B
    alignment, full-range int32 keys and values, all-padding lanes beside B
    inside A, flagged padding; kernel 3 at out_r = 0, Wb, 2 Wb and odd, C =
    48 with 3 buckets, Wb = 1 and 256, 16 lanes a CTA; kernel 6 at C = 8,
    1024 and 4096.  ``bucketed``, ``merge`` and ``to_bucketed`` are
    check_set_kernels' checks."""
    from crdt_tpu_torch.ops import hopper_union as hu

    wb = SET_C // N_BUCKETS
    for n in (1, 7, 9, 127, 130, 4097):
        a, b = bucket_pair(SET_C, N_BUCKETS, n, SEED + 30 + n)
        bucketed(a, b, wb, f"full-range L={n}")
        bucketed(a, b, 2 * wb, f"full-range L={n}, out_r=2Wb")
        ka, va = tile_pair(1, 1, SET_C, n, SEED + 31 + n)[:2]
        kb, vb = tile_pair(1, 1, SET_C, n, SEED + 32 + n)[:2]
        merge((ka[0], va[0]), (kb[0], vb[0]), f"full-range L={n}")
    a, b = bucket_pair(SET_C, N_BUCKETS, 130, SEED + 33)
    bucketed(a, b, 0, "out_r=0")
    if bucketed(a, b, 5, "odd out_r=5") <= 5:
        raise AssertionError("the odd out_r case did not truncate")
    bucketed(tuple(off_alignment(list(a))), tuple(off_alignment(list(b))), 17,
             "unaligned, odd out_r=17")
    a, b = bucket_pair(SET_C, N_BUCKETS, 4097, SEED + 34, b_inside_a=True,
                       empty_lanes=(0, 7, 8, 4096))
    bucketed(a, b, wb, "B inside A, all-padding lanes")
    sa = to_bucketed(*strided_planes(4097, SEED + 35))
    sb = to_bucketed(*strided_planes(4097, SEED + 36))
    bucketed(*flag_padding(sa, sb), wb, "strided draw, flagged padding L=4097")
    for c, nb, n, outs in ((48, 3, 130, (16, 32, 7)), (64, 64, 130, (1, 2)),
                           (512, 2, 130, (256, 512)), (4096, 16, 33, (512,))):
        a, b = bucket_pair(c, nb, n, SEED + 37 + c)
        for out_r in outs:
            bucketed(a, b, out_r, f"C={c} B={nb} L={n} out_r={out_r}", n_buckets=nb)
    limit = hu.smem_limit(torch.device("cuda"))
    for c, n in ((8, 9), (8, 4097), (4096, 130)):
        ka, va, kb, vb = tile_pair(1, 1, c, n, SEED + 38 + c + n)
        merge((ka[0], va[0]), (kb[0], vb[0]), f"full-range C={c} L={n}")
    ka, va, kb, vb = tile_pair(1, 1, SET_C, 4097, SEED + 39, b_inside_a=True,
                               empty_lanes=(0, 7, 8, 4096))
    merge((ka[0], va[0]), (kb[0], vb[0]), "B inside A, all-padding lanes")
    oa, ob = set_planes(pool, 130, SEED + 40), set_planes(pool, 130, SEED + 41)
    merge(tuple(off_alignment(list(oa))), tuple(off_alignment(list(ob))),
          "OR-Set draw, unaligned L=130")
    merge(*flag_padding(oa, ob), "OR-Set draw, flagged padding L=130")
    log(f"bucketed_union segment edges vs twin: bit-exact at L=1/7/9/127/130/4097, "
        f"out_r=0/5/17/Wb/2Wb, unaligned, B inside A with all-padding lanes, flagged "
        f"padding, full-range keys, C=48 B=3, Wb=1/16/256; plans (lanes a CTA, buffers, "
        f"B): out_r=Wb {hu.bucketed_union_plan(SET_C, N_BUCKETS, wb, limit)}, 2Wb "
        f"{hu.bucketed_union_plan(SET_C, N_BUCKETS, 2 * wb, limit)}, Wb=256 "
        f"{hu.bucketed_union_plan(512, 2, 512, limit)}")
    log(f"merge keep-all edges vs twin: bit-exact at C=8/1024/4096, L=1/7/9/127/130/4097, "
        f"unaligned, B inside A with all-padding lanes, flagged padding (A's tail first); "
        f"plan at C={SET_C}: {hu.merge_plan(SET_C, limit)}, {hu.merge_smem_bytes(SET_C, limit)} "
        f"B a CTA")


def run_set_slice(pool, card: str) -> tuple:
    """Phase 7: the OR-Set main path at full size through the entry points a
    user calls, then its checks and the member mask's times.  Returns
    (operand planes, launches, max |kernel - twin| on the slices, the
    member mask's table row)."""
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
    if launches["member_mask"] != 1:
        raise AssertionError(f"columnar_member_mask launched member_mask "
                             f"{launches['member_mask']} times, expected 1")
    err = mask_err = 0
    for sl in (slice(0, SLICE), slice(SET_R - SLICE, SET_R)):
        planes = [x[:, sl].contiguous() for x in (pa, ra, pb, rb)]
        err = max(err, same(f"set_union lanes {sl.start}-{sl.stop}",
                            (keys[:, sl], vals[:, sl], nu[sl]),
                            hu._set_union_plain(*planes, SET_C)))
        mask_err = max(mask_err, same(
            f"member_mask lanes {sl.start}-{sl.stop}", (mask[:, sl],),
            (orset._columnar_member_mask_plain(keys[:, sl].contiguous(),
                                               vals[:, sl].contiguous(), SET_UNIVERSE),)))
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
    log(f"OR-Set slice checks: max n_unique {max_nu} <= C, join and member mask == twins "
        f"on lanes 0-{SLICE} and the last {SLICE}, {len(lanes)} sampled lanes == plain "
        f"fold (tags, tombstones, members; lane 0 holds "
        f"{len(workload.set_view(pool, held[0], seen[0])[0])} tags)")
    del k_cpu, v_cpu, m_cpu, mask, nu
    mask_row = member_mask_times(keys, vals, launches["member_mask"], mask_err, card)
    return (pa, ra, pb, rb), launches, err, mask_row


def member_mask_times(keys, vals, launches: int, err: int, card: str) -> dict:
    """Phase 7's member mask at R=2^20 on the joined planes: the kernel, its
    plain twin and, as the library yardstick, the twin's one
    ``scatter_reduce_`` over rows it has decoded.  Returns the table row."""
    from crdt_tpu_torch.models import orset
    from crdt_tpu_torch.ops import pack

    ms = time_ms(lambda: orset.columnar_member_mask(keys, vals, SET_UNIVERSE), reps=20)
    plain_ms = time_ms(lambda: orset._columnar_member_mask_plain(keys, vals, SET_UNIVERSE),
                       reps=3, warmup=1)
    valid = keys != SENTINEL
    elem = (keys >> (pack.RID_BITS + pack.SEQ_BITS)) & ((1 << pack.ELEM_BITS) - 1)
    rows = orset._mask_rows(torch.where(valid, elem, SET_UNIVERSE), SET_UNIVERSE)
    del elem
    live = (valid & (vals == 0)).to(torch.int32)
    del valid
    table = torch.zeros((SET_UNIVERSE + 1, SET_R), dtype=torch.int32, device="cuda")
    library_ms = time_ms(lambda: table.scatter_reduce_(0, rows, live, reduce="amax"),
                         reps=3, warmup=1)
    del rows, live, table
    torch.cuda.empty_cache()
    log("member_mask plain twin: the decode planes, an int64 row plane and "
        "scatter_reduce_; library yardstick: that one scatter_reduce_ on rows decoded "
        "beforehand")
    # bytes: the key and removed planes read once, the bool mask written
    # once; operations: one decode and bit set for each row
    return kernel_row("member_mask", "crdt_tpu_torch/csrc/set_member.cu",
                      "none (crdt_tpu/models/orset.py:428, .at[].max)", launches, err, ms,
                      plain_ms, 2 * SET_C * SET_R * 4 + SET_UNIVERSE * SET_R,
                      SET_C * SET_R, library_ms, card)


def set_times_full(planes, card: str) -> tuple:
    """Phase 7 times at R=2^20: set_union, its twin, the library sort and
    the whole columnar_join, and the full-width floor beside set_union
    (phase 13); then one profiled columnar_join.  Returns set_union's table
    row and the floor's time and error."""
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
    floor_full = floor_full_width(planes, ms, card)
    real = int((pa != SENTINEL).sum()) + int((pb != SENTINEL).sum())
    # bytes: 4 planes read, 2 planes + n_unique written; operations: one
    # binary search (log2 C compares) for each live row of either side
    row = kernel_row("set_union", "crdt_tpu_torch/csrc/set_union.cu",
                     "crdt_tpu/ops/pallas_union.py:218", 0, 0, ms, plain_ms,
                     (4 * SET_C * SET_R + 2 * SET_C * SET_R + SET_R) * 4,
                     real * math.ceil(math.log2(SET_C)), library_ms, card)
    profile(f"OR-Set columnar_join at R={SET_R}",
            lambda: orset.columnar_join(pa, ra, pb, rb))
    return row, floor_full


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
    unfused_ms = time_ms(lambda: hu.sorted_union_columnar_unfused(*a, *b, out_size=SET_C),
                         reps=5)
    log(f"sorted_union_columnar_unfused end to end (L={SET_L}, out=C): {unfused_ms:.4f} ms, "
        f"its merge kernel {ms:.4f} ms ({100 * ms / unfused_ms:.1f}%)")

    (ka, va), (kb, vb) = strided
    ba = ue.sorted_to_bucketed(ka, va, N_BUCKETS, KEY_BITS)[:2]
    bb = ue.sorted_to_bucketed(kb, vb, N_BUCKETS, KEY_BITS)[:2]

    def segments(x):  # (C, L) -> (L·B, Wb): one row per (lane, bucket)
        return x.reshape(N_BUCKETS, wb, SET_L).permute(2, 0, 1).reshape(-1, wb)

    seg_keys = torch.cat([segments(ba[0]), segments(bb[0])], dim=1)
    library_ms = time_ms(lambda: torch.sort(seg_keys, dim=1), reps=5)
    del seg_keys
    log("bucketed_union library yardstick: one segmented torch.sort over the "
        f"(L·B, 2·Wb) = ({SET_L * N_BUCKETS}, {2 * wb}) bucket rows")
    real = int((ba[0] != SENTINEL).sum()) + int((bb[0] != SENTINEL).sum())
    # the table's row: the resident chain's out_r = Wb; the engine's 2·Wb
    # beside it in the log
    shapes = {}
    limit = hu.smem_limit(torch.device("cuda"))
    for out_r in (wb, 2 * wb):
        ms = time_ms(lambda o=out_r: hu.bucketed_union_columnar(
            *ba, *bb, n_buckets=N_BUCKETS, out_bucket_rows=o), reps=10)
        plain_ms = time_ms(lambda o=out_r: hu._bucketed_union_plain(*ba, *bb, N_BUCKETS, o),
                           reps=5)
        n_bytes = (4 * SET_C * SET_L + 2 * N_BUCKETS * out_r * SET_L + 2 * SET_L) * 4
        shapes[out_r] = (ms, plain_ms, n_bytes)
        bound_ms, bound_by = bound(n_bytes, real * math.ceil(math.log2(wb)))
        plan = hu.bucketed_union_plan(SET_C, N_BUCKETS, out_r, limit)
        log(f"bucketed_union out_r={out_r} (L={SET_L}, B={N_BUCKETS}): {ms:.4f} ms, plain "
            f"twin {plain_ms:.4f} ms, library {library_ms:.4f} ms, bound {bound_ms:.4f} ms "
            f"by {bound_by}; plan (lanes a CTA, buffers, B) {plan}")
    ms, plain_ms, n_bytes = shapes[wb]
    bucketed = ("bucketed_union", "crdt_tpu_torch/csrc/set_union.cu",
                "crdt_tpu/ops/pallas_union.py:1003", ms, plain_ms, n_bytes,
                real * math.ceil(math.log2(wb)), library_ms)
    engine_ms = time_ms(lambda: ue.engine_bucket(ka, va, kb, vb, SET_C, n_buckets=N_BUCKETS,
                                                 key_bits=KEY_BITS), reps=5)
    log(f"engine_bucket end to end (strided draw, L={SET_L}): {engine_ms:.4f} ms, its "
        f"bucketed_union (out_r=2Wb) {shapes[2 * wb][0]:.4f} ms "
        f"({100 * shapes[2 * wb][0] / engine_ms:.1f}%)")

    auto_ms = time_ms(lambda: orset.columnar_join(*a, *b, engine="auto"), reps=5)
    log(f"columnar_join engine=auto (L={SET_L}, plans bucket, falls back to sort): "
        f"{auto_ms:.4f} ms")
    return merge, bucketed


def set_phases(card: str) -> tuple:
    """Phases 6-8: the OR-Set swarm path.  Returns the table rows of
    set_union, member_mask, merge and bucketed_union, and the full-width
    floor's time and error (phase 13)."""
    from crdt_tpu_torch import workload

    pool = workload.set_pool(SEED)
    err, draw, strided = check_set_kernels(pool)

    planes, launches, slice_err, member_mask = run_set_slice(pool, card)
    set_union, floor_full = set_times_full(planes, card)
    set_union.update(launches=launches["set_union"],
                     max_abs_err=max(err["set_union"], slice_err))
    del planes
    torch.cuda.empty_cache()

    engine_launches = run_set_engines(draw, strided)
    rows = [set_union, member_mask]
    for name, source, replaces, ms, plain_ms, n_bytes, n_ops, library_ms in \
            set_times_engines(draw, strided, card):
        rows.append(kernel_row(name, source, replaces, engine_launches[name], err[name],
                               ms, plain_ms, n_bytes, n_ops, library_ms, card))
    return rows, floor_full


# ---- the RSeq slice ----
#
# R=10,240 replicas (the OpLog phase's swarm) x C=1024 rows x depth 6 (the
# JAX package's RSeq bench shape) over workload.seq_pool's editing history:
# 16 writers, 1,000 elements, a quarter removable.

SEQ_C = 1024
SEQ_W = 16                  # GC floor writers: the history's 16 writers
SEQ_SAMPLED = 64            # seeded lanes checked against the plain fold
N_KEYS_SEQ = 18             # 3 packed words x depth 6


def seq_columnar(pool, lanes: int, c: int, seed: int):
    """A seq_swarm draw on the card, stacked into the columnar layout."""
    from crdt_tpu_torch import workload
    from crdt_tpu_torch.models import rseq_columnar as rc

    return rc.stack(workload.seq_swarm(pool, lanes, c, seed, device="cuda").states)


def lexn_sides(a, b, gc: bool):
    """(keys_a, vals_a, keys_b, vals_b) of two columnar swarms: 18 key words
    and (elem, removed), plus the GC join's src marker when ``gc``."""
    def vals(col, k):
        v = (col.elem, col.removed)
        return v + ((col.keys[0] != SENTINEL).to(torch.int32) * k,) if gc else v

    return tuple(a.keys), vals(a, 1), tuple(b.keys), vals(b, 2)


def check_rseq_kernels(pool) -> dict:
    """Phase 9: lexn_merge, lexn_compact and lexn_union at RSeq's width
    against their twins, the striped and auto paths against the fused
    twin, overflow, ragged lanes and the shared-memory refusals.  Returns
    the largest |kernel - twin| by kernel."""
    from crdt_tpu_torch import workload
    from crdt_tpu_torch.ops import hopper_union as hu

    err = {"lexn_merge": 0, "lexn_compact": 0, "lexn_union_rseq": 0}

    def merge(sides, label):
        got = hu.lexn_merge_columnar(*sides)
        err["lexn_merge"] = max(err["lexn_merge"], same(
            f"lexn_merge {label}", (*got[0], *got[1]),
            tuple(x for t in hu._lexn_merge_plain(*sides) for x in t)))
        return got

    def compact(keys, vals, out, label):
        got = hu.lexn_compact_columnar(keys, vals, out)
        want = hu._lexn_compact_plain(keys, vals, out)
        err["lexn_compact"] = max(err["lexn_compact"], same(
            f"lexn_compact {label}", (*got[0], *got[1], got[2]),
            (*want[0], *want[1], want[2])))
        return int(got[2].max())

    def union(sides, out, label):
        got = hu.sorted_union_columnar_fused_lexn(*sides, out_size=out)
        want = hu._lexn_union_plain(*sides, out)
        err["lexn_union_rseq"] = max(err["lexn_union_rseq"], same(
            f"lexn_union {label}", (*got[0], *got[1], got[2]),
            (*want[0], *want[1], want[2])))
        return int(got[2].max())

    a, b = seq_columnar(pool, R, SEQ_C, SEED + 41), seq_columnar(pool, R, SEQ_C, SEED + 42)
    for gc in (False, True):
        split = f"(18, {3 if gc else 2})"
        mk, mv = merge(lexn_sides(a, b, gc), f"{split} C={SEQ_C} L={R}")
        nu = compact(mk, mv, SEQ_C, f"{split} out=C")
        compact(mk, mv, 2 * SEQ_C, f"{split} out=2C")
        if compact(mk, mv, SEQ_C // 4, f"{split} overflow out=C/4") <= SEQ_C // 4:
            raise AssertionError("the compaction overflow case did not overflow")
    log(f"lexn_merge + lexn_compact vs twins: bit-exact at (18, 2) and (18, 3), "
        f"C={SEQ_C} L={R}, out=C/2C and overflow (max n_unique {nu})")
    for gc in (False, True):
        split = f"(18, {3 if gc else 2})"
        for out in (SEQ_C // 4, SEQ_C, 2 * SEQ_C):
            union(lexn_sides(a, b, gc), out, f"{split} C={SEQ_C} L={R} out={out}")
    log(f"lexn_union (wide body, one CTA an SM) vs twin: bit-exact at (18, 2) and (18, 3), "
        f"C={SEQ_C} L={R}, out=C/4 (overflow), C and 2C")
    half_a, half_b = (seq_columnar(pool, R, SEQ_C // 2, SEED + 43),
                      seq_columnar(pool, R, SEQ_C // 2, SEED + 44))
    for gc in (False, True):
        split = f"(18, {3 if gc else 2})"
        nu = union(lexn_sides(half_a, half_b, gc), SEQ_C // 2, f"{split} C=512 out=C")
        union(lexn_sides(half_a, half_b, gc), SEQ_C, f"{split} C=512 out=2C")
        if nu <= SEQ_C // 2:
            raise AssertionError("the C=512 union did not overflow its capacity")
    del half_a, half_b
    log(f"lexn_union vs twin: bit-exact at (18, 2) and (18, 3), C=512 L={R} "
        f"(overflowing: max n_unique {nu})")

    sides = lexn_sides(a, b, True)
    want = hu._lexn_union_plain(*sides, SEQ_C)
    before = dict(hu.LAUNCHES)
    got = hu.sorted_union_columnar_striped_lexn(*sides, out_size=SEQ_C, stripe=256)
    same("striped, stripe 256", (*got[0], *got[1], got[2]), (*want[0], *want[1], want[2]))
    merges = hu.LAUNCHES["lexn_merge"] - before["lexn_merge"]
    compacts = hu.LAUNCHES["lexn_compact"] - before["lexn_compact"]
    if (merges, compacts) != (12, 1):
        raise AssertionError(f"stripe 256 launched {merges} merges and {compacts} "
                             "compactions, expected 12 and 1")
    wide_a = seq_columnar(pool, 2048, 2 * SEQ_C, SEED + 45)
    wide_b = seq_columnar(pool, 2048, 2 * SEQ_C, SEED + 46)
    sides = lexn_sides(wide_a, wide_b, False)
    before = dict(hu.LAUNCHES)
    got = hu.sorted_union_columnar_lexn_auto(*sides, out_size=2 * SEQ_C)
    want = hu._lexn_union_plain(*sides, 2 * SEQ_C)
    same("auto C=2048", (*got[0], *got[1], got[2]), (*want[0], *want[1], want[2]))
    delta = {k: hu.LAUNCHES[k] - before[k] for k in ("lexn_union", "lexn_merge", "lexn_compact")}
    if delta != {"lexn_union": 0, "lexn_merge": 4, "lexn_compact": 1}:
        raise AssertionError(f"auto at C=2048 did not run the block network: {delta}")
    log("striped (stripe 256: 12 merges + 1 compaction) and auto at C=2048 on 2,048 "
        "lanes (stripe 1024: 4 merges + 1 compaction) == the fused twin")

    for n in (1, 2, 7, 9, 127, 130, 257):
        ra, rb = seq_columnar(pool, n, SEQ_C, SEED + 47), seq_columnar(pool, n, SEQ_C, SEED + 48)
        mk, mv = merge(lexn_sides(ra, rb, True), f"ragged L={n}")
        for out in (SEQ_C // 4, SEQ_C, 2 * SEQ_C):
            compact(mk, mv, out, f"ragged L={n} out={out}")
            union(lexn_sides(ra, rb, True), out, f"(18, 3) C={SEQ_C} ragged L={n} out={out}")
        ra, rb = (seq_columnar(pool, n, SEQ_C // 2, SEED + 49),
                  seq_columnar(pool, n, SEQ_C // 2, SEED + 50))
        union(lexn_sides(ra, rb, False), SEQ_C // 2, f"ragged L={n}")
    log("ragged L=1/2/7/9/127/130/257 (tiles and clusters of 8 lanes split): bit-exact, "
        "out=C/4, C, 2C; the wide body at C=512 (two CTAs an SM) and C=1024 (one)")
    for nk, c, lanes in ((2, 2 * SEQ_C, 130), (2, 4 * SEQ_C, 9), (5, 64, 130),
                         (N_KEYS_SEQ, 64, 130), (N_KEYS_SEQ, 256, R)):
        for kw in ({}, {"b_inside_a": True, "empty_lanes": (0, lanes - 1)}):
            pair = workload.lexn_pair(nk, 2, c, lanes, SEED + 57 + c, device="cuda", **kw)
            for out in (c // 2, c, 2 * c):
                union(pair, out, f"({nk}, 2) C={c} L={lanes} out={out} {kw}")
    log("lexn_union (wide body) vs twin: (2, 2) at C=2048 and 4096 past the tile, (5, 2) "
        "and (18, 2) at C=64 (eight CTAs an SM), (18, 2) at C=256 (four), out=C/2, C, 2C, "
        "B inside A with all-padding lanes: bit-exact")
    check_lexn_layouts(pool, merge, compact)
    check_stripe_c_hands_over(pool)
    err["lexn_merge"] = max(err["lexn_merge"], check_merge_cluster_start())

    limit = hu.smem_limit(torch.device("cuda"))
    big = [torch.full((2 * SEQ_C, 2), SENTINEL, dtype=torch.int32, device="cuda")] * 20
    refusals = []
    before = dict(hu.LAUNCHES)
    for label, call, want_bytes in (
        ("fused union (18, 2) at C=2048", lambda: hu.sorted_union_columnar_fused_lexn(
            big[:18], big[18:], big[:18], big[18:]), hu.lexn_union_smem_bytes(18, 2, 2 * SEQ_C)),
        ("merge at S=2048", lambda: hu.lexn_merge_columnar(
            big[:18], big[18:], big[:18], big[18:]), hu.lexn_merge_smem_bytes(18, 2 * SEQ_C)),
    ):
        try:
            call()
        except RuntimeError as e:
            if f"{want_bytes} B of shared memory" not in str(e):
                raise AssertionError(f"{label}: refusal without its figure: {e}") from e
            refusals.append(f"{label} ({want_bytes} B > {limit} B)")
        else:
            raise AssertionError(f"{label} launched past the {limit} B limit")
    try:
        hu.lexn_plan(1 << 17, N_KEYS_SEQ, 2, limit)
    except ValueError as e:
        refusals.append(f"plan at C=131,072 ({e})")
    else:
        raise AssertionError("the plan accepted C=131,072")
    if hu.LAUNCHES != before:
        raise AssertionError("a refused launch was counted")
    torch.cuda.synchronize()
    log(f"shared-memory refusals with the figure, limit {limit} B: " + "; ".join(refusals))
    return err


MERGE_REPEATS = 400  # launches of each shape in the cluster-start check


def check_merge_cluster_start() -> int:
    """Phase 9: lexn_merge at C=64 and 256, L=10,240, (18, 2), where two
    of its 1,024-thread CTAs can share an SM and start at different times:
    MERGE_REPEATS launches of each, every one == the twin.  The kernel's
    staging writes into the other CTAs of its cluster, so it must reach a
    cluster barrier first; without it such launches fault now and then.
    Returns the largest |kernel - twin|."""
    from crdt_tpu_torch import workload
    from crdt_tpu_torch.ops import hopper_union as hu

    worst = 0
    for c in (64, 256):
        sides = workload.lexn_pair(N_KEYS_SEQ, 2, c, R, SEED + 71 + c, device="cuda")
        want = tuple(x for t in hu._lexn_merge_plain(*sides) for x in t)
        for i in range(MERGE_REPEATS):
            got = hu.lexn_merge_columnar(*sides)
            worst = max(worst, same(f"lexn_merge C={c} launch {i}", (*got[0], *got[1]), want))
        torch.cuda.synchronize()
    log(f"lexn_merge cluster start: {MERGE_REPEATS} launches each at (18, 2), C=64 and 256, "
        f"L={R} (two 1,024-thread CTAs an SM): every one bit-exact")
    return worst


def check_lexn_layouts(pool, merge, compact) -> None:
    """Phase 9, the tile and cluster layouts of kernels 4 and 5 at full
    width: planes that start a row into a block with an odd lane count (no
    16 B alignment, as stripe views of such swarms are), the 32-plane cap
    with keys equal but for their last words, and lanes that are all
    padding beside lanes whose B rows all duplicate A's."""
    from crdt_tpu_torch import workload
    from crdt_tpu_torch.ops import hopper_union as hu

    n = R - 1
    sides = []
    for planes in lexn_sides(seq_columnar(pool, n, SEQ_C, SEED + 51),
                             seq_columnar(pool, n, SEQ_C, SEED + 52), True):
        block = torch.zeros((len(planes), SEQ_C + 1, n), dtype=torch.int32, device="cuda")
        block[:, 1:] = torch.stack(planes)
        sides.append(tuple(block[:, 1:]))
    if sides[0][0].data_ptr() % 16 == 0:
        raise AssertionError("the row-sliced planes are 16 B aligned")
    mk, mv = merge(tuple(sides), f"row-sliced, L={n}")
    merged = torch.zeros((mk.shape[0] + mv.shape[0], 2 * SEQ_C + 1, n), dtype=torch.int32,
                         device="cuda")
    merged[:, 1:] = torch.cat([mk, mv])
    views = tuple(merged[:, 1:])
    for out in (SEQ_C // 4, SEQ_C, 2 * SEQ_C):
        compact(views[:N_KEYS_SEQ], views[N_KEYS_SEQ:], out, f"row-sliced, L={n} out={out}")
    del sides, merged, views, mk, mv
    # 29 key words take S <= 512 (lexn_plan's stripe at C = 1024)
    for label, c, pair in (
        ("32 planes (29, 3)", SEQ_C // 2,
         workload.lexn_pair(29, 3, SEQ_C // 2, R, SEED + 53, device="cuda")),
        ("B inside A, all-padding lanes", SEQ_C, workload.lexn_pair(
            N_KEYS_SEQ, 3, SEQ_C, R, SEED + 54, b_inside_a=True,
            empty_lanes=(0, 7, 8, R // 2, R - 1), device="cuda")),
    ):
        mk, mv = merge(pair, f"{label}, S={c} L={R}")
        for out in (c // 4, c, 2 * c):
            compact(mk, mv, out, f"{label} out={out}")
        del pair, mk, mv
    pair = workload.lexn_pair(29, 3, SEQ_C, R, SEED + 53, device="cuda")
    before = dict(hu.LAUNCHES)
    got = hu.sorted_union_columnar_lexn_auto(*pair, out_size=SEQ_C)
    want = hu._lexn_union_plain(*pair, SEQ_C)
    same("auto, 32 planes at C=1024", (*got[0], *got[1], got[2]), (*want[0], *want[1], want[2]))
    merges = hu.LAUNCHES["lexn_merge"] - before["lexn_merge"]
    if merges != 4:
        raise AssertionError(f"auto at 29 key words, C=1024 ran {merges} merges, expected 4 "
                             "(stripe 512)")
    del pair, got, want
    limit = hu.smem_limit(torch.device("cuda"))
    for nk, s in ((N_KEYS_SEQ, SEQ_C), (29, SEQ_C // 2)):
        clusters = hu.lexn_merge_clusters(nk, s)
        if clusters < 1:
            raise AssertionError(f"the card places no lexn_merge cluster at {nk} key words")
        log(f"lexn_merge clusters: {clusters} clusters of 8 CTAs resident at once at "
            f"{hu.lexn_merge_smem_bytes(nk, s)} B a CTA ({nk} key words, S={s}; "
            f"cudaOccupancyMaxActiveClusters); L={R} takes {-(-R // 8)}")
    for rows in (SEQ_C, 2 * SEQ_C):
        lt = hu.lexn_compact_tile(rows, limit)
        log(f"lexn_compact tile over {rows} rows: {lt} lanes a CTA, "
            f"{hu.lexn_compact_smem_bytes(rows, lt)} B")
    log("row-sliced unaligned planes, 32 planes (and auto at C=1024: stripe 512, 4 merges), "
        "B inside A and all-padding lanes: bit-exact at out=C/4, C, 2C")


def check_stripe_c_hands_over(pool) -> None:
    """At stripe = C the striped union is one merge whose (P, 2C, L) blocks
    are the compaction's input, no concatenation between them: the
    compaction receives the merge's own tensors."""
    from crdt_tpu_torch.ops import hopper_union as hu

    seen = {}
    merge, compact = hu.lexn_merge_columnar, hu.lexn_compact_columnar

    def spy_merge(*args):
        seen["merge"] = merge(*args)
        return seen["merge"]

    def spy_compact(keys, vals, out):
        seen["compact"] = (keys, vals)
        return compact(keys, vals, out)

    sides = lexn_sides(seq_columnar(pool, R, SEQ_C, SEED + 55),
                       seq_columnar(pool, R, SEQ_C, SEED + 56), False)
    hu.lexn_merge_columnar, hu.lexn_compact_columnar = spy_merge, spy_compact
    try:
        got = hu.sorted_union_columnar_striped_lexn(*sides, out_size=SEQ_C)
    finally:
        hu.lexn_merge_columnar, hu.lexn_compact_columnar = merge, compact
    if (seen["compact"][0] is not seen["merge"][0]
            or seen["compact"][1] is not seen["merge"][1]):
        raise AssertionError("at stripe = C the compaction did not take the merge's blocks")
    want = hu._lexn_union_plain(*sides, SEQ_C)
    same("striped at C=1024 (one merge, one compaction)", (*got[0], *got[1], got[2]),
         (*want[0], *want[1], want[2]))
    log("striped at C=1024, S=C: one merge, its blocks straight into the compaction (no "
        "concatenation), == the fused twin")


def run_rseq_slice(pool) -> dict:
    """Phases 10-11: the RSeq main path at full size through the entry
    points a user calls, the GC barrier and the revival, then their
    checks.  Returns what the timing phase needs."""
    import warnings

    import numpy as np

    from crdt_tpu_torch import workload
    from crdt_tpu_torch.models import rseq, rseq_columnar as rc, rseq_engine as reng
    from crdt_tpu_torch.models import tomb_gc
    from crdt_tpu_torch.models.oplog_engine import EngineFallback
    from crdt_tpu_torch.ops import hopper_union as hu
    from crdt_tpu_torch.ops import joins
    from crdt_tpu_torch.parallel import swarm
    from crdt_tpu_torch.utils.tree import leaves, tree_map

    sw = workload.seq_swarm(pool, R, SEQ_C, SEED + 31, device="cuda")
    alive = torch.ones(R, dtype=torch.bool, device="cuda")
    alive[DEAD] = False
    peer_gen = torch.Generator(device="cuda").manual_seed(SEED + 32)
    rounds = [swarm.random_peers(peer_gen, R, device="cuda") for _ in range(3)]
    rng = np.random.default_rng(SEED + 33)
    lanes = sorted({0, R - 1, DEAD, *rng.choice(R, SEQ_SAMPLED, replace=False).tolist()})
    held, seen = sw.held.cpu().numpy(), sw.seen.cpu().numpy()
    alive_np = alive.cpu().numpy()
    torch.cuda.synchronize()

    for name in hu.LAUNCHES:
        hu.LAUNCHES[name] = 0
    with warnings.catch_warnings():
        warnings.simplefilter("error", EngineFallback)
        t0 = time.perf_counter()
        col, reason = rc.plan(sw.states)
        start = col
        for peers in rounds:
            col = rc.gossip_round(col, peers, alive)
        col, max_nu = rc.converge_checked(col, alive)
        conv = rc.unstack(col)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    launches = dict(hu.LAUNCHES)
    log(f"RSeq main path: plan -> 3 gossip rounds -> converge -> unstack at R={R} "
        f"C={SEQ_C} D={rseq.DEPTH}: {seconds:.3f} s host wall, launches {launches}; "
        f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.1f} GiB")

    if reason is not None or start is None:
        raise AssertionError(f"plan fell back: {reason}")
    levels = math.ceil(math.log2(R))
    expected = {"lexn_union": 3 + levels, "lexn_merge": 0, "lexn_compact": 0}
    if {k: launches[k] for k in expected} != expected:
        raise AssertionError(f"RSeq launches {launches}, expected {expected}: the wide "
                             "body's fused union at C=1024, no stripe")
    max_nu = int(max_nu)
    if max_nu > SEQ_C:
        raise AssertionError(f"max_n_unique {max_nu} > C={SEQ_C}")

    # the port's generic engine at full width
    g = swarm.make(sw.states, alive)
    for peers in rounds:
        g = swarm.gossip_round(g, peers, rseq.join)
    neutral = rseq.empty(SEQ_C, device="cuda")
    work = joins.pad_to_pow2(swarm.mask_dead_with_neutral(g.state, alive, neutral), neutral)
    g_nu = 0
    while leaves(work)[0].shape[0] > 1:
        p = leaves(work)[0].shape[0] // 2
        work, nu = rseq.join_checked(tree_map(lambda x: x[:p], work),
                                     tree_map(lambda x: x[p:2 * p], work))
        g_nu = max(g_nu, int(nu.max()))
    generic = swarm.broadcast_where_alive(g.state, alive, tree_map(lambda x: x[0], work))
    same("columnar engine vs generic engine", leaves(conv), leaves(generic))
    if g_nu != max_nu:
        raise AssertionError(f"max_n_unique {max_nu} != generic {g_nu}")
    del g, work, generic
    lub_tombs, lub_live = workload.seq_view(pool, held[alive_np], seen[alive_np])
    for lane in lanes:
        one = rseq.RSeq(conv.keys[lane], conv.elem[lane], conv.removed[lane])
        want = (workload.seq_view(pool, held[lane], seen[lane])[1] if lane == DEAD
                else lub_live)
        if rseq.to_list(one) != want:
            raise AssertionError(f"lane {lane}: to_list != the plain fold")
    log(f"RSeq slice checks: == generic engine on every plane of all {R} lanes, "
        f"{len(lanes)} sampled lanes == plain fold ({len(lub_live)} live of "
        f"{len(lub_tombs)} elements), max_n_unique={max_nu} <= C, dead lane unchanged, "
        f"launches == prediction ({expected})")

    # ---- 11. the GC barrier ----
    if not held[alive_np].any(axis=0).all():
        raise AssertionError("the alive LUB misses a pool element: the stable "
                             "frontier's precondition fails")
    gstate = tomb_gc.Gc(inner=conv, floor=torch.full((R, SEQ_W), -1, dtype=torch.int32,
                                                     device="cuda"))
    for name in hu.LAUNCHES:
        hu.LAUNCHES[name] = 0
    with warnings.catch_warnings():
        warnings.simplefilter("error", EngineFallback)
        t0 = time.perf_counter()
        gcd = tomb_gc.gc_round(swarm.make(gstate, alive), rseq.GC_ADAPTER, neutral).state
        torch.cuda.synchronize()
        gc_seconds = time.perf_counter() - t0
    gc_launches = dict(hu.LAUNCHES)
    gen = tomb_gc.gc_round(swarm.make(gstate, alive), rseq.GC_ADAPTER, neutral,
                           engine="generic").state
    same("gc_round columnar vs generic", leaves(gcd), leaves(gen))
    del gen
    floor = gcd.floor[0]
    if not bool((gcd.floor[alive] == floor).all()):
        raise AssertionError("alive lanes disagree on the floor")
    rid, seq = rseq.GC_ADAPTER.rid_seq(conv)
    covered = rseq.GC_ADAPTER.valid(conv) & (seq <= floor[rid.clamp(0, SEQ_W - 1).long()])
    dropped = (covered & conv.removed).sum(dim=1, dtype=torch.int32)
    if not torch.equal(torch.where(alive, rseq.n_rows(conv) - dropped, rseq.n_rows(conv)),
                       rseq.n_rows(gcd.inner)):
        raise AssertionError("the barrier did not collect exactly the removed rows under "
                             "the frontier")
    if not torch.equal(rseq.size(conv), rseq.size(gcd.inner)):
        raise AssertionError("the barrier changed a live count")
    for lane in lanes:
        if lane == DEAD:
            continue
        one = rseq.RSeq(gcd.inner.keys[lane], gcd.inner.elem[lane], gcd.inner.removed[lane])
        if rseq.to_list(one) != lub_live:
            raise AssertionError(f"lane {lane}: the barrier changed the live list")
    for x, y in zip(leaves(gstate), leaves(gcd)):
        if not torch.equal(x[DEAD], y[DEAD]):
            raise AssertionError("the barrier touched the dead lane")
    log(f"GC barrier: gc_round (columnar) == engine=\"generic\" at R={R}, floor "
        f"{floor.tolist()}, collected {int(dropped[0])} removed rows a lane, live lists "
        f"unchanged, {gc_seconds:.3f} s host wall, launches {gc_launches}")

    def lane_gc(i):
        return tree_map(lambda x: x[i:i + 1], gcd)

    peer = 0
    bits = reng.fit_joint_seq_bits(lane_gc(DEAD).inner, lane_gc(peer).inner)
    for name in hu.LAUNCHES:
        hu.LAUNCHES[name] = 0
    out, nu = reng.gc_merge_checked(reng.stack(lane_gc(DEAD), bits),
                                    reng.stack(lane_gc(peer), bits))
    revived = reng.unstack(out)
    pull_launches = dict(hu.LAUNCHES)
    same("revived replica vs the collected LUB", leaves(revived), leaves(lane_gc(peer)))
    rows = revived.inner.keys[0, :int(nu[0])].cpu().numpy()
    idents = {(int(r[-2]), int(r[-1])) for r in rows}
    if idents != {k for k, dead in lub_tombs.items() if not dead}:
        raise AssertionError("the revived replica's identities != the live identities "
                             "of the plain fold")
    if (pull_launches["lexn_gc_union"], pull_launches["lexn_union"],
            pull_launches["lexn_merge"], pull_launches["lexn_compact"]) != (1, 0, 0, 0):
        raise AssertionError(f"the GC pull launched {pull_launches}")
    log(f"revival: replica {DEAD} after one gc_merge_checked from replica {peer} == the "
        f"collected LUB ({int(nu[0])} rows, no collected row brought back), launches "
        f"{pull_launches}")
    gc_pair, gc_err = check_gc_join(gstate, gcd, int(dropped[0]))
    return {"start": start, "alive": alive, "rounds": rounds, "launches": launches,
            "gstate": gstate, "gc_launches": gc_launches, "gc_pair": gc_pair,
            "gc_err": gc_err}


STALE_SHARE = 0.01  # the seq-swarm-10k.gc cell's share of stale replicas


def gc_join_composition(a, b):
    """The GC join's composition on the card: the lossless union at 2C
    (kernel 1 with the side marker), then the floor rule and compaction in
    plain torch: (ColumnarGc, n_unique, dropped)."""
    from crdt_tpu_torch.models import rseq_engine as reng

    merged, n_unique, drop = reng._gc_suppress(a, b, *reng._gc_union(a, b))
    return merged, n_unique, drop.sum(dim=0, dtype=torch.int32)


def gc_join_planes(join) -> list:
    merged, n_unique, dropped = join
    return [*merged.col.keys, merged.col.elem, merged.col.removed, merged.floor, n_unique,
            dropped]


def check_gc_join(gstate, gcd, collected: int) -> tuple:
    """Phase 11's GC join at the seq-swarm-10k.gc cell's shape (R=10,240,
    C=1,024, depth 6, W=16) with real floors on both sides: the barrier's
    collected swarm, a seeded 1% of its replicas stale (the converged
    table from before the barrier and floor -1, so they still hold the
    removed rows the others collected), each replica joined with a seeded
    peer.  A stale replica pulling from a fresh one drops its own collected
    rows (B's floor covers A's rows); a fresh one pulling from a stale one
    drops the peer's (A's floor covers B's).  The fused join (one
    lexn_gc_union launch) == the composition on every plane, n_unique,
    dropped and the floor, and each of those pairs drops exactly the rows
    the barrier collected.  Returns ((puller, peer) staged, max |err|)."""
    from crdt_tpu_torch.models import rseq_engine as reng
    from crdt_tpu_torch.ops import hopper_union as hu
    from crdt_tpu_torch.utils.tree import tree_map

    gen = torch.Generator().manual_seed(SEED + 34)
    stale = (torch.rand(R, generator=gen) < STALE_SHARE).cuda()
    stale[DEAD] = False  # the dead lane is gstate's in both
    peers = torch.randperm(R, generator=gen).cuda()
    mixed = tree_map(lambda x, y: torch.where(stale.view(-1, *[1] * (x.dim() - 1)), x, y),
                     gstate, gcd)
    cg = reng.stack(mixed, reng.fit_joint_seq_bits(mixed.inner))
    peer = tree_map(lambda x: x[..., peers], cg)
    if not reng._fused(cg):
        raise AssertionError("the GC join at the cell's shape does not take the fused route")
    torch.cuda.synchronize()
    for name in hu.LAUNCHES:
        hu.LAUNCHES[name] = 0
    got = reng._gc_join(cg, peer)
    launched = {k: v for k, v in hu.LAUNCHES.items() if v}
    if launched != {"lexn_gc_union": 1}:
        raise AssertionError(f"the fused GC join launched {launched}, expected one "
                             "lexn_gc_union")
    err = same("GC join at the cell's shape: fused vs the composition",
               gc_join_planes(got), gc_join_planes(gc_join_composition(cg, peer)))
    dropped = got[2]
    fresh = ~stale
    fresh[DEAD] = False
    for side, lanes in (("A's (B's floor)", stale & fresh[peers]),
                        ("B's (A's floor)", fresh & stale[peers])):
        if not lanes.any() or not bool((dropped[lanes] == collected).all()):
            raise AssertionError(f"the floor rule on {side} rows: dropped "
                                 f"{dropped[lanes].unique().tolist()} on {int(lanes.sum())} "
                                 f"lanes, expected the {collected} rows the barrier collected")
    log(f"GC join at the cell's shape (R={R}, C={SEQ_C}, W={SEQ_W}, {int(stale.sum())} stale "
        f"replicas): fused == composition on every plane, n_unique, dropped and the floor; "
        f"{int((stale & fresh[peers]).sum())} stale pullers drop their own and "
        f"{int((fresh & stale[peers]).sum())} fresh pullers drop the peer's {collected} "
        f"collected rows ({int(dropped.sum())} in all), launches {launched}")
    return (cg, peer), err


def rseq_times(pool, ctx, err, card) -> list:
    """Phase 12: the RSeq calls' times, each kernel's with its twin and
    bound, and one profiled gossip round and converge.  Returns the table
    rows of lexn_merge, lexn_compact and lexn_union at (18, 2), and of
    lexn_gc_union."""
    from crdt_tpu_torch.models import rseq_columnar as rc, rseq_engine as reng
    from crdt_tpu_torch.ops import hopper_union as hu

    col, alive, rounds = ctx["start"], ctx["alive"], ctx["rounds"]
    gossip_ms = time_ms(lambda: rc.gossip_round(col, rounds[0], alive), reps=5)
    converge_ms = time_ms(lambda: rc.converge_checked(col, alive), reps=3, warmup=1)
    cg = reng.stack(ctx["gstate"])
    gc_ms = time_ms(lambda: reng.gc_converge_checked(cg, alive), reps=3, warmup=1)
    del cg
    log(f"RSeq gossip_round (R={R}, C={SEQ_C}, D=6): {gossip_ms:.4f} ms")
    log(f"RSeq converge_checked (R={R}): {converge_ms:.4f} ms")
    log(f"RSeq gc_converge_checked (R={R}, W={SEQ_W}): {gc_ms:.4f} ms")

    a, b = seq_columnar(pool, R, SEQ_C, SEED + 41), seq_columnar(pool, R, SEQ_C, SEED + 42)
    log_c = math.ceil(math.log2(SEQ_C))
    rows = []
    sides = lexn_sides(a, b, False)
    n_planes, out = N_KEYS_SEQ + len(sides[1]), SEQ_C
    merge_ms = time_ms(lambda: hu.lexn_merge_columnar(*sides), reps=10)
    merge_plain = time_ms(lambda: hu._lexn_merge_plain(*sides), reps=3, warmup=1)
    mk, mv = hu.lexn_merge_columnar(*sides)
    compact_ms = time_ms(lambda: hu.lexn_compact_columnar(mk, mv, out), reps=10)
    compact_plain = time_ms(lambda: hu._lexn_compact_plain(mk, mv, out), reps=3, warmup=1)
    del mk, mv
    # bytes: every input plane read once, every output plane written once;
    # operations: one key-word compare for each binary-search step of the
    # 2C merged rows (further words are compared only on ties), one for
    # each row's duplicate test
    rows.append(kernel_row(
        "lexn_merge", "crdt_tpu_torch/csrc/lexn_union.cu", "crdt_tpu/ops/pallas_union.py:492",
        ctx["launches"]["lexn_merge"], err["lexn_merge"], merge_ms, merge_plain,
        4 * (2 * n_planes * SEQ_C * R + n_planes * 2 * SEQ_C * R), 2 * SEQ_C * R * log_c,
        None, card))
    rows.append(kernel_row(
        "lexn_compact", "crdt_tpu_torch/csrc/lexn_union.cu", "crdt_tpu/ops/pallas_union.py:557",
        ctx["launches"]["lexn_compact"], err["lexn_compact"], compact_ms, compact_plain,
        4 * (n_planes * 2 * SEQ_C * R + n_planes * out * R + R), 2 * SEQ_C * R, None, card))
    log("lexn_merge / lexn_compact / lexn_union at 18 key words, library yardstick: none "
        "— torch.sort takes one key tensor, and 18 int32 words do not pack into one int64 "
        "(kernel 1's (2, 2) yardstick packs its 2); the plain twin's "
        "sorted_union._sort_by_keys is 18 stable sorts, not one call; and no call "
        "punches duplicates and compacts a batch of lanes")
    # the wide body at the main path's C=1024 (the row: (18, 2), out=C, as
    # gossip and converge call it) and at C=512 on phase 9's draws;
    # bytes: inputs read once, outputs and n_unique written once;
    # operations: a key-word compare a binary-search step of the 2C rows
    draws = {SEQ_C: (a, b), SEQ_C // 2: (seq_columnar(pool, R, SEQ_C // 2, SEED + 43),
                                         seq_columnar(pool, R, SEQ_C // 2, SEED + 44))}
    for c, (da, db) in draws.items():
        sides = lexn_sides(da, db, False)
        n_planes = N_KEYS_SEQ + len(sides[1])
        ms = time_ms(lambda: hu.sorted_union_columnar_fused_lexn(*sides, out_size=c), reps=10)
        dev_ms = device_time_ms(lambda: hu.sorted_union_columnar_fused_lexn(*sides, out_size=c))
        plain_ms = time_ms(lambda: hu._lexn_union_plain(*sides, c), reps=3, warmup=1)
        n_bytes = 4 * (2 * n_planes * c * R + n_planes * c * R + R)
        n_ops = 2 * c * R * math.ceil(math.log2(c))
        bound_ms, by = bound(n_bytes, n_ops)
        body = hu.lexn_union_body(N_KEYS_SEQ, len(sides[1]), c, c,
                                  hu.smem_limit(torch.device("cuda")))
        share = (f"share {bound_ms / dev_ms:.3f} of the device time" if dev_ms
                 else "device time not measured")
        log(f"lexn_union [(18, {len(sides[1])}), C={c}, out=C, wide body "
            f"{hu.wide_threads(body)} threads a CTA]: {ms:.4f} ms/launch (device "
            f"{dev_ms:.4f}), plain twin {plain_ms:.4f} ms, bound {bound_ms:.4f} ms by {by} "
            f"({share}) [{card}]")
        if c == SEQ_C:
            rows.append(kernel_row(
                "lexn_union_rseq", "crdt_tpu_torch/csrc/lexn_union.cu",
                "crdt_tpu/ops/pallas_union.py:353", ctx["launches"]["lexn_union"],
                err["lexn_union_rseq"], ms, plain_ms, n_bytes, n_ops, None, card))
    log(f"lexn_union_rseq: the wide body's fused union at (18, 2), C={SEQ_C}, out=C, on "
        f"the RSeq main path ({ctx['launches']['lexn_union']} launches); library: none "
        "(as above)")
    del a, b, draws, sides
    rows.append(gc_union_row(ctx, card))
    profile("RSeq gossip_round", lambda: rc.gossip_round(col, rounds[0], alive))
    profile("RSeq converge_checked", lambda: rc.converge_checked(col, alive))
    return rows


def gc_union_row(ctx, card) -> dict:
    """Kernel 1's GC instance (lexn_gc_union) at the seq-swarm-10k.gc
    cell's shape on phase 11's pair with real floors: its time (CUDA
    events and profiler device time), its plain twin's (the lossless union
    twin at 2C with the side marker, then the floor rule and compaction)
    and its bound.  Bytes: both sides' 20 planes read once, C rows of the
    20 written once, n_unique, dropped and both floor planes; operations: a
    key-word compare a binary-search step of the 2C rows."""
    from crdt_tpu_torch.models import rseq_engine as reng
    from crdt_tpu_torch.ops import hopper_union as hu

    a, b = ctx["gc_pair"]

    def call():
        return hu.gc_union_columnar_lexn(
            a.col.keys, (a.col.elem, a.col.removed), a.floor,
            b.col.keys, (b.col.elem, b.col.removed), b.floor, a.col.seq_bits)

    def plain():
        sides = [(tuple(x.col.keys), (x.col.elem, x.col.removed,
                                      (x.col.keys[0] != SENTINEL).to(torch.int32) * k))
                 for x, k in ((a, 1), (b, 2))]
        keys, vals, _ = hu._lexn_union_plain(*sides[0], *sides[1], 2 * SEQ_C)
        return reng._gc_suppress(a, b, keys, vals)

    ms = time_ms(call, reps=10)
    dev_ms = device_time_ms(call)
    plain_ms = time_ms(plain, reps=3, warmup=1)
    n_planes = N_KEYS_SEQ + 2
    n_bytes = 4 * (2 * n_planes * SEQ_C * R + n_planes * SEQ_C * R + 2 * R + 2 * SEQ_W * R)
    n_ops = 2 * SEQ_C * R * math.ceil(math.log2(SEQ_C))
    bound_ms, by = bound(n_bytes, n_ops)
    share = (f"share {bound_ms / dev_ms:.3f} of the device time" if dev_ms
             else "device time not measured")
    log(f"lexn_gc_union [(18, 2), C={SEQ_C}, out=C, W={SEQ_W}, the floor rule in the wide "
        f"body's flag pass]: {ms:.4f} ms/launch (device {dev_ms:.4f}), plain twin "
        f"{plain_ms:.4f} ms, bound {bound_ms:.4f} ms by {by} ({share}); "
        f"{ctx['gc_launches']['lexn_gc_union']} launches in the GC barrier; library: none "
        f"(as above) [{card}]")
    return kernel_row("lexn_gc_union", "crdt_tpu_torch/csrc/lexn_union.cu",
                      "crdt_tpu/models/tomb_gc.py (join_checked's union and floor rule)",
                      ctx["gc_launches"]["lexn_gc_union"], ctx["gc_err"], ms, plain_ms,
                      n_bytes, n_ops, None, card)


def rseq_phases(card: str) -> list:
    """Phases 9-12: the RSeq swarm path.  Returns the table rows of
    lexn_merge, lexn_compact and lexn_union at (18, 2), and of lexn_union's
    GC instance lexn_gc_union."""
    from crdt_tpu_torch import workload

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    pool = workload.seq_pool(SEED)
    log(f"RSeq pool: {len(pool)} elements, {int(pool.removable.sum())} removable, "
        f"depth histogram {pool.depth_histogram()}")
    err = check_rseq_kernels(pool)
    torch.cuda.empty_cache()
    ctx = run_rseq_slice(pool)
    torch.cuda.empty_cache()
    rows = rseq_times(pool, ctx, err, card)
    log(f"RSeq phases: peak device memory {torch.cuda.max_memory_allocated() / 2**30:.1f} GiB "
        "(kernel checks, main path, generic engine and GC barrier at full width)")
    return rows


# ---- the OR-Set union floors (kernels 7 and 8) ----
#
# benches/orset_floor.py's shape and draw: C=1024, L=131,072, each column
# sorted uniform [0, 2^30) with the first C/2 rows real and the rest
# SENTINEL, vals = the draw & 1, and the dispatcher's max(2, C//16) = 64
# buckets.

FLOOR_C, FLOOR_L = 1024, 131_072
FLOOR_BUCKETS = max(2, FLOOR_C // 16)


def floor_draw(c: int, lanes: int, seed: int) -> list:
    """(keys_a, vals_a, keys_b, vals_b) on the card: the bits from numpy,
    each column sorted on the card."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(2):
        kk = torch.from_numpy(rng.integers(0, 1 << 30, (c, lanes), dtype=np.int32)).cuda()
        kk = torch.sort(kk, dim=0).values
        real = torch.arange(c, device="cuda")[:, None] < c // 2
        out += [torch.where(real, kk, SENTINEL).contiguous(), kk & 1]
    return out


def full_range_draw(c: int, lanes: int, seed: int) -> list:
    """Full-range int32 keys with a fifth of the rows SENTINEL and values
    past 2^15, on the card: the sums wrap and ``<< 16`` drops bits."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(2):
        keys = rng.integers(-2**31, 2**31, (c, lanes), dtype=np.int32)
        keys[rng.random((c, lanes)) < 0.2] = SENTINEL
        out += [torch.from_numpy(keys).cuda(),
                torch.from_numpy(rng.integers(-2**31, 2**31, (c, lanes), dtype=np.int32)).cuda()]
    return out


def floor_work(c: int, lanes: int, seg: int, out_rows: int) -> tuple:
    """(bytes, int32 operations) of one floor: 4 planes read, 2 planes of
    ``out_rows`` rows and nu written; per lane of n = 2C rows, 2 planes x
    log2(2·seg) butterfly stages x n, 3 punch passes, the mask and prefix,
    disp's shift and OR, the two suffix scans (9 n), one shift a kept row."""
    n = 2 * c
    stages = (2 * seg).bit_length() - 1
    return (4 * (4 * c * lanes + 2 * out_rows * lanes + lanes),
            lanes * (2 * stages * n + 9 * n + out_rows))


def floor_twin(name: str, planes, arg: int):
    """The plain twin of floor ``name`` (``arg``: out_size, or n_buckets),
    B reversed per segment as the entry point reverses it."""
    from crdt_tpu_torch.ops import orset_floor as of

    c = planes[0].shape[0]
    seg = c if name == "floor_union" else c // arg
    return of._floor_plain(*planes[:2], of._flip_buckets(planes[2], c // seg),
                           of._flip_buckets(planes[3], c // seg), seg,
                           arg if name == "floor_union" else seg)


def floor_check(name, planes, arg, label, err) -> None:
    """Kernel and twin on the same planes, bit-equal on every output."""
    from crdt_tpu_torch.ops import orset_floor as of

    fn = of.floor_union if name == "floor_union" else of.bucketed_floor_union
    err[name] = max(err[name], same(f"{name} {label}", fn(*planes, arg),
                                    floor_twin(name, planes, arg)))


def check_floor_edges(err) -> None:
    """Phase 13's edges, kernel against twin on full-range int32 with
    values past 2^15: lane counts that split a tile of 8 lanes or a walk of
    256 (1, 7, 9, 127, 130, 4097), out_size 0, odd, C and 2C, C = 8 (one
    thread a lane) and 8,192 (one lane a tile), B = 1, 2, 64 and C (the walk
    at Wb <= 16, the tile body above), planes off 16 B alignment, and the
    refusal past the envelope."""
    from crdt_tpu_torch.ops import hopper_union as hu
    from crdt_tpu_torch.ops import orset_floor as of

    for n in (1, 7, 9, 127, 130, 4097):
        planes = full_range_draw(1024, n, SEED + 65 + n)
        floor_check("floor_union", planes, 1024, f"edge L={n}", err)
        floor_check("bucketed_floor_union", planes, 64, f"edge L={n}", err)
    planes = full_range_draw(1024, 130, SEED + 66)
    for out in (0, 1023, 2048):
        floor_check("floor_union", planes, out, f"edge out={out}", err)
    for b in (1, 2, 64, 1024):
        floor_check("bucketed_floor_union", planes, b, f"edge B={b}", err)
    shifted = off_alignment(planes)
    floor_check("floor_union", shifted, 1024, "planes off 16 B", err)
    for b in (2, 64):
        floor_check("bucketed_floor_union", shifted, b, f"planes off 16 B, B={b}", err)
    for c, n, outs, buckets in ((8, 4097, (16, 5), (1, 8)), (8192, 9, (8192, 3), (1, 2, 512))):
        planes = full_range_draw(c, n, SEED + 67 + c)
        for out in outs:
            floor_check("floor_union", planes, out, f"edge C={c} out={out}", err)
        for b in buckets:
            floor_check("bucketed_floor_union", planes, b, f"edge C={c} B={b}", err)
    del planes, shifted
    before = dict(hu.LAUNCHES)
    try:
        of.floor_union(*[torch.zeros((16_384, 1), dtype=torch.int32, device="cuda")] * 4,
                       16_384)
    except RuntimeError as e:
        log(f"floor_union at C=16,384 refused: {e}")
    else:
        raise AssertionError("floor_union past its envelope (C=16,384) launched")
    if hu.LAUNCHES != before:
        raise AssertionError("a refused floor counted a launch")
    log(f"floor edges vs twins: bit-exact at L=1/7/9/127/130/4097, out=0/1023/2C, "
        f"B=1/2/64/C, C=8 and 8192, planes off 16 B; max |err| {err}")


def device_time_ms(fn, reps: int = 10) -> float:
    """The mean device time of one call's kernels, from torch.profiler over
    ``reps`` calls (the CUDA events also count the host's launch gap)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as torch_profile

    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    averages = prof.key_averages()
    host_keys = {e.key for e in averages if e.device_type == DeviceType.CPU}
    return sum(e.self_device_time_total for e in averages
               if e.device_type == DeviceType.CUDA and e.key not in host_keys) / reps / 1e3


def queued_ms(fn, n: int = 20) -> float:
    """The device time of one call of ``fn`` without the profiler or the
    host's launch gaps: ``n`` calls queued behind a sleeping kernel run
    back to back on the card, timed by CUDA events around them."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(50_000_000)  # ~25 ms at the H100's clock: longer than n host calls
    start.record()
    for _ in range(n):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


def floor_full_width(planes, set_union_ms: float, card: str) -> dict:
    """Phase 13 at full width, inside phase 7: floor_union on the stacked
    OR-Set planes at L=2^20 beside that phase's set_union, == its twin on
    the first and last 65,536 lanes."""
    from crdt_tpu_torch.ops import orset_floor as of

    ms = time_ms(lambda: of.floor_union(*planes, SET_C), reps=5)
    got = of.floor_union(*planes, SET_C)
    err = {"floor_union": 0}
    for sl in (slice(0, SLICE), slice(SET_R - SLICE, SET_R)):
        want = floor_twin("floor_union", [x[:, sl].contiguous() for x in planes], SET_C)
        err["floor_union"] = max(err["floor_union"], same(
            f"floor_union lanes {sl.start}-{sl.stop}", [x[:, sl] for x in got], want))
    del got
    n_bytes, _ = floor_work(SET_C, SET_R, SET_C, SET_C)
    log(f"floor_union at R={SET_R} on the OR-Set planes: {ms:.4f} ms beside set_union's "
        f"{set_union_ms:.4f} ms (headroom {100 * (set_union_ms - ms) / set_union_ms:.1f}%), "
        f"bytes bound {bound(n_bytes, 0)[0]:.4f} ms; == twin on lanes 0-{SLICE} and the "
        f"last {SLICE} [{card}]")
    return {"ms": ms, "set_union_ms": set_union_ms, "err": err["floor_union"]}


def floor_phases(full: dict, card: str) -> list:
    """Phase 13: the floors' path at orset_floor.py's shape (one launch of
    each through its entry point), the kernels against their twins, then
    the floor/fused times.  Returns the table rows of the two floors."""
    from crdt_tpu_torch.ops import hopper_union as hu
    from crdt_tpu_torch.ops import orset_floor as of

    torch.cuda.empty_cache()
    c, lanes, nb = FLOOR_C, FLOOR_L, FLOOR_BUCKETS
    wb = c // nb
    draw = floor_draw(c, lanes, SEED + 61)
    torch.cuda.synchronize()
    for name in hu.LAUNCHES:
        hu.LAUNCHES[name] = 0
    floor = of.floor_union(*draw, c)
    bucketed = of.bucketed_floor_union(*draw, nb)
    torch.cuda.synchronize()
    launches = dict(hu.LAUNCHES)
    log(f"floor path at C={c} L={lanes} B={nb}: floor_union + bucketed_floor_union, "
        f"launches {launches}")
    if launches["floor_union"] != 1 or launches["bucketed_floor_union"] != 1:
        raise AssertionError(f"the floors launched {launches}, expected one each")
    err = {"floor_union": max(full["err"], same(
               "floor_union OR-Set floor draw", floor, floor_twin("floor_union", draw, c))),
           "bucketed_floor_union": same(
               "bucketed_floor_union OR-Set floor draw", bucketed,
               floor_twin("bucketed_floor_union", draw, nb))}
    del floor, bucketed

    floor_check("floor_union", draw, c // 2, "out=C/2", err)
    for b in (2, 128):
        floor_check("bucketed_floor_union", draw, b, f"B={b}", err)
    wide = full_range_draw(c, 10_000, SEED + 62)
    floor_check("floor_union", wide, c, "full-range int32, L=10,000", err)
    floor_check("bucketed_floor_union", wide, nb, "full-range int32, L=10,000", err)
    for cc, n in ((64, lanes), (2048, 16_384)):
        other = full_range_draw(cc, n, SEED + 63)
        floor_check("floor_union", other, cc, f"C={cc} L={n}", err)
        floor_check("bucketed_floor_union", other, max(2, cc // 16), f"C={cc} L={n}", err)
    for n in (1, 1000):
        ragged = floor_draw(c, n, SEED + 64)
        floor_check("floor_union", ragged, c, f"ragged L={n}", err)
        floor_check("bucketed_floor_union", ragged, nb, f"ragged L={n}", err)
    del wide, other, ragged
    log(f"floors vs twins: bit-exact on the OR-Set floor draw (out=C and C/2, B={nb}, 2 "
        f"and 128), full-range int32, C=64 and 2048, ragged L=1/1000; max |err| {err}")
    check_floor_edges(err)
    from crdt_tpu_torch import _build
    func = ""
    for line in _build.build_log("set_floor").splitlines():
        if "Function properties for" in line:
            func = line.split("Function properties for", 1)[1].strip()
        elif "registers" in line or "spill" in line:
            log(f"  ptxas [set_floor] {func}: {line.strip()}")
    tile_plan = of.floor_tile_plan(c)
    walk_plan = of.bucketed_floor_plan(c, nb, hu.smem_limit(torch.device("cuda")))
    log(f"floor plans at C={c}: floor_union tile body {tile_plan} (lanes a tile, rows a "
        f"thread, B); bucketed_floor_union at B={nb} {walk_plan}")

    floor_ms = time_ms(lambda: of.floor_union(*draw, c), reps=20)
    fused_ms = time_ms(lambda: hu.sorted_union_columnar_fused(*draw, out_size=c), reps=20)
    bfloor_ms = time_ms(lambda: of.bucketed_floor_union(*draw, nb), reps=20)
    bfused_ms = time_ms(lambda: hu.bucketed_union_columnar(*draw, nb, out_bucket_rows=wb),
                        reps=20)
    floor_dev = device_time_ms(lambda: of.floor_union(*draw, c))
    bfloor_dev = device_time_ms(lambda: of.bucketed_floor_union(*draw, nb))
    floor_plain = time_ms(lambda: floor_twin("floor_union", draw, c), reps=3, warmup=1)
    bfloor_plain = time_ms(lambda: floor_twin("bucketed_floor_union", draw, nb), reps=3,
                           warmup=1)
    work = floor_work(c, lanes, c, c)
    bwork = floor_work(c, lanes, wb, c)
    # the library yardsticks of kernels 2 and 3 on the floors' draw: a
    # torch.sort of the 2C keys a lane, and one segmented torch.sort of the
    # (L·B, 2·Wb) bucket rows
    both = torch.cat([draw[0], draw[2]], dim=0)
    library_ms = time_ms(lambda: torch.sort(both, dim=0), reps=10)
    seg_keys = torch.cat([x.reshape(nb, wb, lanes).permute(2, 0, 1).reshape(-1, wb)
                          for x in (draw[0], draw[2])], dim=1)
    blibrary_ms = time_ms(lambda: torch.sort(seg_keys, dim=1), reps=10)
    del both, seg_keys
    log(json.dumps({
        "capacity": c, "lanes": lanes, "n_buckets": nb,
        "floor_ms": floor_ms, "floor_device_ms": floor_dev, "fused_ms": fused_ms,
        "headroom_pct": 100 * (fused_ms - floor_ms) / fused_ms,
        "bucketed_floor_ms": bfloor_ms, "bucketed_floor_device_ms": bfloor_dev,
        "bucketed_fused_ms": bfused_ms,
        "bucketed_headroom_pct": 100 * (bfused_ms - bfloor_ms) / bfused_ms,
        "floor_vs_floor": floor_ms / bfloor_ms,
        "floor_bytes_bound_ms": bound(work[0], 0)[0],
        "bucketed_floor_bytes_bound_ms": bound(bwork[0], 0)[0],
        "fused_bytes_bound_ms": bound(4 * (6 * c * lanes + lanes), 0)[0],
        "bucketed_fused_bytes_bound_ms": bound(4 * (6 * c * lanes + 2 * lanes), 0)[0],
        "card": card,
    }))
    rows = []
    for name, replaces, ms, plain_ms, (n_bytes, n_ops), lib_ms in (
            ("floor_union", "benches/orset_floor.py:37", floor_ms, floor_plain, work,
             library_ms),
            ("bucketed_floor_union", "benches/orset_floor.py:86", bfloor_ms, bfloor_plain,
             bwork, blibrary_ms)):
        rows.append(kernel_row(name, "crdt_tpu_torch/csrc/set_floor.cu", replaces,
                               launches[name], err[name], ms, plain_ms, n_bytes, n_ops,
                               lib_ms, card))
    log(f"floor library yardsticks (kernels 2's and 3's): torch.sort of the 2C keys a lane "
        f"{library_ms:.4f} ms, the segmented sort of the (L·B, 2·Wb) = ({lanes * nb}, "
        f"{2 * wb}) bucket rows {blibrary_ms:.4f} ms [{card}]")
    del draw
    torch.cuda.empty_cache()
    return rows


# ---- the counter and register family (BASELINE.json configs 0-2) ----

GC_R, GC_NODES, GC_BANK = 1 << 20, 8, 16      # bench.py
PN_NODES, PN_BANK = 64, 4                      # bench_baseline.py
LWW_SMALL, LWW_BIG, LWW_BANK = 100_352, 1 << 25, 4
LWW_RID_BITS = 7                               # rids span [0, 64)
REG_R, REG_W, REG_OPS, REG_SLICE = 1 << 20, 8, 16, 65_536
JOIN_SAMPLES = 128


def quantile(xs, q: float) -> float:
    """Nearest-rank quantile of the samples."""
    xs = sorted(xs)
    return xs[min(len(xs) - 1, max(0, round(q * (len(xs) - 1))))]


def per_call_ms(step, n: int, warmup: int = 8) -> list:
    """``n`` calls of ``step(i)`` queued back to back with a CUDA event
    between each two: the device time of every call."""
    for i in range(warmup):
        step(i)
    events = [torch.cuda.Event(enable_timing=True) for _ in range(n + 1)]
    events[0].record()
    for i in range(n):
        step(i)
        events[i + 1].record()
    torch.cuda.synchronize()
    return [events[i].elapsed_time(events[i + 1]) for i in range(n)]


def report_rate(label: str, replicas: int, times: list, state_bytes: int, card: str,
                note: str = "") -> None:
    """Replica-merges/s and p50/p99 over the per-join samples, beside the
    bytes bound of a join (read the state and the peer, write the state)."""
    p50, p99 = quantile(times, 0.5), quantile(times, 0.99)
    bound_ms = 3 * state_bytes / HBM_BYTES_PER_S * 1e3
    log(f"{label}: {replicas / (p50 / 1e3):.4e} replica-merges/s (median of {len(times)} "
        f"joins), p50 {p50 * 1e3:.2f} us, p99 {p99 * 1e3:.2f} us; bound "
        f"{3 * state_bytes / 1e9:.4f} GB a join, {bound_ms * 1e3:.2f} us, "
        f"{replicas / (bound_ms / 1e3):.4e} merges/s{note} [{card}]")


def check_chain(label, join, state_np, bank_np, fold, from_numpy, value, k: int) -> None:
    """k chained joins with the bank's peers in turn, on the card and in the
    port's CPU run, against a numpy fold of the same sequence: every plane
    and the value bit-equal."""
    from crdt_tpu_torch.utils.tree import leaves

    def chain(device):
        x = from_numpy(state_np, device=device)
        peers = [from_numpy({f: v[i] for f, v in bank_np.items()}, device=device)
                 for i in range(min(k, len(next(iter(bank_np.values())))))]
        for i in range(k):
            x = join(x, peers[i % len(peers)])
        return x

    card_state, cpu_state = chain("cuda"), chain("cpu")
    want = dict(state_np)
    n_bank = len(next(iter(bank_np.values())))
    for i in range(k):
        want = fold(want, {f: v[i % n_bank] for f, v in bank_np.items()})
    want_state = from_numpy(want, device="cpu")
    got = [x.cpu() for x in leaves(card_state)]
    same(f"{label} card vs numpy fold", got, leaves(want_state))
    same(f"{label} card vs the port on the CPU", got, leaves(cpu_state))
    same(f"{label} value", [value(card_state).cpu()], [value(want_state)])


def np_max_fold(a: dict, b: dict) -> dict:
    return {f: np.maximum(a[f], b[f]) for f in a}


def np_lww_fold(a: dict, b: dict) -> dict:
    newer = (b["ts"] > a["ts"]) | ((b["ts"] == a["ts"]) & (b["rid"] > a["rid"]))
    return {f: np.where(newer, b[f], a[f]) for f in a}


def counter_phases(card: str) -> None:
    """Phase 14: the counters and registers at BASELINE's sizes — chained
    joins against a bank of peers, checked against a numpy fold and the
    port's CPU run, then merges/s and p50/p99 beside the bytes bound."""
    from crdt_tpu_torch import convert, workload
    from crdt_tpu_torch.models import gcounter, lww, pncounter
    from crdt_tpu_torch.utils.tree import leaves

    torch.cuda.empty_cache()
    # -- G-Counter: 1M replicas x 8 nodes against 16 distinct peers (bench.py) --
    a = {"counts": workload.counter_bank(SEED + 71, (GC_R, GC_NODES))}
    bank = {"counts": workload.counter_bank(SEED + 72, (GC_BANK, GC_R, GC_NODES))}
    check_chain("G-Counter chain", gcounter.join, a, bank, np_max_fold,
                convert.gcounter_from_numpy, gcounter.value, GC_BANK)
    x = convert.gcounter_from_numpy(a, device="cuda")
    peers = [gcounter.GCounter(counts=c) for c in torch.from_numpy(bank["counts"]).cuda()]

    def gc_step(i):
        nonlocal x
        x = gcounter.join(x, peers[i % GC_BANK])

    times = per_call_ms(gc_step, JOIN_SAMPLES)
    report_rate(f"G-Counter join R={GC_R} x {GC_NODES} nodes, {GC_BANK} peers", GC_R, times,
                GC_R * GC_NODES * 4, card,
                " (the 33.5 MB state fits the 50 MB L2: a rate past the bound means the "
                "running state stayed in L2; every peer streams from HBM)")
    del x, peers, bank

    # -- G-Counter pair: increment + join of two 8-slot counters (config 0) --
    pa = convert.gcounter_from_numpy({"counts": workload.counter_bank(SEED + 73, (GC_NODES,))},
                                     device="cuda")
    pb = convert.gcounter_from_numpy({"counts": workload.counter_bank(SEED + 74, (GC_NODES,))},
                                     device="cuda")
    start = pa

    def pair_step(i):
        nonlocal pa
        pa = gcounter.join(gcounter.increment(pa, i % GC_NODES, 1), pb)

    n = JOIN_SAMPLES * 2
    times = per_call_ms(pair_step, n, warmup=0)
    want, peer = start.counts.cpu().numpy(), pb.counts.cpu().numpy()
    for i in range(n):
        want[i % GC_NODES] += 1
        want = np.maximum(want, peer)
    if not np.array_equal(pa.counts.cpu().numpy(), want):
        raise AssertionError("G-Counter pair: increments + joins != the numpy count")
    log(f"G-Counter pair (8 slots, increment + join, {n} samples): p50 "
        f"{quantile(times, 0.5) * 1e3:.2f} us, p99 {quantile(times, 0.99) * 1e3:.2f} us a "
        f"step, == numpy; launch-bound: 64 B of state [{card}]")

    # -- PN-Counter: 1,024 and 2^20 replicas x 64 nodes, 4 peers (bench_baseline.py) --
    for r in (1024, GC_R):
        st = {"pos": workload.counter_bank(SEED + 75, (r, PN_NODES)),
              "neg": workload.counter_bank(SEED + 76, (r, PN_NODES))}
        bk = {"pos": workload.counter_bank(SEED + 77, (PN_BANK, r, PN_NODES)),
              "neg": workload.counter_bank(SEED + 78, (PN_BANK, r, PN_NODES))}
        check_chain(f"PN-Counter chain R={r}", pncounter.join, st, bk, np_max_fold,
                    convert.pncounter_from_numpy, pncounter.value, PN_BANK)
        x = convert.pncounter_from_numpy(st, device="cuda")
        bpos, bneg = (torch.from_numpy(bk[f]).cuda() for f in ("pos", "neg"))

        def pn_step(i):
            nonlocal x
            x = pncounter.join(x, pncounter.PNCounter(pos=bpos[i % PN_BANK],
                                                      neg=bneg[i % PN_BANK]))

        times = per_call_ms(pn_step, JOIN_SAMPLES)
        report_rate(f"PN-Counter join R={r} x {PN_NODES} nodes, {PN_BANK} peers", r, times,
                    2 * r * PN_NODES * 4, card)
        del x, bpos, bneg, st, bk

    # -- LWW: 100,352 registers and 2^25 as (262,144, 128) planes, 4 peers --
    for shape in ((LWW_SMALL,), (LWW_BIG // 128, 128)):
        r = math.prod(shape)
        st = workload.lww_bank(SEED + 79, shape)
        bk = workload.lww_bank(SEED + 80, (LWW_BANK, *shape))
        check_chain(f"LWW chain R={r}", lww.join, st, bk, np_lww_fold,
                    convert.lww_from_numpy, lww.value, LWW_BANK)
        x = convert.lww_from_numpy(st, device="cuda")
        peers = {f: torch.from_numpy(v).cuda() for f, v in bk.items()}

        def lww_step(i):
            nonlocal x
            x = lww.join(x, lww.LWWRegister(**{f: v[i % LWW_BANK] for f, v in peers.items()}))

        times = per_call_ms(lww_step, JOIN_SAMPLES)
        report_rate(f"LWW join R={r} {shape}, {LWW_BANK} peers", r, times, 3 * r * 4, card)
        if r == LWW_BIG:
            a = convert.lww_from_numpy(st, device="cuda")
            b = lww.LWWRegister(**{f: v[0] for f, v in peers.items()})
            ok = [bool(lww.pack_budget_ok(s_, LWW_RID_BITS)) for s_ in (a, b)]
            if not all(ok):
                raise AssertionError("the LWW draw does not fit the pack budget")
            packed = lww.join_packed(lww.pack(a, LWW_RID_BITS), lww.pack(b, LWW_RID_BITS))
            same("LWW unpack(join_packed) vs join", leaves(lww.unpack(packed)),
                 leaves(lww.join(a, b)))
            px = lww.pack(a, LWW_RID_BITS)
            pkeys = [lww.pack(lww.LWWRegister(**{f: v[i] for f, v in peers.items()}),
                              LWW_RID_BITS) for i in range(LWW_BANK)]

            def packed_step(i):
                nonlocal px
                px = lww.join_packed(px, pkeys[i % LWW_BANK])

            times = per_call_ms(packed_step, JOIN_SAMPLES)
            report_rate(f"LWW join_packed R={r} (rid_bits {LWW_RID_BITS}, pack budget "
                        "checked on the host)", r, times, 2 * r * 4, card)
            del a, b, packed, px, pkeys
        del x, peers, st, bk
    torch.cuda.empty_cache()
    register_phase(card)


def register_phase(card: str) -> None:
    """Phase 14, last part: EW/DW flags and the MV-register at 2^20
    replicas x 8 writers through two seeded op scripts (sides A and B), then
    their joins; the card == the port's CPU run on the first 65,536
    replicas, and the join times."""
    from crdt_tpu_torch import workload
    from crdt_tpu_torch.models import flags, mvregister
    from crdt_tpu_torch.utils.tree import leaves, tree_map

    def select(mask, new, old):
        def pick(x, y):
            return torch.where(mask.reshape(mask.shape + (1,) * (x.dim() - 1)), x, y)
        return tree_map(pick, new, old)

    def run(script, r, device):
        ew = flags.ew_zero(REG_W, (r,), device=device)
        dw = flags.dw_zero(REG_W, (r,), device=device)
        mv = mvregister.zero(REG_W, (r,), device=device)
        for op in script:
            m = torch.from_numpy(op["mask"][:r]).to(device)
            w = op["writer"]
            if op["enable"]:
                ew = select(m, flags.ew_enable(ew, w), ew)
                dw = select(m, flags.dw_enable(dw, w), dw)
            else:
                ew = select(m, flags.ew_disable(ew, w), ew)
                dw = select(m, flags.dw_disable(dw, w), dw)
            mv = select(m, mvregister.write(mv, w, op["ts"], op["payload"]), mv)
        return ew, dw, mv

    scripts = [workload.register_script(SEED + 81 + k, REG_OPS, REG_R, REG_W) for k in (0, 1)]
    sides = [run(s_, REG_R, "cuda") for s_ in scripts]
    joins = (flags.ew_join, flags.dw_join, mvregister.join)
    joined = [j(x, y) for j, x, y in zip(joins, *sides)]
    cpu_sides = [run(s_, REG_SLICE, "cpu") for s_ in scripts]
    cpu_joined = [j(x, y) for j, x, y in zip(joins, *cpu_sides)]
    for label, got, want in (("side A", sides[0], cpu_sides[0]),
                             ("side B", sides[1], cpu_sides[1]),
                             ("joined", joined, cpu_joined)):
        same(f"flags + MV-register {label}: card vs the port on the CPU",
             [x[:REG_SLICE].cpu() for x in leaves(got)], leaves(want))
    values = [flags.ew_value(joined[0]), flags.dw_value(joined[1]),
              mvregister.n_siblings(joined[2])]
    cpu_values = [flags.ew_value(cpu_joined[0]), flags.dw_value(cpu_joined[1]),
                  mvregister.n_siblings(cpu_joined[2])]
    same("flag values and sibling counts", [v[:REG_SLICE].cpu() for v in values], cpu_values)
    log(f"EW/DW flags + MV-register at R={REG_R} x {REG_W} writers, {REG_OPS} ops a side: "
        f"card == the port's CPU run on {REG_SLICE} replicas; EW true on "
        f"{int(values[0].sum())}, DW true on {int(values[1].sum())}, mean siblings "
        f"{float(values[2].float().mean()):.3f}")
    # a replica's bytes: tok + obs words (and DW's touched byte); seq, ts,
    # payload + obs words
    flag_bytes = 4 * (REG_W + REG_W * REG_W)
    per_replica = (flag_bytes, flag_bytes + 1, 4 * (3 * REG_W + REG_W * REG_W))
    for k, (label, join) in enumerate((("EW-Flag", flags.ew_join), ("DW-Flag", flags.dw_join),
                                       ("MV-register", mvregister.join))):
        x, y = sides[0][k], sides[1][k]
        times = per_call_ms(lambda i, j=join, a=x, b=y: j(a, b), JOIN_SAMPLES)
        report_rate(f"{label} join R={REG_R} x {REG_W} writers", REG_R, times,
                    REG_R * per_replica[k], card)

# ---- phase 15: the KV node path (ReplicaNode + LocalCluster) ----

# The reference's deployment (ClusterConfig's defaults: 5 replicas, logs of
# 1024 rows growing 2x, delta gossip) under its write shape
# (WorkloadGenerator.next_command), at a backlog of 2^17 writes landed in
# 64 rounds of 2,048: each round one add_commands batch per live replica,
# then one tick().  Replica 4 is down for rounds 16-31.
KV_WRITES, KV_ROUNDS = 131_072, 64
KV_CAPACITY = 1 << 17                  # where (a)'s logs grow to from 1024
KV_DEAD, KV_DOWN, KV_UP = 4, 16, 32
KV_EXTRA_TICKS = 64
KV_MIXED, KV_MIXED_ROUNDS = 4096, 16   # the untimed run of the parity mix
KV_BATCH = 2048                        # merge_checked's batch in the timing


def kv_drive(cluster, oracles, commands, rounds: int, down: int, up: int,
             profile_last: bool = False, label: str = "") -> dict:
    """Land ``commands`` ((cmd, target) pairs, ts = their index) in ``rounds``
    rounds, each one add_commands batch per live replica and one tick(),
    with replica KV_DEAD down from round ``down`` to round ``up``; mirror
    every acknowledged write into the oracles; then tick until converged.
    Returns the host-clock times, each ending in a sync."""
    per_round = len(commands) // rounds
    add_s, ticks, barriers, acked, prof = 0.0, [], [], 0, None
    compact = cluster.compact

    def timed_compact():
        t0 = time.perf_counter()
        frontier = compact()
        torch.cuda.synchronize()
        barriers.append((time.perf_counter() - t0) * 1e3)
        return frontier

    def timed_tick():
        t0 = time.perf_counter()
        cluster.tick()
        torch.cuda.synchronize()
        ticks.append((time.perf_counter() - t0) * 1e3)

    cluster.compact = timed_compact  # tick() calls self.compact()
    for rnd in range(rounds):
        if rnd in (down, up):
            cluster.nodes[KV_DEAD].set_alive(rnd == up)
        batches = {}
        for i in range(rnd * per_round, (rnd + 1) * per_round):
            cmd, target = commands[i]
            cmds, tss = batches.setdefault(target, ([], []))
            cmds.append(cmd)
            tss.append(i)
        t0 = time.perf_counter()
        landed = {r: cluster.nodes[r].add_commands(*batches[r]) for r in sorted(batches)}
        torch.cuda.synchronize()
        add_s += time.perf_counter() - t0
        for r, idents in landed.items():
            if idents is None:  # refused: the replica is down
                continue
            acked += len(idents)
            for cmd, ts in zip(*batches[r]):
                oracles[r].add_command(cmd, ts)
        if profile_last and rnd == rounds - 1:
            prof = profile(f"KV node path{label}: one tick() after the last write round",
                           cluster.tick)
        else:
            timed_tick()
    extra = 0
    while not cluster.converged():
        if extra == KV_EXTRA_TICKS:
            raise AssertionError(f"no convergence {KV_EXTRA_TICKS} ticks after the writes")
        timed_tick()
        extra += 1
    del cluster.compact
    return {"acked": acked, "add_s": add_s, "ticks": ticks, "barriers": barriers,
            "extra_ticks": extra, "profile": prof}


def kv_check(label: str, cluster, want: dict) -> list:
    """Every replica's view == the oracle's converged state, and every node
    tensor on the card."""
    from crdt_tpu_torch.utils.tree import leaves

    states = cluster.states()
    for r, got in enumerate(states):
        if got != want:
            raise AssertionError(f"{label}: replica {r}'s view != the oracle's converged "
                                 f"state ({len(got or {})} vs {len(want)} keys)")
        node = cluster.nodes[r]
        held = leaves(node.log) + (leaves(node._summary_cache[0]) if node._summary_cache else [])
        if not all(x.is_cuda for x in held):
            raise AssertionError(f"{label}: replica {r} holds a tensor off the card")
    return states


def kv_run(compact_every: int, commands, card: str, profile_last: bool) -> tuple:
    """One LocalCluster run of the backlog, checked against the oracle."""
    from crdt_tpu_torch.api.cluster import LocalCluster
    from crdt_tpu_torch.models import oplog
    from crdt_tpu_torch.oracle import OracleReplica, Quirks
    from crdt_tpu_torch.utils.config import ClusterConfig

    cfg = ClusterConfig(delta_gossip=True, compact_every=compact_every, seed=SEED)
    cluster = LocalCluster(cfg)
    oracles = [OracleReplica(r, Quirks()) for r in range(cfg.n_replicas)]
    t = kv_drive(cluster, oracles, commands, KV_ROUNDS, KV_DOWN, KV_UP, profile_last)
    want = OracleReplica.converged_state(oracles)
    states = kv_check(f"compact_every={compact_every}", cluster, want)
    t["rows"] = [int(oplog.size(n.log)) for n in cluster.nodes]
    t["capacity"] = [n.log.capacity for n in cluster.nodes]
    ticks = t["ticks"]
    barrier = (f", compaction barrier median {quantile(t['barriers'], 0.5):.4f} ms over "
               f"{len(t['barriers'])}" if t["barriers"] else "")
    log(f"KV cluster compact_every={compact_every}: {t['acked']} of {len(commands)} writes "
        f"acknowledged, add_commands {t['acked'] / t['add_s']:.1f} writes/s; tick() median "
        f"{quantile(ticks, 0.5):.4f} ms, p99 {quantile(ticks, 0.99):.4f} ms over "
        f"{len(ticks)} ticks ({t['extra_ticks']} after the writes){barrier}; log rows "
        f"{t['rows']}, capacity {t['capacity']}; all 5 views == the oracle's converged "
        f"state ({len(want)} keys) [{card}]")
    return cluster, states, t


def kv_phase(card: str) -> dict:
    """Phase 15: the reference's own system on the card.  Run (a), the
    never-pruned log (compact_every=0, the reference's main.go:75), and run
    (b), a compaction barrier every 8 ticks with the revived replica caught
    up by summary adoption: both == the oracle over the acknowledged
    writes, (b) == (a), (b)'s tails below (a)'s logs; then the parity mix,
    the merge at capacity 2^17 and get_state()."""
    from crdt_tpu_torch import workload
    from crdt_tpu_torch.api.cluster import LocalCluster
    from crdt_tpu_torch.models import oplog
    from crdt_tpu_torch.oracle import OracleReplica, Quirks
    from crdt_tpu_torch.ops import hopper_union as hu
    from crdt_tpu_torch.utils.config import ClusterConfig

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    gen = workload.WorkloadGenerator(ClusterConfig(seed=SEED))
    commands = [gen.next_command() for _ in range(KV_WRITES)]
    for name in hu.LAUNCHES:
        hu.LAUNCHES[name] = 0
    t0 = time.perf_counter()
    run_a, states_a, ta = kv_run(0, commands, card, profile_last=False)
    run_b, states_b, tb = kv_run(8, commands, card, profile_last=True)
    wall = time.perf_counter() - t0
    if any(hu.LAUNCHES.values()):
        raise AssertionError(f"the node path launched a hand kernel: {hu.LAUNCHES}")
    if states_b != states_a:
        raise AssertionError("run (b)'s views != run (a)'s: compaction is not transparent")
    if not all(b < a for b, a in zip(tb["rows"], ta["rows"])):
        raise AssertionError(f"run (b)'s tails {tb['rows']} not below run (a)'s logs "
                             f"{ta['rows']}")
    if max(ta["capacity"]) != KV_CAPACITY:
        raise AssertionError(f"run (a)'s logs reached capacity {ta['capacity']}, "
                             f"not {KV_CAPACITY}")
    # replica 4 missed the barriers of rounds 16-31 and came back behind
    # their frontier, so its adoption is of the summary sections
    revived = len(run_b.nodes[KV_DEAD].events.find(event="frontier_adopt"))
    if not tb["barriers"] or not revived:
        raise AssertionError("run (b): the revived replica adopted no frontier")
    log(f"KV runs: (b) == (a) on all 5 views; (b)'s tails {tb['rows']} < (a)'s logs "
        f"{ta['rows']}; the revived replica adopted {revived} frontiers; the node path "
        f"launched no hand kernel (the JAX node merges with XLA's sorted union, the "
        f"port's with the plain torch one); both runs {wall:.1f} s")

    # -- the parity mix (multi-key, non-numeric, odd numerals), untimed --
    rng = np.random.default_rng(SEED + 91)
    mixed = [(workload.mixed_command(rng), int(rng.integers(0, 5))) for _ in range(KV_MIXED)]
    cluster = LocalCluster(ClusterConfig(compact_every=8, seed=SEED + 1))
    oracles = [OracleReplica(r, Quirks()) for r in range(5)]
    tm = kv_drive(cluster, oracles, mixed, KV_MIXED_ROUNDS, 4, 8)
    want = OracleReplica.converged_state(oracles)
    kv_check("parity mix", cluster, want)
    n_text = sum(not v.lstrip("+-").isdigit() for v in want.values())
    log(f"KV parity mix: {KV_MIXED} commands ({tm['acked']} acknowledged), all 5 views == "
        f"the oracle ({len(want)} keys, {n_text} resolved to text)")
    del cluster, run_b

    # -- the merge at capacity 2^17 against a 2,048-row batch; get_state() --
    node = run_a.nodes[0]
    batch = oplog.from_ops(KV_BATCH, {
        "ts": np.arange(KV_WRITES, KV_WRITES + KV_BATCH, dtype=np.int32),
        "rid": np.zeros(KV_BATCH, np.int32),
        "seq": np.arange(1 << 20, (1 << 20) + KV_BATCH, dtype=np.int32),
        "key": np.arange(KV_BATCH, dtype=np.int32) % 62,
        "val": np.full(KV_BATCH, -15, np.int32),
        "payload": np.zeros(KV_BATCH, np.int32),
        "is_num": np.ones(KV_BATCH, bool)}, device="cuda")
    _, n_unique = oplog.merge_checked(node.log, batch)
    if int(n_unique) != ta["rows"][0] + KV_BATCH:
        raise AssertionError(f"merge_checked n_unique {int(n_unique)} != "
                             f"{ta['rows'][0]} + {KV_BATCH}")
    merge_ms = time_ms(lambda: oplog.merge_checked(node.log, batch), reps=20)
    merge_dev = device_time_ms(lambda: oplog.merge_checked(node.log, batch), reps=20)
    cap = node.log.capacity
    n_bytes = 25 * ((cap + KV_BATCH) + cap) + 4  # a row: 6 int32 + 1 bool
    get_ms = []
    for _ in range(5):
        t0 = time.perf_counter()
        node.get_state()
        get_ms.append((time.perf_counter() - t0) * 1e3)
    peak = torch.cuda.max_memory_allocated()
    kv = {
        "writes": KV_WRITES, "acked_a": ta["acked"], "acked_b": tb["acked"],
        "add_commands_writes_per_s_a": ta["acked"] / ta["add_s"],
        "add_commands_writes_per_s_b": tb["acked"] / tb["add_s"],
        "tick_ms_a": [quantile(ta["ticks"], 0.5), quantile(ta["ticks"], 0.99), len(ta["ticks"])],
        "tick_ms_b": [quantile(tb["ticks"], 0.5), quantile(tb["ticks"], 0.99), len(tb["ticks"])],
        "barrier_ms_median": quantile(tb["barriers"], 0.5), "barriers": len(tb["barriers"]),
        "get_state_ms": statistics.median(get_ms), "merge_checked_ms": merge_ms,
        "merge_checked_device_ms": merge_dev,
        "merge_checked_bound_ms": n_bytes / HBM_BYTES_PER_S * 1e3,
        "rows_a": ta["rows"], "rows_b": tb["rows"], "peak_gib": peak / 2**30,
        "runs_s": wall, "card": card,
    }
    log(f"oplog.merge_checked at capacity {cap} against a {KV_BATCH}-row batch: "
        f"{merge_ms:.4f} ms (CUDA events, median of 20), device {merge_dev:.4f} ms "
        f"(profiler, mean of 20), bytes bound {kv['merge_checked_bound_ms']:.6f} ms "
        f"({n_bytes / 1e6:.3f} MB at 3.35 TB/s); get_state() {kv['get_state_ms']:.4f} ms; "
        f"peak device memory {peak / 2**30:.3f} GiB [{card}]")
    log(json.dumps({"kv_node": kv}))
    return kv


# ---- phase 16: the join registry, the typed cluster and the soaks ----

REGISTRY_TRIALS = 12
# (b) the typed cluster: the reference's 5 replicas (ClusterConfig's
# defaults) with the siblings' barriers on.  Map writes go over the
# reference's 62-key alphabet with its deltas in [-20, -11] (main.go:274-276),
# one remove per 16 updates; set adds and removes (3:1) over a 4,096-element
# universe; sequence edits at 70 % inserts / 30 % deletes, near the public
# automerge-perf editing trace's mix (182,315 inserts, 77,463 deletes); and
# the reference's KV writes (WorkloadGenerator).  32 rounds, replica 4 down
# for rounds 8-15, then ticks to convergence.
# (half of the 16,384 / 16,384 / 8,192 / 4,096 this phase once took, to
# keep the smoke in half its time limit: that card run and its CPU twin
# took 280 s)
TYPED_MAP, TYPED_SET, TYPED_SEQ, TYPED_KV = 8_192, 8_192, 4_096, 2_048
TYPED_ROUNDS, TYPED_DEAD, TYPED_DOWN, TYPED_UP = 32, 4, 8, 16
TYPED_UNIVERSE, TYPED_EXTRA_TICKS = 4_096, 64
TYPED_BARRIERS = dict(set_collect_every=8, seq_collect_every=8, map_reset_every=16)
# (c) the sequence soak at the JAX long mode's columnar shape
# (tests/test_seq_soak.py:50), at capacity 512 and 1024 (kernel 1's wide
# body) and 2048 (kernels 4, 5: the stripe)
SOAK_N, SOAK_STEPS, SOAK_SEED = 4, 400, 0


def tree_cpu(x):
    from crdt_tpu_torch.utils.tree import tree_map

    return tree_map(lambda t: t.cpu(), x)


def tree_same(x, y) -> bool:
    from crdt_tpu_torch.utils.tree import leaves

    lx, ly = leaves(x), leaves(y)
    return len(lx) == len(ly) and all(
        a.dtype == b.dtype and torch.equal(a.cpu(), b.cpu()) for a, b in zip(lx, ly))


def registry_check(device: str) -> dict:
    """(a): every registered join on ``device`` states drawn by its own
    generator, 12 trials: the four laws, each join == the same join on the
    CPU copies, and ``converge`` by name == on the CPU.  Returns the
    launches by kernel."""
    import zlib

    from crdt_tpu_torch.ops import hopper_union as hu
    from crdt_tpu_torch.ops import joins
    from crdt_tpu_torch.utils.tree import tree_map

    registry = joins.registered_joins()
    for name in hu.LAUNCHES:
        hu.LAUNCHES[name] = 0
    t0 = time.perf_counter()
    for name, spec in sorted(registry.items()):
        rng = np.random.default_rng(zlib.crc32(name.encode()))
        join, neutral = spec.join, spec.neutral(device=device)
        drawn = []
        for _ in range(REGISTRY_TRIALS):
            a, b, c = (spec.rand(rng, device=device) for _ in range(3))
            drawn.append(a)
            ab = join(a, b)
            for law, x, y in (("commutativity", ab, join(b, a)),
                              ("associativity", join(ab, c), join(a, join(b, c))),
                              ("idempotence", join(a, a), a),
                              ("identity", join(a, neutral), a),
                              ("== the CPU join", ab, join(tree_cpu(a), tree_cpu(b)))):
                if not tree_same(x, y):
                    raise AssertionError(f"registry {name}: {law} fails on {device}")
        stacked = tree_map(lambda *xs: torch.stack(xs), *drawn[:5])
        if not tree_same(joins.converge(name, stacked), joins.converge(name, tree_cpu(stacked))):
            raise AssertionError(f"registry {name}: converge on {device} != on the CPU")
    sync(device)
    launches = dict(hu.LAUNCHES)
    log(f"registry: {len(registry)} joins x {REGISTRY_TRIALS} trials on the card: "
        f"commutative, associative, idempotent, neutral, == the CPU join and converge "
        f"({time.perf_counter() - t0:.1f} s); launches {launches}")
    if launches["bucketed_union"] == 0:
        raise AssertionError("the registry's orset_bucketed join launched no bucketed_union")
    return launches


def typed_schedule() -> list:
    """The seeded schedule of (b), round by round: (kv, map, set, seq) ops."""
    from crdt_tpu_torch import workload
    from crdt_tpu_torch.utils.config import ALPHABET, ClusterConfig

    rng = np.random.default_rng(SEED + 160)
    gen = workload.WorkloadGenerator(ClusterConfig(seed=SEED + 161))
    rounds, n_map = [], 0
    for _ in range(TYPED_ROUNDS):
        kv = [gen.next_command() for _ in range(TYPED_KV // TYPED_ROUNDS)]
        maps = []
        for _ in range(TYPED_MAP // TYPED_ROUNDS):
            kind = "rem" if n_map % 17 == 16 else "upd"
            n_map += 1
            maps.append((int(rng.integers(0, 5)), kind, ALPHABET[int(rng.integers(0, 62))],
                         int(rng.integers(-20, -10))))
        sets = [(int(rng.integers(0, 5)), "add" if rng.random() < 0.75 else "remove",
                 f"e{int(rng.integers(0, TYPED_UNIVERSE))}")
                for _ in range(TYPED_SET // TYPED_ROUNDS)]
        seqs = [(int(rng.integers(0, 5)), bool(rng.random() < 0.7), float(rng.random()))
                for _ in range(TYPED_SEQ // TYPED_ROUNDS)]
        rounds.append((kv, maps, sets, seqs))
    return rounds


def typed_views(c) -> dict:
    return {"kv": c.states(), "set": [n.members() for n in c.set_nodes],
            "seq": [n.items() for n in c.seq_nodes], "map": [n.items() for n in c.map_nodes],
            "epochs": [n.epochs() for n in c.map_nodes],
            "set_floor": [n.vv_snapshot()[1] for n in c.set_nodes],
            "seq_floor": [n.vv_snapshot()[1] for n in c.seq_nodes],
            "vv": [(n.version_vector(), s.version_vector(), q.version_vector(),
                    m.version_vector()) for n, s, q, m in
                   zip(c.nodes, c.set_nodes, c.seq_nodes, c.map_nodes)]}


def typed_run(device: str, rounds: list, timed: bool) -> tuple:
    """Drive one typed LocalCluster on ``device`` through ``rounds``: each
    round every op on its replica, one tick; then tick to convergence of
    all four surfaces.  With ``timed``, every op, tick and barrier is
    bracketed by a sync and the host clock, and the last round's tick runs
    under the profiler."""
    from crdt_tpu_torch.api.cluster import LocalCluster
    from crdt_tpu_torch.utils.config import ClusterConfig

    cluster = LocalCluster(ClusterConfig(seed=SEED, **TYPED_BARRIERS), device=device)
    t = {k: [] for k in ("upd", "rem", "add", "remove", "insert_at", "remove_at", "tick",
                         "set_collect", "seq_collect", "map_reset", "add_commands")}
    prof = {}

    def clock(key, fn, *args):
        if timed:
            sync(device)
            t0 = time.perf_counter()
        out = fn(*args)
        if timed:
            sync(device)
            if out is not None:
                t[key].append((time.perf_counter() - t0) * 1e3)
        return out

    for name in ("set_collect", "seq_collect", "map_reset"):  # tick() calls them
        setattr(cluster, name, lambda _f=getattr(cluster, name), _n=name: clock(_n, _f))
    acked, ts = 0, 0
    for rnd, (kv, maps, sets, seqs) in enumerate(rounds):
        if rnd in (TYPED_DOWN, TYPED_UP):
            for nodes in (cluster.nodes, cluster.set_nodes, cluster.seq_nodes,
                          cluster.map_nodes):
                nodes[TYPED_DEAD].set_alive(rnd == TYPED_UP)
        batches = {}
        for cmd, target in kv:
            cmds, tss = batches.setdefault(target, ([], []))
            cmds.append(cmd)
            tss.append(ts)
            ts += 1
        for r in sorted(batches):
            clock("add_commands", cluster.nodes[r].add_commands, *batches[r])
        for rep, kind, key, delta in maps:
            node = cluster.map_nodes[rep]
            out = (clock("upd", node.upd, key, delta) if kind == "upd"
                   else clock("rem", node.rem, key))
            acked += out is not None
        for rep, kind, elem in sets:
            acked += clock(kind, getattr(cluster.set_nodes[rep], kind), elem) is not None
        for i, (rep, insert, u) in enumerate(seqs):
            node = cluster.seq_nodes[rep]
            n = len(node.items() or ())
            if insert:
                out = clock("insert_at", node.insert_at, int(u * (n + 1)), f"q{rnd}.{i}")
            else:
                out = clock("remove_at", node.remove_at, int(u * n)) if n else None
            acked += out is not None
        if timed and rnd == len(rounds) - 1:
            prof = profile("typed cluster: one tick() after the last round", cluster.tick) or {}
        else:
            clock("tick", cluster.tick)
    extra = 0
    while not (cluster.converged() and cluster.set_converged() and cluster.seq_converged()
               and cluster.map_converged()):
        if extra == TYPED_EXTRA_TICKS:
            raise AssertionError(f"typed cluster on {device}: no convergence "
                                 f"{TYPED_EXTRA_TICKS} ticks after the writes")
        clock("tick", cluster.tick)
        extra += 1
    return cluster, t, {"acked": acked, "extra_ticks": extra, "profile": prof}


def typed_cluster_check(card: str, kv_tick_ms: list) -> dict:
    """(b): the typed cluster on the card, checked against the same
    schedule's CPU run, which runs after the card's so that no time shares
    the host with it; per-op, tick and barrier times."""
    from crdt_tpu_torch.models import rseq
    from crdt_tpu_torch.ops import hopper_union as hu
    from crdt_tpu_torch.utils.tree import leaves

    rounds = typed_schedule()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    for name in hu.LAUNCHES:
        hu.LAUNCHES[name] = 0
    t0 = time.perf_counter()
    card_c, t, info = typed_run("cuda", rounds, timed=True)
    card_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    if any(hu.LAUNCHES.values()):
        raise AssertionError(f"the typed nodes launched a hand kernel: {hu.LAUNCHES}")
    t0 = time.perf_counter()
    cpu_c, _, _ = typed_run("cpu", rounds, timed=False)
    cpu_s = time.perf_counter() - t0
    got, want = typed_views(card_c), typed_views(cpu_c)
    for surface in got:
        if got[surface] != want[surface]:
            raise AssertionError(f"typed cluster: {surface} on the card != on the CPU")
    for surface in ("kv", "set", "seq", "map", "epochs"):
        if any(v != got[surface][0] for v in got[surface][1:]):
            raise AssertionError(f"typed cluster: the replicas' {surface} views differ")
    reg = card_c.metrics.registry
    counts = {k: reg.counter_value(k) for k in (
        "set_collections", "seq_collections", "map_resets_scheduled", "map_reset_skipped",
        "set_collect_skipped", "seq_collect_skipped", "set_floor_adoptions",
        "seq_floor_adoptions", "map_epoch_adoptions", "set_grow", "seq_grow")}
    if not (counts["set_collections"] and counts["seq_collections"]
            and counts["map_reset_skipped"] and got["set_floor"][0] and got["seq_floor"][0]):
        raise AssertionError(f"typed cluster: a barrier never ran or a map reset was not "
                             f"skipped while replica {TYPED_DEAD} was down: {counts}")
    for r in range(5):
        held = (leaves(card_c.set_nodes[r].gc) + leaves(card_c.seq_nodes[r].gc)
                + leaves(card_c.map_nodes[r].device_state()))
        if not all(x.is_cuda for x in held):
            raise AssertionError(f"typed cluster: replica {r} holds a sibling tensor off the card")
    seq = card_c.seq_nodes[0].gc.inner

    def q(key):
        xs = t[key]
        return [quantile(xs, 0.5), quantile(xs, 0.99), len(xs)] if xs else None

    out = {
        "ops": {"map": TYPED_MAP, "set": TYPED_SET, "seq": TYPED_SEQ, "kv": TYPED_KV},
        "acked": info["acked"], "extra_ticks": info["extra_ticks"],
        "op_ms": {k: q(k) for k in ("upd", "rem", "add", "remove", "insert_at", "remove_at",
                                    "add_commands")},
        "tick_ms": q("tick"), "kv_only_tick_ms_phase15": kv_tick_ms,
        "barrier_ms": {k: q(k) for k in ("set_collect", "seq_collect", "map_reset")},
        "profiled_tick": info["profile"], "peak_gib": peak / 2**30,
        "seq_rows": int(rseq.n_rows(seq)), "seq_capacity": seq.capacity,
        "seq_depth": seq.depth, "set_capacity": card_c.set_nodes[0].gc.inner.capacity,
        "set_members": len(got["set"][0]), "seq_len": len(got["seq"][0]),
        "map_keys": len(got["map"][0]), "map_epochs": len(got["epochs"][0]),
        "counters": counts, "card_run_s": card_s, "cpu_run_s": cpu_s,
    }
    ms = out["op_ms"]
    log(f"typed cluster: {TYPED_MAP} map + {TYPED_SET} set + {TYPED_SEQ} sequence + "
        f"{TYPED_KV} KV ops in {TYPED_ROUNDS} rounds, replica {TYPED_DEAD} down for rounds "
        f"{TYPED_DOWN}-{TYPED_UP - 1}: {info['acked']} typed ops acknowledged; all 5 replicas "
        f"converged {info['extra_ticks']} ticks after the writes; every view, vv, floor and "
        f"epoch == the CPU run; {counts}")
    log(f"typed cluster times: upd {ms['upd']}, add {ms['add']}, insert_at {ms['insert_at']} "
        f"ms [median, p99, n]; tick() {out['tick_ms']} ms with the siblings beside phase "
        f"15's KV-only {kv_tick_ms}; barriers {out['barrier_ms']}; sequence rows "
        f"{out['seq_rows']} of capacity {out['seq_capacity']}; peak device memory "
        f"{peak / 2**30:.3f} GiB; runs: card {card_s:.1f} s, CPU {cpu_s:.1f} s [{card}]")
    return out


def first_auto_join(capacity: int) -> tuple:
    """The operands of the first join of the soak's auto run (the same
    seeded schedule, stepped up to that join)."""
    from crdt_tpu_torch.harness.seq_soak import SeqSoakRunner
    from crdt_tpu_torch.models import rseq_engine as reng

    runner = SeqSoakRunner(n=SOAK_N, seed=SOAK_SEED, capacity=capacity, device="cuda")
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
    return seen[0]


def soak_pair(capacity: int, card: str) -> dict:
    """(c) one capacity: the seeded sequence soak on the auto engine (the
    lexN kernels) and on the generic one, equal reports, launches and ms a
    join; then the join's kernel vs its twin at the soak's own operands."""
    import dataclasses

    from crdt_tpu_torch.harness.seq_soak import SeqSoakRunner
    from crdt_tpu_torch.models import rseq_engine as reng
    from crdt_tpu_torch.ops import hopper_union as hu
    from crdt_tpu_torch.utils.tree import tree_map

    out, reports = {}, {}
    for engine in ("auto", "generic"):
        runner = SeqSoakRunner(n=SOAK_N, seed=SOAK_SEED, capacity=capacity, engine=engine,
                               device="cuda")
        join_ms, per_join = [], []

        def join(_orig=runner._join, _r=runner):
            before, launched = _r.report.joins, dict(hu.LAUNCHES)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _orig()
            torch.cuda.synchronize()
            if _r.report.joins > before:
                join_ms.append((time.perf_counter() - t0) * 1e3)
                per_join.append(sum(hu.LAUNCHES[k] - launched[k] for k in launched))
        runner._join = join
        for name in hu.LAUNCHES:
            hu.LAUNCHES[name] = 0
        t0 = time.perf_counter()
        reports[engine] = runner.run(SOAK_STEPS)
        torch.cuda.synchronize()
        out[engine] = {"s": time.perf_counter() - t0, "launches": dict(hu.LAUNCHES),
                       "join_ms": [quantile(join_ms, 0.5), quantile(join_ms, 0.99),
                                   len(join_ms)],
                       "launches_a_join": sorted(set(per_join))}
    if dataclasses.asdict(reports["auto"]) != dataclasses.asdict(reports["generic"]):
        raise AssertionError(f"seq soak at capacity {capacity}: auto {reports['auto']} != "
                             f"generic {reports['generic']}")
    if any(out["generic"]["launches"].values()):
        raise AssertionError("the generic soak launched a hand kernel")
    out["report"] = dataclasses.asdict(reports["auto"])
    out["launches_a_step"] = {k: v / SOAK_STEPS for k, v in out["auto"]["launches"].items() if v}
    # the join's union at the soak's own operands (one lane, 18 key words,
    # elem / removed / src): the kernel route vs the fused twin
    pair = first_auto_join(capacity)
    ca, cb = reng._stack_pair(*pair)
    sides = lexn_sides(ca.col, cb.col, gc=True)
    err = same(f"soak union C={capacity}",
               hu.sorted_union_columnar_lexn_auto(*sides),
               hu._lexn_union_plain(*sides, 2 * capacity))
    out["union_ms"] = time_ms(lambda: hu.sorted_union_columnar_lexn_auto(*sides), reps=50)
    out["union_device_ms"] = device_time_ms(lambda: hu.sorted_union_columnar_lexn_auto(*sides))
    out["union_queued_ms"] = queued_ms(lambda: hu.sorted_union_columnar_lexn_auto(*sides))
    out["union_plain_ms"] = time_ms(lambda: hu._lexn_union_plain(*sides, 2 * capacity), reps=10)
    # the auto join by layer (CUDA events around each host call): staging the
    # pair, the lossless union, the rest of gc_merge_checked (where the
    # fused route takes the shape, its GC union and the floor max, less the
    # lossless union), unstack, and the whole join
    merged = reng.gc_merge_checked(ca, cb)[0]
    layers = {
        "stack_pair": time_ms(lambda: reng._stack_pair(*pair), reps=50),
        "union": out["union_ms"],
        "gc_merge_checked": time_ms(lambda: reng.gc_merge_checked(ca, cb), reps=50),
        "unstack": time_ms(lambda: tree_map(lambda x: x[0], reng.unstack(merged)), reps=50),
        "join": time_ms(lambda: reng.gc_join_checked_auto(*pair), reps=50),
    }
    layers["suppression"] = layers["gc_merge_checked"] - layers["union"]
    out["join_layers_ms"] = layers
    n_planes = N_KEYS_SEQ + 3
    n_bytes = 4 * (2 * n_planes * capacity + n_planes * 2 * capacity + 1)
    n_ops = 2 * capacity * math.ceil(math.log2(2 * capacity))
    out["union_bound_ms"], out["union_bound_by"] = bound(n_bytes, n_ops)
    out["union_max_abs_err"] = err
    log(f"seq soak n={SOAK_N} C={capacity} {SOAK_STEPS} steps: auto == generic "
        f"({reports['auto']}); auto launches {out['auto']['launches']} "
        f"({out['launches_a_step']} a step, {out['auto']['launches_a_join']} a join), join "
        f"{out['auto']['join_ms']} ms vs generic {out['generic']['join_ms']} ms "
        f"[median, p99, n]; runs {out['auto']['s']:.1f} / {out['generic']['s']:.1f} s; its "
        f"union (18, 3) at one lane: {out['union_ms']:.4f} ms/call (device: profiler "
        f"{out['union_device_ms'] or 'not measured'}, queued {out['union_queued_ms']:.4f}), twin "
        f"{out['union_plain_ms']:.4f} ms, bound "
        f"{out['union_bound_ms']:.6f} ms by {out['union_bound_by']}, == twin; the auto join "
        f"by layer: " + ", ".join(f"{k} {v:.4f}" for k, v in layers.items()) + f" ms [{card}]")
    return out


def gc_soaks(card: str) -> dict:
    """(c) the set and map soaks at their CLI defaults (1,000 steps, seeds
    0-2, 4 replicas, capacity 512), states on the card."""
    from crdt_tpu_torch.harness.gc_soak import MapSoakRunner, SetSoakRunner

    out = {}
    for label, make in (("set", lambda s: SetSoakRunner(n=4, seed=s, capacity=512,
                                                        device="cuda")),
                        ("map", lambda s: MapSoakRunner(n=4, seed=s, device="cuda"))):
        t0 = time.perf_counter()
        reports = [str(make(s).run(1000)) for s in range(3)]
        out[label] = {"s": time.perf_counter() - t0, "reports": reports}
        log(f"{label} soak (CLI defaults, seeds 0-2): {out[label]['s']:.1f} s; "
            + "; ".join(reports) + f" [{card}]")
    return out


def typed_phase(card: str, rows: list, kv: dict) -> None:
    """Phase 16: the registry on the card, the typed cluster and the soaks,
    one ``{"typed_nodes": ...}`` JSON line.  The rows of kernels 4 and 5 in
    the kernel table take their launches from the capacity-2048 soak, the
    path that runs them since the wide body took C = 1024."""
    t0 = time.perf_counter()
    reg = registry_check("cuda")
    cluster = typed_cluster_check(card, kv["tick_ms_a"])
    soaks = {c: soak_pair(c, card) for c in (512, 1024, 2048)}
    for c in (512, 1024):
        launched = soaks[c]["auto"]["launches"]
        if not launched["lexn_gc_union"] or launched["lexn_union"] or \
                launched["lexn_merge"] or launched["lexn_compact"]:
            raise AssertionError(f"the capacity-{c} auto soak launched {launched}, expected "
                                 "the wide body's GC instance (lexn_gc_union) alone")
    launched = soaks[2048]["auto"]["launches"]
    if launched["lexn_union"] or launched["lexn_gc_union"] or \
            not (launched["lexn_merge"] and launched["lexn_compact"]):
        raise AssertionError(f"the capacity-2048 auto soak launched {launched}, expected "
                             "the striped lexn_merge and lexn_compact alone")
    gcs = gc_soaks(card)
    for row in rows:
        if row["name"] in ("lexn_merge", "lexn_compact"):
            row["launches"] = launched[row["name"]]
    log(json.dumps({"typed_nodes": {
        "registry_launches": reg, "cluster": cluster, "seq_soak": soaks, "gc_soaks": gcs,
        "phase_s": time.perf_counter() - t0, "card": card}}))


# ---- phase 17: the reference's HTTP surface on the card ----

# ClusterConfig()'s 5 replicas (the reference's deployment, main.go:316-327)
# behind api.http_shim on loopback, taking phase 15's traffic shape over
# HTTP: 131,072 reference-shaped writes (WorkloadGenerator, seed 0) as (a)
# 2,048 single-op POST /data from 8 client threads, replica 4 down for the
# second quarter, and (b) 129,024 writes in op pages of 512; then (c) 64
# rounds of pulls over HTTP (each replica GETs a seeded peer's /gossip?vv=
# and POSTs it to its own /push), a barrier over HTTP every 8 rounds; and (d)
# `python -m crdt_tpu_torch` as a subprocess on the card.
HTTP_BUDGET_S = 60
# 16,384 single-op posts took 90 s at ~180/s; 8,192 took the phase to 99 s
# of its 60 and the smoke past its 900 s aim (PERF.md §4)
HTTP_SINGLE, HTTP_THREADS = 2_048, 8
HTTP_PAGE_WRITES, HTTP_PAGE = 129_024, 512
HTTP_ROUNDS, HTTP_BARRIER_EVERY = 64, 8
HTTP_EXTRA_ROUNDS = 64
HTTP_BURST = 256
HTTP_DEAD = 4


def http_call(url: str, method: str = "GET", body: bytes | None = None, headers=None) -> tuple:
    """One request: (status, headers, body, seconds) on a connection of its
    own (the shim speaks HTTP/1.0)."""
    import http.client
    from urllib.parse import urlsplit

    u = urlsplit(url)
    t0 = time.perf_counter()
    c = http.client.HTTPConnection(u.hostname, u.port, timeout=120)
    try:
        c.request(method, u.path + (f"?{u.query}" if u.query else ""), body=body,
                  headers=headers or {})
        r = c.getresponse()
        data = r.read()
        return r.status, dict(r.getheaders()), data, time.perf_counter() - t0
    finally:
        c.close()


class HttpTally:
    """Every status the phase's client saw, so an unplanned 5xx fails it."""

    def __init__(self):
        import threading

        self.lock = threading.Lock()
        self.statuses: dict = {}
        self.planned_502 = 0

    def note(self, status: int, planned_502: bool = False) -> None:
        with self.lock:
            self.statuses[status] = self.statuses.get(status, 0) + 1
            if status == 502 and planned_502:
                self.planned_502 += 1

    def check(self) -> None:
        bad = {s: n for s, n in self.statuses.items() if s >= 500}
        if bad != ({502: self.planned_502} if self.planned_502 else {}):
            raise AssertionError(f"unplanned 5xx answers: {bad} (planned 502s "
                                 f"{self.planned_502})")


def post_writes(urls, writes, tally, oracles, down=None) -> list:
    """POST /data of every (index, cmd, target) in ``writes`` from
    HTTP_THREADS client threads (thread t takes the writes with index
    t mod HTTP_THREADS); every 200 is mirrored into its target's oracle.
    ``down`` is the replica whose 502s are planned.  Returns the per-post
    seconds."""
    import threading

    lat, lock, errors = [], threading.Lock(), []

    def client(t):
        try:
            for i, cmd, target in writes[t::HTTP_THREADS]:
                status, hdr, body, sec = http_call(urls[target] + "/data", "POST",
                                                   json.dumps(cmd).encode())
                tally.note(status, planned_502=target == down)
                with lock:
                    lat.append(sec)
                    if status == 200:
                        if body != b"Inserted" or "X-CRDT-Session-Token" not in hdr:
                            raise AssertionError(f"POST /data answered {body!r}, {hdr}")
                        oracles[target].add_command(cmd, i)
                    elif not (status == 502 and target == down):
                        raise AssertionError(f"POST /data to replica {target}: {status}")
        except BaseException as e:  # re-raised on the main thread
            errors.append(e)

    threads = [threading.Thread(target=client, args=(t,)) for t in range(HTTP_THREADS)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    if errors:
        raise errors[0]
    return lat


def series_sum(text: str, name: str, **labels) -> float:
    """The sum of every series ``name`` in a Prometheus text whose labels
    include ``labels``."""
    total = 0.0
    for line in text.splitlines():
        if line.startswith(name + "{") or line.startswith(name + " "):
            key, value = line.rsplit(" ", 1)
            if all(f'{k}="{v}"' in key for k, v in labels.items()):
                total += float(value)
    return total


def http_phase(card: str) -> dict:
    """Phase 17: the reference's surface on the card, over HTTP.  Every
    acknowledged write read back from all 5 replicas (GET /data == the
    oracle's fold), every GET /gossip body == its node's
    gossip_payload_json, the /metrics ingest counters == the client's
    counts, no 5xx but the planned 502s, no hand kernel launched (the
    prediction: the node merges with the plain torch sorted union); then
    one {"http_surface": ...} JSON line."""
    import copy
    import random
    from pathlib import Path
    from urllib.parse import quote

    from crdt_tpu_torch import workload
    from crdt_tpu_torch.api.cluster import LocalCluster
    from crdt_tpu_torch.api.http_shim import HttpCluster
    from crdt_tpu_torch.api.node import stable_frontier_host
    from crdt_tpu_torch.consistency.stability import (STABILITY_HEADER, StabilityTracker,
                                                      decode_summary)
    from crdt_tpu_torch.oracle import OracleReplica, Quirks
    from crdt_tpu_torch.ops import hopper_union as hu
    from crdt_tpu_torch.utils.config import ClusterConfig

    t_phase = time.perf_counter()
    log(f"phase 17 (the HTTP surface): budget {HTTP_BUDGET_S} s")
    cfg = ClusterConfig()
    cluster = LocalCluster(cfg)  # the card: device=None
    if cluster.nodes[0].log.ts.device.type != "cuda":
        raise AssertionError("LocalCluster() did not place its logs on the card")
    server = HttpCluster(cluster)
    server.start()
    urls = server.urls
    oracles = [OracleReplica(r, Quirks()) for r in range(cfg.n_replicas)]
    gen = workload.WorkloadGenerator(ClusterConfig())  # seed 0
    tally = HttpTally()
    predicted = {name: 0 for name in hu.LAUNCHES}  # no hand kernel on this path
    for name in hu.LAUNCHES:
        hu.LAUNCHES[name] = 0
    try:
        # -- (a) single-op writes, replica 4 down for the second quarter --
        writes = [(i, *gen.next_command()) for i in range(HTTP_SINGLE)]
        q = HTTP_SINGLE // 4
        t0 = time.perf_counter()
        lat = post_writes(urls, writes[:q], tally, oracles)
        status = http_call(urls[HTTP_DEAD] + "/condition/false")[0]
        tally.note(status)
        lat += post_writes(urls, writes[q:2 * q], tally, oracles, down=HTTP_DEAD)
        tally.note(http_call(urls[HTTP_DEAD] + "/condition/true")[0])
        lat += post_writes(urls, writes[2 * q:], tally, oracles)
        single_s = time.perf_counter() - t0
        acked_single = sum(len(o.log) for o in oracles)
        want_502 = sum(1 for _, _, t in writes[q:2 * q] if t == HTTP_DEAD)
        if tally.planned_502 != want_502 or acked_single != HTTP_SINGLE - want_502:
            raise AssertionError(f"(a): {tally.planned_502} 502s, {acked_single} acknowledged; "
                                 f"want {want_502} and {HTTP_SINGLE - want_502}")
        log(f"(a) {HTTP_SINGLE} single-op POST /data from {HTTP_THREADS} threads: "
            f"{acked_single} acknowledged, {tally.planned_502} planned 502s (replica "
            f"{HTTP_DEAD} down), {acked_single / single_s:.1f} acknowledged writes/s; "
            f"p50 {quantile(lat, 0.5) * 1e3:.3f} ms, p99 {quantile(lat, 0.99) * 1e3:.3f} ms "
            f"[{card}]")

        # -- (b) op pages of 512, 429s backed off and counted --
        replay = copy.deepcopy(gen)
        t0 = time.perf_counter()
        pages = gen.drive_pages_http(urls, HTTP_PAGE_WRITES, page_size=HTTP_PAGE, timeout=120)
        pages_s = time.perf_counter() - t0
        if pages["admitted"] != HTTP_PAGE_WRITES or pages["lost"]:
            raise AssertionError(f"(b): {pages}")
        for i in range(HTTP_PAGE_WRITES):
            cmd, target = replay.next_command()
            oracles[target].add_command(cmd, HTTP_SINGLE + i)
        log(f"(b) {HTTP_PAGE_WRITES} writes in {pages['pages']} pages of {HTTP_PAGE}: "
            f"{pages['admitted']} admitted, {pages['sheds']} sheds (429) backed off, "
            f"{HTTP_PAGE_WRITES / pages_s:.1f} acknowledged writes/s [{card}]")

        # -- one profiled burst of concurrent posts --
        burst = [(HTTP_SINGLE + HTTP_PAGE_WRITES + i, *gen.next_command())
                 for i in range(HTTP_BURST)]
        prof = profile(f"a burst of {HTTP_BURST} concurrent POST /data",
                       lambda: post_writes(urls, burst, tally, oracles))

        # -- (c) pull rounds and barriers over HTTP --
        rng = random.Random(SEED + 17)
        tracker = StabilityTracker(cluster.nodes[0], urls[1:])
        pull_ms, gossip_ms, barrier_ms, checked = [], [], [], 0

        def pull(i: int, rnd: int) -> None:
            nonlocal checked
            peer = rng.choice([j for j in range(cfg.n_replicas) if j != i])
            t0 = time.perf_counter()
            st, _, body, _ = http_call(urls[i] + "/vv")
            tally.note(st)
            since = json.loads(body)["vv"]
            st, hdr, body, sec = http_call(urls[peer] + "/gossip?vv=" + quote(json.dumps(since)),
                                           headers={"X-CRDT-Trace": f"smoke-{rnd}-{i}"})
            tally.note(st)
            gossip_ms.append(sec * 1e3)
            want = cluster.nodes[peer].gossip_payload_json({int(r): s for r, s in since.items()})
            if st != 200 or body != want:
                raise AssertionError(f"GET /gossip of replica {peer}: {st}, body != "
                                     "gossip_payload_json")
            checked += 1
            summary = decode_summary(hdr.get(STABILITY_HEADER))
            if peer != 0:
                tracker.note(urls[peer], summary["vv"], summary["frontier"])
            st = http_call(urls[i] + "/push", "POST", b'{"payload": ' + body + b"}")[0]
            tally.note(st)
            if st != 200:
                raise AssertionError(f"POST /push to replica {i}: {st}")
            pull_ms.append((time.perf_counter() - t0) * 1e3)

        def barrier() -> dict:
            t0 = time.perf_counter()
            snaps = []
            for u in urls:
                st, _, body, _ = http_call(u + "/vv")
                tally.note(st)
                snaps.append(json.loads(body))
            frontier = stable_frontier_host(
                [{int(r): s for r, s in x["vv"].items()} for x in snaps],
                [{int(r): s for r, s in x["frontier"].items()} for x in snaps])
            body = json.dumps({"frontier": {str(r): s for r, s in frontier.items()}}).encode()
            for u in urls:
                tally.note(http_call(u + "/compact", "POST", body)[0])
            barrier_ms.append((time.perf_counter() - t0) * 1e3)
            return frontier

        folds = []
        for rnd in range(HTTP_ROUNDS):
            for i in range(cfg.n_replicas):
                pull(i, rnd)
            if (rnd + 1) % HTTP_BARRIER_EVERY == 0:
                folds.append(barrier())
        extra = 0
        while not cluster.converged():
            if extra == HTTP_EXTRA_ROUNDS:
                raise AssertionError(f"no convergence {HTTP_EXTRA_ROUNDS} rounds after (c)")
            for i in range(cfg.n_replicas):
                pull(i, HTTP_ROUNDS + extra)
            extra += 1
        # the tracker's frontier, from the headers alone, may lag the
        # barriers' (its summaries are as old as the last pull) but never
        # passes what every replica holds
        minted = tracker.mint()
        if not minted or any(s > n.version_vector().get(r, -1)
                             for n in cluster.nodes for r, s in minted.items()):
            raise AssertionError(f"the stability tracker minted {minted}")
        log(f"(c) {HTTP_ROUNDS} rounds of HTTP pulls (+{extra} to converge): pull round "
            f"median {statistics.median(pull_ms):.3f} ms, GET /gossip?vv= p50 "
            f"{quantile(gossip_ms, 0.5):.3f} ms, {len(folds)} barriers over HTTP median "
            f"{statistics.median(barrier_ms):.3f} ms; {checked} GET /gossip bodies == "
            f"gossip_payload_json; the stability tracker minted {len(minted)} writers, "
            f"lag {tracker.lag_ops()} ops [{card}]")

        # -- every acknowledged write read back from all 5 replicas --
        want = OracleReplica.converged_state(oracles)
        get_ms = []
        for r, u in enumerate(urls):
            for _ in range(4):
                st, _, body, sec = http_call(u + "/data")
                tally.note(st)
                get_ms.append(sec * 1e3)
            if st != 200 or json.loads(body) != want:
                raise AssertionError(f"GET /data of replica {r} != the oracle's fold of the "
                                     f"acknowledged writes")
        acked = sum(len(o.log) for o in oracles)
        metrics = http_call(urls[0] + "/metrics")[2].decode()
        counts = {
            "ops": series_sum(metrics, "crdt_ingest_ops_admitted_total", lane="kv"),
            "pages": series_sum(metrics, "crdt_ingest_pages_total"),
            "sheds": series_sum(metrics, "crdt_ingest_shed_total", lane="kv"),
            "duplicates": series_sum(metrics, "crdt_ingest_pages_duplicate_total"),
        }
        client = {"ops": HTTP_SINGLE + HTTP_BURST + pages["admitted"],
                  "pages": pages["pages"] + pages["sheds"], "sheds": pages["sheds"],
                  "duplicates": 0}
        if counts != client:
            raise AssertionError(f"/metrics ingest counters {counts} != the client's {client}")
        tally.check()
        launched = {name: hu.LAUNCHES[name] for name in hu.LAUNCHES}
        if launched != predicted:
            raise AssertionError(f"hand-kernel launches {launched} != predicted {predicted}")
        log(f"all 5 replicas' GET /data == the oracle's fold of {acked} acknowledged writes "
            f"({len(want)} keys); /metrics ingest counters == the client's {client}; "
            f"statuses {tally.statuses}; hand-kernel launches {launched} as predicted")
    finally:
        server.stop()
    del cluster

    # -- (d) the entry point, on the card --
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "-m", "crdt_tpu_torch", "--duration", "10",
                          "--ephemeral-ports", "--write-ms", "1"],
                         cwd=Path(__file__).resolve().parent, capture_output=True, text=True,
                         timeout=300)
    demo_s = time.perf_counter() - t0
    final = (out.stdout.strip().splitlines() or [""])[-1]
    if out.returncode != 0 or "converged=True" not in final:
        raise AssertionError(f"python -m crdt_tpu_torch exited {out.returncode}: {final!r} "
                             f"{out.stderr[-2000:]}")
    log(f"(d) python -m crdt_tpu_torch --duration 10 on the card: exit 0, {final!r} "
        f"({demo_s:.1f} s)")

    line = {
        "card": card,
        "post_data_ms_p50": quantile(lat, 0.5) * 1e3, "post_data_ms_p99": quantile(lat, 0.99) * 1e3,
        "single_writes_per_s": acked_single / single_s, "page_writes_per_s": HTTP_PAGE_WRITES / pages_s,
        "get_data_ms_p50": quantile(get_ms, 0.5), "get_gossip_vv_ms_p50": quantile(gossip_ms, 0.5),
        "pull_round_ms": statistics.median(pull_ms), "barrier_ms": statistics.median(barrier_ms),
        "burst": None if prof is None else {
            "posts": HTTP_BURST, "busy_share": 1 - prof["idle_share"], "wall_ms": prof["wall_ms"],
            "device_ops": prof["device_ops"]},
        "acked": acked, "planned_502": tally.planned_502, "pages": pages,
        "rounds": HTTP_ROUNDS + extra, "barriers": len(barrier_ms),
        "hand_kernel_launches": launched, "demo_s": demo_s,
        "phase_s": time.perf_counter() - t_phase,
    }
    log(f"phase 17: {line['phase_s']:.1f} s (budget {HTTP_BUDGET_S} s)")
    log(json.dumps({"http_surface": line}))
    return line


# ---- phase 18: the network daemon ----

NET_BUDGET_S = 120
NET_REPLICAS = 5
NET_SINGLE, NET_THREADS = 2_048, 8
NET_PAGE_WRITES, NET_PAGE = 129_024, 512
NET_CRASHED = 3                         # the daemon killed and restored
NET_STRIDE = 64                         # --rid-stride (the CLI default)
NET_BARRIER_EVERY = 8                   # /admin/barrier on daemon 0, in rounds
NET_MAX_ROUNDS = 64
NET_SOAK_STEPS, NET_SOAK_PAGED = 400, 0.25
NET_SNAP_WRITES = 16_384                # part (c)'s node
NET_RUN_DIR = "build/daemons"           # git-ignored: checkpoints, event logs


def free_ports(n: int) -> list:
    import socket

    socks = [socket.socket() for _ in range(n)]
    for s in socks:
        s.bind(("127.0.0.1", 0))
    ports = [s.getsockname()[1] for s in socks]
    for s in socks:
        s.close()
    return ports


class Daemons:
    """``python -m crdt_tpu_torch --daemon`` processes on the card, one per
    replica, each with its checkpoint dir, event log and stderr file under
    NET_RUN_DIR; daemon 0 coordinates (--compact-every 8); gossip every
    1500 ms, the reference's period.  ``extra`` is appended to every
    daemon's arguments."""

    def __init__(self, root, n: int, extra=()):
        self.root, self.n, self.extra = root, n, list(extra)
        self.ports = free_ports(n)
        self.urls = [f"http://127.0.0.1:{p}" for p in self.ports]
        self.procs = [None] * n
        self.boots = [0] * n

    def start(self, i: int):
        args = [sys.executable, "-m", "crdt_tpu_torch", "--daemon", "--rid", str(i),
                "--port", str(self.ports[i]),
                "--peers", ",".join(u for j, u in enumerate(self.urls) if j != i),
                "--checkpoint-dir", str(self.root / f"ckpt{i}"),
                "--event-log", str(self.root / f"events{i}.jsonl"),
                "--rid-stride", str(NET_STRIDE), "--gossip-ms", "1500"]
        if i == 0:
            args += ["--coordinator", "--compact-every", "8"]
        args += self.extra
        err = open(self.root / f"stderr{i}-{self.boots[i]}.txt", "w")
        self.boots[i] += 1
        self.procs[i] = subprocess.Popen(args, cwd=Path(__file__).resolve().parent,
                                         stdout=subprocess.PIPE, stderr=err, text=True)
        return self.procs[i]

    def serving(self, i: int) -> str:
        """The daemon's 'serving on' line (blocks until it prints)."""
        line = self.procs[i].stdout.readline()
        if " serving on " not in line:
            raise AssertionError(f"daemon {i} exited {self.procs[i].poll()} before serving: "
                                 f"{line!r}; stderr in {self.root}")
        return line.strip()

    def kill9(self, i: int) -> None:
        self.procs[i].kill()
        self.procs[i].wait(60)

    def stop(self) -> list:
        """SIGINT every live daemon (host.stop(), then exit 0); returns the
        exit codes."""
        import signal

        live = [p for p in self.procs if p is not None and p.poll() is None]
        for p in live:
            p.send_signal(signal.SIGINT)
        codes = []
        for p in self.procs:
            if p is None:
                continue
            try:
                codes.append(p.wait(120))
            except subprocess.TimeoutExpired:
                p.kill()
                codes.append(p.wait())
        return codes

    def failures(self, codes: list, lines: int = 30) -> str:
        """The end of the last boot's stderr of each daemon whose exit code
        is not 0 (``codes`` as :meth:`stop` returns them)."""
        live = [i for i, p in enumerate(self.procs) if p is not None]
        out = []
        for i, code in zip(live, codes):
            if code:
                err = self.root / f"stderr{i}-{self.boots[i] - 1}.txt"
                tail = err.read_text(errors="replace").splitlines()[-lines:]
                out.append(f"daemon {i} exited {code}; {err.name} ends:\n" + "\n".join(tail))
        return "\n".join(out)


def card_memory_by_pid() -> dict:
    """{pid: MiB} of the card's compute processes, as ``nvidia-smi
    --query-compute-apps`` lists them (its pids may be another pid
    namespace's than this process sees)."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-compute-apps=pid,used_memory",
                              "--format=csv,noheader,nounits"], capture_output=True,
                             text=True, timeout=30).stdout
    except (OSError, subprocess.SubprocessError):
        return {}
    mem = {}
    for line in out.splitlines():
        parts = [x.strip() for x in line.split(",")]
        if len(parts) == 2 and parts[0].isdigit():
            mem[int(parts[0])] = parts[1]
    return mem


def post_pages(urls, batches, tally, oracles) -> dict:
    """Each target daemon's commands as op pages of NET_PAGE from a client
    thread of its own (PageBuilder origin 1000 + target); a 429 backs off
    its Retry-After and resends the same page.  Every admitted page is
    mirrored into its target's oracle."""
    import threading

    out = {"admitted": [0] * len(urls), "pages": [0] * len(urls), "sheds": [0] * len(urls)}
    errors = []

    def client(target, cmds, builder):
        try:
            def send(raw, chunk):
                while True:
                    st, hdr, body, _ = http_call(urls[target] + "/ingest/page", "POST", raw,
                                                 {"Content-Type": "application/octet-stream"})
                    tally.note(st)
                    out["pages"][target] += 1
                    if st == 429:
                        out["sheds"][target] += 1
                        time.sleep(float(hdr.get("Retry-After", "0.05")))
                        continue
                    if st != 200 or json.loads(body)["admitted"] != len(chunk):
                        raise AssertionError(f"page to daemon {target}: {st} {body[:200]!r}")
                    out["admitted"][target] += len(chunk)
                    for i, cmd in chunk:
                        oracles[target].add_command(cmd, i)
                    return

            chunk = []
            for i, cmd in cmds:
                ((key, value),) = cmd.items()
                chunk.append((i, cmd))
                raw = builder.add(key, value)
                if raw is not None:
                    send(raw, chunk)
                    chunk = []
            raw = builder.flush()
            if raw is not None:
                send(raw, chunk)
        except BaseException as e:  # re-raised on the main thread
            errors.append(e)

    threads = [threading.Thread(target=client, args=(t, cmds, b))
               for t, (cmds, b) in batches.items() if cmds]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    if errors:
        raise errors[0]
    return out


def net_phase_daemons(card: str, root) -> dict:
    """Phase 18 (a): five daemon processes, 131,072 writes, a kill -9 and
    a restore, convergence, and the checks."""
    from urllib.parse import quote

    from crdt_tpu_torch import workload
    from crdt_tpu_torch.ingest import PageBuilder
    from crdt_tpu_torch.obs.events import read_jsonl
    from crdt_tpu_torch.oracle import OracleReplica, Quirks
    from crdt_tpu_torch.utils.config import ClusterConfig

    n = NET_REPLICAS
    fleet = Daemons(root, n)
    oracles = [OracleReplica(r, Quirks()) for r in range(n)]
    tally = HttpTally()
    gen = workload.WorkloadGenerator(ClusterConfig())  # seed 0
    # client-side counts per daemon boot: the ingest counters a daemon's
    # /metrics must equal (a restarted daemon's registry starts at 0)
    acked = [0] * n
    out = {}
    free_before = torch.cuda.mem_get_info()[0]
    try:
        t0 = time.perf_counter()
        for i in range(n):
            fleet.start(i)
        lines = [fleet.serving(i) for i in range(n)]
        out["boot_s"] = time.perf_counter() - t0
        for i, line in enumerate(lines):
            if f"rid={i} (base {i}, incarnation 0, restored=False)" not in line:
                raise AssertionError(f"daemon {i}: {line}")
        log(f"(a) {n} daemons serving in {out['boot_s']:.2f} s: {fleet.urls}")

        half = (NET_SINGLE + NET_PAGE_WRITES) // 2
        writes = [(i, *gen.next_command()) for i in range(NET_SINGLE + NET_PAGE_WRITES)]
        # -- single-op POST /data from 8 threads (the first half of the stream) --
        single = writes[:NET_SINGLE]
        t0 = time.perf_counter()
        lat = post_writes(fleet.urls, single, tally, oracles)
        out["single_s"] = time.perf_counter() - t0
        for _, _, target in single:
            acked[target] += 1
        log(f"    {NET_SINGLE} single-op POST /data from {NET_THREADS} threads: "
            f"{NET_SINGLE / out['single_s']:.1f} acknowledged writes/s, p50 "
            f"{quantile(lat, 0.5) * 1e3:.3f} ms, p99 {quantile(lat, 0.99) * 1e3:.3f} ms [{card}]")

        def pages(batch):
            by_target = {t: [] for t in range(n)}
            for i, cmd, target in batch:
                by_target[target].append((i, cmd))
            return {t: (cmds, builders[t]) for t, cmds in by_target.items()}

        builders = [PageBuilder(origin=1000 + t, page_size=NET_PAGE) for t in range(n)]
        paged_s, page_out = 0.0, []
        t0 = time.perf_counter()
        page_out.append(post_pages(fleet.urls, pages(writes[NET_SINGLE:half]), tally,
                                   oracles))
        paged_s += time.perf_counter() - t0
        for t in range(n):
            acked[t] += page_out[-1]["admitted"][t]

        # -- daemon 3: checkpoint, kill -9, restart on the same dir --
        st, _, body, sec = http_call(fleet.urls[NET_CRASHED] + "/admin/checkpoint", "POST",
                                     b"{}")
        tally.note(st)
        if st != 200:
            raise AssertionError(f"/admin/checkpoint: {st} {body!r}")
        snap = Path(json.loads(body)["snapshot"])
        out["checkpoint_ms"] = sec * 1e3
        out["snapshot_bytes"] = sum(f.stat().st_size for f in snap.iterdir())
        fleet.kill9(NET_CRASHED)
        t0 = time.perf_counter()
        fleet.start(NET_CRASHED)
        line = fleet.serving(NET_CRASHED)
        out["restart_to_serving_s"] = time.perf_counter() - t0
        want_rid = NET_CRASHED + NET_STRIDE
        if f"rid={want_rid} (base {NET_CRASHED}, incarnation 1, restored=True)" not in line:
            raise AssertionError(f"restarted daemon {NET_CRASHED}: {line}")
        st = http_call(fleet.urls[NET_CRASHED] + "/ping")[0]
        tally.note(st)
        if st != 200:
            raise AssertionError(f"restarted daemon's /ping: {st}")
        acked[NET_CRASHED] = 0  # its new registry counts from its reboot
        log(f"    daemon {NET_CRASHED}: /admin/checkpoint {out['checkpoint_ms']:.3f} ms "
            f"({out['snapshot_bytes']} bytes), kill -9, restarted serving in "
            f"{out['restart_to_serving_s']:.2f} s at incarnation 1 (rid {want_rid}), restored")

        # -- the second half, every daemon (the restarted one included) --
        t_restart = time.perf_counter()
        t0 = time.perf_counter()
        page_out.append(post_pages(fleet.urls, pages(writes[half:]), tally, oracles))
        paged_s += time.perf_counter() - t0
        for t in range(n):
            acked[t] += page_out[-1]["admitted"][t]
        if page_out[-1]["admitted"][NET_CRASHED] == 0:
            raise AssertionError("the restarted daemon took no writes")
        sheds = sum(sum(p["sheds"]) for p in page_out)
        out["paged_s"] = paged_s
        log(f"    {NET_PAGE_WRITES} writes in op pages of {NET_PAGE} (one client thread a "
            f"daemon): {NET_PAGE_WRITES / paged_s:.1f} acknowledged writes/s, {sheds} sheds "
            f"backed off [{card}]")

        # -- convergence: /admin/pull rounds, a barrier every 8 --
        pull_ms, barrier_ms, client_pulls = [], [], [0] * n
        rounds = 0
        want = OracleReplica.converged_state(oracles)
        while True:
            states = []
            for u in fleet.urls:
                st, _, body, _ = http_call(u + "/data")
                tally.note(st)
                states.append(json.loads(body))
            if all(s == states[0] for s in states):
                break
            if rounds == NET_MAX_ROUNDS:
                raise AssertionError(f"no convergence in {NET_MAX_ROUNDS} rounds")
            for i, u in enumerate(fleet.urls):
                st, _, body, sec = http_call(u + "/admin/pull", "POST", b"{}")
                tally.note(st)
                if st != 200:
                    raise AssertionError(f"/admin/pull on daemon {i}: {st} {body!r}")
                pull_ms.append(sec * 1e3)
                client_pulls[i] += 1
            rounds += 1
            if rounds % NET_BARRIER_EVERY == 0:
                st, _, body, sec = http_call(fleet.urls[0] + "/admin/barrier", "POST", b"{}")
                tally.note(st)
                barrier_ms.append(sec * 1e3)
        out["converge_rounds"] = rounds
        out["converge_s"] = time.perf_counter() - t_restart
        # a final barrier, and one pull each so every member adopts it
        st, _, body, sec = http_call(fleet.urls[0] + "/admin/barrier", "POST", b"{}")
        tally.note(st)
        barrier_ms.append(sec * 1e3)
        for i, u in enumerate(fleet.urls):
            st = http_call(u + "/admin/pull", "POST", b"{}")[0]
            tally.note(st)
            client_pulls[i] += 1
        log(f"    converged {rounds} /admin/pull rounds after the restart "
            f"({out['converge_s']:.2f} s after it, the second half's writes included); "
            f"/admin/pull p50 {quantile(pull_ms, 0.5):.3f} ms p99 "
            f"{quantile(pull_ms, 0.99):.3f} ms, /admin/barrier median "
            f"{statistics.median(barrier_ms):.3f} ms over {len(barrier_ms)} [{card}]")

        # -- every acknowledged write from all five --
        for i, u in enumerate(fleet.urls):
            st, _, body, _ = http_call(u + "/data")
            tally.note(st)
            if st != 200 or json.loads(body) != want:
                raise AssertionError(f"GET /data of daemon {i} != the oracle's fold of the "
                                     "acknowledged writes")
        n_acked = sum(len(o.log) for o in oracles)
        if n_acked != NET_SINGLE + NET_PAGE_WRITES:
            raise AssertionError(f"{n_acked} writes acknowledged of "
                                 f"{NET_SINGLE + NET_PAGE_WRITES}")
        # -- the audit reports and the stability headers' digests --
        by_frontier = {}
        for i, u in enumerate(fleet.urls):
            st, _, body, _ = http_call(u + "/audit")
            tally.note(st)
            rep = json.loads(body)
            if rep["state"] == 2 or rep["divergences"] or rep["scrub_drifts"]:
                raise AssertionError(f"daemon {i}'s audit report: {rep}")
            st, hdr, _, _ = http_call(u + "/gossip?vv=" + quote(json.dumps({})))
            tally.note(st)
            summary = json.loads(hdr["X-CRDT-Stability"])
            by_frontier.setdefault(json.dumps(summary["frontier"], sort_keys=True),
                                   []).append(summary["digest"])
        if any(len(set(d)) != 1 for d in by_frontier.values()) or \
                max(len(d) for d in by_frontier.values()) < 2:
            raise AssertionError(f"stability-header digests at equal frontiers: {by_frontier}")
        # -- the /metrics counters --
        gossip_total = 0
        for i, u in enumerate(fleet.urls):
            st, _, body, _ = http_call(u + "/metrics")
            tally.note(st)
            text = body.decode()
            ops = series_sum(text, "crdt_ingest_ops_admitted_total", lane="kv")
            if ops != acked[i]:
                raise AssertionError(f"daemon {i}: ingest ops admitted {ops} != the client's "
                                     f"{acked[i]}")
            outcomes = {k: series_sum(text, f"crdt_net_gossip_{k}_total")
                        for k in ("rounds", "noop", "skipped", "quarantined")}
            # the crashed daemon's log spans both boots: count this boot's
            recs = read_jsonl(str(root / f"events{i}.jsonl"))
            last_boot = max(k for k, e in enumerate(recs) if e.get("event") == "boot")
            events = [e for e in recs[last_boot:] if e.get("event") in (
                "pull_merge", "pull_noop", "pull_skip", "payload_quarantine")]
            if sum(outcomes.values()) != len(events) or outcomes["quarantined"]:
                raise AssertionError(f"daemon {i}: net_gossip outcomes {outcomes} vs "
                                     f"{len(events)} round events in its log")
            if sum(outcomes.values()) < client_pulls[i]:
                raise AssertionError(f"daemon {i}: {outcomes} below the client's "
                                     f"{client_pulls[i]} pulls")
            gossip_total += sum(outcomes.values())
        tally.check()
        # the card's memory in use by the five daemons, all told (this
        # process's own allocations do not change across the window)
        out["card_mib_all_daemons"] = (free_before - torch.cuda.mem_get_info()[0]) / 2**20
        mem = card_memory_by_pid()
        out["card_mib"] = {str(i): mem.get(p.pid) for i, p in enumerate(fleet.procs)}
        if not any(out["card_mib"].values()):
            # nvidia-smi names its processes by pids of another namespace:
            # every compute process's MiB, this one's among them
            out["card_mib"] = {"by_process": sorted(mem.values(), key=float),
                               "this_process_allocated": torch.cuda.memory_allocated() >> 20}
        log(f"    all {n} GET /data == the oracle's fold of {n_acked} acknowledged writes "
            f"({len(want)} keys); audits clean; digests equal at each frontier "
            f"({[len(d) for d in by_frontier.values()]} daemons a frontier); /metrics "
            f"ingest ops == the client's per "
            f"daemon; net_gossip outcomes == the event logs' ({gossip_total}, client pulls "
            f"{sum(client_pulls)}); statuses {tally.statuses}; card memory "
            f"{out['card_mib_all_daemons']:.0f} MiB for the {n} daemons, by process "
            f"{out['card_mib']} MiB")
        out.update({
            "single_writes_per_s": NET_SINGLE / out["single_s"],
            "paged_writes_per_s": NET_PAGE_WRITES / paged_s,
            "post_data_ms_p50": quantile(lat, 0.5) * 1e3,
            "post_data_ms_p99": quantile(lat, 0.99) * 1e3,
            "pull_ms_p50": quantile(pull_ms, 0.5), "pull_ms_p99": quantile(pull_ms, 0.99),
            "barrier_ms": statistics.median(barrier_ms), "acked": n_acked,
            "sheds": sheds, "statuses": {str(k): v for k, v in tally.statuses.items()},
        })
    finally:
        codes = fleet.stop()
    if any(c != 0 for c in codes):
        raise AssertionError(f"daemon exit codes {codes} (a nonzero code: a failure raised by "
                             f"stop(); stderr in {root})\n{fleet.failures(codes)}")
    return out


def net_phase_soak(card: str) -> dict:
    """Phase 18 (b): one NetworkSoakRunner on the card (5 replicas, seed 0,
    400 steps, a quarter of the writes as op pages), healed and checked by
    its oracle; no hand kernel launched."""
    from crdt_tpu_torch.harness.soak import NetworkSoakRunner
    from crdt_tpu_torch.ops import hopper_union as hu

    for name in hu.LAUNCHES:
        hu.LAUNCHES[name] = 0
    t0 = time.perf_counter()
    runner = NetworkSoakRunner(n=NET_REPLICAS, seed=0, p_page=NET_SOAK_PAGED)
    if runner.hosts[0].node.log.ts.device.type != "cuda":
        raise AssertionError("NetworkSoakRunner's hosts are not on the card")
    report = runner.run(NET_SOAK_STEPS)
    soak_s = time.perf_counter() - t0
    launched = {k: v for k, v in hu.LAUNCHES.items() if v}
    if launched:
        raise AssertionError(f"the soak launched hand kernels {launched}; predicted none")
    log(f"(b) {report} ({soak_s:.2f} s on the card); no hand kernel launched, as predicted")
    return {"soak_s": soak_s, "steps": report.steps, "writes": report.writes_accepted,
            "pages": report.pages_admitted, "kills": report.kills,
            "rounds_to_converge": report.rounds_to_converge}


def net_phase_restore(card: str, root) -> dict:
    """Phase 18 (c): a snapshot written by a port node on the card restores
    into a fresh node on the card with equal state, vv, frontier, summary
    and audit digest; a corrupted log.npz generation is quarantined by
    load_latest_node and the generation before it restored."""
    from crdt_tpu_torch import workload
    from crdt_tpu_torch.api.node import ReplicaNode
    from crdt_tpu_torch.obs import audit
    from crdt_tpu_torch.utils import checkpoint as ckpt
    from crdt_tpu_torch.utils.config import ClusterConfig

    def view(node):
        return (node.get_state(), node.version_vector(), node.frontier, node._summary,
                node._seq.count, audit.store_digest_hex(node))

    gen = workload.WorkloadGenerator(ClusterConfig(), seed=18)
    node = ReplicaNode(rid=2)  # the card
    half = NET_SNAP_WRITES // 2
    node.add_commands([gen.next_command()[0] for _ in range(half)])
    node.compact({2: half // 2 - 1})
    d = root / "restore"
    t0 = time.perf_counter()
    ckpt.save_node_atomic(str(d), node)
    save_ms = (time.perf_counter() - t0) * 1e3
    gen0 = view(node)
    node.add_commands([gen.next_command()[0] for _ in range(half)])
    ckpt.save_node_atomic(str(d), node)
    fresh = ReplicaNode(rid=2)
    t0 = time.perf_counter()
    if not ckpt.load_latest_node(str(d), fresh):
        raise AssertionError("no snapshot restored")
    restore_ms = (time.perf_counter() - t0) * 1e3
    if view(fresh) != view(node) or fresh.log.ts.device.type != "cuda":
        raise AssertionError("the restored node != the node that wrote the snapshot")
    raw = bytearray((d / "snap-00000001" / "log.npz").read_bytes())
    raw[len(raw) // 2] ^= 0xFF
    (d / "snap-00000001" / "log.npz").write_bytes(bytes(raw))
    older = ReplicaNode(rid=2)
    if not ckpt.load_latest_node(str(d), older) or view(older) != gen0:
        raise AssertionError("the corrupted generation was not replaced by the one before it")
    quarantined = [e["snap"] for e in older.events.find(event="snapshot_quarantine")]
    if quarantined != ["snap-00000001"] or not (d / "quarantine-snap-00000001").is_dir():
        raise AssertionError(f"quarantine events {quarantined}")
    log(f"(c) a port snapshot of {NET_SNAP_WRITES} writes on the card (save "
        f"{save_ms:.3f} ms, restore {restore_ms:.3f} ms) == the writer in state, vv, frontier, "
        f"summary and digest; the corrupted generation quarantined and the one before "
        f"restored [{card}]")
    return {"save_ms": save_ms, "restore_ms": restore_ms}


def net_phase(card: str) -> dict:
    """Phase 18: the network daemon on the card, then one
    {"network_daemon": ...} JSON line."""
    import shutil

    t_phase = time.perf_counter()
    log(f"phase 18 (the network daemon): budget {NET_BUDGET_S} s")
    root = Path(__file__).resolve().parent / NET_RUN_DIR
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    line = {"card": card}
    line["daemons"] = net_phase_daemons(card, root)
    line["soak"] = net_phase_soak(card)
    line["restore"] = net_phase_restore(card, root)
    line["phase_s"] = time.perf_counter() - t_phase
    log(f"phase 18: {line['phase_s']:.1f} s (budget {NET_BUDGET_S} s)")
    log(json.dumps({"network_daemon": line}))
    return line


# ---- phase 19: the keyspace tier ----

KS_BUDGET_S = 240
KS_REPLICAS = 5
KS_SHARDS, KS_TARGET = 64, 128          # the million-key tier, resharded 64 -> 128
# benches/bench_keyspace.py's million-key walk, cut to a 32nd: at
# 1,000,000 writes (and 65,536 through the window) the writes alone took
# 373 s of the 240 s budget and the reshard's start passed 120 s; at
# 125,000 the phase took 303 s in the whole smoke, at 62,500 186-231 s
# and the smoke past its 900 s aim (PERF.md §4)
KS_WRITES = 31_250
KS_WINDOW_WRITES = 4_096                # written through the open reshard window
KS_PAGE = 512
KS_TENANTS = ("t-acme", "t-bolt", "t-crab", "t-dune")
KS_LEVELS = ("eventual", "session", "bounded", "linearizable")
KS_READS = 512                          # a level
KS_READ_KEYS = 16                       # host-plane keys the reads ask for
KS_CAS_THREADS, KS_CAS_EACH, KS_CAS_KEYS = 8, 64, 16
KS_CRASHED = 3
KS_MAX_ROUNDS = 16
KS_RUN_DIR = "build/keyspace"           # git-ignored: checkpoints, event logs
KS_ALL_RIDS = 256                       # a vv query past every writer's seq


def ks_stream(n_ops: int, seed: int, first: int = 0) -> list:
    """(tenant, key, value) writes with benches/bench_keyspace.py's shape (own
    copy: the smoke imports nothing of the JAX package): key ``u%06d`` from
    the coprime walk ``i * 999,983 mod 10^6`` (every key of the first
    million written once), the tenant drawn uniformly from KS_TENANTS by
    ``random.Random(seed)``."""
    import random

    rng = random.Random(seed)
    out = []
    for i in range(first, first + n_ops):
        idx = (i * 999_983) % 1_000_000
        out.append((KS_TENANTS[rng.randrange(len(KS_TENANTS))], f"u{idx:06d}",
                    f"v{idx:06d}" if first == 0 else f"w{idx:06d}"))
    return out


def ks_post_pages(urls, writes, tally, origin: int) -> dict:
    """Write i goes to daemon i mod n, from one client thread a daemon, as
    tenant-scoped op pages of KS_PAGE (a PageBuilder a tenant and daemon,
    ``X-CRDT-Tenant``); a 429 backs off its Retry-After and resends the
    same page.  ``origin`` numbers the builders' writer streams (a page
    watermark is per origin).  Returns the pages, back-offs and per-page
    seconds."""
    import threading

    from crdt_tpu_torch.ingest import PageBuilder

    n = len(urls)
    out = {"pages": 0, "backoffs": 0, "page_s": []}
    lock, errors = threading.Lock(), []

    def client(t):
        try:
            builders = {tn: PageBuilder(origin=origin + 16 * t + k, page_size=KS_PAGE)
                        for k, tn in enumerate(KS_TENANTS)}
            pending = {tn: 0 for tn in KS_TENANTS}

            def send(tenant, raw):
                while True:
                    st, hdr, body, sec = http_call(
                        urls[t] + "/ingest/page", "POST", raw,
                        {"Content-Type": "application/octet-stream",
                         "X-CRDT-Tenant": tenant})
                    tally.note(st)
                    if st == 429:
                        with lock:
                            out["backoffs"] += 1
                        time.sleep(float(hdr.get("Retry-After", "0.05")))
                        continue
                    got = json.loads(body) if st == 200 else None
                    if got is None or got["admitted"] != pending[tenant] or got["dup"]:
                        raise AssertionError(f"page to daemon {t}: {st} {body[:200]!r}")
                    with lock:
                        out["pages"] += 1
                        out["page_s"].append(sec)
                    pending[tenant] = 0
                    return

            for tenant, key, value in writes[t::n]:
                pending[tenant] += 1
                raw = builders[tenant].add(key, value)
                if raw is not None:
                    send(tenant, raw)
            for tenant, b in builders.items():
                raw = b.flush()
                if raw is not None:
                    send(tenant, raw)
        except BaseException as e:  # re-raised on the main thread
            errors.append(e)

    threads = [threading.Thread(target=client, args=(t,)) for t in range(n)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    if errors:
        raise errors[0]
    return out


def ks_each(urls, fn) -> list:
    """fn(i, url) on every daemon at once (a thread each); the results in
    daemon order."""
    import threading

    res, errors = [None] * len(urls), []

    def run(i):
        try:
            res[i] = fn(i, urls[i])
        except BaseException as e:
            errors.append(e)

    threads = [threading.Thread(target=run, args=(i,)) for i in range(len(urls))]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    if errors:
        raise errors[0]
    return res


def ks_converge(urls, fold, tally, label: str, card: str) -> dict:
    """``POST /admin/ks_pull`` rounds (every daemon pulls every peer, the
    daemons at once) until every daemon's ``GET /ks/data?tenant=T`` == the
    client's fold of T for all four tenants; then every shard's vv is
    equal on all daemons and every key sits at exactly one shard (the
    shards' key counts sum to the fold's keys).  Returns the rounds,
    seconds, pull latencies and per-daemon shard stats."""
    from urllib.parse import quote

    n_keys = sum(len(f) for f in fold.values())
    pull_ms, rounds = [], 0
    t0 = time.perf_counter()

    def pull(i, u):
        ms = []
        for j, v in enumerate(urls):
            if j == i:
                continue
            st, _, body, sec = http_call(u + "/admin/ks_pull", "POST",
                                         json.dumps({"peer": v}).encode())
            tally.note(st)
            if st != 200:
                raise AssertionError(f"/admin/ks_pull on daemon {i}: {st} {body!r}")
            ms.append(sec * 1e3)
        return ms

    def stats(i, u):
        st, _, body, _ = http_call(u + "/ks/data")
        tally.note(st)
        return json.loads(body)["shards"]

    def tenants_equal(i, u):
        for t in KS_TENANTS:
            st, _, body, _ = http_call(u + "/ks/data?tenant=" + t)
            tally.note(st)
            got = json.loads(body)
            if st != 200 or got["tenant"] != t or got["state"] != fold[t]:
                return False
        return True

    while True:
        if rounds == KS_MAX_ROUNDS:
            raise AssertionError(f"{label}: no convergence in {KS_MAX_ROUNDS} rounds")
        for ms in ks_each(urls, pull):
            pull_ms += ms
        rounds += 1
        shard_stats = ks_each(urls, stats)
        if any(s != shard_stats[0] for s in shard_stats):
            continue
        if sum(s["keys"] for s in shard_stats[0]) != n_keys:
            continue
        if all(ks_each(urls, tenants_equal)):
            break
    converge_s = time.perf_counter() - t0
    # every shard's vv on every daemon (a vv query past every writer: the
    # payload is empty, the body carries the shard's vv)
    since = quote(json.dumps({str(r): 2**31 - 1 for r in range(KS_ALL_RIDS)}))

    def vvs(i, u):
        out = []
        for s in range(len(shard_stats[0])):
            st, _, body, _ = http_call(u + f"/ks/gossip?shard={s}&vv={since}"
                                       + (f"&epoch={epoch_of[i]}"))
            tally.note(st)
            if st != 200:
                raise AssertionError(f"/ks/gossip shard {s} on daemon {i}: {st} {body!r}")
            out.append(json.loads(body)["vv"])
        return out

    epoch_of = []
    for u in urls:
        st, _, body, _ = http_call(u + "/admin/ks_reshard", "POST", b'{"action": "status"}')
        tally.note(st)
        epoch_of.append(json.loads(body)["epoch"])
    by_daemon = ks_each(urls, vvs)
    if any(v != by_daemon[0] for v in by_daemon):
        raise AssertionError(f"{label}: shard vvs differ across the daemons")
    log(f"    {label}: converged in {rounds} /admin/ks_pull rounds, {converge_s:.2f} s "
        f"(pull p50 {quantile(pull_ms, 0.5):.3f} ms p99 {quantile(pull_ms, 0.99):.3f} ms); "
        f"all {len(urls)} GET /ks/data?tenant= == the client's fold for {len(KS_TENANTS)} "
        f"tenants ({n_keys} keys), every shard's vv equal on all {len(urls)} "
        f"({len(shard_stats[0])} shards), every key at one shard [{card}]")
    return {"rounds": rounds, "seconds": converge_s, "pull_ms": pull_ms,
            "shard_stats": shard_stats[0], "epochs": epoch_of}


def ks_metric_map(text: str, name: str) -> dict:
    """{label string: value} of every series ``name`` in a Prometheus text."""
    out = {}
    for line in text.splitlines():
        if line.startswith(name + "{"):
            key, value = line.rsplit(" ", 1)
            out[key[len(name):]] = float(value)
    return out


def ks_fences(urls, tally) -> list:
    """Each daemon's {slot: highest known fence}, from its /metrics."""
    import re

    out = []
    for u in urls:
        st, _, body, _ = http_call(u + "/metrics")
        tally.note(st)
        fences = {}
        for key, v in ks_metric_map(body.decode(), "crdt_lease_fence_epoch").items():
            fences[int(re.search(r'slot="(\d+)"', key).group(1))] = int(v)
        out.append(fences)
    return out


def ks_strong_ops(urls, tally, card: str) -> dict:
    """Phase 19 (c): reads at the four levels and concurrent CAS increments
    over the five daemons' consistency planes and leases."""
    import random
    import threading

    from urllib.parse import quote

    n = len(urls)
    # host-plane keys for the reads, written on daemon 0; the last write's
    # token covers them all (one writer, seqs in order)
    read_keys = {f"r{k:02d}": f"x{k}" for k in range(KS_READ_KEYS)}
    token = None
    for k, v in read_keys.items():
        st, hdr, body, _ = http_call(urls[0] + "/data", "POST", json.dumps({k: v}).encode())
        tally.note(st)
        if st != 200:
            raise AssertionError(f"POST /data {k}: {st} {body!r}")
        token = hdr["X-CRDT-Session-Token"]
    refusals = []     # (op, reason) of every 503 the client saw
    read_ms = {}
    rng = random.Random(19)
    for level in KS_LEVELS:
        lat = []
        for _ in range(KS_READS):
            d = rng.randrange(n)
            key = f"r{rng.randrange(KS_READ_KEYS):02d}"
            hdrs = {"X-CRDT-Session-Token": token} if level == "session" else {}
            st, _, body, sec = http_call(urls[d] + f"/read?key={quote(key)}&level={level}",
                                         headers=hdrs)
            lat.append(sec)
            if st == 503:
                got = json.loads(body)
                refusals.append((got["op"], got["reason"]))
                continue
            tally.note(st)
            got = json.loads(body)
            if st != 200 or got["key"] != key or got["level"] != level:
                raise AssertionError(f"/read {key} {level} at daemon {d}: {st} {body!r}")
            # eventual and bounded reads may trail; session and
            # linearizable reads must see the write
            fresh = level in ("session", "linearizable")
            if got["value"] != read_keys[key] and (fresh or got["value"] is not None):
                raise AssertionError(f"/read {key} {level} at daemon {d}: {got}")
        read_ms[level] = {"p50": quantile(lat, 0.5) * 1e3, "p99": quantile(lat, 0.99) * 1e3}

    fences0 = ks_fences(urls, tally)
    keys = [f"c{k:02d}" for k in range(KS_CAS_KEYS)]
    lock, errors = threading.Lock(), []
    wins = {k: 0 for k in keys}
    maybe = {k: 0 for k in keys}        # indeterminate 503s: minted, not acked
    n409 = [0]

    def client(t):
        try:
            trng = random.Random(1000 + t)
            seen = {}
            for _ in range(KS_CAS_EACH):
                key = keys[trng.randrange(len(keys))]
                d = trng.randrange(n)
                expect = seen.get(key)
                # non-numeric values: the store sums numeric ones
                update = f"n{int(expect[1:]) + 1 if expect else 1}"
                st, hdr, body, _ = http_call(urls[d] + "/cas", "POST", json.dumps(
                    {"key": key, "expect": expect, "update": update}).encode())
                got = json.loads(body)
                with lock:
                    if st == 200:
                        tally.note(st)
                        wins[key] += 1
                        seen[key] = update
                        if "X-CRDT-Session-Token" not in hdr or not got["token"]:
                            raise AssertionError(f"CAS 200 without its token: {got}")
                    elif st == 409:
                        tally.note(st)
                        n409[0] += 1
                        if not got.get("conflict") or got["key"] != key \
                                or got["actual"] == expect or not got.get("coordinator"):
                            raise AssertionError(f"CAS 409 body {got} for expect {expect!r}")
                        seen[key] = got["actual"]
                    elif st == 503:
                        refusals.append((got["op"], got["reason"]))
                        if got.get("indeterminate"):
                            maybe[key] += 1
                    else:
                        raise AssertionError(f"CAS at daemon {d}: {st} {body!r}")
        except BaseException as e:
            errors.append(e)

    t0 = time.perf_counter()
    threads = [threading.Thread(target=client, args=(t,)) for t in range(KS_CAS_THREADS)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    cas_s = time.perf_counter() - t0
    if errors:
        raise errors[0]
    for key in keys:
        st, _, body, _ = http_call(urls[0] + f"/read?key={key}&level=linearizable")
        tally.note(st)
        value = json.loads(body)["value"]
        value = 0 if value is None else int(value[1:])
        if not wins[key] <= value <= wins[key] + maybe[key]:
            raise AssertionError(f"{key}: value {value} after {wins[key]} CAS 200s "
                                 f"({maybe[key]} indeterminate)")
    fences1 = ks_fences(urls, tally)
    for i, (a, b) in enumerate(zip(fences0, fences1)):
        if any(b.get(s, 0) < f for s, f in a.items()):
            raise AssertionError(f"daemon {i}'s fences went down: {a} -> {b}")
    n_cas = KS_CAS_THREADS * KS_CAS_EACH
    log(f"(c) {KS_READS} reads a level: " + ", ".join(
        f"{lv} p50 {read_ms[lv]['p50']:.3f} ms p99 {read_ms[lv]['p99']:.3f} ms"
        for lv in KS_LEVELS) + f"; {n_cas} CAS increments from {KS_CAS_THREADS} threads on "
        f"{KS_CAS_KEYS} keys: {n_cas / cas_s:.1f} CAS/s, {sum(wins.values())} 200s, "
        f"{n409[0]} 409s, {len(refusals)} 503s; every key's value == its 200s [{card}]")
    return {"read_ms": read_ms, "cas_per_s": n_cas / cas_s, "cas_200": sum(wins.values()),
            "cas_409": n409[0], "refusals": refusals, "fences": fences1}


def ks_check_events(root, n: int, refusals: list) -> dict:
    """Every 503 the client saw is one ``consistency_unavailable`` event in
    the deciding daemon's log (matched fleet-wide by (op, reason): a
    forwarded refusal is re-raised at its origin without a second event),
    and no (slot, fence) was committed by two daemons."""
    from crdt_tpu_torch.obs.events import read_jsonl

    events, commits = [], {}
    for i in range(n):
        for e in read_jsonl(str(root / f"events{i}.jsonl")):
            if e.get("event") == "consistency_unavailable":
                events.append((e["op"], e["reason"]))
            elif e.get("event") == "cas_commit":
                for s, f in e["fences"].items():
                    commits.setdefault((s, f), set()).add(i)
    if sorted(events) != sorted(refusals):
        raise AssertionError(f"503s {sorted(refusals)} != consistency_unavailable events "
                             f"{sorted(events)}")
    shared = {k: v for k, v in commits.items() if len(v) > 1}
    if not commits or shared:
        raise AssertionError(f"CAS commits by (slot, fence): {commits}")
    return {"commits": sum(1 for _ in commits), "unavailable_events": len(events)}


def ks_phase(card: str) -> dict:
    """Phase 19: the keyspace tier on the card, then one {"keyspace_tier": ...}
    JSON line."""
    import shutil

    t_phase = time.perf_counter()
    log(f"phase 19 (the keyspace tier): budget {KS_BUDGET_S} s")
    root = Path(__file__).resolve().parent / KS_RUN_DIR
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    n = KS_REPLICAS
    fleet = Daemons(root, n, extra=["--keyspace-shards", str(KS_SHARDS)])
    tally = HttpTally()
    fold = {t: {} for t in KS_TENANTS}
    line = {"card": card, "writes": KS_WRITES, "window_writes": KS_WINDOW_WRITES,
            "shards": KS_SHARDS, "target": KS_TARGET, "daemons": n}
    free_before = torch.cuda.mem_get_info()[0]
    try:
        t0 = time.perf_counter()
        for i in range(n):
            fleet.start(i)
        for i in range(n):
            fleet.serving(i)
        line["boot_s"] = time.perf_counter() - t0
        log(f"(a) {n} daemons with {KS_SHARDS} shards each serving in "
            f"{line['boot_s']:.2f} s")

        # -- (a) the million-key writes --
        writes = ks_stream(KS_WRITES, 0)
        t0 = time.perf_counter()
        got = ks_post_pages(fleet.urls, writes, tally, origin=2000)
        line["write_s"] = time.perf_counter() - t0
        for tenant, key, value in writes:
            fold[tenant][key] = value
        line["writes_per_s"] = KS_WRITES / line["write_s"]
        line["backoffs_429"] = got["backoffs"]
        log(f"    {KS_WRITES} writes in tenant op pages of {KS_PAGE} ({got['pages']} pages, "
            f"one client thread a daemon): {line['writes_per_s']:.1f} acknowledged "
            f"writes/s, page p50 {quantile(got['page_s'], 0.5) * 1e3:.3f} ms, "
            f"{got['backoffs']} 429 back-offs [{card}]")

        # -- (b) convergence --
        conv = ks_converge(fleet.urls, fold, tally, "(b)", card)
        ops = sum(s["ops"] for s in conv["shard_stats"])
        if ops != KS_WRITES:
            raise AssertionError(f"(b): the shards hold {ops} ops, {KS_WRITES} written")
        line.update({"converge_rounds": conv["rounds"], "converge_s": conv["seconds"],
                     "pull_ms_p50": quantile(conv["pull_ms"], 0.5),
                     "pull_ms_p99": quantile(conv["pull_ms"], 0.99)})
        line["card_mib_all_daemons"] = (free_before - torch.cuda.mem_get_info()[0]) / 2**20

        # -- (c) strong reads, CAS, fences --
        strong = ks_strong_ops(fleet.urls, tally, card)
        ev = ks_check_events(root, n, strong["refusals"])
        line.update({"read_ms": strong["read_ms"], "cas_per_s": strong["cas_per_s"],
                     "cas_200": strong["cas_200"], "cas_409": strong["cas_409"],
                     "cas_503": len(strong["refusals"]), "cas_commits": ev["commits"]})
        log(f"    every 503 == a consistency_unavailable event ({ev['unavailable_events']}); "
            f"{ev['commits']} (slot, fence) commits, none by two daemons; fences monotone")

        # -- (d) online reshard 64 -> 128 with writes through the window --
        def reshard(action: str, check):
            def one(i, u):
                st, _, body, _ = http_call(u + "/admin/ks_reshard", "POST", json.dumps(
                    {"action": action, "shards": KS_TARGET}).encode())
                tally.note(st)
                out = json.loads(body) if st == 200 else None
                if out is None or not check(out):
                    raise AssertionError(f"reshard {action} on daemon {i}: {st} {body!r}")
                return out
            return ks_each(fleet.urls, one)  # every daemon at once

        t0 = time.perf_counter()
        started = reshard("start", lambda o: o["phase"] == "migrate"
                          and o["target"] == KS_TARGET)
        line["reshard_moved"] = started[0]["moved"]
        window = ks_stream(KS_WINDOW_WRITES, 1, first=KS_WRITES)
        tw = time.perf_counter()
        ks_post_pages(fleet.urls, window, tally, origin=3000)
        line["window_write_s"] = time.perf_counter() - tw
        for tenant, key, value in window:
            fold[tenant][key] = value
        streams = reshard("stream", lambda o: o["ok"] == o["sent"] > 0)
        reshard("cutover", lambda o: o["epoch"] == 1 and o["n_shards"] == KS_TARGET)
        line["reshard_window_s"] = time.perf_counter() - t0
        log(f"(d) reshard {KS_SHARDS} -> {KS_TARGET}: start on all {n} "
            f"({line['reshard_moved']} keys move), {KS_WINDOW_WRITES} writes through the "
            f"window, a stream round each ({sum(s['sent'] for s in streams)} slices), "
            f"cutover on all {n}: window {line['reshard_window_s']:.2f} s [{card}]")
        conv2 = ks_converge(fleet.urls, fold, tally, "(d)", card)
        if conv2["epochs"] != [1] * n or len(conv2["shard_stats"]) != KS_TARGET:
            raise AssertionError(f"(d): epochs {conv2['epochs']}, "
                                 f"{len(conv2['shard_stats'])} shards")
        line.update({"reshard_converge_rounds": conv2["rounds"],
                     "reshard_converge_s": conv2["seconds"]})

        # -- (e) daemon 3: checkpoint, SIGKILL, restore --
        fences_before = ks_fences([fleet.urls[KS_CRASHED]], tally)[0]
        st, _, body, sec = http_call(fleet.urls[KS_CRASHED] + "/admin/checkpoint", "POST",
                                     b"{}")
        tally.note(st)
        if st != 200:
            raise AssertionError(f"/admin/checkpoint: {st} {body!r}")
        line["checkpoint_s"] = sec
        fleet.kill9(KS_CRASHED)
        t0 = time.perf_counter()
        fleet.start(KS_CRASHED)
        served = fleet.serving(KS_CRASHED)
        line["restart_to_serving_s"] = time.perf_counter() - t0
        if "incarnation 1, restored=True" not in served:
            raise AssertionError(f"restarted daemon {KS_CRASHED}: {served}")
        u3 = fleet.urls[KS_CRASHED]
        st, _, body, _ = http_call(u3 + "/admin/ks_reshard", "POST", b'{"action": "status"}')
        tally.note(st)
        status = json.loads(body)
        if status != {"epoch": 1, "phase": "idle", "target": None, "n_shards": KS_TARGET}:
            raise AssertionError(f"restored daemon's reshard status {status}")
        fences_after = ks_fences([u3], tally)[0]
        if fences_after != fences_before:
            raise AssertionError(f"fence floors {fences_before} -> {fences_after}")
        slot, floor = max(fences_after.items(), key=lambda x: x[1])
        if floor < 1:
            raise AssertionError(f"daemon {KS_CRASHED} knows no fence: {fences_after}")
        st, _, body, _ = http_call(u3 + "/push", "POST", json.dumps(
            {"payload": {}, "fences": {str(slot): floor - 1}}).encode())
        tally.note(st)
        if st != 409 or json.loads(body) != {"fenced": True, "slot": slot, "fence": floor}:
            raise AssertionError(f"/push below the floor: {st} {body!r}")
        for t in KS_TENANTS:
            st, _, body, _ = http_call(u3 + "/ks/data?tenant=" + t)
            tally.note(st)
            if json.loads(body)["state"] != fold[t]:
                raise AssertionError(f"restored daemon's tenant {t} != the fold")
        log(f"(e) daemon {KS_CRASHED}: checkpoint {line['checkpoint_s']:.2f} s, kill -9, "
            f"serving again in {line['restart_to_serving_s']:.2f} s at epoch 1 with "
            f"{KS_TARGET} shards, the same fence floors (a /push below slot {slot}'s "
            f"floor {floor} refused 409), every tenant == the fold [{card}]")

        # -- (f) the fleet rollup CLI --
        st_before = []
        for u in fleet.urls:
            st, _, body, _ = http_call(u + "/metrics")
            tally.note(st)
            st_before.append(body.decode())
        cli = subprocess.run(
            [sys.executable, "-m", "crdt_tpu_torch.obs", "fleet", *fleet.urls,
             "--timeout", "120", "--out", str(root / "fleet.json")], cwd=Path(__file__).resolve().parent,
            capture_output=True, text=True, timeout=120)
        if cli.returncode != 0:
            raise AssertionError(f"obs fleet exited {cli.returncode}: {cli.stderr[-2000:]}")
        report = json.loads((root / "fleet.json").read_text())
        for t in KS_TENANTS:
            want = sum(series_sum(text, "crdt_keyspace_tenant_ops_total", tenant=t)
                       for text in st_before)
            if report["tenants"][t]["ops"] != want:
                raise AssertionError(f"fleet tenant {t} ops {report['tenants'][t]['ops']} "
                                     f"!= the members' /metrics {want}")
        for text in st_before:
            for key, v in ks_metric_map(text, "crdt_keyspace_shard_ops").items():
                shard = key.split('shard="')[1].split('"')[0]
                node = key.split('node="')[1].split('"')[0]
                if report["shards"][shard]["nodes"][node]["ops"] != v:
                    raise AssertionError(f"fleet shard {shard} node {node} ops != /metrics")
        log(f"(f) python -m crdt_tpu_torch.obs fleet over the {n} daemons: exit 0, per-tenant "
            f"ops and per-shard, per-member ops == each daemon's /metrics")
        tally.check()
    finally:
        codes = fleet.stop()
    if any(c != 0 for c in codes):
        raise AssertionError(f"daemon exit codes {codes} (stderr in {root})\n"
                             f"{fleet.failures(codes)}")
    line["statuses"] = {str(k): v for k, v in tally.statuses.items()}
    line["phase_s"] = time.perf_counter() - t_phase
    log(f"phase 19: {line['phase_s']:.1f} s (budget {KS_BUDGET_S} s)")
    log(json.dumps({"keyspace_tier": line}))
    return line


# ---- phase 20: the nemesis soak ----

NEM_BUDGET_S = 150
NEM_NODES, NEM_STEPS, NEM_SEED = 3, 120, 0   # the README's default arm
NEM_RUN_DIR = "build/nemesis"                # git-ignored: fault logs, bundles
# (b): one arm a mode, (label, seed, steps, modes); each seed is one whose
# laws hold at this size (the modes' CPU tests hold the port to the JAX
# package's runs at test size)
NEM_ARMS = (
    ("gc", 0, 100, {"gc": True}),
    ("strong", 0, 120, {"strong": True, "crash_coordinator": True}),
    ("reshard", 0, 120, {"multitenant": True, "reshard": True}),
    ("audit", 0, 120, {"audit": True}),
    ("composite", 0, 120, {"composite": True}),
    ("overload", 0, 120, {"overload": True}),
)


def nemesis_arm(ns, seed: int, steps: int, device: str, **kw) -> tuple:
    """One ``run_soak`` on ``device``; returns (report, seconds, the first
    soak's black-box event counts).  The counts are read from every
    slot's JSONL log just before the soak's temp dir goes: a subclass
    stands in for ``NemesisSoak`` for the call."""
    from collections import Counter

    boxes = []

    class Counted(ns.NemesisSoak):
        def close(self):
            c = Counter()
            for s in self.slots:
                for e in ns.read_jsonl(s.event_log_path):
                    ev = e.get("event")
                    c[ev] += 1
                    if ev == "snapshot_restore" and e.get("fallback"):
                        c["fallback_restore"] += 1
            boxes.append(c)
            super().close()

    plain = ns.NemesisSoak
    ns.NemesisSoak = Counted
    try:
        t0 = time.perf_counter()
        rep = ns.run_soak(seed, NEM_NODES, steps, device=device, **kw)
        return rep, time.perf_counter() - t0, boxes[0]
    finally:
        ns.NemesisSoak = plain


def nemesis_row(rep, seconds: float, box, fault_records: int) -> dict:
    return {"seconds": seconds, "writes": rep.writes, "rounds_to_converge": rep.heal_rounds,
            "fault_records": fault_records, "fault_counts": rep.fault_counts,
            "payload_quarantines": rep.payload_quarantines,
            "snapshot_quarantines": rep.snapshot_quarantines,
            "fallback_restores": box["fallback_restore"], "crashes": rep.crashes,
            "reboots": rep.reboots}


def nemesis_phase(card: str) -> dict:
    """Phase 20: the nemesis soak's default arm and each mode on the card,
    then one {"nemesis": ...} JSON line."""
    import shutil

    from crdt_tpu_torch.harness import nemesis_soak as ns

    t_phase = time.perf_counter()
    log(f"phase 20 (the nemesis soak): budget {NEM_BUDGET_S} s")
    root = Path(__file__).resolve().parent / NEM_RUN_DIR
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    torch.cuda.reset_peak_memory_stats()
    line = {"card": card, "nodes": NEM_NODES, "arms": {}}

    # -- (a) the default arm, replayed, and a CPU run of the same seed --
    logs = {tag: root / f"default-{tag}.jsonl" for tag in ("card", "replay", "cpu")}
    runs = {}
    for tag, device, kw in (("card", "cuda", {"assemble_check": True}), ("replay", "cuda", {}),
                            ("cpu", "cpu", {})):
        runs[tag] = nemesis_arm(ns, NEM_SEED, NEM_STEPS, device, fault_log=str(logs[tag]),
                                postmortem_dir=str(root), **kw)
    rep, secs, box = runs["card"]
    card_log = logs["card"].read_bytes()
    if logs["replay"].read_bytes() != card_log:
        raise AssertionError("(a): the replayed run's fault log differs from the first run's")
    if rep.blame_coverage is None or rep.blame_coverage < 0.95:
        raise AssertionError(f"(a): blame coverage {rep.blame_coverage} < 0.95")
    cpu = runs["cpu"][0]
    if logs["cpu"].read_bytes() != card_log:
        raise AssertionError("(a): the CPU run's fault log differs from the card's")
    for key in ("final_vv", "state_json", "writes_ledger", "fault_counts"):
        if getattr(cpu, key) != getattr(rep, key):
            raise AssertionError(f"(a): the card's {key} differs from the CPU run's")
    n_faults = len(card_log.splitlines())
    line["default"] = dict(nemesis_row(rep, secs, box, n_faults), steps=NEM_STEPS,
                           seed=NEM_SEED, blame_coverage=rep.blame_coverage,
                           replay_s=runs["replay"][1], cpu_s=runs["cpu"][1])
    log(f"(a) default arm, {NEM_NODES} nodes x {NEM_STEPS} steps, seed {NEM_SEED}: "
        f"{rep.summary()} [{secs:.2f} s on the card, replay {runs['replay'][1]:.2f} s, "
        f"CPU {runs['cpu'][1]:.2f} s]")
    log(f"    replay fault log byte-identical ({len(card_log)} B, {n_faults} records); "
        f"card == CPU: fault log, vv, state, ledger; blame coverage {rep.blame_coverage:.3f}")

    # -- (b) one arm a mode --
    for label, seed, steps, modes in NEM_ARMS:
        flog = root / f"{label}.jsonl"
        rep, secs, box = nemesis_arm(ns, seed, steps, "cuda", fault_log=str(flog),
                                     postmortem_dir=str(root), **modes)
        row = dict(nemesis_row(rep, secs, box, len(flog.read_bytes().splitlines())),
                   seed=seed, steps=steps)
        if label == "gc":
            row.update(gc_mints=rep.gc_mints, gc_retained=rep.gc_retained,
                       gc_retained_shadow=rep.gc_retained_shadow)
        elif label == "strong":
            row.update(strong_ok=rep.strong_ok, strong_unavailable=rep.strong_unavailable,
                       coordinator_crashes=rep.coordinator_crashes,
                       zombie_attempts=rep.zombie_attempts, cas_commits=rep.cas_commits,
                       fenced_rejects=rep.fenced_rejects)
        elif label == "reshard":
            row.update(mt_restores=rep.mt_restores, mt_sheds=rep.mt_sheds,
                       rs_streams=rep.rs_streams, rs_fences=rep.rs_fences,
                       rs_quarantines=rep.rs_quarantines)
        elif label == "audit":
            row.update(audit_planted=rep.audit_planted, audit_convictions=rep.audit_drifts,
                       audit_divergences=rep.audit_divergences,
                       audit_postmortems=rep.audit_postmortems)
        elif label == "composite":
            row.update(composite_ops=rep.composite_ops)
        else:
            row.update(sheds=rep.sheds, shed_ops=rep.shed_ops)
        line["arms"][label] = row
        log(f"(b) {label}: {steps} steps, seed {seed}: {rep.summary()} [{secs:.2f} s]")
    line["peak_card_mib"] = torch.cuda.max_memory_allocated() / 2**20
    line["phase_s"] = time.perf_counter() - t_phase
    log(f"phase 20: {line['phase_s']:.1f} s (budget {NEM_BUDGET_S} s), peak card memory "
        f"{line['peak_card_mib']:.1f} MiB [{card}]")
    log(json.dumps({"nemesis": line}))
    return line


# ---- phase 21: the crash soak ----

CRASH_BUDGET_S = 120
CRASH_REPLICAS, CRASH_STEPS, CRASH_SEED = 3, 200, 0   # the CLI's default schedule
CRASH_RUN_DIR = "build/crashsoak"                     # git-ignored: checkpoints, logs


def crash_phase(card: str) -> dict:
    """Phase 21: the crash soak's daemons on the card, the trace assembler
    over their logs, then one {"crash_soak": ...} JSON line."""
    import shutil

    from crdt_tpu_torch.harness.crashsoak import CrashSoakRunner

    t_phase = time.perf_counter()
    log(f"phase 21 (the crash soak): budget {CRASH_BUDGET_S} s")
    here = Path(__file__).resolve().parent
    root = here / CRASH_RUN_DIR
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    t0 = time.perf_counter()
    runner = CrashSoakRunner(n=CRASH_REPLICAS, seed=CRASH_SEED, workdir=str(root / "fleet"),
                             postmortem_dir=str(root), device="cuda")
    boot_s = time.perf_counter() - t0
    report = runner.run(CRASH_STEPS)
    soak_s = time.perf_counter() - t0
    if report.sigkills < 1 or report.restores < 1 or report.checkpoints < 1:
        raise AssertionError(f"the schedule ran no SIGKILL, restore or checkpoint: {report}")
    restarts = [t for d in runner.daemons for t in d.spawn_s[1:]]
    log(f"{report} [{soak_s:.2f} s, {CRASH_REPLICAS} daemons serving in {boot_s:.2f} s]")
    logs = [d.event_log_path for d in runner.daemons]
    cli = subprocess.run(
        [sys.executable, "-m", "crdt_tpu_torch.obs", "assemble", *logs,
         "--out", str(root / "trace.json"), "--blame", str(root / "blame.json")],
        cwd=here, capture_output=True, text=True, timeout=120)
    if cli.returncode != 0:
        raise AssertionError(f"obs assemble exited {cli.returncode}: {cli.stderr[-2000:]}")
    trace = json.loads((root / "trace.json").read_text())
    tracks = {e["args"]["name"] for e in trace["traceEvents"]
              if e.get("ph") == "M" and e.get("name") == "thread_name"}
    want = {f"node slot {i}" for i in range(CRASH_REPLICAS)}
    if not want <= tracks:
        raise AssertionError(f"assembled trace tracks {sorted(tracks)} lack {sorted(want)}")
    summary = json.loads(cli.stdout)
    line = {"card": card, "replicas": CRASH_REPLICAS, "steps": CRASH_STEPS, "seed": CRASH_SEED,
            "sigkills": report.sigkills, "restores": report.restores,
            "checkpoints": report.checkpoints, "writes_accepted": report.writes_accepted,
            "ops_lost_to_crashes": report.ops_lost_to_crashes,
            "rounds_to_converge": report.rounds_to_converge, "event_lines": report.event_lines,
            "boot_s": boot_s, "restart_to_serving_s": restarts, "soak_s": soak_s,
            "assemble": {k: summary[k] for k in ("records", "trace_events", "n_visible",
                                                 "n_spikes")}}
    line["phase_s"] = time.perf_counter() - t_phase
    log(f"python -m crdt_tpu_torch.obs assemble over the {CRASH_REPLICAS} event logs: exit 0, "
        f"{summary['records']} records -> {summary['trace_events']} trace events, a track a "
        f"slot; restart to serving {[round(t, 2) for t in restarts]} s")
    log(f"phase 21: {line['phase_s']:.1f} s (budget {CRASH_BUDGET_S} s) [{card}]")
    log(json.dumps({"crash_soak": line}))
    return line


# ---- phase 22: the host runtime, the mesh plane and tracing ----

HR_BUDGET_S = 90
HR_WRITES, HR_BATCH = 65_536, 512         # (a) one node each way
HR_KS_SHARDS, HR_KS_WRITES, HR_KS_PAGE = 64, 16_384, 512
HR_SOAK_STEPS, HR_SOAK_SEED = 120, 0
HR_RUN_DIR = "build/host_runtime"         # git-ignored: the trace, fault logs
NATIVE_BUILD: dict = {}


def native_build() -> dict:
    """Build (or load) the native host runtime once and time it: g++ of
    ``crdt_tpu_torch/native/ingest.cpp`` into ``build/native/``."""
    from crdt_tpu_torch import native

    if not NATIVE_BUILD:
        fresh = not native.library_path().exists()
        t0 = time.perf_counter()
        native.lib()
        NATIVE_BUILD.update(seconds=time.perf_counter() - t0, built=fresh,
                            library=native.library_path().name)
    return NATIVE_BUILD


def python_path_cluster(config):
    """A LocalCluster whose nodes take the Python path (use_native=False):
    the cluster builds its nodes with the module's ReplicaNode, swapped for
    the construction only."""
    import functools

    from crdt_tpu_torch.api import cluster as cluster_mod

    plain = cluster_mod.ReplicaNode
    cluster_mod.ReplicaNode = functools.partial(plain, use_native=False)
    try:
        return cluster_mod.LocalCluster(config)
    finally:
        cluster_mod.ReplicaNode = plain


def hr_nodes(card: str) -> dict:
    """(a) one node each way on the same batched writes, then phase 15's
    never-pruned cluster mix each way."""
    from crdt_tpu_torch import workload
    from crdt_tpu_torch.api.cluster import LocalCluster
    from crdt_tpu_torch.api.node import ReplicaNode
    from crdt_tpu_torch.models import oplog
    from crdt_tpu_torch.oracle import OracleReplica, Quirks
    from crdt_tpu_torch.utils.clock import HostClock
    from crdt_tpu_torch.utils.config import ClusterConfig

    out = {"build": native_build()}
    gen = workload.WorkloadGenerator(ClusterConfig(seed=SEED + 22))
    cmds = [gen.next_command()[0] for _ in range(HR_WRITES)]
    # python, native, native, python: each way's rate is the mean of its
    # two runs, so neither takes the process's warm-up alone
    clock, nodes, rates = HostClock(), {}, {"native": [], "python": []}
    for way in ("python", "native", "native", "python"):
        kw = {} if way == "native" else {"use_native": False}
        node = ReplicaNode(rid=0, capacity=1024, clock=clock, device="cuda", **kw)
        if node._native != (way == "native"):
            raise AssertionError(f"the {way} node took the other path")
        t0 = time.perf_counter()
        for i in range(0, HR_WRITES, HR_BATCH):
            node.add_commands(cmds[i:i + HR_BATCH], list(range(i, i + HR_BATCH)))
        torch.cuda.synchronize()
        rates[way].append(HR_WRITES / (time.perf_counter() - t0))
        nodes[way] = node
    for way, r in rates.items():
        out[f"node_writes_per_s_{way}"] = statistics.mean(r)
        out[f"node_writes_per_s_{way}_runs"] = r
    n, p = nodes["native"], nodes["python"]
    for f in oplog._FIELDS:
        if not torch.equal(getattr(n.log, f), getattr(p.log, f)):
            raise AssertionError(f"(a) native and Python nodes differ on plane {f}")
    if int(oplog.size(n.log)) != int(oplog.size(p.log)) or \
            n.version_vector() != p.version_vector() or n.get_state() != p.get_state():
        raise AssertionError("(a) native and Python nodes differ in n_unique, vv or state")
    if n.gossip_payload_json() != json.dumps(p.gossip_payload(), separators=(",", ":")).encode():
        raise AssertionError("(a) the wire store's bytes != the payload's compact JSON")
    log(f"(a) one node, {HR_WRITES} writes in batches of {HR_BATCH}, Python/native/native/"
        f"Python: native {out['node_writes_per_s_native']:.1f} writes/s "
        f"({', '.join(f'{x:.1f}' for x in rates['native'])}), Python "
        f"{out['node_writes_per_s_python']:.1f} writes/s "
        f"({', '.join(f'{x:.1f}' for x in rates['python'])}); planes, n_unique, vv, state "
        f"equal [{card}]")
    del nodes, n, p

    gen = workload.WorkloadGenerator(ClusterConfig(seed=SEED))
    commands = [gen.next_command() for _ in range(KV_WRITES)]
    states = {}
    for way in ("native", "python"):
        cfg = ClusterConfig(delta_gossip=True, compact_every=0, seed=SEED)
        cluster = LocalCluster(cfg) if way == "native" else python_path_cluster(cfg)
        if any(node._native != (way == "native") for node in cluster.nodes):
            raise AssertionError(f"the {way} cluster's nodes took the other path")
        oracles = [OracleReplica(r, Quirks()) for r in range(cfg.n_replicas)]
        t = kv_drive(cluster, oracles, commands, KV_ROUNDS, KV_DOWN, KV_UP,
                     profile_last=True, label=f" ({way})")
        states[way] = kv_check(f"(a) {way} cluster", cluster, OracleReplica.converged_state(oracles))
        ticks = t["ticks"]
        prof = t["profile"] or {}
        out[f"cluster_{way}"] = {
            "writes_per_s": t["acked"] / t["add_s"], "tick_ms_p50": quantile(ticks, 0.5),
            "tick_ms_p99": quantile(ticks, 0.99), "ticks": len(ticks),
            "profiled_tick_idle_share": prof.get("idle_share"),
            "profiled_tick_wall_ms": prof.get("wall_ms")}
        log(f"(a) phase 15's never-pruned cluster mix, {way}: "
            f"{out[f'cluster_{way}']['writes_per_s']:.1f} writes/s, tick() median "
            f"{quantile(ticks, 0.5):.4f} ms, p99 {quantile(ticks, 0.99):.4f} ms over "
            f"{len(ticks)} ticks; all 5 views == the oracle [{card}]")
        del cluster
    if states["native"] != states["python"]:
        raise AssertionError("(a) the native cluster's views != the Python cluster's")
    return out


def hr_skew(card: str) -> dict:
    """(b) F1 on the card: after a clock skew, GET /gossip's bytes keep the
    key each op got when it entered, and equal the CPU run's."""
    from crdt_tpu_torch.api.node import ReplicaNode
    from crdt_tpu_torch.utils.clock import ManualClock

    bodies = {}
    for device in ("cuda", "cpu"):
        clock = ManualClock(start=1_000_100)
        clock.epoch_ms = 1_000_000
        node = ReplicaNode(rid=0, capacity=8, clock=clock, device=device)
        node.add_command({"a": "1", "b": 'x"y'})
        clock.advance(100)
        node.add_command({"a": "2"})
        clock.epoch_ms -= 500
        clock.advance(100)
        node.add_command({"c": "\n"})
        bodies[device] = [node.gossip_payload_json(s) for s in (None, {0: 0})]
    full = bodies["cuda"][0]
    if bodies["cuda"] != bodies["cpu"]:
        raise AssertionError("(b) the card's gossip bytes != the CPU run's")
    if b'"2000100:0:0":{"a":"1","b":"x\\"y"}' not in full or b'"1999600:0:0"' in full:
        raise AssertionError(f"(b) an op was re-timed after the skew: {full!r}")
    log(f"(b) F1 after a -500 ms clock skew: GET /gossip keeps each op's entry key "
        f"({full.decode()}), card == CPU bytes, full and delta")
    return {"gossip_bytes": len(full)}


def hr_mesh(card: str) -> dict:
    """(c) the mesh plane against the host path over one card: the same
    tenant writes through a door over each keyspace."""
    from crdt_tpu_torch.keyspace import KeyspaceFrontDoor, ShardedKeyspace, qualify
    from crdt_tpu_torch.utils.clock import HostClock
    from crdt_tpu_torch.utils.metrics import Metrics

    clock = HostClock()
    writes = ks_stream(HR_KS_WRITES, 0)
    kss, doors, page_ms = {}, {}, {}
    for mode in ("on", "off"):
        ks = ShardedKeyspace(0, HR_KS_SHARDS, clock=clock, metrics=Metrics(), mesh=mode,
                             device="cuda")
        ks.enable_audit()
        if ks.mesh_active != (mode == "on"):
            raise AssertionError(f"(c) mesh={mode} keyspace: mesh_active {ks.mesh_active}")
        kss[mode] = ks
        doors[mode] = KeyspaceFrontDoor(ks, max_batch=1 << 20, flush_deadline_s=3600.0)
        page_ms[mode] = []

    def page(mode, rows):
        ks, door = kss[mode], doors[mode]
        by_tenant = {}
        for j, (tenant, key, value) in rows:
            by_tenant.setdefault(tenant, {}).setdefault(ks.shard_of(tenant, key), []).append(
                (j, {qualify(tenant, key): value}, tenant))
        t0 = time.perf_counter()
        tickets = [tk for tenant, groups in by_tenant.items()
                   for _, tk in door._submit_groups(groups, tenant)]
        door.flush_all()
        idents = [i for tk in tickets for i in tk.wait(0)]
        torch.cuda.synchronize()
        if len(idents) != len(rows) or None in idents:
            raise AssertionError(f"(c) mesh={mode}: a page's writes were not all acknowledged")
        return (time.perf_counter() - t0) * 1e3

    reg = {m: kss[m].metrics.registry for m in kss}
    before = reg["on"].counter_value("merge_dispatches")
    indexed = list(enumerate(writes))
    n_pages = 0
    for p0 in range(0, HR_KS_WRITES, HR_KS_PAGE):
        rows = indexed[p0:p0 + HR_KS_PAGE]
        for mode in ("on", "off"):
            page_ms[mode].append(page(mode, rows))
        n_pages += 1
    fused = reg["on"].counter_value("merge_dispatches") - before
    if fused != n_pages or reg["on"].counter_value("meshplane_fallbacks"):
        raise AssertionError(f"(c) {fused} fused merges for {n_pages} flushes, fallbacks "
                             f"{reg['on'].counter_value('meshplane_fallbacks')}")

    def check(label):
        for i, (a, b) in enumerate(zip(kss["on"].shards, kss["off"].shards)):
            if (a.get_state() != b.get_state() or a.version_vector() != b.version_vector()
                    or a.gossip_payload_json({}) != b.gossip_payload_json({})
                    or a.audit_snapshot()[2] != b.audit_snapshot()[2]):
                raise AssertionError(f"(c) {label}: shard {i} differs mesh vs host")
            if not a._lock.acquire(blocking=False):
                raise AssertionError(f"(c) {label}: shard {i}'s node lock is held")
            a._lock.release()

    check("after the writes")
    # a failure injected into one fused step: every lane lands inline
    plane = kss["on"]._plane()

    def boom(capacity, batch_cap):
        raise RuntimeError("injected step failure")

    plane._step_for = boom
    extra = list(enumerate(ks_stream(HR_KS_PAGE, 1, first=HR_KS_WRITES), HR_KS_WRITES))
    for mode in ("on", "off"):
        page(mode, extra)
    del plane._step_for
    if reg["on"].counter_value("meshplane_fallbacks") != 1:
        raise AssertionError("(c) the injected failure did not fall back inline")
    check("after the injected failure")
    out = {"shards": HR_KS_SHARDS, "writes": HR_KS_WRITES, "page": HR_KS_PAGE,
           "pages": n_pages, "fused_merges": fused, "fallbacks_normal": 0,
           "merges_host": reg["off"].counter_value("merge_dispatches")}
    for mode in ("on", "off"):
        out[f"page_ms_{mode}"] = [quantile(page_ms[mode], 0.5), quantile(page_ms[mode], 0.99)]
    out["tenant_writes_per_s_on"] = HR_KS_WRITES / (sum(page_ms["on"][:n_pages]) / 1e3)
    out["tenant_writes_per_s_off"] = HR_KS_WRITES / (sum(page_ms["off"][:n_pages]) / 1e3)
    log(f"(c) ShardedKeyspace(0, {HR_KS_SHARDS}) mesh on vs off, {HR_KS_WRITES} tenant writes "
        f"in pages of {HR_KS_PAGE}: page p50/p99 {out['page_ms_on'][0]:.3f} / "
        f"{out['page_ms_on'][1]:.3f} ms fused vs {out['page_ms_off'][0]:.3f} / "
        f"{out['page_ms_off'][1]:.3f} ms host ({out['tenant_writes_per_s_on']:.1f} vs "
        f"{out['tenant_writes_per_s_off']:.1f} tenant writes/s); {fused:.0f} fused merges for "
        f"{n_pages} flushes (host path {out['merges_host']:.0f}), 0 fallbacks; every shard's "
        f"state, vv, payload and digest equal; an injected step failure landed every lane "
        f"inline (1 fallback), no lock held, states still equal [{card}]")
    return out


def trace_region_kernels(path: Path, region: str) -> tuple:
    """(the region's host spans, kernels launched inside them whose name
    holds ``union_kernel``) in a Chrome trace: the launch calls inside a
    span, matched to their kernels by correlation."""
    events = json.loads(path.read_text())["traceEvents"]
    spans = [(e["ts"], e["ts"] + e.get("dur", 0)) for e in events
             if e.get("name") == region and e.get("cat") == "user_annotation"]
    corr = {e["args"]["correlation"] for e in events
            if e.get("cat") in ("cuda_runtime", "cuda_driver") and "Launch" in e.get("name", "")
            and "correlation" in e.get("args", {})
            and any(a <= e["ts"] <= b for a, b in spans)}
    kernels = [e["name"] for e in events if e.get("cat") == "kernel"
               and e.get("args", {}).get("correlation") in corr and "union_kernel" in e["name"]]
    return spans, kernels


def hr_trace_and_soak(card: str, root: Path) -> dict:
    """(d) trace_to around one OpLog swarm converge at phase 2's shape,
    then the nemesis multitenant arm with the mesh plane, card == CPU."""
    from crdt_tpu_torch import workload
    from crdt_tpu_torch.harness import nemesis_soak as ns
    from crdt_tpu_torch.models import oplog_columnar as oc, oplog_engine as eng
    from crdt_tpu_torch.ops import hopper_union as hu
    from crdt_tpu_torch.parallel import meshplane
    from crdt_tpu_torch.utils import tracing

    w = workload.reference_writes(N_WRITES, R, SEED)
    logs, _ = workload.subset_swarm(w.ops, R, C, HOLD_FRACTION, SEED, device="cuda")
    alive = torch.ones(R, dtype=torch.bool, device="cuda")
    alive[DEAD] = False
    col = eng.plan(logs, alive=alive).columnar
    want, want_nu = oc.converge_checked(col, alive)
    before = hu.LAUNCHES["lexn_union"]
    with tracing.trace_to(str(root / "trace")):
        got, nu = oc.converge_checked(col, alive)
        torch.cuda.synchronize()
    launches = hu.LAUNCHES["lexn_union"] - before
    if int(nu) != int(want_nu) or not all(torch.equal(getattr(got, f), getattr(want, f))
                                          for f in ("hi", "lo", "val", "pay")):
        raise AssertionError("(d) the traced converge != the untraced one")
    [path] = list((root / "trace").glob("*.json"))
    spans, kernels = trace_region_kernels(path, "oplog_columnar.converge")
    # late in a long process the profiler may drop some device records
    # (PERF.md §7 q. 2): every kernel it keeps must sit in the region
    if len(spans) != 1 or not 1 <= len(kernels) <= launches:
        raise AssertionError(f"(d) trace: {len(spans)} oplog_columnar.converge spans, "
                             f"{len(kernels)} union kernels inside, {launches} launched")
    out = {"trace_bytes": path.stat().st_size, "region_launches": launches,
           "region_kernels_traced": len(kernels), "region_kernel_names": sorted(set(kernels))}
    log(f"(d) trace_to around converge_checked (R={R}, C={C}): the trace holds the "
        f"oplog_columnar.converge region and {len(kernels)} of its {launches} lexn_union "
        f"launches ({sorted(set(kernels))}); traced == untraced")

    fallbacks = []
    converge = meshplane.MeshPlane.converge

    def counted(plane, pendings):
        res = converge(plane, pendings)
        fallbacks.append(plane.metrics.registry.counter_value("meshplane_fallbacks"))
        return res

    meshplane.MeshPlane.converge = counted
    try:
        runs = {}
        for device in ("cuda", "cpu"):
            flog = root / f"multitenant-mesh-{device}.jsonl"
            runs[device] = nemesis_arm(ns, HR_SOAK_SEED, HR_SOAK_STEPS, device,
                                       fault_log=str(flog), postmortem_dir=str(root),
                                       multitenant=True, ks_mesh="on")
            runs[device] += (flog.read_bytes(),)
    finally:
        meshplane.MeshPlane.converge = converge
    (rep, secs, _, flog), (cpu, cpu_s, _, cpu_log) = runs["cuda"], runs["cpu"]
    if flog != cpu_log:
        raise AssertionError("(d) the card's multitenant fault log != the CPU run's")
    for key in ("final_vv", "state_json", "writes_ledger"):
        if getattr(rep, key) != getattr(cpu, key):
            raise AssertionError(f"(d) the card's multitenant {key} != the CPU run's")
    if not fallbacks or any(fallbacks):
        raise AssertionError(f"(d) {len(fallbacks)} fused steps, fallbacks {max(fallbacks)}")
    out.update(soak_s=secs, soak_cpu_s=cpu_s, soak_fused_steps=len(fallbacks),
               soak_writes=rep.writes, soak_fault_records=len(flog.splitlines()))
    log(f"(d) nemesis multitenant, ks_mesh=on, {NEM_NODES} nodes x {HR_SOAK_STEPS} steps, "
        f"seed {HR_SOAK_SEED}: {rep.summary()} [{secs:.2f} s on the card, CPU {cpu_s:.2f} s]; "
        f"{len(fallbacks)} fused steps, 0 fallbacks; card == CPU: fault log, vv, state, ledger")
    return out


def hr_phase(card: str) -> dict:
    """Phase 22: the native host runtime, F1 on the card, the mesh plane and
    tracing; one {"host_runtime": ...} JSON line."""
    import shutil

    t_phase = time.perf_counter()
    log(f"phase 22 (the host runtime, the mesh plane and tracing): budget {HR_BUDGET_S} s")
    root = Path(__file__).resolve().parent / HR_RUN_DIR
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    line = {"card": card}
    for part, fn in (("nodes", lambda: hr_nodes(card)), ("skew", lambda: hr_skew(card)),
                     ("mesh", lambda: hr_mesh(card)),
                     ("trace", lambda: hr_trace_and_soak(card, root))):
        t0 = time.perf_counter()
        line[part] = fn()
        line[part]["part_s"] = time.perf_counter() - t0
    line["phase_s"] = time.perf_counter() - t_phase
    log(f"phase 22: {line['phase_s']:.1f} s (budget {HR_BUDGET_S} s) [{card}]")
    log(json.dumps({"host_runtime": line}))
    return line


# ---- phase 23: several devices ----
#
# The sharded converges, the generic join all-reduce and pmax over a
# torch.distributed group, the stripe pipeline and the mesh plane's
# partitioned engine, each held bit for bit against the single-device
# path on the card.  One card allows two multi-rank arms: a world of 1
# over NCCL in this process, and four ranks sharing the card (NCCL refuses
# two ranks on one device, so the four run gloo with every shard on the
# card and each collective staged through host memory).

MD_BUDGET_S = 75
MD_RANKS = 4
MD_PMAX_R = 1 << 20                      # phase 14's G-Counter swarm, x 8 nodes
MD_STRIPES, MD_STRIPE_C = 8, 1 << 18     # benches/bench_pipeline.py's default shape
MD_KS_WRITES = 4_096                     # phase 22 (c)'s shape, cut from 16,384
MD_RUN_DIR = "build/multidevice"         # git-ignored: the four ranks' inputs and results
MD_REPS = 3


def md_inputs() -> dict:
    """(a)'s inputs at full width, on the card: phase 3's OpLog swarm, phase
    10's RSeq swarm (its GC-wrapped twin with floor -1), and a G-Counter
    swarm of 2^20 x 8; one lane dead in each."""
    from crdt_tpu_torch import workload
    from crdt_tpu_torch.models import gcounter, oplog_engine as eng, rseq_columnar as rc
    from crdt_tpu_torch.models import rseq_engine as reng

    w = workload.reference_writes(N_WRITES, R, SEED)
    logs, _ = workload.subset_swarm(w.ops, R, C, HOLD_FRACTION, SEED, device="cuda")
    alive = torch.ones(R, dtype=torch.bool, device="cuda")
    alive[DEAD] = False
    col = eng.plan(logs, alive=alive).columnar
    pool = workload.seq_pool(SEED)
    sw = workload.seq_swarm(pool, R, SEQ_C, SEED + 31, device="cuda")
    rcol, reason = rc.plan(sw.states)
    if rcol is None:
        raise AssertionError(f"phase 23: the RSeq plan fell back: {reason}")
    # the GC-wrapped twin: reng.stack of (sw.states, floor -1) at rcol's split
    # is rcol's planes with a floor plane, so it shares them
    cg = reng.ColumnarGc(col=rcol, floor=torch.full((SEQ_W, R), -1, dtype=torch.int32,
                                                    device="cuda"))
    counts = torch.from_numpy(workload.counter_bank(SEED + 71, (MD_PMAX_R, GC_NODES))).to("cuda")
    pm_alive = torch.ones(MD_PMAX_R, dtype=torch.bool, device="cuda")
    pm_alive[DEAD] = False
    return {"logs": logs, "alive": alive, "col": col, "rcol": rcol, "cg": cg,
            "gcounter": gcounter.GCounter(counts=counts), "pm_alive": pm_alive}


def md_steps(mesh, x: dict) -> dict:
    """The five sharded steps of this slice over ``mesh``: name -> a call
    on ``x``'s shards returning (flat output tensors, max_n_unique or
    None)."""
    from crdt_tpu_torch.models import oplog, oplog_columnar as oc, rseq_columnar as rc
    from crdt_tpu_torch.models import rseq_engine as reng
    from crdt_tpu_torch.parallel import mesh as mesh_lib, swarm
    from crdt_tpu_torch.utils.tree import leaves

    col, rcol, cg = x["col"], x["rcol"], x["cg"]
    steps = {
        "oplog_columnar": oc.sharded_converge(mesh, bits=col.bits),
        "rseq_columnar": rc.sharded_converge(mesh, depth=rcol.depth, seq_bits=rcol.seq_bits),
        "rseq_gc": reng.sharded_gc_converge(mesh, depth=rcol.depth, seq_bits=rcol.seq_bits),
    }
    generic = mesh_lib.sharded_converge(mesh, oplog.merge, oplog.merge,
                                        oplog.empty(C, device="cuda"))
    pmax = mesh_lib.pmax_converge(mesh)

    def columnar(name, state):
        out, nu = steps[name](state, x["alive"])
        return leaves(out), nu

    return {
        "oplog_columnar": lambda: columnar("oplog_columnar", col),
        "rseq_columnar": lambda: columnar("rseq_columnar", rcol),
        "rseq_gc": lambda: columnar("rseq_gc", cg),
        "mesh_generic": lambda: (leaves(generic(swarm.make(x["logs"], x["alive"])).state), None),
        "mesh_pmax": lambda: (leaves(pmax(swarm.make(x["gcounter"], x["pm_alive"])).state),
                              None),
    }


def md_single(x: dict) -> dict:
    """The single-device converges the sharded steps are held against."""
    from crdt_tpu_torch.models import gcounter, oplog, oplog_columnar as oc
    from crdt_tpu_torch.models import rseq_columnar as rc, rseq_engine as reng
    from crdt_tpu_torch.parallel import swarm
    from crdt_tpu_torch.utils.tree import leaves

    def columnar(fn, state):
        out, nu = fn(state, x["alive"])
        return leaves(out), nu

    return {
        "oplog_columnar": lambda: columnar(oc.converge_checked, x["col"]),
        "rseq_columnar": lambda: columnar(rc.converge_checked, x["rcol"]),
        "rseq_gc": lambda: columnar(reng.gc_converge_checked, x["cg"]),
        "mesh_generic": lambda: (leaves(swarm.converge(
            swarm.make(x["logs"], x["alive"]), oplog.merge, oplog.empty(C, device="cuda")).state),
            None),
        "mesh_pmax": lambda: (leaves(swarm.converge(
            swarm.make(x["gcounter"], x["pm_alive"]), gcounter.join,
            gcounter.zero(GC_NODES, device="cuda")).state), None),
    }


#: the lane (replica) axis of each step's state leaves: columnar planes
#: carry the lanes last, row-major swarms first
MD_LANE_AXIS = {"oplog_columnar": -1, "rseq_columnar": -1, "rseq_gc": -1,
                "mesh_generic": 0, "mesh_pmax": 0}


def md_shard(x: dict, rank: int, world: int) -> dict:
    """Rank ``rank``'s lanes of every input (contiguous, on the card)."""
    from crdt_tpu_torch.utils.tree import tree_map

    def cut(t, axis, n):
        k = n // world
        return t.narrow(axis, rank * k, k).contiguous()

    out = {}
    for key, v in x.items():
        if key in ("col", "rcol", "cg"):
            out[key] = tree_map(lambda t: cut(t, t.dim() - 1, R), v)
        elif key in ("gcounter", "pm_alive"):
            out[key] = tree_map(lambda t: cut(t, 0, MD_PMAX_R), v)
        else:
            out[key] = tree_map(lambda t: cut(t, 0, R), v)
    if x["cg"].col is x["rcol"]:  # keep the shared planes shared
        out["cg"].col = out["rcol"]
    return out


def md_digest(tensors) -> str:
    import hashlib

    h = hashlib.sha1()
    for t in tensors:
        h.update(str(tuple(t.shape)).encode())
        h.update(t.contiguous().cpu().numpy().tobytes())
    return h.hexdigest()


def md_world_a(card: str, x: dict, want: dict) -> dict:
    """(a) a world of 1 over NCCL in this process: every step == the
    single-device converge, with its ms beside the single converge's and
    kernel 1's launches."""
    import torch.distributed as dist

    from crdt_tpu_torch.ops import hopper_union as hu
    from crdt_tpu_torch.parallel import mesh as mesh_lib

    port = free_ports(1)[0]
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}", world_size=1,
                            rank=0)
    try:
        mesh = mesh_lib.make_mesh(device="cuda")
        if (mesh.size, mesh.backend) != (1, "nccl"):
            raise AssertionError(f"(a) mesh {mesh}")
        steps, single = md_steps(mesh, x), md_single(x)
        out = {}
        for name, step in steps.items():
            for k in hu.LAUNCHES:
                hu.LAUNCHES[k] = 0
            got, nu = step()
            torch.cuda.synchronize()
            launches = hu.LAUNCHES["lexn_union"] + hu.LAUNCHES["lexn_gc_union"]
            same(f"(a) {name}: NCCL world of 1 vs the single-device converge",
                 got, want[name][0])
            if nu is not None and int(nu) != int(want[name][1]):
                raise AssertionError(f"(a) {name}: max_n_unique {int(nu)} != "
                                     f"{int(want[name][1])}")
            if name in ("oplog_columnar", "rseq_columnar", "rseq_gc") and launches == 0:
                raise AssertionError(f"(a) {name}: kernel 1 was not launched")
            ms = time_ms(step, reps=MD_REPS, warmup=1)
            single_ms = time_ms(single[name], reps=MD_REPS, warmup=1)
            out[name] = {"ms": ms, "single_ms": single_ms, "lexn_union_launches": launches,
                         "max_n_unique": None if nu is None else int(nu)}
            log(f"(a) {name}: NCCL world of 1 == single-device converge, {ms:.4f} ms vs "
                f"{single_ms:.4f} ms single, kernel 1 launched {launches} times [{card}]")
    finally:
        dist.destroy_process_group()
    return out


def md_rank(rank: int, world: int, root: str) -> None:
    """One of (b)'s ranks: NCCL first (refused on one card: its message is
    recorded), then the gloo world with this rank's shard on the card;
    writes each step's output digest, max_n_unique and times."""
    import datetime

    import torch.distributed as dist

    from crdt_tpu_torch.ops import hopper_union as hu
    from crdt_tpu_torch.parallel import mesh as mesh_lib

    t_entry = time.time()
    res = {"rank": rank}
    timeout = datetime.timedelta(seconds=60)
    dist.init_process_group("nccl", init_method=f"file://{root}/nccl-store",
                            world_size=world, rank=rank, timeout=timeout)
    try:
        probe = torch.ones(1, device="cuda")
        dist.all_reduce(probe)
        torch.cuda.synchronize()
        res["nccl"] = "accepted"
    except Exception as e:  # noqa: BLE001 - the refusal is the finding
        res["nccl"] = f"{type(e).__name__}: {e}".splitlines()[-1][:300]
    dist.destroy_process_group()
    backend = "nccl" if res["nccl"] == "accepted" else "gloo"
    dist.init_process_group(backend, init_method=f"file://{root}/store", world_size=world,
                            rank=rank, timeout=timeout)
    try:
        from crdt_tpu_torch.utils.tree import tree_map

        mesh = mesh_lib.make_mesh(device="cuda")
        x = torch.load(f"{root}/inputs{rank}.pt", map_location="cpu", weights_only=False)
        x = {k: tree_map(lambda t: t.to("cuda"), v) for k, v in x.items()}
        torch.cuda.synchronize()
        dist.barrier()
        res["ready"] = time.time()
        res["startup_s"] = res["ready"] - t_entry
        res["steps"] = {}
        for name, step in md_steps(mesh, x).items():
            for k in hu.LAUNCHES:
                hu.LAUNCHES[k] = 0
            t0 = time.perf_counter()
            got, nu = step()
            torch.cuda.synchronize()
            dist.barrier()
            res["steps"][name] = {"s": time.perf_counter() - t0, "digest": md_digest(got),
                                  "max_n_unique": None if nu is None else int(nu),
                                  "lexn_union_launches": (hu.LAUNCHES["lexn_union"]
                                                          + hu.LAUNCHES["lexn_gc_union"])}
        res["backend"] = mesh.backend
    finally:
        dist.destroy_process_group()
    Path(f"{root}/rank{rank}.json").write_text(json.dumps(res))


def md_world_b(card: str, x: dict, want: dict) -> dict:
    """(b) four ranks sharing the card at R = 4 x 2,560: each rank's output
    shard == its lanes of the single-device result."""
    import shutil

    import torch.multiprocessing as mp

    root = Path(__file__).resolve().parent / MD_RUN_DIR
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    from crdt_tpu_torch.utils.tree import tree_map

    for r in range(MD_RANKS):
        torch.save({k: tree_map(lambda t: t.cpu(), v) for k, v in md_shard(x, r, MD_RANKS).items()},
                   root / f"inputs{r}.pt")
    t0 = time.time()
    mp.spawn(md_rank, args=(MD_RANKS, str(root)), nprocs=MD_RANKS, join=True)
    wall = time.time() - t0
    ranks = [json.loads((root / f"rank{r}.json").read_text()) for r in range(MD_RANKS)]
    nccl = ranks[0]["nccl"]
    log(f"(b) NCCL with {MD_RANKS} ranks on one card: {nccl}")
    backend = ranks[0]["backend"]
    out = {"ranks": MD_RANKS, "lanes_per_rank": R // MD_RANKS, "nccl": nccl,
           "backend": backend, "wall_s": wall,
           "startup_s": max(r["ready"] for r in ranks) - t0, "steps": {}}
    for name in want:
        for r in ranks:
            k = (R if name != "mesh_pmax" else MD_PMAX_R) // MD_RANKS
            axis = MD_LANE_AXIS[name]
            mine = [t.narrow(axis if axis >= 0 else t.dim() + axis, r["rank"] * k, k)
                    for t in want[name][0]]
            got = r["steps"][name]
            if got["digest"] != md_digest(mine):
                raise AssertionError(f"(b) {name}: rank {r['rank']}'s shard != its lanes of "
                                     "the single-device result")
            if want[name][1] is not None and got["max_n_unique"] != int(want[name][1]):
                raise AssertionError(f"(b) {name}: rank {r['rank']} max_n_unique "
                                     f"{got['max_n_unique']} != {int(want[name][1])}")
        out["steps"][name] = {
            "s": max(r["steps"][name]["s"] for r in ranks),
            "lexn_union_launches": sum(r["steps"][name]["lexn_union_launches"] for r in ranks)}
    out["step_s"] = sum(s["s"] for s in out["steps"].values())
    log(f"(b) {MD_RANKS} ranks on one card ({backend}, each collective staged through host "
        f"memory), R = {MD_RANKS} x {R // MD_RANKS}: every shard of all five steps == the "
        f"single-device result; wall {wall:.2f} s = start-up {out['startup_s']:.2f} s + "
        f"steps {out['step_s']:.3f} s ({', '.join(f'{k} {v['s'] * 1e3:.1f} ms' for k, v in out['steps'].items())}) [{card}]")
    return out


def md_pipeline(card: str) -> dict:
    """(c) run_striped at benches/bench_pipeline.py's default shape, the
    port's sorted_union, stripes host-staged from pinned memory:
    pipelined == serial, 8 dispatches each."""
    from crdt_tpu_torch.obs.registry import MetricsRegistry
    from crdt_tpu_torch.ops import sorted_union as su
    from crdt_tpu_torch.parallel import pipeline

    cap, fill = MD_STRIPE_C, MD_STRIPE_C // 2
    # two pinned buffer sets: with one stripe in flight, build(i+1) writes the
    # set stripe i-1 used, whose copy has finished (the queue blocked on it)
    pinned = [torch.empty((4, cap), dtype=torch.int32, pin_memory=True) for _ in range(2)]

    def run(pipelined, registry=None):
        rng = np.random.default_rng(SEED + 91)

        def build(i):
            buf = pinned[i % 2]
            for side in (0, 2):
                ks = np.sort(rng.integers(0, 1 << 30, size=fill, dtype=np.int32))
                keys = np.full(cap, SENTINEL, np.int32)
                keys[:fill] = ks
                vals = np.zeros(cap, np.int32)
                vals[:fill] = ks & 1
                buf[side].copy_(torch.from_numpy(keys))
                buf[side + 1].copy_(torch.from_numpy(vals))
            return tuple(buf.to("cuda", non_blocking=True).unbind(0))

        def dispatch(i, ka, va, kb, vb):
            keys, vals, n = su.sorted_union((ka,), va, (kb,), vb, out_size=cap)
            return keys[0], vals, n

        t0 = time.perf_counter()
        res, stats = pipeline.run_striped(MD_STRIPES, build, dispatch, pipelined=pipelined,
                                          registry=registry, pipeline="orset_stripe")
        torch.cuda.synchronize()
        return res, stats, time.perf_counter() - t0

    run(True)  # warm-up
    reg = MetricsRegistry()
    (res_p, st_p, wall_p), (res_s, st_s, wall_s) = run(True, reg), run(False)
    for i, (a, b) in enumerate(zip(res_p, res_s)):
        same(f"(c) stripe {i}: pipelined vs serial", list(a), list(b))
    if (st_p["dispatches"], st_s["dispatches"], len(res_p)) != (MD_STRIPES,) * 3:
        raise AssertionError(f"(c) dispatches {st_p['dispatches']}/{st_s['dispatches']}")
    if reg.counter_value("pipeline_dispatches", pipeline="orset_stripe") != MD_STRIPES:
        raise AssertionError("(c) the registry missed the pipeline's dispatches")
    out = {"stripes": MD_STRIPES, "c": cap, "fill": fill,
           "pipelined": {k: st_p[k] for k in ("occupancy", "stage_s", "wait_s")} | {"wall_s": wall_p},
           "serial": {k: st_s[k] for k in ("occupancy", "stage_s", "wait_s")} | {"wall_s": wall_s}}
    log(f"(c) run_striped, {MD_STRIPES} stripes at C={cap}, fill C/2, sorted_union from "
        f"pinned memory: pipelined == serial, {MD_STRIPES} dispatches each; pipelined "
        f"occupancy {st_p['occupancy']:.3f}, stage {st_p['stage_s']:.4f} s, wait "
        f"{st_p['wait_s']:.4f} s, wall {wall_p:.4f} s; serial stage {st_s['stage_s']:.4f} s, "
        f"wait {st_s['wait_s']:.4f} s, wall {wall_s:.4f} s [{card}]")
    return out


def md_meshplane(card: str) -> dict:
    """(d) MeshPlane(engine="pjit") on the one-card mesh against the vmap
    engine: the same tenant writes through a door over each keyspace."""
    from crdt_tpu_torch.keyspace import KeyspaceFrontDoor, ShardedKeyspace, qualify
    from crdt_tpu_torch.parallel.meshplane import MeshPlane
    from crdt_tpu_torch.utils.clock import HostClock
    from crdt_tpu_torch.utils.metrics import Metrics

    clock = HostClock()
    writes = ks_stream(MD_KS_WRITES, 0)
    kss, doors, page_ms = {}, {}, {}
    for engine in ("pjit", "vmap"):
        ks = ShardedKeyspace(0, HR_KS_SHARDS, clock=clock, metrics=Metrics(), mesh="on",
                             device="cuda")
        ks._meshplane = MeshPlane(HR_KS_SHARDS, mode="on", engine=engine, device="cuda",
                                  metrics=ks.shards[0].metrics)
        ks.enable_audit()
        kss[engine] = ks
        doors[engine] = KeyspaceFrontDoor(ks, max_batch=1 << 20, flush_deadline_s=3600.0)
        page_ms[engine] = []
    plane = kss["pjit"]._meshplane
    if (plane.engine, plane.n_devices, kss["pjit"].mesh_engine) != ("pjit", 1, "pjit"):
        raise AssertionError(f"(d) plane {plane.engine} on {plane.n_devices} devices")

    def page(engine, rows):
        ks, door = kss[engine], doors[engine]
        by_tenant = {}
        for j, (tenant, key, value) in rows:
            by_tenant.setdefault(tenant, {}).setdefault(ks.shard_of(tenant, key), []).append(
                (j, {qualify(tenant, key): value}, tenant))
        t0 = time.perf_counter()
        tickets = [tk for tenant, groups in by_tenant.items()
                   for _, tk in door._submit_groups(groups, tenant)]
        door.flush_all()
        idents = [i for tk in tickets for i in tk.wait(0)]
        torch.cuda.synchronize()
        if len(idents) != len(rows) or None in idents:
            raise AssertionError(f"(d) {engine}: a page's writes were not all acknowledged")
        return (time.perf_counter() - t0) * 1e3

    reg = {e: kss[e].metrics.registry for e in kss}
    indexed = list(enumerate(writes))
    n_pages = 0
    for p0 in range(0, MD_KS_WRITES, HR_KS_PAGE):
        for engine in ("pjit", "vmap"):
            page_ms[engine].append(page(engine, indexed[p0:p0 + HR_KS_PAGE]))
        n_pages += 1
    for e in kss:
        if reg[e].counter_value("merge_dispatches") != n_pages or \
                reg[e].counter_value("meshplane_fallbacks"):
            raise AssertionError(f"(d) {e}: {reg[e].counter_value('merge_dispatches')} fused "
                                 f"merges for {n_pages} pages")

    def check(label):
        for i, (a, b) in enumerate(zip(kss["pjit"].shards, kss["vmap"].shards)):
            if (a.get_state() != b.get_state() or a.version_vector() != b.version_vector()
                    or a.gossip_payload_json({}) != b.gossip_payload_json({})
                    or a.audit_snapshot()[2] != b.audit_snapshot()[2]):
                raise AssertionError(f"(d) {label}: shard {i} differs pjit vs vmap")
            if not a._lock.acquire(blocking=False):
                raise AssertionError(f"(d) {label}: shard {i}'s node lock is held")
            a._lock.release()

    check("after the writes")
    fold = plane._fold_group

    def boom(k, *args):
        raise RuntimeError("injected group failure")

    plane._fold_group = boom
    extra = list(enumerate(ks_stream(HR_KS_PAGE, 1, first=MD_KS_WRITES), MD_KS_WRITES))
    for engine in ("pjit", "vmap"):
        page(engine, extra)
    plane._fold_group = fold
    if reg["pjit"].counter_value("meshplane_fallbacks") != 1:
        raise AssertionError("(d) the injected failure did not land every lane inline")
    from crdt_tpu_torch.api.node import device_lock

    if device_lock("cuda").locked():
        raise AssertionError("(d) the card's device lock is held after the failure")
    check("after the injected failure")
    out = {"shards": HR_KS_SHARDS, "writes": MD_KS_WRITES, "page": HR_KS_PAGE,
           "pages": n_pages, "fused_merges": n_pages, "fallbacks_injected": 1}
    for e in kss:
        out[f"page_ms_{e}"] = [quantile(page_ms[e][:n_pages], 0.5),
                               quantile(page_ms[e][:n_pages], 0.99)]
    log(f"(d) MeshPlane(engine=\"pjit\") on the one-card mesh vs vmap, {MD_KS_WRITES} tenant "
        f"writes on {HR_KS_SHARDS} shards in pages of {HR_KS_PAGE}: every shard's state, vv, "
        f"payload and digest equal, one fused merge a page each; page p50/p99 "
        f"{out['page_ms_pjit'][0]:.3f}/{out['page_ms_pjit'][1]:.3f} ms pjit vs "
        f"{out['page_ms_vmap'][0]:.3f}/{out['page_ms_vmap'][1]:.3f} ms vmap; an injected "
        f"group failure landed every lane inline, no lock held [{card}]")
    return out


def md_phase(card: str) -> dict:
    """Phase 23: several devices; one {"multidevice": ...} JSON line."""
    t_phase = time.perf_counter()
    log(f"phase 23 (several devices): budget {MD_BUDGET_S} s")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    x = md_inputs()
    single = md_single(x)
    want = {}
    for name, fn in single.items():
        got, nu = fn()
        want[name] = ([t.clone() for t in got], None if nu is None else int(nu))
    torch.cuda.synchronize()
    line = {"card": card, "inputs_s": time.perf_counter() - t0}
    for part, fn in (("a", lambda: md_world_a(card, x, want)),
                     ("b", lambda: md_world_b(card, x, want)),
                     ("c", lambda: md_pipeline(card)),
                     ("d", lambda: md_meshplane(card))):
        t0 = time.perf_counter()
        line[part] = fn()
        line[part]["part_s"] = time.perf_counter() - t0
    del x, want
    torch.cuda.empty_cache()
    line["phase_s"] = time.perf_counter() - t_phase
    log(f"phase 23: {line['phase_s']:.1f} s (budget {MD_BUDGET_S} s) [{card}]")
    log(json.dumps({"multidevice": line}))
    return line


# ---- phase 24: crdtprove and the race detector ----

VERIFY_BUDGET_S = 60


def verify_phase(card: str) -> dict:
    """Phase 24: (a) every registered join proved with its states on the
    card == the port's committed ledger, (b) ``verify --check-ledger``,
    (c) the nemesis default arm under ``--race-check``; one
    {"verify": ...} JSON line."""
    from crdt_tpu_torch.analysis.verify import ledger, prove
    from crdt_tpu_torch.ops import hopper_union as hu
    from crdt_tpu_torch.ops.joins import registered_joins

    t_phase = time.perf_counter()
    log(f"phase 24 (crdtprove and the race detector): budget {VERIFY_BUDGET_S} s")
    root = Path(__file__).resolve().parent
    committed = ledger.load()["joins"]
    registry = registered_joins()
    for k in hu.LAUNCHES:
        hu.LAUNCHES[k] = 0
    t0 = time.perf_counter()
    per_join = {}
    for name, spec in sorted(registry.items()):
        t1 = time.perf_counter()
        e = prove.prove_spec(spec, registry, device="cuda")
        want = committed[name]
        for key in ("verdict", "domain"):
            if e[key] != want[key]:
                raise AssertionError(f"(a) {name}: {key} {e[key]} != the ledger's {want[key]}")
        for group in ("laws", "obligations"):
            got = {k: (v["holds"], v["space"]) for k, v in e[group].items()}
            if got != {k: (v["holds"], v["space"]) for k, v in want[group].items()}:
                raise AssertionError(f"(a) {name}: {group} {got} != the ledger's")
        per_join[name] = time.perf_counter() - t1
    torch.cuda.synchronize()
    prove_s = time.perf_counter() - t0
    launches = {k: hu.LAUNCHES[k] for k in ("lexn_union", "set_union", "bucketed_union")}
    if launches["bucketed_union"] == 0:
        raise AssertionError("(a) orset_bucketed's sweeps launched no bucketed_union")
    log(f"(a) prove_spec of all {len(registry)} registered joins with their states on the "
        f"card == the committed ledger (verdicts, laws and spaces, domains): {prove_s:.2f} s, "
        f"slowest {max(per_join, key=per_join.get)} {max(per_join.values()):.2f} s; kernel "
        f"launches in the sweeps {launches} [{card}]")

    t0 = time.perf_counter()
    gate = subprocess.run([sys.executable, "-m", "crdt_tpu_torch.analysis", "verify",
                           "--check-ledger"], cwd=root, capture_output=True, text=True,
                          timeout=120)
    gate_s = time.perf_counter() - t0
    if gate.returncode != 0:
        raise AssertionError(f"(b) verify --check-ledger exited {gate.returncode}: "
                             f"{gate.stdout[-2000:]}{gate.stderr[-2000:]}")
    log(f"(b) python -m crdt_tpu_torch.analysis verify --check-ledger: exit 0, "
        f"{gate.stdout.strip().splitlines()[-1]} ({gate_s:.2f} s)")

    t0 = time.perf_counter()
    soak = subprocess.run([sys.executable, "-m", "crdt_tpu_torch.harness.nemesis_soak",
                           "--race-check", "--device", "cuda", "--nodes", str(NEM_NODES),
                           "--steps", str(NEM_STEPS), "--seeds", "1",
                           "--seed-base", str(NEM_SEED)], cwd=root, capture_output=True,
                          text=True, timeout=300)
    soak_s = time.perf_counter() - t0
    ok = [ln for ln in soak.stdout.splitlines() if "race-check OK" in ln]
    if soak.returncode != 0 or not ok:
        raise AssertionError(f"(c) --race-check exited {soak.returncode}: "
                             f"{soak.stdout[-2000:]}{soak.stderr[-2000:]}")
    import re

    reads, writes = (int(v) for v in re.findall(r"(\d+) (?:reads|writes)", ok[0]))
    if reads + writes == 0 or "0 witnesses" not in ok[0]:
        raise AssertionError(f"(c) {ok[0]}")
    # the crdtflow cross-check of the witnesses (every one mapped to a
    # covering CRDT210-213 finding, or named uncovered)
    mapped = re.search(r"flow cross-check: (\d+) witnesses mapped, (\d+) uncovered", ok[0])
    if mapped is None or mapped.groups() != ("0", "0"):
        raise AssertionError(f"(c) the flow section: {ok[0]}")
    log(f"(c) the nemesis default arm under --race-check on the card ({NEM_NODES} nodes, "
        f"{NEM_STEPS} steps, seed {NEM_SEED}): 0 witnesses over {reads} reads / {writes} "
        f"writes, flow cross-check 0 mapped / 0 uncovered ({soak_s:.2f} s)")
    line = {"card": card, "joins": len(registry), "prove_s": prove_s,
            "prove_s_by_join": per_join, "launches": launches, "check_ledger_s": gate_s,
            "race": {"witnesses": 0, "reads": reads, "writes": writes, "s": soak_s,
                     "flow": {"witnesses_mapped": 0, "uncovered": 0}},
            "phase_s": time.perf_counter() - t_phase}
    log(f"phase 24: {line['phase_s']:.1f} s (budget {VERIFY_BUDGET_S} s) [{card}]")
    log(json.dumps({"verify": line}))
    return line


# ---- phase 25: the lint tiers ----

LINT_BUDGET_S = 45
FLOW_BUDGET_S = 60            # the JAX package's crdtflow budget
LINT_RUN_DIR = "build/lint"   # git-ignored: the gate's SARIF
FLOW_RULES = "CRDT210,CRDT211,CRDT212,CRDT213"


def lint_gate(pool, root: Path, *args: str) -> tuple:
    """Start ``python -m crdt_tpu_torch.analysis --check-baseline *args``
    in a process of its own, read to its end on a thread of ``pool``:
    (the process, a future of (exit code, stdout, stderr, wall s, the
    linter's own "analyzed in" s))."""
    import re

    t0 = time.perf_counter()
    proc = subprocess.Popen([sys.executable, "-m", "crdt_tpu_torch.analysis",
                             "--check-baseline", *args], cwd=root,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)

    def read() -> tuple:
        out, err = proc.communicate(timeout=180)
        wall = time.perf_counter() - t0
        analyzed = re.search(r"analyzed in ([0-9.]+)s", out)
        return (proc.returncode, out, err, wall,
                float(analyzed.group(1)) if analyzed else math.nan)

    return proc, pool.submit(read)


def lint_phase(card: str) -> dict:
    """Phase 25: (a) the linter's baseline gate in a process of its own,
    its findings by rule == the committed baseline's, 0 errors; (b) the
    crdtflow rules alone against their 60 s budget; (c) every registered
    join's graph clean in process; (d) the race detector's static bridge
    resolves the port's classes; (a) and (b) run beside (c) and (d); one
    {"lint": ...} JSON line."""
    from collections import Counter
    from concurrent.futures import ThreadPoolExecutor

    from crdt_tpu_torch import analysis
    from crdt_tpu_torch.analysis import baseline, fx_checks
    from crdt_tpu_torch.analysis.verify import race
    from crdt_tpu_torch.ops.joins import registered_joins

    t_phase = time.perf_counter()
    log(f"phase 25 (the lint tiers): budget {LINT_BUDGET_S} s")
    root = Path(__file__).resolve().parent
    run_dir = root / LINT_RUN_DIR
    run_dir.mkdir(parents=True, exist_ok=True)
    sarif = run_dir / "lint.sarif"

    # the two gates run in processes of their own while (c) and (d) run
    # here: the card's host has 8 cores, and each wall includes the others'
    # contention
    pool = ThreadPoolExecutor(2)
    gates = [lint_gate(pool, root, "--sarif", str(sarif)),
             lint_gate(pool, root, "--rules", FLOW_RULES)]
    try:
        t0 = time.perf_counter()
        graph = fx_checks.check_registered_joins(analysis.repo_root())
        fx_s = time.perf_counter() - t0
        if graph != []:
            raise AssertionError("(c) " + "; ".join(f.render() for f in graph))
        n_joins = len(registered_joins())
        t0 = time.perf_counter()
        static = race.watch_from_static()
        static_s = time.perf_counter() - t0
        points = sorted(f"{c.__module__}.{c.__name__}.{a}" for c, a in static)
        if not points or not all(p.startswith("crdt_tpu_torch.") for p in points):
            raise AssertionError(f"(d) race.watch_from_static() resolved {points}")
        (rc, out, err, gate_s, gate_analyzed), (frc, fout, ferr, flow_s, flow_analyzed) = \
            [done.result() for _, done in gates]
    finally:
        for proc, _ in gates:
            if proc.poll() is None:
                proc.kill()
        pool.shutdown()

    if rc != 0:
        raise AssertionError(f"(a) --check-baseline exited {rc}: {out[-3000:]}{err[-2000:]}")
    results = json.loads(sarif.read_text())["runs"][0]["results"]
    by_rule = dict(sorted(Counter(r["ruleId"] for r in results).items()))
    errors = sum(1 for r in results if r["level"] == "error")
    committed = dict(sorted(Counter(e["rule"] for e in baseline.load().values()).items()))
    if errors or by_rule != committed:
        raise AssertionError(f"(a) findings by rule {by_rule} ({errors} errors) != the "
                             f"committed baseline's {committed}")
    log(f"(a) python -m crdt_tpu_torch.analysis --check-baseline: exit 0, "
        f"{out.strip().splitlines()[-1]}; by rule {by_rule} == the committed baseline's, "
        f"0 errors; wall {gate_s:.2f} s (analyzed in {gate_analyzed:.2f} s) [{card}]")
    if frc != 0 or flow_s > FLOW_BUDGET_S:
        raise AssertionError(f"(b) --rules {FLOW_RULES} --check-baseline exited {frc} in "
                             f"{flow_s:.2f} s (budget {FLOW_BUDGET_S} s): "
                             f"{fout[-3000:]}{ferr[-2000:]}")
    log(f"(b) --rules {FLOW_RULES} --check-baseline: exit 0, "
        f"{fout.strip().splitlines()[-1]}; wall {flow_s:.2f} s (analyzed in "
        f"{flow_analyzed:.2f} s) of the {FLOW_BUDGET_S} s budget")
    log(f"(c) fx_checks.check_registered_joins: [] over {n_joins} joins' make_fx graphs "
        f"(torch {torch.__version__}), {fx_s:.2f} s")
    log(f"(d) race.watch_from_static(): {len(points)} watch points {points} "
        f"({static_s:.2f} s)")

    line = {"card": card, "check_baseline_s": gate_s, "analyzed_s": gate_analyzed,
            "findings_by_rule": by_rule, "errors": errors, "flow_rules_s": flow_s,
            "flow_rules_analyzed_s": flow_analyzed, "flow_budget_s": FLOW_BUDGET_S,
            "graph_s": fx_s, "joins": n_joins, "static_watch": points, "static_s": static_s,
            "phase_s": time.perf_counter() - t_phase}
    log(f"phase 25: {line['phase_s']:.1f} s (budget {LINT_BUDGET_S} s) [{card}]")
    log(json.dumps({"lint": line}))
    return line


OPTOUT_BUDGET_S = 45
OPTOUT_BLOCKS = 5             # interleaved blocks an arm
OPTOUT_ROUNDS = 150           # pull rounds a block, (a) and (c)
OPTOUT_KS_ROUNDS = 75         # keyspace rounds a block, (b)
OPTOUT_KS_TENANTS = ("t-acme", "t-bolt")
OPTOUT_BAR_PCT = 5.0          # the JAX package's acceptance bar (benches/bench_obs_overhead.py)


def optout_fold(writes) -> dict:
    """The oracle's view of ``writes`` (command dicts) landed on one replica."""
    from crdt_tpu_torch.oracle import OracleReplica, Quirks

    oracle = OracleReplica(0, Quirks())
    for ts, cmd in enumerate(writes):
        oracle.add_command(cmd, ts)
    return OracleReplica.converged_state([oracle])


def optout_timed(loop) -> float:
    """Seconds of ``loop()`` with the collector paused (its pauses only add
    time, at random places)."""
    import gc

    gc.collect()
    gc.disable()
    try:
        t0 = time.perf_counter()
        loop()
        torch.cuda.synchronize()
        return time.perf_counter() - t0
    finally:
        gc.enable()


def optout_pull_block(rounds: int, registry, audit: bool = False) -> dict:
    """benches/bench_obs_overhead.py's ``_run_block`` (``audit=False``: a
    writer and a puller on one host clock sharing a Metrics over
    ``registry``, a BirthLedger and step clock installed, one command and
    one delta ``pull_round`` a round) or its ``_run_audit_block``
    (``audit=True``, or the same loop with the audit off: a live registry,
    both nodes' digests, a watchdog noting the writer's (vv, frontier,
    digest) every round and evaluating every 8th, and in both a frontier
    fold every 16th round) on the card; one warm round untimed."""
    from crdt_tpu_torch.api.node import ReplicaNode, pull_round
    from crdt_tpu_torch.obs.audit import AuditWatchdog
    from crdt_tpu_torch.obs.provenance import BirthLedger
    from crdt_tpu_torch.obs.trace import mint_trace_id
    from crdt_tpu_torch.utils.clock import HostClock
    from crdt_tpu_torch.utils.metrics import Metrics

    clock = HostClock()
    metrics = Metrics(registry=registry)
    writer = ReplicaNode(rid=0, clock=clock, metrics=metrics, device="cuda")
    puller = ReplicaNode(rid=1, clock=clock, metrics=metrics, device="cuda")
    ledger = BirthLedger()
    fold_every = 0 if audit is None else 16
    watchdog = None
    if audit is None:  # (a): the recorder in the hottest configuration a soak runs
        for node in (writer, puller):
            node.recorder.install(ledger=ledger, step_clock=lambda: 0)
    elif audit:
        writer.enable_audit()
        puller.enable_audit()
        watchdog = AuditWatchdog(puller)
    writes = [{"warm": "1"}] + [{f"k{i % 8}": str(i)} for i in range(rounds)]
    writer.add_command(writes[0])
    fresh = [pull_round(puller, writer.gossip_payload, metrics, delta=True, peer="0",
                        trace=mint_trace_id(1))]
    if fold_every:
        f0 = writer.version_vector()
        writer.compact(f0)
        puller.compact(f0)
    if watchdog is not None:
        watchdog.note_host("http://writer", *writer.audit_snapshot()[1:])

    def loop():
        for i in range(rounds):
            writer.add_command(writes[1 + i])
            fresh.append(pull_round(puller, writer.gossip_payload, metrics, delta=True,
                                    peer="0", trace=mint_trace_id(1)))
            if fold_every and i % fold_every == fold_every - 1:
                f = writer.version_vector()
                writer.compact(f)
                puller.compact(f)
            if watchdog is not None:
                watchdog.note_host("http://writer", *writer.audit_snapshot()[1:])
                if i % 8 == 7:
                    watchdog.evaluate()

    seconds = optout_timed(loop)
    return {"seconds": seconds, "nodes": (writer, puller), "metrics": metrics,
            "ledgers": [ledger], "writes": writes, "merges": len(writes) + sum(fresh),
            "watchdog": watchdog}


def optout_ks_block(rounds: int, registry) -> dict:
    """benches/bench_obs_overhead.py's ``_run_ks_block`` on the card: two
    ``ShardedKeyspace``s of 2 shards (capacity 4096, the host path) sharing
    a Metrics over ``registry``, a per-shard BirthLedger, a tenant front
    door draining each admit inline (max_batch 1), a lease held on slot 0;
    a round admits a write for each of two tenants, re-checks the lease
    and its push fence, and pulls both shards."""
    from crdt_tpu_torch.api.node import pull_round
    from crdt_tpu_torch.consistency.leases import LeaseManager
    from crdt_tpu_torch.keyspace import KeyspaceFrontDoor, ShardedKeyspace, qualify
    from crdt_tpu_torch.obs.provenance import BirthLedger
    from crdt_tpu_torch.obs.trace import mint_trace_id
    from crdt_tpu_torch.utils.clock import HostClock
    from crdt_tpu_torch.utils.metrics import Metrics

    clock = HostClock()
    metrics = Metrics(registry=registry)
    n_shards = 2
    kss = [ShardedKeyspace(rid, n_shards, capacity=4096, metrics=metrics, clock=clock,
                           mesh="off", device="cuda") for rid in (0, 1)]
    writer, puller = kss
    step = {"n": 0}
    ledgers = [BirthLedger() for _ in range(n_shards)]
    for ks in kss:
        for i, shard in enumerate(ks.shards):
            shard.recorder.install(ledger=ledgers[i], step_clock=lambda: step["n"])
    door = KeyspaceFrontDoor(writer, max_batch=1, flush_deadline_s=60.0, metrics=metrics,
                             node="0")
    leases = LeaseManager(writer.shards[0], n_slots=1, duration=3600.0, metrics=metrics)
    leases.attach("http://self", lambda: [])
    fence = leases.ensure(0)
    if fence is None:
        raise AssertionError("(b) a one-member lease was not granted")
    writes = [(t, "warm", "1") for t in OPTOUT_KS_TENANTS]
    for t, k, v in writes:
        door.admit_kv(t, k, v)
    fresh = [pull_round(puller.shards[s], writer.shards[s].gossip_payload, metrics,
                        delta=True, peer="0", trace=mint_trace_id(1))
             for s in range(n_shards)]

    def loop():
        for i in range(rounds):
            step["n"] = i
            for t in OPTOUT_KS_TENANTS:
                door.admit_kv(t, f"k{i % 8}", str(i))
                writes.append((t, f"k{i % 8}", str(i)))
            if leases.ensure(0) != fence:
                raise AssertionError("(b) the held lease's fence moved")
            leases.check_push_fences({0: fence})
            for s in range(n_shards):
                fresh.append(pull_round(puller.shards[s], writer.shards[s].gossip_payload,
                                        metrics, delta=True, peer="0",
                                        trace=mint_trace_id(1)))

    seconds = optout_timed(loop)
    return {"seconds": seconds, "nodes": tuple(s for ks in kss for s in ks.shards),
            "metrics": metrics, "ledgers": ledgers,
            "writes": [{qualify(t, k): v} for t, k, v in writes],
            "merges": len(writes) + sum(fresh), "watchdog": None}


def optout_check(label: str, arm: str, out: dict, want: dict, first: dict | None) -> None:
    """A block's ``==`` checks: every node's view == the oracle's fold
    (a keyspace's shards together) and == ``first``'s, node by node (vv
    and frontier too); the null arm recorded nothing (no series, no rate
    mark, no birth, the recorders off); a live arm counted every merge (a
    write or admit each, and each pull that merged fresh ops), and an
    audited arm's watchdog saw only agreement."""
    from crdt_tpu_torch.obs.audit import AUDIT_OK

    nodes = out["nodes"]
    if len(nodes) == 2:
        views = [n.get_state() for n in nodes]
    else:  # a keyspace pair: each member's shards together
        half = len(nodes) // 2
        views = [{k: v for n in part for k, v in n.get_state().items()}
                 for part in (nodes[:half], nodes[half:])]
    if any(v != want for v in views):
        raise AssertionError(f"{label} {arm}: a view != the oracle's fold of "
                             f"{len(out['writes'])} writes")
    if first is not None:  # the first block of the A/B, either arm
        for a, b in zip(nodes, first["nodes"]):
            if (a.get_state() != b.get_state() or a.version_vector() != b.version_vector()
                    or a.frontier != b.frontier):
                raise AssertionError(f"{label} {arm}: node {a.rid} != the first block's")
    reg = out["metrics"].registry
    births = sum(len(lg) for lg in out["ledgers"])
    if arm == "null":
        if (reg.snapshot() != {} or out["metrics"].snapshot() != {} or out["metrics"]._samples
                or births or any(n.recorder.enabled for n in nodes)):
            raise AssertionError(f"{label} null: the null registry recorded something "
                                 f"({births} births)")
        return
    if reg.counter_value("merge_dispatches") != out["merges"]:
        raise AssertionError(f"{label} {arm}: crdt_merge_dispatches_total "
                             f"{reg.counter_value('merge_dispatches')} != {out['merges']} merges")
    if out["watchdog"] is not None and out["watchdog"].state != AUDIT_OK:
        raise AssertionError(f"{label} {arm}: audit state {out['watchdog'].state}")


def optout_ab(label: str, block, rounds: int, arms: tuple, card: str) -> dict:
    """``OPTOUT_BLOCKS`` interleaved blocks of each arm ``(name, registry
    factory, keywords)``, each checked against the oracle and the first
    block; the best block's µs a round an arm and the overhead of the first
    arm over the second."""
    ref, best, merges = None, {}, {}
    for _ in range(OPTOUT_BLOCKS):
        for arm, registry, kw in arms:
            out = block(rounds, registry(), **kw)
            optout_check(label, arm, out, optout_fold(out["writes"]), ref)
            ref = ref or out
            merges[arm] = out["merges"]
            best[arm] = min(best.get(arm, math.inf), out["seconds"])
    us = {arm: best[arm] / rounds * 1e6 for arm, _, _ in arms}
    (on, _, _), (off, _, _) = arms
    pct = 100.0 * (us[on] - us[off]) / us[off]
    merges = merges[on]
    log(f"{label} {OPTOUT_BLOCKS} x {rounds} rounds an arm, interleaved, GC paused: "
        f"{on} {us[on]:.1f} us/round, {off} {us[off]:.1f} us/round (best block); overhead "
        f"{pct:+.2f}% (the JAX package's bar: <= {OPTOUT_BAR_PCT:.0f}%); every view == the "
        f"oracle's fold and == across blocks and arms; {merges} merges counted [{card}]")
    return {"rounds": rounds, "blocks": OPTOUT_BLOCKS, f"us_per_round_{on}": us[on],
            f"us_per_round_{off}": us[off], "overhead_pct": pct, "merges": merges}


def optout_phase(card: str) -> dict:
    """Phase 26: (a) the pull-round block with a live registry against
    NULL_REGISTRY, (b) the keyspace round the same way, (c) the audit plane
    on against off with a live registry in both; one {"optout": ...} JSON
    line."""
    import gc

    from crdt_tpu_torch.obs import NULL_REGISTRY, MetricsRegistry

    t_phase = time.perf_counter()
    log(f"phase 26 (the telemetry opt-out): budget {OPTOUT_BUDGET_S} s")
    line = {"card": card, "bar_pct": OPTOUT_BAR_PCT}
    null = (lambda: NULL_REGISTRY)
    # the earlier phases' objects go to the permanent generation, so each
    # block's collection before its timed loop scans only the block's own
    gc.collect()
    gc.freeze()
    try:
        line["pull"] = optout_ab("(a) pull round", optout_pull_block, OPTOUT_ROUNDS, (
            ("live", MetricsRegistry, {"audit": None}), ("null", null, {"audit": None})), card)
        line["keyspace"] = optout_ab("(b) keyspace round", optout_ks_block, OPTOUT_KS_ROUNDS, (
            ("live", MetricsRegistry, {}), ("null", null, {})), card)
        line["audit"] = optout_ab("(c) audit plane", optout_pull_block, OPTOUT_ROUNDS, (
            ("on", MetricsRegistry, {"audit": True}), ("off", MetricsRegistry, {"audit": False})),
            card)
    finally:
        gc.unfreeze()
    line["phase_s"] = time.perf_counter() - t_phase
    log(f"phase 26: {line['phase_s']:.1f} s (budget {OPTOUT_BUDGET_S} s) [{card}]")
    log(json.dumps({"optout": line}))
    return line


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
    nb = native_build()
    log(f"native host runtime: {nb['seconds']:.2f} s (g++ -O2, "
        f"{'built' if nb['built'] else 'reused'} build/native/{nb['library']})")
    for name in _build.SOURCES:
        func = ""  # the kernel (mangled) that ptxas's next lines describe
        for line in _build.build_log(name).splitlines():
            if "Function properties for" in line:
                func = line.split("Function properties for", 1)[1].strip()
            elif "registers" in line or "spill" in line:
                log(f"  ptxas [{name}] {func}: {line.strip()}")

    rows = [oplog_phases(card)]
    set_rows, floor_full = set_phases(card)
    rows += set_rows
    rows += rseq_phases(card)
    rows += floor_phases(floor_full, card)
    counter_phases(card)
    kv = kv_phase(card)
    typed_phase(card, rows, kv)
    http_phase(card)
    net_phase(card)
    ks_phase(card)
    nemesis_phase(card)
    crash_phase(card)
    hr_phase(card)
    md_phase(card)
    verify_phase(card)
    lint_phase(card)
    optout_phase(card)

    print(card, flush=True)
    log(json.dumps({"kernels": rows}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
