"""``python -m crdt_tpu_torch`` (own copy of ``python -m crdt_tpu``): the
demo swarm, or one network daemon, with every replica's log on the CUDA
card.

The demo is the reference's ``go run main.go`` (its main.go:316-327): N
replicas serve the reference's HTTP surface on consecutive ports
(``api.http_shim``), gossip in the background, and the reference's
workload POSTs to random replicas, with a periodic convergence report.
The final report drives the cluster to its fixpoint; the exit code is 0
only when every surface converged.

    python -m crdt_tpu_torch --duration 10 --ephemeral-ports

``--daemon`` runs ONE replica as its own process (``api.net.NodeHost``):
it serves on ``--port``, pulls a random one of ``--peers`` every
``--gossip-ms``, and with ``--checkpoint-dir`` restores its newest
snapshot at boot under a fresh incarnation rid (rid + stride x
incarnation).  A fleet is one such process per replica:

    python -m crdt_tpu_torch --daemon --rid 0 --port 8080 \
        --peers http://127.0.0.1:8081,http://127.0.0.1:8082 --coordinator \
        --compact-every 8 --checkpoint-dir ckpt/0 --event-log ckpt/0.jsonl

``--device`` picks the torch device (default: the CUDA card; without one
the command exits 2 rather than fall back; ``--device cpu`` is for the
tests).  ``--keyspace-shards S`` adds the sharded keyspace tier (S
plane shards on the card, the tenant door and the ``/ks/*`` routes).
"""
from __future__ import annotations

import argparse
import json
import sys
import threading
import time

INT32_MAX = 2**31 - 1


def run_demo(args, device) -> int:
    from crdt_tpu_torch.api.cluster import LocalCluster
    from crdt_tpu_torch.api.http_shim import HttpCluster
    from crdt_tpu_torch.utils.config import ClusterConfig
    from crdt_tpu_torch.workload import WorkloadGenerator

    cfg = ClusterConfig(
        n_replicas=args.replicas,
        base_port=args.base_port,
        gossip_period_ms=args.gossip_ms,
        write_period_ms=args.write_ms,
        reference_topology=args.reference_topology,
        compact_every=args.compact_every,
        delta_gossip=not args.full_gossip,
        set_collect_every=args.set_collect_every if args.with_sets else 0,
        seq_collect_every=args.seq_collect_every if args.with_seqs else 0,
        map_reset_every=args.map_reset_every if args.with_maps else 0,
    )
    cluster = LocalCluster(cfg, device=device)
    http = HttpCluster(cluster)
    ports = http.start(
        None if args.ephemeral_ports else cfg.ports()
    )
    urls = [f"http://127.0.0.1:{p}" for p in ports]
    print(f"serving {len(urls)} replicas: {', '.join(urls)}")

    cluster.start()  # background gossip loops (reference-live mode)
    wg = WorkloadGenerator(cfg, seed=args.seed)
    t_end = time.time() + args.duration if args.duration else None
    writes = 0
    last_report = time.time()
    set_ops = 0
    seq_ops = 0
    map_ops = 0
    try:
        while t_end is None or time.time() < t_end:
            writes += wg.drive_http(urls, 1)
            if args.with_sets:
                set_ops += wg.drive_set_http(urls, 1)
            if args.with_seqs:
                seq_ops += wg.drive_seq_http(urls, 1)
            if args.with_maps:
                map_ops += wg.drive_map_http(urls, 1)
            if time.time() - last_report >= args.report_every:
                converged = cluster.converged()
                alive = [s for s in cluster.states() if s is not None]
                keys = len(alive[0]) if alive else 0
                m = cluster.metrics.snapshot()
                line = (
                    f"[{time.strftime('%H:%M:%S')}] writes={writes} "
                    f"keys={keys} converged={converged} "
                    f"gossip_rounds={m.get('gossip_rounds', 0)} "
                    f"payload_ops={m.get('gossip_payload_ops', 0)} "
                    f"merge_p50_ms={m.get('merge_p50_ms', 'n/a')}"
                )
                if args.with_sets:
                    members = cluster.set_nodes[0].members() or []
                    line += (
                        f" | set_ops={set_ops} members={len(members)} "
                        f"set_converged={cluster.set_converged()} "
                        f"set_collections="
                        f"{m.get('set_collections', 0)}"
                    )
                if args.with_seqs:
                    items = cluster.seq_nodes[0].items() or []
                    line += (
                        f" | seq_ops={seq_ops} len={len(items)} "
                        f"seq_converged={cluster.seq_converged()} "
                        f"seq_collections="
                        f"{m.get('seq_collections', 0)}"
                    )
                if args.with_maps:
                    mitems = cluster.map_nodes[0].items() or {}
                    line += (
                        f" | map_ops={map_ops} keys={len(mitems)} "
                        f"map_converged={cluster.map_converged()} "
                        f"map_resets="
                        f"{m.get('map_resets_scheduled', 0)}"
                    )
                print(line)
                last_report = time.time()
            time.sleep(cfg.write_period_ms / 1000.0)
    except KeyboardInterrupt:
        pass
    finally:
        cluster.stop()
        http.stop()

    # final report: drive to the fixpoint (bounded: random-peer pulls can
    # miss — especially under --reference-topology's dead-port friend list)
    ok = cluster.converged()
    set_ok = cluster.set_converged() if args.with_sets else True
    seq_ok = cluster.seq_converged() if args.with_seqs else True
    map_ok = cluster.map_converged() if args.with_maps else True
    for _ in range(64 * len(cluster.nodes)):
        if ok and set_ok and seq_ok and map_ok:
            break
        cluster.tick()
        ok = cluster.converged()
        set_ok = cluster.set_converged() if args.with_sets else True
        seq_ok = cluster.seq_converged() if args.with_seqs else True
        map_ok = cluster.map_converged() if args.with_maps else True
    alive = [s for s in cluster.states() if s is not None]
    line = (f"final: writes={writes} converged={ok} "
            f"state_keys={len(alive[0]) if alive else 0}")
    if args.with_sets:
        members = cluster.set_nodes[0].members() or []
        line += (f" | set_ops={set_ops} set_converged={set_ok} "
                 f"members={len(members)}")
    if args.with_seqs:
        items = cluster.seq_nodes[0].items() or []
        line += (f" | seq_ops={seq_ops} seq_converged={seq_ok} "
                 f"len={len(items)}")
    if args.with_maps:
        mitems = cluster.map_nodes[0].items() or {}
        line += (f" | map_ops={map_ops} map_converged={map_ok} "
                 f"keys={len(mitems)}")
    print(line)
    if args.dump_state and alive:
        print(json.dumps(alive[0], sort_keys=True))
    return 0 if ok and set_ok and seq_ok and map_ok else 1


def run_daemon(args, device) -> int:
    from crdt_tpu_torch.api.net import NodeHost
    from crdt_tpu_torch.utils.config import ClusterConfig

    if args.compact_every and not args.coordinator:
        # barriers come from exactly one member (network_compact's
        # single-scheduler rule); a non-coordinator still folds when the
        # coordinator's barrier reaches it
        print("--compact-every in --daemon mode requires --coordinator "
              "(exactly one daemon in the fleet schedules barriers)",
              file=sys.stderr)
        return 2
    if args.go_compat_gossip and (args.compact_every or args.full_gossip):
        print("--go-compat-gossip forbids --compact-every and --full-gossip "
              "(summary sections / lossy full dumps are for Go peers only)",
              file=sys.stderr)
        return 2
    if args.set_collect_every and not args.coordinator:
        print("--set-collect-every in --daemon mode requires --coordinator "
              "(exactly one daemon schedules set GC barriers)",
              file=sys.stderr)
        return 2
    if args.seq_collect_every and not args.coordinator:
        print("--seq-collect-every in --daemon mode requires --coordinator "
              "(exactly one daemon schedules seq GC barriers)",
              file=sys.stderr)
        return 2
    if args.map_reset_every and not args.coordinator:
        print("--map-reset-every in --daemon mode requires --coordinator "
              "(exactly one daemon schedules map reset barriers)",
              file=sys.stderr)
        return 2
    cfg = ClusterConfig(
        gossip_period_ms=args.gossip_ms,
        compact_every=args.compact_every,
        delta_gossip=not args.full_gossip,
        go_compat_gossip=args.go_compat_gossip,
        set_collect_every=args.set_collect_every,
        seq_collect_every=args.seq_collect_every,
        map_reset_every=args.map_reset_every,
        keyspace_shards=args.keyspace_shards,
    )
    peers = [u for u in (args.peers or "").split(",") if u]
    rid = args.rid
    incarnation = 0
    if args.checkpoint_dir:
        # crash recovery: claim a fresh boot incarnation (persisted before
        # serving) and write under a per-incarnation rid, so a restored
        # daemon never re-mints (rid, seq) pairs its dead predecessor may
        # have gossiped out (utils/checkpoint.py's module docstring)
        if not 0 <= args.rid < args.rid_stride:
            # rid >= stride would alias another slot's incarnation rid
            print(f"--checkpoint-dir requires 0 <= --rid < --rid-stride "
                  f"(got rid={args.rid}, stride={args.rid_stride}): base "
                  "rids share the incarnation id space", file=sys.stderr)
            return 2
        from crdt_tpu_torch.utils.checkpoint import bump_incarnation

        incarnation = bump_incarnation(args.checkpoint_dir)
        rid = args.rid + args.rid_stride * incarnation
        if rid > INT32_MAX:
            # the node's rid plane is int32
            print(f"incarnation {incarnation} of rid {args.rid} (stride "
                  f"{args.rid_stride}) is rid {rid}, past the int32 rid plane",
                  file=sys.stderr)
            return 2
    host = NodeHost(
        rid=rid, peers=peers, port=args.port, config=cfg,
        coordinator=args.coordinator,
        checkpoint_dir=args.checkpoint_dir,
        checkpoint_every_s=args.checkpoint_every_s,
        event_log=args.event_log,
        device=device,
    )
    host.start()
    # run the sequence lattice's device paths once in the background, so
    # a daemon's first /seq ingest pays no one-time setup inside a peer's
    # request deadline; a KV-only fleet's boot never waits on it
    warm_t = threading.Thread(target=host.seq_node.warmup, daemon=True)
    warm_t.start()
    print(f"replica rid={rid} (base {args.rid}, incarnation {incarnation}, "
          f"restored={host.restored}) serving on {host.url}, "
          f"{len(peers)} peer(s)", flush=True)
    t_end = time.time() + args.duration if args.duration else None
    try:
        while t_end is None or time.time() < t_end:
            time.sleep(0.2)
    except KeyboardInterrupt:
        pass
    finally:
        warm_t.join(timeout=120)
        host.stop()
    state = host.node.get_state()
    print(f"final: state_keys={len(state) if state else 0}")
    if args.dump_state and state:
        print(json.dumps(state, sort_keys=True))
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m crdt_tpu_torch",
        description="The CRDT store on a CUDA card: the demo swarm or one network daemon.",
    )
    ap.add_argument("--replicas", type=int, default=5,
                    help="demo: replica count (reference: 5, main.go:319)")
    ap.add_argument("--base-port", type=int, default=8080)
    ap.add_argument("--ephemeral-ports", action="store_true",
                    help="demo: let the OS pick ports (CI-safe)")
    ap.add_argument("--gossip-ms", type=int, default=1500,
                    help="anti-entropy period (reference: 1500, main.go:229)")
    ap.add_argument("--write-ms", type=int, default=300,
                    help="demo workload period (reference: 300, main.go:280)")
    ap.add_argument("--duration", type=float, default=0,
                    help="seconds to run (0 = until Ctrl-C)")
    ap.add_argument("--report-every", type=float, default=5.0)
    ap.add_argument("--seed", type=int, default=None)
    ap.add_argument("--reference-topology", action="store_true",
                    help="demo: friend list includes self + dead ports "
                         "(reference quirk §0.1.9)")
    ap.add_argument("--compact-every", type=int, default=0,
                    help="fold swarm-stable ops every N rounds (0 = never, "
                         "the reference's unbounded-log behavior)")
    ap.add_argument("--full-gossip", action="store_true",
                    help="ship the full log every round (reference behavior) "
                         "instead of deltas")
    ap.add_argument("--set-collect-every", type=int, default=0,
                    help="run a set-lattice GC barrier every N gossip "
                         "rounds (demo: scheduled by replica 0's loop, "
                         "needs --with-sets; daemon: coordinator only; "
                         "0 = only explicit POST /admin/set_barrier)")
    ap.add_argument("--with-sets", action="store_true",
                    help="demo: drive the OR-Set lattice alongside the KV "
                         "workload (/set/add + /set/remove on random "
                         "replicas) and report set convergence")
    ap.add_argument("--with-seqs", action="store_true",
                    help="demo: drive the sequence lattice alongside the "
                         "KV workload (/seq/insert + /seq/remove) and "
                         "report sequence convergence")
    ap.add_argument("--seq-collect-every", type=int, default=0,
                    help="run a sequence GC barrier every N gossip rounds "
                         "(demo: replica 0's loop, needs --with-seqs; "
                         "daemon: coordinator only)")
    ap.add_argument("--with-maps", action="store_true",
                    help="demo: drive the map lattice alongside the KV "
                         "workload (/map/upd + /map/rem — the concrete "
                         "PN-composition map with reset-wins epoch GC) "
                         "and report map convergence")
    ap.add_argument("--map-reset-every", type=int, default=0,
                    help="run a full-fleet map reset barrier every N "
                         "gossip rounds (demo: needs --with-maps; daemon: "
                         "coordinator only; 0 = only explicit "
                         "POST /admin/map_barrier)")
    ap.add_argument("--go-compat-gossip", action="store_true",
                    help="daemon: emit full-dump gossip with bare integer-ms "
                         "keys so an ORIGINAL Go peer can pull from this "
                         "node (lossy: last-writer-per-ms)")
    ap.add_argument("--dump-state", action="store_true")
    ap.add_argument("--daemon", action="store_true",
                    help="run ONE network replica instead of the demo swarm")
    ap.add_argument("--rid", type=int, default=0,
                    help="daemon: globally unique writer id")
    ap.add_argument("--port", type=int, default=8080,
                    help="daemon: listen port (0 = ephemeral)")
    ap.add_argument("--peers", type=str, default="",
                    help="daemon: comma-separated peer base URLs")
    ap.add_argument("--coordinator", action="store_true",
                    help="daemon: schedule cross-fleet barriers from this "
                         "process (exactly one per fleet)")
    ap.add_argument("--checkpoint-dir", type=str, default=None,
                    help="daemon: crash-safe snapshot directory; on boot, "
                         "restore the newest snapshot and claim a fresh "
                         "incarnation (rid += stride * incarnation)")
    ap.add_argument("--checkpoint-every-s", type=float, default=0,
                    help="daemon: periodic snapshot interval (0 = only "
                         "explicit POST /admin/checkpoint)")
    ap.add_argument("--rid-stride", type=int, default=64,
                    help="daemon: writer-id stride between boot "
                         "incarnations of one checkpoint dir")
    ap.add_argument("--event-log", type=str, default=None,
                    help="daemon: JSONL event-log path (one line per "
                         "gossip round, barrier and fault transition, with "
                         "the round's X-CRDT-Trace ID)")
    ap.add_argument("--keyspace-shards", type=int, default=0,
                    help="daemon: enable the sharded keyspace tier with "
                         "this many hash shards (0 = single-plane layout); "
                         "shard planes checkpoint/restore through the "
                         "same manifest machinery as the KV node")
    ap.add_argument("--device", default=None,
                    help="torch device of every replica's state (default: the "
                         "CUDA card; the command fails without one rather than "
                         "fall back; cpu is for the tests)")
    args = ap.parse_args(argv)
    from crdt_tpu_torch import default_device

    try:
        device = default_device(args.device)
    except RuntimeError as e:
        print(f"python -m crdt_tpu_torch: {e}", file=sys.stderr)
        return 2
    return run_daemon(args, device) if args.daemon else run_demo(args, device)


if __name__ == "__main__":
    sys.exit(main())
