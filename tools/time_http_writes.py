"""Time the write paths behind the HTTP surface on a CUDA card: the
replicas' concurrent writes, and single-op POST /data through the ingest
front door.

    python3 tools/time_http_writes.py

Prints one JSON line a measurement, each with the card's name and power
limit:

* ``node_writes``: 5 threads, each landing 100 one-op ``add_commands`` on
  its own replica of a ``LocalCluster()`` (logs of 3,000 rows), with the
  nodes' device lock (``api.node.device_lock``) and with it replaced by a
  no-op lock, beside one thread alone: the median ms a call and the calls
  a second;
* ``post_data``: 2,048 single-op ``POST /data`` (chip_smoke.py
  phase 17's traffic: WorkloadGenerator seed 0, 8 client threads) to an
  ``HttpCluster`` over a fresh ``LocalCluster()``, the clients in the
  server's process or in a process of their own, at the interpreter's
  default switch interval (5 ms) and at 0.2 ms: acknowledged writes a
  second, the client's p50 and p99 ms, the drains and their mean batch.

Exits 1 without a card.
"""
from __future__ import annotations

import contextlib
import json
import statistics
import subprocess
import sys
import threading
import time
from pathlib import Path


def drive(urls, writes) -> list:
    """POST /data of every (index, cmd, target) of ``writes`` from 8 client
    threads; returns each post's seconds."""
    import http.client

    lat, lock = [], threading.Lock()

    def client(t):
        for _, cmd, target in writes[t::8]:
            host, port = urls[target].split("//")[1].split(":")
            t0 = time.perf_counter()
            c = http.client.HTTPConnection(host, int(port), timeout=120)
            c.request("POST", "/data", body=json.dumps(cmd).encode())
            r = c.getresponse()
            r.read()
            c.close()
            if r.status != 200:
                raise AssertionError(f"POST /data: {r.status}")
            with lock:
                lat.append(time.perf_counter() - t0)

    threads = [threading.Thread(target=client, args=(t,)) for t in range(8)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    return lat


POSTS = 2048

# the client process: ``drive`` on (urls, writes) read from stdin
CLIENT = (f"import json, sys; sys.path.insert(0, {str(Path(__file__).resolve().parent)!r}); "
          "from time_http_writes import drive; "
          "print(json.dumps(drive(*json.loads(sys.stdin.read()))))")


def card_line() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], check=True, capture_output=True,
                          text=True, timeout=60).stdout.strip().splitlines()[0]


def warm_cluster(LocalCluster, ClusterConfig):
    import torch

    cluster = LocalCluster(ClusterConfig())
    for n in cluster.nodes:
        n.add_commands([{"w": "1"}] * 3000)
    torch.cuda.synchronize()
    return cluster


def node_writes(nodemod, LocalCluster, ClusterConfig, card) -> None:
    def run(threads: int) -> tuple:
        cluster = warm_cluster(LocalCluster, ClusterConfig)
        times = []

        def worker(node):
            for i in range(100):
                t0 = time.perf_counter()
                node.add_commands([{f"k{i % 62}": "-11"}])
                times.append(time.perf_counter() - t0)

        workers = [threading.Thread(target=worker, args=(n,))
                   for n in cluster.nodes[:threads]]
        t0 = time.perf_counter()
        for w in workers:
            w.start()
        for w in workers:
            w.join()
        return statistics.median(times) * 1e3, 100 * threads / (time.perf_counter() - t0)

    real = nodemod.device_lock
    out = {"alone": run(1), "with_device_lock": run(5)}
    nodemod.device_lock = lambda device: contextlib.nullcontext()
    try:
        out["without_device_lock"] = run(5)
    finally:
        nodemod.device_lock = real
    print(json.dumps({"card": card, "node_writes": {
        k: {"ms_median": ms, "calls_per_s": rate} for k, (ms, rate) in out.items()}}),
        flush=True)


def post_data(n_posts, own_process, switch_s, card) -> None:
    from crdt_tpu_torch import workload
    from crdt_tpu_torch.api.cluster import LocalCluster
    from crdt_tpu_torch.api.http_shim import HttpCluster
    from crdt_tpu_torch.utils.config import ClusterConfig

    sys.setswitchinterval(switch_s)
    cluster = LocalCluster(ClusterConfig())
    drains = []
    for node in cluster.nodes:
        def counted(cmds, tss=None, add=node.add_commands):
            drains.append(len(cmds))
            return add(cmds, tss)
        node.add_commands = counted
    server = HttpCluster(cluster)
    server.start()
    gen = workload.WorkloadGenerator(ClusterConfig())
    writes = [(i, *gen.next_command()) for i in range(n_posts)]
    t0 = time.perf_counter()
    try:
        if own_process:
            lat = json.loads(subprocess.run(
                [sys.executable, "-c", CLIENT], input=json.dumps([server.urls, writes]),
                capture_output=True, text=True, timeout=1200, check=True).stdout)
        else:
            lat = drive(server.urls, writes)
        seconds = time.perf_counter() - t0
    finally:
        server.stop()
        sys.setswitchinterval(0.005)
    lat.sort()
    print(json.dumps({"card": card, "post_data": {
        "posts": n_posts, "clients": "own process" if own_process else "server's process",
        "switch_interval_s": switch_s, "writes_per_s": n_posts / seconds,
        "p50_ms": lat[len(lat) // 2] * 1e3, "p99_ms": lat[int(len(lat) * 0.99)] * 1e3,
        "drains": len(drains), "mean_batch": sum(drains) / len(drains)}}), flush=True)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("time_http_writes: no CUDA device available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    from crdt_tpu_torch.api import node as nodemod
    from crdt_tpu_torch.api.cluster import LocalCluster
    from crdt_tpu_torch.utils.config import ClusterConfig

    card = card_line()
    node_writes(nodemod, LocalCluster, ClusterConfig, card)
    for own_process in (False, True):
        for switch_s in (0.005, 0.0002):
            post_data(POSTS, own_process, switch_s, card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
