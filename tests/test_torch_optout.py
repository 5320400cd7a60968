"""The telemetry opt-out (``NULL_REGISTRY``), the ``Metrics`` readers and
the rest of ``obs`` in the port against the JAX package, zero tolerance.

The opt-out twins run ``benches/bench_obs_overhead.py``'s schedules in
both packages: ``_run_block`` (a writer and a puller on one clock, one
command a round, a delta ``pull_round``, a shared ``BirthLedger``
installed) and ``_run_ks_block`` (two keyspaces of 2 shards, a tenant
front door draining each admit inline, a held lease), each once with a
live registry and once with ``NULL_REGISTRY``.  Both packages' nodes run on
a ``ManualClock`` each (epoch 0), the JAX node on its Python path and its
keyspace with ``mesh="off"``, so views, version vectors, frontiers and
gossip payloads compare as they are.
"""
from __future__ import annotations

import ast
import collections
import math
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

from crdt_tpu.api import node as jnode
from crdt_tpu.consistency.leases import LeaseManager as JLeases
from crdt_tpu.keyspace.frontdoor import KeyspaceFrontDoor as JDoor
from crdt_tpu.keyspace.shards import ShardedKeyspace as JKeyspace
from crdt_tpu.obs import health as jhealth
from crdt_tpu.obs import provenance as jprov
from crdt_tpu.obs import registry as jreg
from crdt_tpu.obs.trace import mint_trace_id as jmint
from crdt_tpu.ops import union_engine as jengine
from crdt_tpu.utils.clock import ManualClock as JClock
from crdt_tpu.utils.metrics import Metrics as JMetrics
from crdt_tpu_torch.api import node as tnode
from crdt_tpu_torch.consistency.leases import LeaseManager as TLeases
from crdt_tpu_torch.keyspace.frontdoor import KeyspaceFrontDoor as TDoor
from crdt_tpu_torch.keyspace.shards import ShardedKeyspace as TKeyspace
from crdt_tpu_torch.obs import devtime as tdevtime
from crdt_tpu_torch.obs import health as thealth
from crdt_tpu_torch.obs import provenance as tprov
from crdt_tpu_torch.obs import registry as treg
from crdt_tpu_torch.obs.trace import mint_trace_id as tmint
from crdt_tpu_torch.ops import sorted_union as tsorted
from crdt_tpu_torch.ops import union_engine as tengine
from crdt_tpu_torch.utils.clock import ManualClock as TClock
from crdt_tpu_torch.utils.metrics import Metrics as TMetrics
from tests.test_torch_node import assert_nodes_equal

ROOT = Path(__file__).resolve().parent.parent

PKG = {
    "j": SimpleNamespace(node=jnode, reg=jreg, prov=jprov, mint=jmint, Clock=JClock,
                         Metrics=JMetrics, Keyspace=JKeyspace, Door=JDoor, Leases=JLeases,
                         kw={}, ks_kw={"mesh": "off"}),
    "t": SimpleNamespace(node=tnode, reg=treg, prov=tprov, mint=tmint, Clock=TClock,
                         Metrics=TMetrics, Keyspace=TKeyspace, Door=TDoor, Leases=TLeases,
                         kw={"device": "cpu"}, ks_kw={"mesh": "off", "device": "cpu"}),
}
ROUNDS = 40
KS_ROUNDS = 12
TENANTS = ("t-acme", "t-bolt")


def run_block(p, registry, rounds=ROUNDS):
    """``_run_block``'s schedule in package ``p``: (writer, puller, metrics,
    ledger)."""
    clock = p.Clock()
    metrics = p.Metrics(registry=registry)
    writer = p.node.ReplicaNode(rid=0, clock=clock, metrics=metrics, use_native=False, **p.kw)
    puller = p.node.ReplicaNode(rid=1, clock=clock, metrics=metrics, use_native=False, **p.kw)
    step = {"n": 0}
    ledger = p.prov.BirthLedger()
    for node in (writer, puller):
        node.recorder.install(ledger=ledger, step_clock=lambda: step["n"])
    writer.add_command({"warm": "1"})
    p.node.pull_round(puller, writer.gossip_payload, metrics, delta=True, peer="0",
                      trace=p.mint(1))
    for i in range(rounds):
        writer.add_command({f"k{i % 8}": str(i)})
        p.node.pull_round(puller, writer.gossip_payload, metrics, delta=True, peer="0",
                          trace=p.mint(1))
    return writer, puller, metrics, ledger


def run_ks_block(p, registry, rounds=KS_ROUNDS):
    """``_run_ks_block``'s schedule in package ``p`` at a small capacity:
    (writer, puller, metrics, ledgers)."""
    clock = p.Clock()
    metrics = p.Metrics(registry=registry)
    n_shards = 2
    writer = p.Keyspace(0, n_shards, capacity=64, metrics=metrics, clock=clock, **p.ks_kw)
    puller = p.Keyspace(1, n_shards, capacity=64, metrics=metrics, clock=clock, **p.ks_kw)
    step = {"n": 0}
    ledgers = [p.prov.BirthLedger() for _ in range(n_shards)]
    for ks in (writer, puller):
        for i, shard in enumerate(ks.shards):
            shard.recorder.install(ledger=ledgers[i], step_clock=lambda: step["n"])
    door = p.Door(writer, max_batch=1, flush_deadline_s=60.0, metrics=metrics, node="0")
    leases = p.Leases(writer.shards[0], n_slots=1, duration=3600.0, metrics=metrics)
    leases.attach("http://self", lambda: [])
    fence = leases.ensure(0)
    assert fence is not None
    for t in TENANTS:
        door.admit_kv(t, "warm", "1")
    for i in range(n_shards):
        p.node.pull_round(puller.shards[i], writer.shards[i].gossip_payload, metrics,
                          delta=True, peer="0", trace=p.mint(1))
    for i in range(rounds):
        step["n"] = i
        for t in TENANTS:
            door.admit_kv(t, f"k{i % 8}", str(i))
        assert leases.ensure(0) == fence
        leases.check_push_fences({0: fence})
        for s in range(n_shards):
            p.node.pull_round(puller.shards[s], writer.shards[s].gossip_payload, metrics,
                              delta=True, peer="0", trace=p.mint(1))
    return writer, puller, metrics, ledgers


def assert_same_node(a, b):
    """Two port nodes of one package: equal view, vv, frontier, payloads."""
    assert a.get_state() == b.get_state()
    assert a.version_vector() == b.version_vector()
    assert a.frontier == b.frontier
    assert a.gossip_payload() == b.gossip_payload()
    assert a.gossip_payload({0: 5}) == b.gossip_payload({0: 5})


def untimed(snap):
    """A snapshot without its timings: the merge's device attribution and
    the wall-clock readings (tests/test_torch_http.py's exemptions)."""
    return {k: v for k, v in snap.items() if not k.startswith("join_")
            and "_p50_ms" not in k and "unixtime" not in k and "seconds" not in k}


def _arms(run):
    return {(pkg, arm): run(PKG[pkg], PKG[pkg].reg.NULL_REGISTRY if arm == "null"
                            else PKG[pkg].reg.MetricsRegistry())
            for pkg in "jt" for arm in ("live", "null")}


def test_pull_round_block_with_and_without_telemetry_matches_jax():
    """Equal across the packages in each arm and across the arms in each
    package; under the null registry neither package records anything."""
    arms = _arms(run_block)
    for arm in ("live", "null"):
        jw, jp, _, _ = arms["j", arm]
        tw, tp, _, _ = arms["t", arm]
        vvs = [tw.version_vector(), tp.version_vector(), {0: 7}]
        assert_nodes_equal(jw, tw, vvs)
        assert_nodes_equal(jp, tp, vvs)
    assert arms["t", "live"][1].get_state() == {f"k{i}": str(sum(range(i, ROUNDS, 8)))
                                                for i in range(8)} | {"warm": "1"}
    for pkg in "jt":
        for k in (0, 1):
            assert_same_node(arms[pkg, "live"][k], arms[pkg, "null"][k])
        writer, puller, metrics, ledger = arms[pkg, "null"]
        assert metrics.snapshot() == {} and metrics.registry.render_prometheus() == "\n"
        assert not writer.recorder.enabled and not puller.recorder.enabled
        assert not puller.enable_audit().enabled
        assert puller.audit_snapshot()[2] is None
        assert all(ledger.birth_step(0, s) is None for s in range(ROUNDS + 2))
        writer, puller, metrics, ledger = arms[pkg, "live"]
        assert writer.recorder.enabled and puller.enable_audit().enabled
        assert metrics.registry.counter_value("merge_dispatches") == 2 * (ROUNDS + 1)
        assert all(ledger.birth_step(0, s) is not None for s in range(ROUNDS + 1))
    # the live arms record the same series in both packages, values aside
    # (the merge timings and the device attribution are the exemptions of
    # tests/test_torch_http.py)
    jsnap, tsnap = arms["j", "live"][2].snapshot(), arms["t", "live"][2].snapshot()
    assert untimed(jsnap) == untimed(tsnap)
    assert any(k.startswith("join_device_count") for k in tsnap)


def test_keyspace_block_with_and_without_telemetry_matches_jax():
    """``_run_ks_block``'s loop: every shard equal across the packages and
    the arms; the null arm records nothing in either package."""
    arms = _arms(run_ks_block)
    for arm in ("live", "null"):
        for k in (0, 1):
            jks, tks = arms["j", arm][k], arms["t", arm][k]
            for js, ts in zip(jks.shards, tks.shards):
                assert_nodes_equal(js, ts, [ts.version_vector()])
    for pkg in "jt":
        live, null = arms[pkg, "live"], arms[pkg, "null"]
        for k in (0, 1):
            for a, b in zip(live[k].shards, null[k].shards):
                assert_same_node(a, b)
        assert null[2].snapshot() == {}
        assert all(not s.recorder.enabled for ks in null[:2] for s in ks.shards)
        assert all(lg.birth_step(0, s) is None for lg in null[3] for s in range(64))
        assert any(lg.birth_step(0, s) is not None for lg in live[3] for s in range(64))
        if pkg == "t":
            assert untimed(arms["j", "live"][2].snapshot()) == untimed(live[2].snapshot())
        tenant_ops = [k for k in live[2].snapshot() if k.startswith("keyspace_tenant_ops{")]
        assert tenant_ops and not any(k.startswith("keyspace_") for k in null[2].snapshot())


# ------------------------------------------------------------- Metrics


def _observations(seed: int, n: int = 500) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return np.exp(rng.uniform(np.log(1e-7), np.log(2e3), n))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_metrics_quantiles_match_jax(seed):
    """p50 and quantile over the same observations (the log2 buckets'
    upper bounds, the +Inf bucket, q clamped into the mass); NaN for an
    absent histogram in both."""
    jm, tm = JMetrics(), TMetrics()
    for x in _observations(seed):
        jm.observe("merge", float(x))
        tm.observe("merge", float(x))
    assert jm.p50("merge") == tm.p50("merge")
    for q in (0.0, 0.01, 0.25, 0.5, 0.9, 0.99, 1.0, 1.5):
        assert jm.quantile("merge", q) == tm.quantile("merge", q)
    assert math.isnan(jm.quantile("absent", 0.5)) and math.isnan(tm.quantile("absent", 0.5))
    assert jm.snapshot() == tm.snapshot()


def test_metrics_counts_and_snapshot_match_jax():
    """``_counts`` (label-free counters only) and the snapshot, with a
    name used as both a counter and a timer."""
    pair = (JMetrics(reservoir=16), TMetrics(reservoir=16))
    for m in pair:
        m.inc("merge_events", 3)
        m.inc("seq_collect_behind")
        m.registry.inc("labeled", peer="x")
        for _ in range(5):
            m.observe("merge", 0.002)
    assert pair[0]._counts == pair[1]._counts == {"merge_events": 3, "seq_collect_behind": 1}
    assert pair[0].snapshot() == pair[1].snapshot()


def test_metrics_rate_lifetime_and_windowed():
    """tests/test_obs.py's rate properties in the port: the lifetime rate,
    a window covering the whole lifetime equal to it, absent names 0."""
    m = TMetrics()
    for _ in range(10):
        m.inc("ops")
    assert m.rate("ops") > 0
    assert m.rate("absent") == 0
    full = m.rate("ops", window=60.0)
    assert full == pytest.approx(m.rate("ops"), rel=0.5)
    assert m.rate("absent", window=60.0) == 0


def test_metrics_rate_window_rebases_on_its_marks():
    """A window shorter than the lifetime counts from the newest mark at or
    before its start (the count already there when it opened), else from
    the oldest mark inside it; with no mark at all it reads 0.  The marks
    are set on each instance by hand, the same in both packages."""
    for p in PKG.values():
        m = p.Metrics()
        m._t0 -= 100.0  # a Metrics made 100 s ago
        now = m._t0 + 100.0
        m.registry.inc("ops", 30)
        m._samples["ops"] = collections.deque([(now - 50.0, 10.0), (now - 5.0, 20.0)])
        assert m.rate("ops", window=10.0) == pytest.approx((30 - 10) / 10.0, rel=1e-3)
        assert m.rate("ops", window=1.0) == pytest.approx((30 - 20) / 1.0, rel=1e-3)
        m._samples["ops"] = collections.deque([(now - 5.0, 20.0)])
        assert m.rate("ops", window=10.0) == pytest.approx((30 - 20) / 5.0, rel=1e-3)
        assert m.rate("ops", window=200.0) == pytest.approx(30 / 100.0, rel=1e-3)
        m.registry.inc("quiet", 4)
        assert m.rate("quiet", window=10.0) == 0.0


def test_null_registry_skips_rate_marks_in_both_packages():
    for p in PKG.values():
        m = p.Metrics(registry=p.reg.NULL_REGISTRY)
        m.inc("ops", 5)
        m.observe("merge", 0.1)
        assert m._samples == {} and m.snapshot() == {} and m._counts == {}
        assert m.rate("ops") == 0 and math.isnan(m.p50("merge"))
        reg = p.reg.NULL_REGISTRY
        reg.add_callback(lambda r: r.set_gauge("g", 1.0))
        assert reg.snapshot() == {} and reg.histograms("merge") == []
        assert reg.counter_value("ops") == 0 and reg.gauge_value("g") is None


# ------------------------------------------------------------- devtime


class SpyRegistry(treg.MetricsRegistry):
    """A live registry that notes the dispatch at which each gauge is set."""

    def __init__(self):
        super().__init__()
        self.gauge_sets = []

    def set_gauge(self, name, value, **labels):
        n = self.histogram("join_device", node=labels.get("node", ""), kind="merge")
        self.gauge_sets.append((name, n.count if n is not None else 0))
        super().set_gauge(name, value, **labels)


def test_device_gauges_are_sampled_one_in_sixteen():
    """33 merges of one node: the join_device histogram counts all 33, the
    bytes gauge lands at dispatches 1, 17 and 33 only; a second node's
    first dispatch lands its own."""
    reg = SpyRegistry()
    metrics = TMetrics(registry=reg)
    nodes = [tnode.ReplicaNode(rid=rid, metrics=metrics, device="cpu", use_native=False,
                               clock=TClock()) for rid in (731, 732)]
    for rid in (731, 732):
        tdevtime._dispatch_counts.pop((str(rid), "merge"), None)
    for i in range(33):
        nodes[0].add_command({"k": str(i)})
    assert reg.histogram("join_device", node="731", kind="merge").count == 33
    assert [d for name, d in reg.gauge_sets if name == "join_bytes_per_dispatch"] == [1, 17, 33]
    nodes[1].add_command({"k": "1"})
    assert reg.gauge_value("join_bytes_per_dispatch", node="732", kind="merge") > 0
    assert tdevtime.GAUGE_SAMPLE_EVERY == 16


def test_null_registry_node_skips_the_merge_attribution():
    """A NULL_REGISTRY node times nothing: no dispatch counted for its
    label, no annotation, no observe_join."""
    label = ("733", "merge")
    tdevtime._dispatch_counts.pop(label, None)
    node = tnode.ReplicaNode(rid=733, metrics=TMetrics(registry=treg.NULL_REGISTRY),
                             device="cpu", use_native=False, clock=TClock())
    for i in range(3):
        node.add_command({"k": str(i)})
    assert label not in tdevtime._dispatch_counts
    tdevtime.observe_join(treg.NULL_REGISTRY, "733", (node.log,), node.log, 0.01)
    assert label not in tdevtime._dispatch_counts
    with tdevtime.dispatch_annotation("merge", enabled=False) as got:
        assert got is None
    with tdevtime.DispatchTimer() as t:
        pass
    assert t.seconds >= 0


def test_observe_join_has_one_call_site_gated_on_the_recorder():
    """The port calls observe_join at one merge site, inside ``if timing``
    where ``timing = self.recorder.enabled``."""
    sites = []
    for path in sorted((ROOT / "crdt_tpu_torch").rglob("*.py")):
        tree = ast.parse(path.read_text())
        parents = {c: n for n in ast.walk(tree) for c in ast.iter_child_nodes(n)}
        for n in ast.walk(tree):
            if isinstance(n, ast.Call) and getattr(n.func, "attr", None) == "observe_join":
                up = parents[n]
                while not isinstance(up, (ast.If, ast.FunctionDef)):
                    up = parents[up]
                sites.append((path.relative_to(ROOT).as_posix(),
                              isinstance(up, ast.If) and ast.unparse(up.test)))
    assert sites == [("crdt_tpu_torch/api/node.py", "timing")]
    src = (ROOT / "crdt_tpu_torch/api/node.py").read_text()
    assert src.count("timing = self.recorder.enabled") == 1


# ------------------------------------------------------------- the rest of obs


def test_propagation_by_tenant_matches_jax():
    """The same tenant-labelled (and unlabelled) propagation histograms
    through both packages' fold."""
    rng = np.random.default_rng(5)
    regs = {"j": [jreg.MetricsRegistry() for _ in range(3)],
            "t": [treg.MetricsRegistry() for _ in range(3)]}
    for i in range(3):
        for _ in range(60):
            tenant = ["t-acme", "t-bolt", None][int(rng.integers(0, 3))]
            steps, secs = float(rng.integers(1, 40)), float(rng.uniform(1e-4, 2.0))
            labels = {"origin": str(i)} | ({"tenant": tenant, "shard": "3"} if tenant else {})
            for pkg in "jt":
                regs[pkg][i].observe("op_propagation_steps", steps, **labels)
                regs[pkg][i].observe("op_propagation", secs, **labels)
    want = jprov.propagation_by_tenant(*regs["j"])
    assert set(want) == {"t-acme", "t-bolt"}
    assert tprov.propagation_by_tenant(*regs["t"]) == want
    assert tprov.propagation_summary(*regs["t"]) == jprov.propagation_summary(*regs["j"])
    assert tprov.propagation_by_tenant(treg.MetricsRegistry()) == {}


def test_sample_race_watch_without_a_detector_matches_jax():
    jr, tr = jreg.MetricsRegistry(), treg.MetricsRegistry()
    jhealth.sample_race_watch(jr)
    thealth.sample_race_watch(tr)
    assert tr.gauge_value("race_witnesses") == 0.0
    assert jr.render_prometheus() == tr.render_prometheus()


@pytest.mark.parametrize("name", ["sort", "bucket", "bitmap"])
def test_get_engine_is_the_union_engines(name):
    assert tsorted.get_engine(name) is tengine.get_engine(name)
    assert tengine.get_engine(name).__name__ == jengine.get_engine(name).__name__
    with pytest.raises(KeyError):
        tsorted.get_engine("nope")


def test_package_surface_imports():
    """The imports the README shows, and the package-level names."""
    import torch

    import crdt_tpu_torch
    from crdt_tpu_torch import native
    from crdt_tpu_torch.api import LocalCluster, ReplicaNode
    from crdt_tpu_torch.harness import WorkloadGenerator
    from crdt_tpu_torch.obs import NULL_REGISTRY, FlightRecorder
    from crdt_tpu_torch.utils import constants

    assert ReplicaNode is tnode.ReplicaNode and LocalCluster.__module__.endswith("cluster")
    assert NULL_REGISTRY is treg.NULL_REGISTRY and FlightRecorder is tprov.FlightRecorder
    assert WorkloadGenerator.__module__ == "crdt_tpu_torch.workload"
    assert crdt_tpu_torch.constants is constants and constants.DEFAULT_DTYPE is torch.int32
    assert isinstance(native.AVAILABLE, bool)
    native.lib()
    assert native.AVAILABLE is True
