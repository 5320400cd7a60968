"""The port's fault plane (crdt_tpu_torch.faults, device="cpu") against the
JAX package's, zero tolerance: every case of tests/test_faults.py runs in
both packages and the two runs give equal answers.

* Snapshot integrity: the manifest round trip and tamper checks, LATEST at
  a missing directory, the corrupt-LATEST fallback, no restorable snapshot,
  fsync stalls and the FaultyDisk's torn write.
* The circuit breaker's transitions, jitter, threshold and gauges.
* Each wire injector (drop, truncate, corrupt, duplicate, reorder, delay)
  against a served host, the agent-level duplicate and reorder
  idempotence, and payload validation.
* Schedules, plane decisions and step-indexed fault logs: equal bytes
  across the packages over a sweep of seeds, and a JAX FaultyTransport
  pulling from a port daemon (and the reverse) lands where the
  same-package pull does.
* The nemesis smoke (seed 0, 2 nodes, 30 steps) in both packages.
"""
import json
import pathlib
import random
import time
import types
import urllib.request

import pytest

PKGS = ("j", "t")


def pkg(p):
    """One package's modules, with the port's constructors on the CPU."""
    if p == "j":
        from crdt_tpu import faults
        from crdt_tpu.api import net, node
        from crdt_tpu.obs import health
        from crdt_tpu.utils import checkpoint, config, metrics
        dev = {}
    else:
        from crdt_tpu_torch import faults
        from crdt_tpu_torch.api import net, node
        from crdt_tpu_torch.obs import health
        from crdt_tpu_torch.utils import checkpoint, config, metrics
        dev = {"device": "cpu"}
    return types.SimpleNamespace(
        faults=faults, net=net, health=health, ckpt=checkpoint,
        ClusterConfig=config.ClusterConfig, Metrics=metrics.Metrics,
        node=lambda rid=0, capacity=64: node.ReplicaNode(rid=rid, capacity=capacity, **dev),
        host=lambda **kw: net.NodeHost(**kw, **dev))


def both(fn):
    out = {p: fn(pkg(p)) for p in PKGS}
    assert out["t"] == out["j"]
    return out["t"]


def _events(node, name):
    return [{k: v for k, v in e.items() if k != "ts_ms"}
            for e in node.events.tail(100) if e.get("event") == name]


def _count(metrics, name):
    return metrics.registry.counter_value(name) or 0


def _plane(P, *rules, seed=0):
    return P.faults.FaultPlane(P.faults.NemesisSchedule(
        seed=seed, steps=1000, nodes=2, rules=tuple(rules), skews=()))


class Served:
    """One serving NodeHost per package with a little state (the gossip
    source), started lazily and stopped at teardown."""

    def __init__(self):
        self.hosts = {}

    def __call__(self, P):
        key = P.net.__name__
        if key not in self.hosts:
            host = P.host(rid=1, peers=[], port=0)
            host.node.add_command({"x": "1"}, ts=10)
            host.node.add_command({"y": "2"}, ts=11)
            host.start_server()
            self.hosts[key] = host
        return self.hosts[key]

    def stop(self):
        for h in self.hosts.values():
            h.stop_server()


@pytest.fixture
def served():
    s = Served()
    yield s
    s.stop()


def _puller(P, rid=0):
    node = P.node(rid=rid)
    return node, P.net.NetworkAgent(node, [], P.ClusterConfig())


# ---- snapshot integrity: manifest round trip + fallback restore ----


def test_manifest_roundtrip_and_tamper_detection(tmp_path):
    def run(P):
        root = tmp_path / P.net.__name__
        n = P.node(capacity=32)
        n.add_command({"x": "5"}, ts=10)
        snap = P.ckpt.save_node_atomic(root, n)
        manifest = json.loads((pathlib.Path(snap) / P.ckpt.MANIFEST_NAME).read_text())
        out = [sorted(manifest["files"]), P.ckpt.verify_snapshot(snap)]
        torn = P.faults.tear_snapshot(snap, rng=random.Random("t"))
        out += [torn, P.ckpt.verify_snapshot(snap)]
        (pathlib.Path(snap) / torn).unlink()
        out += [P.ckpt.verify_snapshot(snap), P.ckpt.verify_snapshot(root / "nope")]
        return out

    out = both(run)
    assert out[0] == ["log.npz", "meta.json"] and out[1] is None
    assert out[3] == f"digest mismatch: {out[2]}"
    assert out[4] == f"manifest file missing: {out[2]}"
    assert out[5] == "missing snapshot directory"


def test_latest_pointing_at_missing_dir_falls_back(tmp_path):
    def run(P):
        root = tmp_path / P.net.__name__
        n = P.node(capacity=32)
        n.add_command({"x": "5"}, ts=10)
        P.ckpt.save_node_atomic(root, n)
        P.faults.point_latest_at_missing(root)
        n2 = P.node(capacity=32)
        return [P.ckpt.load_latest_node(root, n2), n2.get_state(),
                _events(n2, "snapshot_quarantine"), _events(n2, "snapshot_restore")]

    ok, state, [q], [r] = both(run)
    assert ok and state == {"x": "5"}
    assert q["reason"] == "missing snapshot directory"
    assert r["fallback"] and r["verified"]


def test_corrupt_latest_restores_previous_generation(tmp_path):
    def run(P):
        root = tmp_path / P.net.__name__
        n = P.node(capacity=32)
        n.add_command({"x": "5"}, ts=10)
        P.ckpt.save_node_atomic(root, n)
        n.add_command({"y": "9"}, ts=11)
        P.ckpt.save_node_atomic(root, n)
        torn_name = pathlib.Path(P.faults.plant_corruption(root)).name
        n2 = P.node(capacity=32)
        return [torn_name, P.ckpt.load_latest_node(root, n2), n2.get_state(),
                _count(n2.metrics, "snapshot_quarantines"), _count(n2.metrics, "snapshot_restores"),
                _events(n2, "snapshot_quarantine"), _events(n2, "snapshot_restore"),
                bool(list(root.glob(f"quarantine-{torn_name}"))), (root / torn_name).exists()]

    torn_name, ok, state, nq, nr, [q], [r], moved, left = both(run)
    assert ok and state == {"x": "5"} and nq == nr == 1
    assert q["snap"] == torn_name and "digest mismatch" in q["reason"]
    assert r["fallback"] and r["verified"] and r["snap"] != torn_name
    assert moved and not left


def test_no_restorable_snapshot_returns_false(tmp_path):
    def run(P):
        root = tmp_path / P.net.__name__
        n = P.node(capacity=32)
        out = [P.ckpt.load_latest_node(root, n)]
        n.add_command({"x": "1"}, ts=10)
        P.faults.tear_snapshot(P.ckpt.save_node_atomic(root, n))
        n2 = P.node(capacity=32)
        return out + [P.ckpt.load_latest_node(root, n2), len(_events(n2, "snapshot_quarantine"))]

    assert both(run) == [False, False, 1]


def test_fsync_stall_injection(tmp_path):
    def run(P):
        n = P.node(capacity=32)
        n.add_command({"x": "1"}, ts=10)
        t0 = time.perf_counter()
        with P.faults.fsync_stall(0.02):
            assert P.ckpt._FSYNC_STALL_S == 0.02
            P.ckpt.save_node_atomic(tmp_path / P.net.__name__, n)
        return [time.perf_counter() - t0 >= 0.02, P.ckpt._FSYNC_STALL_S]

    assert both(run) == [True, 0.0]


def test_faulty_disk_torn_write_detected_on_restore(tmp_path):
    def run(P):
        root = tmp_path / P.net.__name__
        plane = _plane(P, P.faults.FaultRule("truncate", op="disk"))
        n = P.node(capacity=32)
        n.add_command({"x": "1"}, ts=10)
        snap, torn = P.faults.FaultyDisk(plane, "0").save(str(root), n)
        n2 = P.node(capacity=32)
        return [torn, P.ckpt.verify_snapshot(snap) is not None, plane.log,
                P.ckpt.load_latest_node(root, n2)]

    torn, bad, log, restored = both(run)
    assert torn and bad and not restored
    assert [r["fault"] for r in log] == ["torn_write"]


# ---- circuit breaker: half-open transitions + decorrelated jitter ----


def test_circuit_breaker_half_open_transitions():
    def run(P):
        now = {"t": 0.0}
        peer = P.net.RemotePeer("http://127.0.0.1:9", backoff_base_s=1.0, backoff_cap_s=30.0,
                                rng=random.Random("cb"), clock=lambda: now["t"])
        out = [peer.circuit_state(), peer.backed_off()]
        peer._note_transport_failure()
        out += [peer.circuit_state(), peer.backed_off(), peer.failures, peer.retry_at]
        now["t"] = peer.retry_at + 0.01
        out += [peer.backed_off(), peer.circuit_state(), peer.backed_off()]
        peer._note_transport_failure()
        out += [peer.circuit_state(), peer.backed_off(), peer.retry_at]
        now["t"] = peer.retry_at + 0.01
        out.append(peer.backed_off())
        peer._note_reachable()
        return out + [peer.circuit_state(), peer.failures, peer.backed_off()]

    out = both(run)
    assert out[:5] == ["closed", False, "open", True, 1] and 1.0 <= out[5] <= 3.0
    assert out[6:11] == [False, "half_open", True, "open", True]
    assert out[12:] == [False, "closed", 0, False]


def test_backoff_jitter_is_decorrelated_and_capped():
    def run(P):
        out = []
        for s in range(6):
            p = P.net.RemotePeer("http://127.0.0.1:9", backoff_base_s=0.5, backoff_cap_s=4.0,
                                 rng=random.Random(f"j{s}"), clock=lambda: 0.0)
            for _ in range(8):
                p._note_transport_failure()
                out.append(p._delay)
            out.append(p.retry_at)
        return out

    out = both(run)
    assert all(0.5 <= d <= 4.0 for i, d in enumerate(out) if i % 9 != 8)
    assert len(set(out[8::9])) > 1


def test_failure_threshold_gates_the_breaker():
    def run(P):
        peer = P.net.RemotePeer("http://127.0.0.1:9", failure_threshold=3,
                                rng=random.Random("th"), clock=lambda: 0.0)
        out = []
        for _ in range(3):
            peer._note_transport_failure()
            out.append((peer.circuit_state(), peer.backed_off()))
        return out

    assert both(run) == [("closed", False), ("closed", False), ("open", True)]


def test_circuit_state_gauges(served):
    def run(P):
        peer = P.net.RemotePeer("http://127.0.0.1:9", clock=lambda: 0.0, rng=random.Random("g"))
        peer._note_transport_failure()
        m = P.Metrics()
        P.health.sample_peer_circuits(m.registry, "0", [peer])
        with urllib.request.urlopen(served(P).url + "/metrics", timeout=5) as res:
            body = res.read().decode()
        return [m.registry.gauge_value("net_peer_circuit_state", node="0", peer=peer.url),
                m.registry.gauge_value("net_peers_unreachable", node="0"),
                m.registry.gauge_value("net_peers_total", node="0"), "net_peers_total" in body]

    assert both(run) == [2, 1, 1, True]


# ---- wire injectors, pinned one at a time ----


def test_drop_injector_counts_transport_failure(served):
    def run(P):
        node, agent = _puller(P)
        t = P.faults.FaultyTransport(served(P).url, _plane(P, P.faults.FaultRule("drop")), "0", "1")
        return [agent.pull_from(t), node.get_state(), t.failures, t.circuit_state(),
                _count(agent.metrics, "net_gossip_skipped"), t.plane.log]

    ok, state, failures, circuit, skipped, log = both(run)
    assert not ok and state == {} and failures == 1 and circuit == "open" and skipped == 1
    assert [r["fault"] for r in log] == ["drop"]


def test_truncate_injector_skips_never_partially_merges(served):
    def run(P):
        node, agent = _puller(P)
        host = served(P)
        t = P.faults.FaultyTransport(host.url, _plane(P, P.faults.FaultRule("truncate")), "0", "1")
        out = [agent.pull_from(t), node.get_state(), node.version_vector(),
               _count(agent.metrics, "net_gossip_skipped")]
        t.plane.heal()
        return out + [agent.pull_from(t), node.get_state() == host.node.get_state(), t.plane.log]

    out = both(run)
    assert out[:4] == [False, {}, {}, 1] and out[4:6] == [True, True]


def test_corrupt_injector_quarantines_and_loop_survives(served):
    def run(P):
        node, agent = _puller(P)
        host = served(P)
        t = P.faults.FaultyTransport(host.url, _plane(P, P.faults.FaultRule("corrupt")), "0", "1")
        out = [agent.pull_from(t), node.get_state(),
               _count(agent.metrics, "net_gossip_quarantined"),
               [(q["surface"], "ValueError" in q["error"])
                for q in _events(node, "payload_quarantine")]]
        t.plane.heal()
        return out + [agent.pull_from(t), node.get_state() == host.node.get_state(), t.plane.log]

    out = both(run)
    assert out[:4] == [False, {}, 1, [("net_gossip", True)]] and out[4:6] == [True, True]


def test_duplicate_injector_second_delivery_noops(served):
    def run(P):
        node, agent = _puller(P)
        t = P.faults.FaultyTransport(served(P).url, _plane(P, P.faults.FaultRule("duplicate")),
                                     "0", "1")
        out = [agent.pull_from(t), t.pending_redelivery()]
        state = json.dumps(node.get_state(), sort_keys=True)
        vv = node.version_vector()
        out += [agent.pull_from(t), t.pending_redelivery()]
        return out + [json.dumps(node.get_state(), sort_keys=True) == state,
                      node.version_vector() == vv, state, t.plane.log]

    assert both(run)[:6] == [True, 1, False, 0, True, True]


def test_reorder_injector_old_after_new_noops(served):
    def run(P):
        node, agent = _puller(P)
        host = served(P)
        plane = _plane(P, P.faults.FaultRule("reorder", end=1))
        t = P.faults.FaultyTransport(host.url, plane, "0", "1")
        out = [agent.pull_from(t), t.pending_redelivery(), node.get_state()]
        plane.step = 1
        host.node.add_command({"z": "7"}, ts=12)
        node.receive(host.node.gossip_payload())
        state = json.dumps(node.get_state(), sort_keys=True)
        vv = node.version_vector()
        out += [agent.pull_from(t), t.pending_redelivery()]
        return out + [json.dumps(node.get_state(), sort_keys=True) == state,
                      node.version_vector() == vv, state, plane.log]

    assert both(run)[:7] == [False, 1, {}, False, 0, True, True]


def test_delay_injector_sleeps_but_delivers(served):
    def run(P):
        node, agent = _puller(P)
        host = served(P)
        t = P.faults.FaultyTransport(host.url, _plane(P, P.faults.FaultRule("delay", arg=0.01)),
                                     "0", "1")
        t0 = time.perf_counter()
        ok = agent.pull_from(t)
        return [ok, time.perf_counter() - t0 >= 0.01, node.get_state() == host.node.get_state(),
                t.plane.log]

    out = both(run)
    assert out[:3] == [True, True, True]
    assert out[3] == [{"step": 0, "fault": "delay", "src": "0", "dst": "1", "op": "gossip",
                       "arg": 0.01}]


class _ScriptedPeer:
    """Duck-typed RemotePeer: serves a fixed payload sequence."""

    url = "scripted://peer"

    def __init__(self, payloads):
        self.payloads = list(payloads)

    def gossip_payload(self, since=None, trace=None):
        return self.payloads.pop(0) if self.payloads else {}


def test_agent_duplicate_and_reorder_delivery_idempotent():
    def run(P):
        src = P.node(rid=1)
        src.add_command({"a": "1"}, ts=10)
        older = src.gossip_payload()
        src.add_command({"b": "2"}, ts=11)
        newer = src.gossip_payload()
        node, agent = _puller(P)
        peer = _ScriptedPeer([newer, newer, older])
        out = [agent.pull_from(peer)]
        state = json.dumps(node.get_state(), sort_keys=True)
        vv = node.version_vector()
        out += [agent.pull_from(peer), agent.pull_from(peer)]
        return out + [json.dumps(node.get_state(), sort_keys=True) == state,
                      node.version_vector() == vv,
                      state == json.dumps(src.get_state(), sort_keys=True), state]

    assert both(run)[:6] == [True, False, False, True, True, True]


def test_validate_payload_flags_malformed_bodies(served):
    def run(P):
        node = P.node(capacity=32)
        good = served(P).node.gossip_payload()
        bad_cmd = dict(good)
        bad_cmd[next(k for k in bad_cmd if not k.startswith("__"))] = "not-a-dict"
        return [node.validate_payload(good),
                node.validate_payload({"nemesis:corrupt:key": {"a": "b"}}),
                node.validate_payload(bad_cmd)]

    ok, mangled, bad = both(run)
    assert ok is None and "ValueError" in mangled and "non-dict command" in bad


# ---- schedule/plane determinism + cross-package bytes ----


def test_schedule_generation_is_deterministic():
    def run(P):
        S = P.faults.NemesisSchedule
        a = S.generate(7, 3, 100)
        return [a == S.generate(7, 3, 100), a != S.generate(8, 3, 100),
                S.from_json(a.to_json()) == a, bool(a.rules),
                any(r.kind == "drop" for r in a.rules), a.to_json()]

    assert both(run)[:5] == [True, True, True, True, True]


@pytest.mark.parametrize("seed", [0, 1, 7, 123])
def test_schedules_and_rule_helpers_equal_bytes_across_packages(seed):
    """The same (seed, nodes, steps) gives byte-equal schedule JSON in both
    packages, with every generator switch and both appended rule sets."""
    def run(P):
        from_sched = P.faults.NemesisSchedule
        sched = P.faults.schedule
        out = []
        for nodes, steps in ((2, 30), (3, 120), (5, 400)):
            for flags in ({}, {"clock_skew": False}, {"partitions": False, "disk_faults": False},
                          {"message_faults": False}):
                out.append(from_sched.generate(seed, nodes, steps, **flags).to_json())
        rules = sched.reshard_window_rules(10, 20) + sched.divergence_rules(5, 30, p=0.1)
        out.append(json.dumps([r.__dict__ for r in rules], sort_keys=True))
        return out

    both(run)


def test_plane_decisions_replay_identically():
    def run(P):
        sched = P.faults.NemesisSchedule.generate(7, 3, 100)
        p1, p2 = P.faults.FaultPlane(sched), P.faults.FaultPlane(sched)
        out = []
        for step in (0, 3, 17, 50):
            p1.step = p2.step = step
            for src, dst in (("0", "1"), ("1", "2"), ("2", "0")):
                d1 = p1.decide(src, dst, "gossip")
                assert d1 == p2.decide(src, dst, "gossip")
                out.append(sorted(d1))
        p1.heal()
        return out + [p1.decide("0", "1", "gossip"), p1.decisions]

    out = both(run)
    assert out[-2] == {} and out[-1] == {"gossip": 13}


def test_plane_decision_sweep_and_fault_log_bytes_equal(tmp_path):
    """Every (step, edge, op) decision of a generated schedule, the census,
    the skews and a written fault log: equal across the packages."""
    def run(P):
        sched = P.faults.NemesisSchedule.generate(3, 3, 60)
        path = tmp_path / f"{P.net.__name__}.jsonl"
        plane = P.faults.FaultPlane(sched, log_path=str(path))
        out = []
        for step in range(60):
            plane.step = step
            out.append([s.skew_ms for s in plane.skews_at(step)])
            for src in "012":
                for dst in "012":
                    for op in ("gossip", "data", "disk", "ks_migrate", "vv"):
                        hits = plane.decide(src, dst, op)
                        out.append(sorted((k, r.arg, r.p) for k, r in hits.items()))
                        for kind in sorted(hits):
                            plane.record(kind, src=src, dst=dst, op=op)
        plane.heal()
        plane.close()
        return out + [plane.counts(), plane.decisions, path.read_bytes()]

    out = both(run)
    assert out[-3].get("heal") == 1 and len(out[-1]) > 0


def test_fault_log_is_step_indexed_without_wall_time(tmp_path):
    def run(P):
        path = tmp_path / f"{P.net.__name__}.jsonl"
        plane = P.faults.FaultPlane(P.faults.NemesisSchedule(seed=0, steps=10, nodes=2, rules=(),
                                                             skews=()), log_path=str(path))
        plane.step = 3
        plane.record("drop", src="0", dst="1", op="gossip")
        plane.heal()
        plane.close()
        return path.read_bytes()

    assert [json.loads(line) for line in both(run).decode().splitlines()] == [
        {"step": 3, "fault": "drop", "src": "0", "dst": "1", "op": "gossip"},
        {"step": 3, "fault": "heal"}]


@pytest.mark.parametrize("kind", ["drop", "truncate", "corrupt", "duplicate", "reorder"])
def test_faulty_transport_across_the_packages(served, kind):
    """A JAX FaultyTransport pulling from a port daemon, and a port one
    pulling from a JAX daemon, land on the state, vv and fault log that a
    same-package pull lands on (two pulls: the fault, then the redelivery
    or the recovery after heal)."""
    def pull(P, source):
        node, agent = _puller(P)
        t = P.faults.FaultyTransport(source.url, _plane(P, P.faults.FaultRule(kind, end=1)),
                                     "0", "1")
        out = [agent.pull_from(t)]
        t.plane.step = 1
        out.append(agent.pull_from(t))
        return out + [node.get_state(), node.version_vector(), t.plane.log,
                      t.pending_redelivery()]

    j, t = pkg("j"), pkg("t")
    same = pull(j, served(j))
    assert pull(j, served(t)) == same
    assert pull(t, served(j)) == same == pull(t, served(t))


def test_muted_recorder_records_no_visibility():
    """A muted flight recorder (a checkpoint replay) records nothing on
    the merge path, as in the JAX package: no op_visible event and no
    propagation observation; unmuted, the same payload records."""
    def run(P):
        src = P.node(rid=1)
        src.add_command({"a": "1"}, ts=10)
        out = []
        for muted in (True, False):
            node = P.node(rid=0)
            node.recorder.muted = muted
            node.receive(src.gossip_payload())
            out.append([len(_events(node, "op_visible")),
                        sorted(k for k in node.metrics.registry.snapshot()
                               if k.startswith("op_propagation"))])
        return out

    muted, live = both(run)
    assert muted == [0, []] and live[0] == 1 and live[1]


# ---- end-to-end smoke ----


def test_nemesis_soak_smoke(tmp_path):
    from crdt_tpu.harness.nemesis_soak import run_soak as jrun
    from crdt_tpu_torch.harness.nemesis_soak import run_soak as trun

    logs = []
    for name, run, kw in (("j", jrun, {}), ("t", trun, {"device": "cpu"})):
        log = tmp_path / f"{name}.jsonl"
        rep = run(seed=0, nodes=2, steps=30, fault_log=str(log), **kw)
        assert rep.writes > 0 and rep.final_keys > 0
        logs.append((log.read_bytes(), rep.state_json, rep.final_vv, rep.writes_ledger))
    assert logs[0] == logs[1]
