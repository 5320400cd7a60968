"""The port's audit plane (crdt_tpu_torch.ops.digest and .obs.audit)
against the JAX package's, zero tolerance: the digest functions on seeded
rows, a JAX node and a port node (device="cpu") taking the same
transitions with the digest compared after each one, the frontier clamp,
the planted-flip chain of tests/test_audit.py mirrored on both packages
(with the postmortem bundle), cross_check, and the ``python -m
crdt_tpu_torch.obs.audit`` CLI."""
import json
import random
import subprocess
import sys
import tarfile
from pathlib import Path

import numpy as np
import pytest

from crdt_tpu.api import node as jnode
from crdt_tpu.obs import audit as jaudit
from crdt_tpu.ops import digest as jdig
from crdt_tpu.utils import checkpoint as jckpt
from crdt_tpu.utils import clock as jclock
from crdt_tpu_torch.api import node as tnode
from crdt_tpu_torch.obs import audit as taudit
from crdt_tpu_torch.ops import digest as tdig
from crdt_tpu_torch.utils import checkpoint as tckpt
from crdt_tpu_torch.utils import clock as tclock

ROOT = Path(__file__).resolve().parent.parent


def _rows(seed: int, n: int = 64):
    rng = random.Random(seed)
    return [(f"k{rng.randrange(50)}", rng.randrange(-2 ** 40, 2 ** 62),
             rng.randrange(-5, 2 ** 31), rng.randrange(0, 2 ** 33)) for _ in range(n)]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_row_hash_forms_equal_the_jax_package(seed):
    """key_lanes, fold_ts, row_lanes_one, the pure-int mirror, lane sums
    and the hex form: equal to the JAX package's on the same rows."""
    int_acc = tdig.ZERO_INTS
    np_rows = []
    for key, ts, rid, seq in _rows(seed):
        assert np.array_equal(tdig.key_lanes(key), jdig.key_lanes(key))
        assert tdig.key_lanes_ints(key) == jdig.key_lanes_ints(key)
        assert tdig.fold_ts(ts) == jdig.fold_ts(ts)
        a = tdig.row_lanes_one(tdig.key_lanes(key), ts, rid, seq)
        b = tdig.row_lanes_ints(tdig.key_lanes_ints(key), ts, rid, seq)
        assert np.array_equal(a, jdig.row_lanes_one(jdig.key_lanes(key), ts, rid, seq))
        assert b == jdig.row_lanes_ints(jdig.key_lanes_ints(key), ts, rid, seq)
        assert tuple(int(v) for v in a) == b
        np_rows.append(a)
        int_acc = tdig.add_lanes_ints(int_acc, b)
    batch = np.stack(np_rows)
    assert np.array_equal(tdig.lane_sum(batch), jdig.lane_sum(batch))
    assert tdig.digest_hex(tdig.lane_sum(batch)) == tdig.digest_hex(int_acc)
    rows = [(tdig.key_lanes(k), ts, r, s) for k, ts, r, s in _rows(seed, 16)]
    assert np.array_equal(tdig.digest_rows(rows), jdig.digest_rows(rows))
    kl = tdig.key_lanes_ints("x")
    r = tdig.row_lanes_ints(kl, 5, 1, 2)
    assert tdig.sub_lanes_ints(tdig.add_lanes_ints(int_acc, r), r) == int_acc
    assert np.array_equal(tdig.sub_lanes(tdig.add_lanes(batch[0], batch[1]), batch[1]), batch[0])


def test_digest_hex_round_trip_and_garbage_rejected():
    acc = (1, 2, 0xFFFFFFFF, 0)
    s = tdig.digest_hex(acc)
    assert s == jdig.digest_hex(acc) and len(s) == 32
    assert tuple(int(v) for v in tdig.parse_digest_hex(s)) == acc
    for bad in (None, 7, "", "zz" * 16, s[:-1], s + "0"):
        assert tdig.parse_digest_hex(bad) is None and jdig.parse_digest_hex(bad) is None


class Pair:
    """A JAX node and a port node, each on its own ManualClock at the same
    epoch, taking the same calls; ``same()`` holds their digests equal."""

    def __init__(self, rid: int, epoch: int = 1_000_000):
        self.j = jnode.ReplicaNode(rid=rid, capacity=64, clock=jclock.ManualClock())
        self.t = tnode.ReplicaNode(rid=rid, capacity=64, clock=tclock.ManualClock(),
                                   device="cpu")
        for n in (self.j, self.t):
            n.clock.epoch_ms = epoch
            n.enable_audit()

    def both(self, name, *args, **kw):
        a = getattr(self.j, name)(*args, **kw)
        b = getattr(self.t, name)(*args, **kw)
        assert a == b, (name, a, b)
        return a

    def same(self, where: str) -> None:
        assert self.t.digest.acc == self.j.digest.acc, where
        assert self.t.digest.winner == self.j.digest.winner, where
        assert self.t.audit_snapshot() == self.j.audit_snapshot(), where
        _, _, acc = self.t.digest.compute_from_store()
        assert acc == self.t.digest.acc, f"the port's digest drifted after {where}"


def _pull(dst: Pair, src: Pair, payloads=None) -> None:
    for side in ("j", "t"):
        d, s = getattr(dst, side), getattr(src, side)
        fetch = (lambda since=None, s=s: s.gossip_payload(since)) if payloads is None \
            else (lambda since=None, p=payloads: dict(p))
        mod = jnode if side == "j" else tnode
        mod.pull_round(d, fetch, d.metrics, delta=True, peer=str(s.rid))


def test_digest_equal_after_every_state_transition(tmp_path):
    """Local writes, a batched write, merges, a compaction fold, summary
    adoption by a fresh node and a checkpoint round trip: the port's
    digest (accumulator, winners, snapshot) == the JAX node's after each,
    and == its own from-scratch recompute."""
    a, b = Pair(0), Pair(1)
    for i in range(6):
        a.both("add_command", {f"k{i % 4}": str(i)}, ts=i * 10)
    a.same("local writes")
    a.both("add_commands", [{"k1": "x"}, {"k5": "7", "k6": "y"}], [70, 71])
    a.same("a batched write")
    _pull(b, a)
    b.same("merge")
    b.both("add_command", {"k9": "peer"}, ts=100)
    _pull(a, b)
    a.same("cross merge")
    f = a.both("version_vector")
    a.both("compact", f)
    a.same("fold")
    fresh = Pair(2)
    _pull(fresh, a, payloads=a.t.gossip_payload())
    fresh.same("summary adoption")
    assert fresh.t.audit_digest_at(f) == a.t.audit_digest_at(f) == a.j.audit_digest_at(f)
    b.both("compact", f)
    b.same("a fold on the second node")
    tckpt.save_node_atomic(str(tmp_path / "t"), a.t)
    jckpt.save_node_atomic(str(tmp_path / "j"), a.j)
    back = Pair(0, epoch=5)
    assert tckpt.load_latest_node(str(tmp_path / "t"), back.t)
    assert jckpt.load_latest_node(str(tmp_path / "j"), back.j)
    back.same("checkpoint restore")
    assert back.t.audit_digest_at(f) == a.j.audit_digest_at(f)


def test_frontier_clamp_under_skew_and_in_flight_ops():
    """Clocks 4.3 s apart, op sets that differ above the frontier: equal
    digests AT the frontier, in both packages alike; outside the window
    the clamp refuses (None) in both."""
    a, b = Pair(0, epoch=1_000_000), Pair(1, epoch=1_004_321)
    for i in range(5):
        a.both("add_command", {f"k{i}": str(i)}, ts=i * 10)
    b.both("add_command", {"kb": "1"}, ts=7)
    _pull(b, a)
    _pull(a, b)
    f = a.both("version_vector")
    a.both("compact", f)
    b.both("compact", f)
    before = a.t.audit_digest_at(f)
    assert before == b.t.audit_digest_at(f) == a.j.audit_digest_at(f) is not None
    a.both("add_command", {"k0": "newer"}, ts=500)
    b.both("add_command", {"zz": "other"}, ts=600)
    for p in (a, b):
        assert p.t.audit_digest_at(f) == p.j.audit_digest_at(f) == before
    ahead = {r: s + 10 for r, s in f.items()}
    for n in (a.t, a.j):
        assert n.audit_digest_at(ahead) is None and n.audit_digest_at({}) is None


def test_planted_flip_convicted_detected_and_postmortem(tmp_path):
    """tests/test_audit.py's chain, on both packages: plant a silent
    winner-ts flip on a, its scrub convicts it (b scrubs clean), b's
    watchdog sees the disagreement at the shared frontier, emits
    divergence_detected, latches AUDIT_DIVERGED and writes one postmortem
    bundle with the witnesses; the packages' witnesses, digests and
    divergence records are equal."""
    seen = {}
    for pkg, node_mod, aud, clk in (("j", jnode, jaudit, jclock), ("t", tnode, taudit, tclock)):
        kw = {} if pkg == "j" else {"device": "cpu"}
        a = node_mod.ReplicaNode(rid=0, capacity=64, clock=clk.ManualClock(), **kw)
        b = node_mod.ReplicaNode(rid=1, capacity=64, clock=clk.ManualClock(), **kw)
        a.enable_audit()
        b.enable_audit()
        for i in range(6):
            a.add_command({f"k{i % 3}": str(i)}, ts=i * 10)
        node_mod.pull_round(b, a.gossip_payload, b.metrics, delta=True, peer="0")
        f = a.version_vector()
        a.compact(f)
        b.compact(f)
        out = tmp_path / pkg
        out.mkdir()
        log = out / "events.jsonl"
        log.write_text(json.dumps({"event": "boot", "node": "1"}) + "\n")
        wd = aud.AuditWatchdog(b)
        wd.configure_postmortem(str(out), seed=7, log_paths=[str(log)])
        _, fr, dig = a.audit_snapshot()
        wd.note_host("http://a", fr, dig)
        assert wd.state == aud.AUDIT_OK
        witness = aud.plant_divergence(a)
        assert a.audit_scrub() is True and b.audit_scrub() is False
        _, fr2, dig2 = a.audit_snapshot()
        assert fr2 == fr and dig2 != dig
        wd.note_host("http://a", fr2, dig2)
        assert wd.state == aud.AUDIT_DIVERGED
        [div] = wd.divergences
        [ev] = b.events.find(event="divergence_detected")
        assert b.metrics.registry.gauge_value("audit_state") == aud.AUDIT_DIVERGED
        bundle = out / "postmortem-7.tar.gz"
        assert wd.postmortem_path == str(bundle)
        with tarfile.open(bundle) as tf:
            names = tf.getnames()
            wit = json.loads(tf.extractfile("audit_witnesses.json").read())
        assert "events.jsonl" in names
        # latched: a second disagreeing frontier writes no second bundle
        a.add_command({"k0": "more"}, ts=900)
        node_mod.pull_round(b, a.gossip_payload, b.metrics, delta=True, peer="0")
        f3 = a.version_vector()
        a.compact(f3)
        b.compact(f3)
        _, fr3, dig3 = a.audit_snapshot()
        wd.note_host("http://a", fr3, dig3)
        assert wd.state == aud.AUDIT_DIVERGED
        assert len(list(out.glob("postmortem-*.tar.gz"))) == 1
        seen[pkg] = (witness, div, {k: ev[k] for k in div}, wit, dig, dig2, dig3,
                     wd.report()["divergences"], b.metrics.registry.counter_value(
                         "audit_divergences"))
    assert seen["t"] == seen["j"]


def test_plant_divergence_is_rid_keyed_and_value_invisible():
    """Two nodes planting 'the same' corruption disagree (the bump is
    rid-keyed) and get_state never changes, as in the JAX package."""
    nodes = [tnode.ReplicaNode(rid=rid, capacity=64, clock=tclock.ManualClock(), device="cpu")
             for rid in (3, 4)]
    for i in range(4):
        nodes[0].add_command({f"k{i}": str(i)}, ts=i)
    nodes[1].receive(nodes[0].gossip_payload())
    for n in nodes:
        n.enable_audit()
        n.compact({3: 3})
    assert nodes[0].audit_snapshot()[1:] == nodes[1].audit_snapshot()[1:]  # frontier, digest
    before = [n.get_state() for n in nodes]
    wits = [taudit.plant_divergence(n) for n in nodes]
    assert wits[0]["key"] == wits[1]["key"] and wits[0]["ts_after"] != wits[1]["ts_after"]
    assert [n.get_state() for n in nodes] == before
    for n in nodes:
        assert n.audit_scrub()
    assert nodes[0].audit_snapshot()[2] != nodes[1].audit_snapshot()[2]


def test_watchdog_scrub_cadence_stall_and_lag_edges():
    """evaluate(): the scrub every scrub_every ticks, the frontier stall
    after stall_rounds stale ticks (edge-triggered, re-armed on
    recovery), the lag breach once per excursion; counters and events as
    the JAX watchdog's."""
    from crdt_tpu.consistency.stability import StabilityTracker as JTracker
    from crdt_tpu_torch.consistency.stability import StabilityTracker as TTracker

    out = {}
    for pkg, node_mod, aud, tracker, clk in (("j", jnode, jaudit, JTracker, jclock),
                                            ("t", tnode, taudit, TTracker, tclock)):
        kw = {} if pkg == "j" else {"device": "cpu"}
        n = node_mod.ReplicaNode(rid=0, capacity=64, clock=clk.ManualClock(), **kw)
        n.enable_audit()
        n.add_command({"a": "1"}, ts=1)
        now = [0.0]
        tr = tracker(n, ["p"], max_staleness=5.0, clock=lambda: now[0])
        wd = aud.AuditWatchdog(n, stability=tr, scrub_every=2, stall_rounds=2,
                               lag_threshold=3.0)
        log = []
        for step in range(8):
            if step == 4:
                tr.note("p", {0: 0}, {})
            now[0] = 10.0 if step >= 6 else 0.0
            n.metrics.registry.set_gauge("convergence_lag_ops", 9.0 if step in (1, 2, 6) else 0.0,
                                         node="0")
            wd.evaluate()
            log.append((wd.evals, n.metrics.registry.counter_value("audit_frontier_stalls"),
                        n.metrics.registry.counter_value("audit_lag_breaches")))
        out[pkg] = (log, [e["event"] for e in n.events.find() if e["event"].startswith("audit")],
                    wd.report())
    assert out["t"] == out["j"]


def test_watchdog_shard_planes_and_lease_zombies():
    """The keyspace's shard planes in the watchdog (planes(), note_shard
    agreeing then diverging, the report's per-plane digests) and the
    lease-zombie evaluator (edge-triggered on an expired, unhanded-off
    lease; re-armed on recovery): answers, counters and events as the JAX
    watchdog's."""
    out = {}
    for pkg in ("j", "t"):
        if pkg == "j":
            from crdt_tpu.consistency.leases import LeaseManager
            from crdt_tpu.keyspace import KeyspaceFrontDoor, ShardedKeyspace

            ks = ShardedKeyspace(0, 3, capacity=32, mesh="off", clock=jclock.ManualClock())
            node, aud = jnode.ReplicaNode(rid=0, capacity=32, clock=jclock.ManualClock()), jaudit
        else:
            from crdt_tpu_torch.consistency.leases import LeaseManager
            from crdt_tpu_torch.keyspace import KeyspaceFrontDoor, ShardedKeyspace

            ks = ShardedKeyspace(0, 3, capacity=32, mesh="off", clock=tclock.ManualClock(),
                                 device="cpu")
            node = tnode.ReplicaNode(rid=0, capacity=32, clock=tclock.ManualClock(),
                                     device="cpu")
            aud = taudit
        node.enable_audit()
        ks.enable_audit()
        door = KeyspaceFrontDoor(ks, max_batch=4)
        for i in range(9):
            door.admit_cmd("t-a", {f"k{i}": str(i)}, timeout=5.0)
        now = [0.0]
        leases = LeaseManager(node, n_slots=2, duration=1.0, clock=lambda: now[0])
        leases.attach("http://me", lambda: [])
        wd = aud.AuditWatchdog(node, keyspace=ks, leases=leases, scrub_every=0)
        log = [[p for p, _ in wd.planes()], wd._plane_node("ks-9") is None]
        for i in range(3):
            snap = ks.audit_snapshot(i)
            wd.note_shard("peer", i, snap[0], snap[2])
        wd.note_shard("peer2", 1, ks.audit_snapshot(1)[0], "0" * 32)
        log.append(leases.ensure(0))
        for step in range(5):
            now[0] = (2.0 if step in (1, 2) else 0.5) + step * 0.0
            if step == 3:
                leases.held_fence(0)
            wd.evaluate()
            log.append((wd.state, node.metrics.registry.counter_value("audit_lease_zombies")))
        reg = node.metrics.registry
        log.append([reg.gauge_value("audit_agreement", plane=f"ks-{i}") for i in range(3)])
        rep = wd.report()
        log.append((sorted(rep["planes"]), rep["divergences"], rep["state"]))
        log.append([{k: v for k, v in e.items() if k not in ("ts_ms", "v", "trace")}
                    for e in node.events.find() if e["event"].startswith(("audit", "divergence",
                                                                           "lease"))])
        out[pkg] = log
    assert out["t"] == out["j"]
    assert out["t"][0] == ["host", "ks-0", "ks-1", "ks-2"] and out["t"][-2][1]


def test_cross_check_and_the_cli(tmp_path):
    """cross_check groups digests by exact frontier as the JAX function
    does; ``python -m crdt_tpu_torch.obs.audit`` over saved reports exits
    1 on a disagreement, 0 on agreement."""
    reports = {
        "a": {"state": 1, "planes": {"host": {"digest": "x" * 32, "frontier": {"0": 3}}}},
        "b": {"state": 1, "planes": {"host": {"digest": "x" * 32, "frontier": {"0": 3}}}},
        "c": {"state": 1, "planes": {"host": {"digest": "y" * 32, "frontier": {"0": 4}}}},
        "d": {"state": 0, "planes": {"host": {"digest": None, "frontier": {}}}},
    }
    assert taudit.cross_check(reports) == jaudit.cross_check(reports)
    paths = []
    for name, rep in reports.items():
        p = tmp_path / f"{name}.json"
        p.write_text(json.dumps(rep))
        paths.append(str(p))

    def cli(*targets):
        return subprocess.run([sys.executable, "-m", "crdt_tpu_torch.obs.audit", *targets],
                              cwd=ROOT, capture_output=True, text=True, timeout=60)

    ok = cli(*paths[:2])
    assert ok.returncode == 0 and json.loads(ok.stdout)["verdict"] == "ok"
    reports["c"]["planes"]["host"]["frontier"] = {"0": 3}
    (tmp_path / "c.json").write_text(json.dumps(reports["c"]))
    bad = cli(*paths)
    assert bad.returncode == 1 and json.loads(bad.stdout)["verdict"] == "diverged"
    assert "digests disagree" in bad.stderr
    assert cli(str(tmp_path / "missing.json")).returncode == 2
