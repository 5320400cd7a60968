"""The port's replica node, in-process cluster and oracle
(crdt_tpu_torch.api.node, api.cluster, oracle) against the JAX package's
on the same seeded schedules: views, version vectors, frontiers, folded
summaries and gossip payloads equal (wire timestamps after subtracting each
cluster's epoch), and the final views equal to the oracle's."""
import json
import time

import numpy as np
import pytest

from crdt_tpu.api import cluster as jcluster
from crdt_tpu.api import node as jnode
from crdt_tpu.harness.workload import WorkloadGenerator as JWorkload
from crdt_tpu.models import oplog as jlog
from crdt_tpu.oracle import OracleReplica as JOracle
from crdt_tpu.oracle import Quirks as JQuirks
from crdt_tpu.utils import clock as jclock
from crdt_tpu.utils import config as jconfig
from crdt_tpu_torch import workload
from crdt_tpu_torch.api import cluster as tcluster
from crdt_tpu_torch.api import node as tnode
from crdt_tpu_torch.models import oplog as tlog
from crdt_tpu_torch.oracle import OracleReplica as TOracle
from crdt_tpu_torch.oracle import Quirks as TQuirks
from crdt_tpu_torch.utils import clock as tclock
from crdt_tpu_torch.utils import config as tconfig
from tests.test_parity import _rand_cmd

FIELDS = ("ts", "rid", "seq", "key", "val", "payload", "is_num")


def assert_logs_equal(j, t):
    assert j.log.capacity == t.log.capacity
    for f in FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(j.log, f)),
                                      getattr(t.log, f).numpy(), err_msg=f)


def wire(payload, epoch):
    """A gossip payload with its wire timestamps rebased by ``epoch``."""
    if payload is None:
        return None
    out = {}
    for k, v in payload.items():
        if k == tnode.FRONTIER_KEY:
            out[k] = v
        elif k == tnode.SUMMARY_KEY:
            out[k] = {key: dict(e, ts=e["ts"] - epoch) for key, e in v.items()}
        else:
            ts, _, rest = k.partition(":")
            out[f"{int(ts) - epoch}:{rest}" if rest else str(int(ts) - epoch)] = v
    return out


def assert_nodes_equal(j, t, peers_vv=()):
    """One node in both packages: view, watermarks, fold, log, payloads."""
    assert j.get_state() == t.get_state()
    assert j.version_vector() == t.version_vector()
    assert j.frontier == t.frontier
    ej, et = j.clock.epoch_ms, t.clock.epoch_ms
    assert wire({tnode.SUMMARY_KEY: j._summary}, ej) == wire({tnode.SUMMARY_KEY: t._summary}, et)
    for since in (None, {}, *peers_vv):
        assert wire(j.gossip_payload(since), ej) == wire(t.gossip_payload(since), et)
    if j.alive:
        assert_logs_equal(j, t)


class Pair:
    """One schedule driven through a JAX node and a port node: every call
    goes to both, and both must answer alike."""

    def __init__(self, rid, capacity=8, clocks=None, native=False, **kw):
        jc, tc = clocks or (jclock.ManualClock(), tclock.ManualClock())
        self.j = jnode.ReplicaNode(rid=rid, capacity=capacity, clock=jc,
                                   use_native=native, **kw)
        self.t = tnode.ReplicaNode(rid=rid, capacity=capacity, clock=tc,
                                   use_native=native, device="cpu", **kw)

    def both(self, name, *args, **kw):
        a = getattr(self.j, name)(*args, **kw)
        b = getattr(self.t, name)(*args, **kw)
        assert a == b, (name, a, b)
        return a

    def payload(self, since=None):
        pj, pt = self.j.gossip_payload(since), self.t.gossip_payload(since)
        assert pj == pt  # one ManualClock epoch (0) on both sides
        return pj


@pytest.mark.parametrize("native", [False, True], ids=["python", "native"])
def test_node_schedule_matches_jax(native):
    """Writes single and batched (multi-key and non-numeric values, same-ms
    collisions), growth past capacity 8, full and delta pulls, a fused
    pull, a compaction barrier, a dead node's refusals and its revival by
    summary adoption: equal after every step, with both packages' Python
    paths and with both native runtimes."""
    rng = np.random.default_rng(0)
    clocks = (jclock.ManualClock(), tclock.ManualClock())
    nodes = [Pair(r, clocks=clocks, native=native) for r in range(3)]

    def check():
        vvs = [n.t.version_vector() for n in nodes]
        for n in nodes:
            assert_nodes_equal(n.j, n.t, vvs)

    ts = 0
    for step in range(12):
        for n in nodes:
            ts += int(rng.integers(0, 2))
            n.both("add_command", _rand_cmd(rng), ts=ts)
        k = int(rng.integers(1, 6))
        tss = [ts + int(i) for i in rng.integers(0, 3, k)]
        nodes[step % 3].both("add_commands", [_rand_cmd(rng) for _ in range(k)], tss)
        dst, src = rng.choice(3, 2, replace=False)
        since = None if step % 2 else nodes[dst].t.version_vector()
        nodes[dst].both("receive", nodes[src].payload(since))
        check()
    assert nodes[0].t.log.capacity > 8  # grew past capacity
    # a fused pull of both peers' deltas
    since = nodes[0].t.version_vector()
    nodes[0].both("receive_many", [nodes[1].payload(since), nodes[2].payload(since)])
    check()
    # node 2 goes down and misses a barrier
    nodes[2].both("set_alive", False)
    nodes[2].both("add_command", {"z": "1"}, ts=ts + 1)
    nodes[0].both("add_command", {"y": "4"}, ts=ts + 1)
    assert nodes[2].t.get_state() is None and nodes[2].t.gossip_payload() is None
    for a, b in ((0, 1), (1, 0)):
        nodes[a].both("receive", nodes[b].payload(nodes[a].t.version_vector()))
    frontier = tnode.stable_frontier_host(
        [n.t.version_vector() for n in nodes[:2]], [n.t.frontier for n in nodes])
    assert frontier == jnode.stable_frontier_host(
        [n.j.version_vector() for n in nodes[:2]], [n.j.frontier for n in nodes])
    for n in nodes[:2]:
        n.both("compact", frontier)
    check()
    assert nodes[0].t._summary and nodes[0].t.frontier == frontier
    # revival: the payload carries the summary sections; adoption matches
    nodes[2].both("set_alive", True)
    p = nodes[0].payload(nodes[2].t.version_vector())
    assert tnode.SUMMARY_KEY in p
    nodes[2].both("receive", p)
    nodes[2].both("add_command", {"a": "3", "b": "x"}, ts=ts + 2)
    nodes[0].both("receive", nodes[2].payload(nodes[0].t.version_vector()))
    check()
    j, t = nodes[0].j, nodes[0].t
    assert j.gossip_payload_json() == t.gossip_payload_json()
    assert j.gossip_payload_json(nodes[1].t.version_vector()) == \
        t.gossip_payload_json(nodes[1].t.version_vector())
    assert json.loads(t.gossip_payload_json()) == t.gossip_payload()


def test_go_compat_payload_and_echo_match():
    """go_compat_gossip: bare integer-ms keys, last writer per ms, a Go
    peer's echo dropped, compaction refused; as the JAX node does."""
    rng = np.random.default_rng(1)
    a = Pair(0, go_compat_gossip=True)
    for i in range(10):
        a.both("add_command", _rand_cmd(rng), ts=i // 3)
    p = a.payload()
    assert all(":" not in k for k in p)
    assert a.both("receive", {"1": {"q": "5"}, "999": {"r": "-1"}}) == 1
    assert_nodes_equal(a.j, a.t)
    for node in (a.j, a.t):
        with pytest.raises(ValueError, match="go-compat"):
            node.compact({0: 0})


def test_malformed_payloads_raise_in_both():
    """A mangled wire key, a timestamp outside the int32 window and a
    frontier without its summary raise in both nodes and change nothing."""
    a = Pair(0)
    a.both("add_command", {"x": "5"}, ts=100)
    for bad in ({"1:2": {"x": "1"}}, {str(2**40): {"x": "1"}},
                {tnode.FRONTIER_KEY: {"0": 3}}):
        for node in (a.j, a.t):
            with pytest.raises(ValueError):
                node.receive(bad)
    assert_nodes_equal(a.j, a.t)


def test_merge_begin_commit_and_abort_match():
    """The deferred merge: commit with the caller's merged log, the inline
    commit, and abort (lock released, host indexes ahead of the log)."""
    rng = np.random.default_rng(2)
    src = Pair(1)
    for i in range(12):
        src.both("add_command", _rand_cmd(rng), ts=i)
    a = Pair(0)
    a.both("add_command", {"k": "1"}, ts=0)

    def commit(node, log_mod, pending):
        log = node.log
        while pending.rows_held() + pending.fresh > log.capacity:
            log = log_mod.grow(log, log.capacity * 2)
        kw = {} if log_mod is jlog else {"device": "cpu"}
        batch = log_mod.from_ops(max(pending.fresh, 1), pending.ops, **kw)
        merged, n = log_mod.merge_checked(log, batch)
        return pending.commit(merged, int(n))

    half = {k: v for i, (k, v) in enumerate(src.payload().items()) if i < 6}
    pj, pt = a.j.merge_begin([half]), a.t.merge_begin([half])
    assert (pj.fresh, pj.adopted) == (pt.fresh, pt.adopted) and pt.fresh > 0
    assert commit(a.j, jlog, pj) == commit(a.t, tlog, pt)
    assert_nodes_equal(a.j, a.t)
    ij, pj = a.j.add_commands_begin([{"m": "2"}, {"n": "s"}], [20, 21])
    it, pt = a.t.add_commands_begin([{"m": "2"}, {"n": "s"}], [20, 21])
    assert ij == it == [(0, 1), (0, 2)]
    assert pj.commit_inline() == pt.commit_inline() == 2
    assert_nodes_equal(a.j, a.t)
    rest = src.payload(a.t.version_vector())
    pj, pt = a.j.merge_begin([rest]), a.t.merge_begin([rest])
    pj.abort()
    pt.abort()
    assert a.j._lock.acquire(timeout=1) and a.t._lock.acquire(timeout=1)
    a.j._lock.release()
    a.t._lock.release()
    assert a.j.version_vector() == a.t.version_vector() == {0: 2, 1: 11}


def _skewed_pair(native):
    """A JAX node and a port node (rid 0, ``epoch_ms`` 1,000,000) given the
    same writes at local ms 1,000,100 and 1,000,200, then a clock skew of
    -500 ms and one more write.  ``native`` picks the native runtime in
    the JAX node and the port's default; otherwise both Python paths."""
    nodes = []
    for mod, clock, kw in ((jnode, jclock, {"use_native": native}),
                           (tnode, tclock, {"device": "cpu", **({} if native else
                                                               {"use_native": False})})):
        c = clock.ManualClock(start=1_000_100)
        c.epoch_ms = 1_000_000
        n = mod.ReplicaNode(rid=0, capacity=8, clock=c, **kw)
        n.add_command({"a": "1", "b": 'x"y'})
        c.advance(100)
        n.add_command({"a": "2"})
        c.epoch_ms -= 500
        c.advance(100)
        n.add_command({"c": "\n"})
        nodes.append(n)
    return nodes


@pytest.mark.parametrize("native", [True, False], ids=["native", "python"])
def test_gossip_bytes_after_a_clock_skew_match_jax(native):
    """After a clock skew the port serves the bytes the JAX node serves:
    natively, each op keeps the wire key it got when it entered
    (``"2000100:0:0"``, not re-timed to 1999600); on the Python path both
    serve ``json.dumps`` with keys encoded when served.  A peer decodes
    the same rows from either."""
    j, t = _skewed_pair(native)
    for since in (None, {}, {0: 0}, {0: 2}):
        assert t.gossip_payload_json(since) == j.gossip_payload_json(since), since
    body = t.gossip_payload_json()
    assert (b'"2000100:0:0":{"a":"1","b":"x\\"y"}' in body) == native
    assert (b'"1999600:0:0"' in body) == (not native)
    peers = []
    for mod, clock, kw in ((jnode, jclock, {"use_native": native}),
                           (tnode, tclock, {"device": "cpu", "use_native": native})):
        c = clock.ManualClock(start=5)
        c.epoch_ms = 1_000_000
        peers.append(mod.ReplicaNode(rid=1, capacity=8, clock=c, **kw))
    for peer, src in zip(peers, (j, t)):
        assert peer.receive(json.loads(src.gossip_payload_json())) == 4
    pj, pt = peers
    assert sorted(pt._commands.items()) == sorted(pj._commands.items())
    assert pt.get_state() == pj.get_state()
    assert_logs_equal(pj, pt)
    assert pt.gossip_payload_json() == pj.gossip_payload_json()


def _configs(**kw):
    return jconfig.ClusterConfig(**kw), tconfig.ClusterConfig(**kw)


def _clusters(**kw):
    jc, tc = _configs(**kw)
    return jcluster.LocalCluster(jc), tcluster.LocalCluster(tc, device="cpu")


def assert_clusters_equal(jc, tc):
    assert jc.states() == tc.states()
    for j, t in zip(jc.nodes, tc.nodes):
        assert j.alive == t.alive
        assert j.version_vector() == t.version_vector()
        assert j.frontier == t.frontier
        vvs = [n.version_vector() for n in tc.nodes]
        assert_nodes_equal(j, t, vvs)


def tick_both(jc, tc, n):
    """Tick both clusters ``n`` times, equal after each tick; returns the
    tick at which both converged (or n)."""
    for i in range(n):
        assert jc.tick() == tc.tick()
        assert_clusters_equal(jc, tc)
        if tc.converged():
            assert jc.converged()
            return i
    return n


def test_cluster_schedule_of_test_api_matches_jax_and_oracle():
    """tests/test_api.py's test_cluster_converges_and_matches_oracle: 30
    WorkloadGenerator writes on 4 replicas (seed 3), ticked to
    convergence; tick by tick equal to JAX, finally equal to both oracles."""
    jc, tc = _clusters(n_replicas=4, seed=3, log_capacity=64)
    jwl = JWorkload(jc.config)
    twl = workload.WorkloadGenerator(tc.config)
    jo = [JOracle(r, JQuirks()) for r in range(4)]
    to = [TOracle(r, TQuirks()) for r in range(4)]
    for i in range(30):
        cmd, target = twl.next_command()
        assert (cmd, target) == jwl.next_command()
        for c, o in ((jc, jo), (tc, to)):
            c.nodes[target].add_command(cmd, ts=1000 + i)
            o[target].add_command(cmd, ts=1000 + i)
    assert tick_both(jc, tc, 100) < 100
    want = TOracle.converged_state(to)
    assert want == JOracle.converged_state(jo)
    assert all(s == want for s in tc.states())


def test_background_loop_converges_to_jax_and_the_oracle():
    """LocalCluster.start/stop: one gossip thread per replica (the 0th also
    schedules a barrier every 2 of its rounds) while writes land from this
    thread; after stop(), tick() to convergence.  Thread timing makes the
    peer draws nondeterministic, so only the end is compared: equal to both
    oracles and to a JAX cluster ticked over the same writes."""
    jc, tc = _clusters(n_replicas=4, seed=5, log_capacity=64,
                       gossip_period_ms=10, compact_every=2)
    twl = workload.WorkloadGenerator(tc.config)
    to = [TOracle(r, TQuirks()) for r in range(4)]
    jo = [JOracle(r, JQuirks()) for r in range(4)]

    def write(i):
        cmd, target = twl.next_command()
        for c, o in ((jc, jo), (tc, to)):
            assert c.nodes[target].add_command(cmd, ts=1000 + i)
            o[target].add_command(cmd, ts=1000 + i)

    for i in range(20):
        write(i)
    tc.start()
    try:
        for i in range(20, 40):
            write(i)
            time.sleep(0.005)
        deadline = time.monotonic() + 30
        while not tc.nodes[0].frontier and time.monotonic() < deadline:
            time.sleep(0.01)
    finally:
        tc.stop()
    assert tc.nodes[0].frontier, "no compaction barrier ran in the loop"
    assert tc.metrics.registry.counter_value("gossip_loop_errors") == 0
    for c in (jc, tc):
        for _ in range(100):
            if c.converged():
                break
            c.tick()
        assert c.converged()
    want = TOracle.converged_state(to)
    assert want == JOracle.converged_state(jo)
    assert tc.states() == jc.states() == [want] * 4


def test_log_growth_schedule_of_test_api_matches():
    """tests/test_api.py's test_log_growth_beyond_initial_capacity: 50 ops
    into capacity 8."""
    jc, tc = _clusters(n_replicas=1, log_capacity=8)
    for i in range(50):
        assert jc.nodes[0].add_command({"k": "1"}, ts=i)
        assert tc.nodes[0].add_command({"k": "1"}, ts=i)
    assert tc.nodes[0].get_state() == {"k": "50"}
    assert tc.nodes[0].log.capacity >= 50
    assert_clusters_equal(jc, tc)


WRITES = [("a", "5"), ("b", "-20"), ("a", "7"), ("c", "hello"),
          ("b", "3"), ("c", "world"), ("a", "-1"), ("d", "007")]


def _drive(clusters, writes, seed=0):
    """tests/test_delta_gossip.py's _drive, on both clusters."""
    rng = np.random.default_rng(seed)
    for i, (key, val) in enumerate(writes):
        rid = int(rng.integers(0, len(clusters[0].nodes)))
        for c in clusters:
            c.nodes[rid].add_command({key: val}, ts=i * 10)


@pytest.mark.parametrize("fuse", [1, 2], ids=["k1", "fuse_pull_k2"])
def test_periodic_barriers_match_jax_and_the_never_pruned_log(fuse):
    """tests/test_delta_gossip.py's compacting cluster (a barrier every 3
    ticks, delta gossip, writes before and after) tick by tick against JAX,
    and its views equal to a never-pruning port cluster's; with
    fuse_pull_k=2 the rounds are fused."""
    jc, tc = _clusters(n_replicas=4, log_capacity=64, compact_every=3, fuse_pull_k=fuse)
    plain = tcluster.LocalCluster(tconfig.ClusterConfig(
        n_replicas=4, log_capacity=64, delta_gossip=False), device="cpu")
    _drive((jc, tc, plain), WRITES)
    tick_both(jc, tc, 4)
    _drive((jc, tc, plain), [("e", "100"), ("a", "2"), ("f", "xyz")], seed=1)
    assert tick_both(jc, tc, 60) < 60
    for _ in range(60):
        plain.tick()
    assert plain.converged() and plain.states() == tc.states()
    assert jc.compact() == tc.compact()
    assert_clusters_equal(jc, tc)
    assert all(n._commands == {} for n in tc.nodes)
    assert all(n._commands for n in plain.nodes)
    if fuse > 1:
        assert tc.metrics.registry.counter_value("pull_round_peers_fused", node="0") > 0


@pytest.mark.parametrize("fuse", [1, 2], ids=["k1", "fuse_pull_k2"])
def test_piggyback_and_revival_by_summary_match(fuse):
    """tests/test_delta_gossip.py's frontier piggyback (a caught-up peer
    folds locally and prunes at adoption) and its dead node that misses a
    barrier and then adopts the summary, tick by tick against JAX."""
    jc, tc = _clusters(n_replicas=4, log_capacity=64, fuse_pull_k=fuse)
    _drive((jc, tc), WRITES)
    assert tick_both(jc, tc, 60) < 60
    for c in (jc, tc):
        a, b = c.nodes[0], c.nodes[1]
        legacy = b.gossip_payload()  # a full dump from before the fold
        a.compact(a.version_vector())
        p = a.gossip_payload(since=b.version_vector())
        assert tnode.FRONTIER_KEY in p and tnode.SUMMARY_KEY not in p
        assert b.receive(p) == 1
        # re-delivered folded ops are not counted again against the summary
        assert a.receive(legacy) == 0 and b.receive(legacy) == 0
    assert_clusters_equal(jc, tc)
    assert tc.nodes[1]._commands == {} and tc.nodes[1].frontier == tc.nodes[0].frontier
    for c in (jc, tc):
        c.nodes[2].set_alive(False)
        c.nodes[0].add_command({"z": "41"}, ts=10_000)
    tick_both(jc, tc, 8)
    assert jc.compact() == tc.compact()
    assert tc.nodes[2].frontier != tc.nodes[0].frontier  # missed the barrier
    for c in (jc, tc):
        c.nodes[2].set_alive(True)
    assert tick_both(jc, tc, 60) < 60
    assert tc.nodes[2].frontier == tc.nodes[0].frontier
    assert tc.nodes[2].get_state() == tc.nodes[0].get_state()
    snap = tc.metrics.snapshot()
    assert snap["frontier_adoptions"] >= 2 and "merge_p50_ms" in snap


def test_barrier_skipped_when_frontier_holders_dead_matches():
    """tests/test_delta_gossip.py's chain-rule wedge on both packages."""
    jc, tc = _clusters(n_replicas=3, log_capacity=64)
    for c in (jc, tc):
        c.nodes[2].set_alive(False)
        c.nodes[0].add_command({"a": "5"}, ts=10)
        c.nodes[1].add_command({"b": "7"}, ts=20)
    tick_both(jc, tc, 60)
    f1 = tc.compact()
    assert f1 and f1 == jc.compact()
    for c in (jc, tc):
        c.nodes[0].set_alive(False)
        c.nodes[1].set_alive(False)
        c.nodes[2].set_alive(True)
        c.nodes[2].add_command({"z": "1"}, ts=30)
        assert c.compact() == {}
        for n in c.nodes:
            n.set_alive(True)
    assert tick_both(jc, tc, 60) < 60
    assert jc.compact() == tc.compact()
    assert_clusters_equal(jc, tc)


def test_reference_topology_matches():
    """The reference's friend list (self and dead ports) draws the same
    peers and skips the same rounds."""
    jc, tc = _clusters(n_replicas=3, reference_topology=True, seed=5, log_capacity=64)
    for c in (jc, tc):
        for i, node in enumerate(c.nodes):
            node.add_command({"abc"[i]: "7"}, ts=100 + i)
    assert tick_both(jc, tc, 200) < 200
    assert tc.nodes[0].get_state() == {"a": "7", "b": "7", "c": "7"}
    assert (tc.metrics.registry.counter_value("gossip_skipped")
            == jc.metrics.registry.counter_value("gossip_skipped"))


@pytest.mark.parametrize("quirks", [False, True], ids=["fixed", "reference_quirks"])
@pytest.mark.parametrize("seed", [0, 1])
def test_oracle_copy_matches_jax_oracle(quirks, seed):
    """The port's plain-Python oracle against JAX's on _rand_cmd histories
    with pulls and an invalid body: handler results, payloads and rebuilt
    views equal."""
    rng = np.random.default_rng(seed)
    jq, tq = (JQuirks.reference(), TQuirks.reference()) if quirks else (JQuirks(), TQuirks())
    jo = [JOracle(r, jq) for r in range(3)]
    to = [TOracle(r, tq) for r in range(3)]
    ts = 0
    for w in range(40):
        ts += int(rng.integers(0, 3))
        r = int(rng.integers(0, 3))
        cmd = None if w == 17 else _rand_cmd(rng)
        a, b = jo[r].add_command(cmd, ts), to[r].add_command(cmd, ts)
        assert (a.status, a.body) == (b.status, b.body)
        if w % 5 == 4:
            dst, src = rng.choice(3, size=2, replace=False)
            jo[dst].receive(jo[src].gossip_payload())
            to[dst].receive(to[src].gossip_payload())
    for j, t in zip(jo, to):
        assert j.gossip_payload() == t.gossip_payload()
        assert j.rebuilt_state() == t.rebuilt_state()
        assert j.state == t.state
    assert JOracle.converged_state(jo) == TOracle.converged_state(to)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_mixed_command_draws_the_parity_mix(seed):
    """workload.mixed_command (the chip smoke's string-mode run) draws
    tests/test_parity.py's _rand_cmd sequence from the same generator."""
    a, b = np.random.default_rng(seed), np.random.default_rng(seed)
    for _ in range(300):
        assert workload.mixed_command(b) == _rand_cmd(a)


def test_drive_cluster_matches_jax():
    """WorkloadGenerator.drive_cluster (wall-clock stamps, a tick every 10
    writes) on both packages: the same writes accepted, and after
    convergence the same views (all deltas numeric, so the views do not
    depend on the stamps)."""
    jc, tc = _clusters(n_replicas=3, seed=4, log_capacity=64)
    assert (JWorkload(jc.config).drive_cluster(jc, 40, gossip_every=10)
            == workload.WorkloadGenerator(tc.config).drive_cluster(tc, 40, gossip_every=10))
    for c in (jc, tc):
        for _ in range(60):
            c.tick()
            if c.converged():
                break
    assert tc.converged() and tc.states() == jc.states()
