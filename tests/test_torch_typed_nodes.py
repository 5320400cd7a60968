"""The port's typed sibling nodes (crdt_tpu_torch.api.setnode, seqnode,
mapnode) and the typed LocalCluster against the JAX package's, on the
scripts of tests/test_setnode.py, tests/test_seqnode.py and
tests/test_mapnode.py: every call goes to a JAX node and a port node,
whose answers, payload JSON (key order included), version vectors, floors,
op records and device tables must be equal after every step; snapshots
cross between the packages both ways.  Zero tolerance."""
import json

import numpy as np
import pytest
import torch

from crdt_tpu.api import mapnode as jmap
from crdt_tpu.api import seqnode as jseq
from crdt_tpu.api import setnode as jset
from crdt_tpu.models import ormap_gc as jomg
from crdt_tpu.models import pncounter as jpn
from crdt_tpu_torch.api import mapnode as tmap
from crdt_tpu_torch.api import seqnode as tseq
from crdt_tpu_torch.api import setnode as tset
from crdt_tpu_torch.models import ormap_gc as tomg
from crdt_tpu_torch.models import pncounter as tpn
from crdt_tpu_torch.models import tomb_gc
from tests.test_torch_node import _clusters, assert_clusters_equal


def _arr(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def assert_planes(j, t, fields):
    for f in fields:
        a, b = _arr(getattr(j, f)), _arr(getattr(t, f))
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)


def assert_json(a, b):
    assert json.dumps(a) == json.dumps(b)


class Twin:
    """One node in both packages: every call goes to both, both must answer
    alike (a payload as the same JSON text), and after every call their
    whole state must be equal.  A call returns the JAX side's answer, so a
    payload goes on to both receivers alike."""

    def __init__(self, jnode, tnode):
        self.j, self.t = jnode, tnode

    def __getattr__(self, name):
        def call(*args, **kw):
            try:
                a = getattr(self.j, name)(*args, **kw)
            except Exception as e:  # noqa: BLE001 — the port must raise alike
                with pytest.raises(type(e)):
                    getattr(self.t, name)(*args, **kw)
                self.check()
                raise
            b = getattr(self.t, name)(*args, **kw)
            assert_json(a, b)
            self.check()
            return a
        return call

    def check(self):
        j, t = self.j, self.t
        assert j.alive == t.alive
        assert_json(j.gossip_payload(), t.gossip_payload())
        assert j._seq.count == t._seq.count
        assert list(j.elems.items() if hasattr(j, "elems") else j.keys.items()) == \
            list(t.elems.items() if hasattr(t, "elems") else t.keys.items())
        was = j.alive, t.alive
        j.alive = t.alive = True
        try:
            self.check_state()
        finally:
            j.alive, t.alive = was


class SetTwin(Twin):
    def __init__(self, rid, **kw):
        super().__init__(jset.SetNode(rid=rid, **kw), tset.SetNode(rid=rid, device="cpu", **kw))

    def check_state(self):
        j, t = self.j, self.t
        assert j.members() == t.members()
        assert j.vv_snapshot() == t.vv_snapshot()
        assert j._ops == t._ops and j._by_writer == t._by_writer
        assert j._tombstoned == t._tombstoned and j._n_writers == t._n_writers
        assert_planes(j.gc.inner, t.gc.inner, ("elem", "rid", "seq", "removed"))
        assert_planes(j.gc, t.gc, ("floor",))


class SeqTwin(Twin):
    def __init__(self, rid, **kw):
        super().__init__(jseq.SeqNode(rid=rid, **kw), tseq.SeqNode(rid=rid, device="cpu", **kw))

    def check_state(self):
        j, t = self.j, self.t
        assert j.items() == t.items() and j.idents() == t.idents()
        assert j.vv_snapshot() == t.vv_snapshot()
        assert j._ops == t._ops and j._by_writer == t._by_writer
        assert j._tombstoned == t._tombstoned and j._depth == t._depth
        assert_planes(j.gc.inner, t.gc.inner, ("keys", "elem", "removed"))
        assert_planes(j.gc, t.gc, ("floor",))


class MapTwin(Twin):
    def __init__(self, rid, **kw):
        super().__init__(jmap.MapNode(rid=rid, **kw), tmap.MapNode(rid=rid, device="cpu", **kw))

    def check_state(self):
        j, t = self.j, self.t
        assert j.items() == t.items() and j.epochs() == t.epochs()
        assert j.vv_snapshot() == t.vv_snapshot()
        assert j._ops == t._ops and j._by_writer == t._by_writer
        assert_planes(j, t, ("_tok", "_obs", "_pos", "_neg", "_epoch"))
        dj, dt = j.device_state(), t.device_state()
        assert_planes(dj.map.presence, dt.map.presence, ("tok", "obs"))
        assert_planes(dj.map.values, dt.map.values, ("pos", "neg"))
        assert_planes(dj, dt, ("epoch",))


def pull(dst: Twin, src: Twin, delta: bool = True) -> int:
    since = dst.version_vector() if delta else None
    return dst.receive(src.gossip_payload(since=since))


def sync(a: Twin, b: Twin, rounds: int = 2) -> None:
    for _ in range(rounds):
        pull(b, a)
        pull(a, b)


def set_barrier(nodes):
    floor = jset.set_barrier(nodes[0].j, [n.j.vv_snapshot() for n in nodes[1:]])
    assert floor == tset.set_barrier(nodes[0].t, [n.t.vv_snapshot() for n in nodes[1:]])
    for n in nodes:
        if floor:
            n.collect(floor)
    return floor


def seq_barrier(nodes):
    floor = jseq.seq_barrier(nodes[0].j, [n.j.vv_snapshot() for n in nodes[1:]])
    assert floor == tseq.seq_barrier(nodes[0].t, [n.t.vv_snapshot() for n in nodes[1:]])
    for n in nodes:
        if floor:
            n.collect(floor)
    return floor


def snapshot_both_ways(twin_cls, twin, rid=None, **kw):
    """The JAX node's snapshot loaded by a fresh port node and the port's
    by a fresh JAX node: the restored pair equals the original."""
    rid = twin.j.rid if rid is None else rid
    sj = json.loads(json.dumps(twin.j.to_snapshot()))
    st = json.loads(json.dumps(twin.t.to_snapshot()))
    assert sj == st
    fresh = twin_cls(rid, **kw)
    fresh.j.from_snapshot(st)  # the port's snapshot into JAX
    fresh.t.from_snapshot(sj)  # JAX's snapshot into the port
    fresh.check()
    return fresh


# ---- SetNode: tests/test_setnode.py's scripts ----


def test_set_add_remove_readd_and_delta_sizes():
    a, b = SetTwin(0), SetTwin(1)
    a.add("x")
    sync(a, b, 3)
    b.remove("x")
    a.add("x")  # concurrent re-add
    sync(a, b, 3)
    assert a.members() == b.members() == ["x"]
    a.remove("x")
    sync(a, b, 3)
    assert a.members() == []
    for i in range(10):
        a.add(f"e{i}")
    sync(a, b, 3)
    a.add("fresh")
    p = a.gossip_payload(since=b.version_vector())
    assert [k for k in p if k not in (tset.FLOOR_KEY, tset.FULL_KEY)] == ["0:13"]


def test_set_gc_composes_with_delta_and_full_fallback():
    a, b = SetTwin(0), SetTwin(1)
    for i in range(20):
        a.add(f"e{i}")
    sync(a, b, 3)
    for i in range(15):
        a.remove(f"e{i}")
    sync(a, b, 3)
    assert set_barrier([a, b])
    assert len(a.t._ops) == 5
    a.add("post-gc")
    p = a.gossip_payload(since=b.version_vector())
    assert not p.get(tset.FULL_KEY)
    b.receive(p)
    fresh = SetTwin(2)
    p = a.gossip_payload(since=fresh.version_vector())
    assert p.get(tset.FULL_KEY) is True
    fresh.receive(p)
    a.add("later")
    fresh.receive(a.gossip_payload(since=fresh.version_vector()))
    assert fresh.members() == a.members()


def test_set_no_resurrection_and_late_tombstone():
    a, b, c = SetTwin(0), SetTwin(1), SetTwin(2)
    a.add("x")
    sync(a, b, 3)
    sync(a, c, 3)
    a.remove("x")
    sync(a, b, 3)
    assert set_barrier([a, b])
    p = a.gossip_payload(since=c.version_vector())
    assert p.get(tset.FULL_KEY) is True
    c.receive(p)  # absence-implies-collected suppression
    assert c.members() == []
    a.receive(c.gossip_payload(since=a.version_vector()))
    # a late tombstone still applies
    d, e, f = SetTwin(0), SetTwin(1), SetTwin(2)
    d.add("x")
    sync(d, e, 3)
    sync(d, f, 3)
    f.remove("x")
    set_barrier([d, e])
    d.receive(f.gossip_payload(since=d.version_vector()))
    sync(d, e, 3)
    assert e.members() == []


def test_set_remove_record_retained_and_incomparable_floors():
    a, b, c = SetTwin(0), SetTwin(1), SetTwin(2)
    a.add("x")
    sync(a, b, 3)
    b.remove("x")
    pb = b.gossip_payload(since=c.version_vector())
    c.receive({k: v for k, v in pb.items()
               if k in (tset.FLOOR_KEY, tset.FULL_KEY) or "remove" in v})
    c.receive({k: v for k, v in pb.items()
               if k not in (tset.FLOOR_KEY, tset.FULL_KEY) and "add" in v})
    assert c.members() == []
    x, y = SetTwin(0), SetTwin(1)
    x.add("x")
    y.add("y")
    sync(x, y, 3)
    x.remove("x")
    y.remove("y")
    sync(x, y, 3)
    x.collect({0: 0})
    y.collect({1: 0})
    with pytest.raises(ValueError, match="incomparable"):
        x.receive(y.gossip_payload(since=x.version_vector()))


def test_set_snapshots_cross_both_ways_and_growth():
    a, b = SetTwin(0), SetTwin(1)
    for i in range(8):
        a.add(f"e{i}")
    sync(a, b, 3)
    for i in range(4):
        a.remove(f"e{i}")
    sync(a, b, 3)
    set_barrier([a, b])
    a.add("post")
    b.receive(a.gossip_payload(since=b.version_vector()))
    b.remove("post")
    a2 = snapshot_both_ways(SetTwin, a)
    sync(a2, b, 3)
    assert a2.members() == b.members()
    # an incarnation restore under a fresh rid
    inc = snapshot_both_ways(SetTwin, a, rid=64)
    assert inc.add("z") == (64, 0)
    assert jset.set_barrier(a.j, [None]) == tset.set_barrier(a.t, [None]) == {}
    # tables grow past capacity 4; a writer rid past n_writers grows the floor
    g = SetTwin(0, capacity=4, n_writers=2)
    for i in range(20):
        g.add(f"e{i}")
    g.receive(SetTwin(5).gossip_payload())
    w = SetTwin(5)
    w.add("far")
    g.receive(w.gossip_payload())
    assert g.t.gc.inner.capacity >= 20 and g.t._n_writers == 8


@pytest.mark.parametrize("kind", ["set", "seq"])
def test_ingest_overflow_raises_gc_overflow(kind, monkeypatch):
    """An ingest union that reports more rows than the grown table holds
    raises GcOverflow (the port's join is patched to report one row too
    many; the JAX package is left untouched)."""
    if kind == "set":
        node, mod, write = tset.SetNode(rid=0, capacity=4, device="cpu"), tset.orset, "add"
    else:
        node, mod, write = tseq.SeqNode(rid=0, capacity=4, device="cpu"), tseq.rseq, "append"
    real = mod.join_checked

    def over(a, b):
        out, n = real(a, b)
        return out, n + a.capacity
    monkeypatch.setattr(mod, "join_checked", over)
    with pytest.raises(tomb_gc.GcOverflow):
        getattr(node, write)("x")


# ---- SeqNode: tests/test_seqnode.py's scripts ----


def test_seq_editing_order_and_two_writers():
    n = SeqTwin(0)
    assert n.append("a") == (0, 0)
    assert n.append("c") == (0, 1)
    assert n.insert_at(1, "b") == (0, 2)
    assert n.items() == ["a", "b", "c"]
    assert n.remove_at(1) == (0, 3)
    assert n.remove_at(5) is None
    n.insert_at(-3, "front")
    n.insert_at(99, "back")
    a, b = SeqTwin(0), SeqTwin(1)
    for x in "one two three".split():
        a.append(x)
    sync(a, b)
    a.insert_at(0, "zero")
    b.append("four")
    b.remove_at(1)
    sync(a, b)
    assert a.items() == ["zero", "one", "three", "four"]
    a.append("new")
    p = a.gossip_payload(since=b.version_vector())
    assert [k for k in p if k not in (tseq.FLOOR_KEY, tseq.FULL_KEY)] == ["0:4"]
    assert b.receive(p) == 1


def test_seq_gc_barrier_suppression_and_tombstone_index():
    a, b, c = SeqTwin(0), SeqTwin(1), SeqTwin(2)
    for i in range(6):
        a.append(f"e{i}")
    sync(a, b)
    sync(a, c)
    b.remove_at(0)
    b.remove_at(0)
    sync(a, b)
    assert seq_barrier([a, b])
    assert len(a.t._ops) == 4 and a.t._tombstoned == set()
    a.append("tail")
    assert pull(b, a) == 1
    payload = a.gossip_payload(since=c.version_vector())
    assert payload.get(tseq.FULL_KEY)
    c.receive(payload)
    assert c.items() == a.items()
    sync(a, c)
    assert c.t._tombstoned == set()


def test_seq_snapshots_cross_both_ways():
    a = SeqTwin(0)
    for x in "xyz":
        a.append(x)
    a.remove_at(0)
    b = snapshot_both_ways(SeqTwin, a)
    assert b.append("w") == (0, 4)
    p, q = SeqTwin(0), SeqTwin(1)
    for x in "pqr":
        p.append(x)
    sync(p, q)
    p.remove_at(2)
    sync(p, q)
    floor = seq_barrier([p, q])
    fresh = snapshot_both_ways(SeqTwin, p)
    assert fresh.t._floor == floor
    assert pull(q, fresh) == 0
    shallow = SeqTwin(0, depth=2)
    shallow.append("a")
    again = snapshot_both_ways(SeqTwin, shallow, depth=2)
    assert again.t._depth == 2


def test_seq_receive_widens_and_rejects_bad_wire():
    n = SeqTwin(1, depth=2)
    op = {"ins": "deep", "path": [[1, 0, 0, 0], [2, 0, 0, 1], [3, 0, 0, 2]]}
    assert n.receive({"0:2": op}) == 1
    assert n.t._depth >= 3
    n.append("after")
    assert n.items() == ["deep", "after"]
    for bad in ({"ins": "x", "path": [[1, 0, 7, 7]]}, {"ins": "x", "path": []},
                {"del": [1]}, {"what": 1}):
        with pytest.raises(ValueError):
            n.receive({"0:9": bad})
    a = SeqTwin(0)
    a.append("only")
    a.collect({0: 0, 5: 7})  # floor beyond a's knowledge: adopts nothing
    assert a.t._floor == {}
    assert a.t.metrics.registry.counter_value("seq_collect_behind") == 1


def test_seq_capacity_growth_gap_widen_and_warmup():
    """Inserts past capacity 4 grow the table (seq_grow); repeated inserts
    into one gap exhaust a depth-2 table and widen it; warmup leaves the
    node untouched."""
    n = SeqTwin(0, capacity=4, depth=2)
    for i in range(10):
        n.insert_at(1 if i else 0, f"v{i}")
    assert n.t.gc.inner.capacity >= 10
    n.t.warmup()
    n.j.warmup()
    n.check()
    g = SeqTwin(0, capacity=8, depth=1)
    for i in range(80):
        g.insert_at(1 if i else 0, f"w{i}")
    assert g.t.metrics.registry.counter_value("seq_widen") >= 1


# ---- MapNode: tests/test_mapnode.py's scripts ----


def test_map_pn_semantics_and_device_state_join():
    a, b = MapTwin(0), MapTwin(1)
    a.upd("x", 5)
    a.upd("x", -2)
    b.upd("x", 10)
    b.upd("y", -7)
    da_j, db_j = a.j.device_state(), b.j.device_state()
    da, db = a.t.device_state(), b.t.device_state()
    want = jomg.join(da_j, db_j, __import__("jax").vmap(jpn.join))
    got = tomg.join(da, db, tpn.join)
    sync(a, b)
    assert a.items() == {"x": 13, "y": -7}
    dt = a.t.device_state()
    for x, y in ((got.map.presence.tok, dt.map.presence.tok), (got.epoch, dt.epoch),
                 (got.map.values.pos, dt.map.values.pos)):
        assert torch.equal(x, y)
    np.testing.assert_array_equal(np.asarray(want.map.values.neg), got.map.values.neg.numpy())
    assert a.upd_many([("x", 1), ("z", -4)]) == [(0, 2), (0, 3)]


def test_map_add_wins_reset_and_stale_update():
    a, b, c = MapTwin(0), MapTwin(1), MapTwin(2)
    a.upd("k", 3)
    sync(a, b)
    sync(a, c)
    b.upd("k", 4)
    assert a.rem("k") is not None
    sync(a, b)
    assert a.value("k") == 7
    assert a.rem("nope") is None
    b.rem("k")
    sync(a, b)
    assert jmap.map_barrier_ready(a.j, [b.j.version_vector()]) == \
        tmap.map_barrier_ready(a.t, [b.t.version_vector()]) is True
    assert a.mint_reset() == {"k": 1}
    pull(b, a)
    c.upd("k", 100)  # at the old epoch: dominated once the epoch arrives
    sync(a, c)
    sync(b, c)
    assert c.value("k") is None and c.epochs() == {"k": 1}
    b.upd("k", 2)
    sync(a, b)
    assert a.value("k") == 2
    assert not tmap.map_barrier_ready(a.t, [None])


def test_map_snapshots_cross_both_ways_and_vv_reconverges():
    a, b = MapTwin(0), MapTwin(1)
    a.upd("k", 5)
    a.upd("stay", 1)
    sync(a, b)
    pre = json.loads(json.dumps(b.j.to_snapshot()))
    assert pre == json.loads(json.dumps(b.t.to_snapshot()))
    b.rem("k")
    sync(a, b)
    a.mint_reset()
    pull(b, a)
    b2 = MapTwin(1)
    b2.j.from_snapshot(pre)
    b2.t.from_snapshot(pre)
    b2.check()
    assert b2.value("k") == 5
    b2.upd("k", 50)
    sync(a, b2)
    assert b2.epochs() == {"k": 1} and b2.value("k") is None
    assert b2.upd("fresh", 1) == (1, 1)
    snapshot_both_ways(MapTwin, a)
    c = MapTwin(2)
    pull(c, a)
    assert c.version_vector() == a.version_vector()
    # keys and writers past the initial planes grow them
    g = MapTwin(0, n_keys=2, n_writers=2)
    for i in range(5):
        g.upd(f"k{i}", i - 2)
    w = MapTwin(9)
    w.upd("k1", 3)
    w.rem("k1")
    g.receive(w.gossip_payload())
    assert g.t._w == 16 and g.t._k == 8


# ---- the typed LocalCluster ----


def _sibling_views(c):
    return ([n.members() for n in c.set_nodes], [n.items() for n in c.seq_nodes],
            [n.items() for n in c.map_nodes], [n.epochs() for n in c.map_nodes],
            [n.vv_snapshot() for n in c.set_nodes], [n.vv_snapshot() for n in c.seq_nodes],
            [n.vv_snapshot() for n in c.map_nodes],
            c.set_converged(), c.seq_converged(), c.map_converged())


@pytest.mark.parametrize("fuse", [1, 2], ids=["k1", "fuse_pull_k2"])
def test_typed_cluster_ticks_match_jax(fuse):
    """Both clusters with set_collect_every=3, seq_collect_every=4,
    map_reset_every=5, the same seeded writes to the KV, set, sequence and
    map surfaces over 16 rounds with replica 3 down for rounds 4-9, then
    ticked to convergence: equal KV views and nodes, sibling views, vvs,
    floors, epochs and ``*_converged()`` after every tick."""
    jc, tc = _clusters(n_replicas=4, seed=2, log_capacity=64, set_collect_every=3,
                       seq_collect_every=4, map_reset_every=5, fuse_pull_k=fuse)
    rng = np.random.default_rng(7)
    for rnd in range(16):
        if rnd in (4, 10):
            for c in (jc, tc):
                for nodes in (c.nodes, c.set_nodes, c.seq_nodes, c.map_nodes):
                    nodes[3].set_alive(rnd == 10)
        for i in range(6):
            r = int(rng.integers(0, 4))
            key = "abcdefgh"[int(rng.integers(0, 8))]
            elem = f"e{int(rng.integers(0, 12))}"
            delta = int(rng.integers(-20, -10))
            pos = int(rng.integers(0, 6))
            kind = rng.random()
            out = []
            for c in (jc, tc):
                out.append((
                    c.nodes[r].add_command({key: str(delta)}, ts=100 * rnd + i),
                    c.set_nodes[r].add(elem) if kind < 0.7 else c.set_nodes[r].remove(elem),
                    c.seq_nodes[r].insert_at(pos, elem) if kind < 0.7
                    else c.seq_nodes[r].remove_at(pos),
                    c.map_nodes[r].upd(key, delta) if kind < 0.94 else c.map_nodes[r].rem(key),
                ))
            assert out[0][1:] == out[1][1:] and bool(out[0][0]) == bool(out[1][0])
        assert jc.tick() == tc.tick()
        assert_clusters_equal(jc, tc)
        assert _sibling_views(jc) == _sibling_views(tc)
    for _ in range(40):
        assert jc.tick() == tc.tick()
        assert _sibling_views(jc) == _sibling_views(tc)
        if tc.set_converged() and tc.seq_converged() and tc.map_converged() and tc.converged():
            break
    assert tc.set_converged() and tc.seq_converged() and tc.map_converged()
    assert_clusters_equal(jc, tc)
    for name in ("set_collections", "seq_collections", "map_resets_scheduled",
                 "map_reset_skipped", "set_gossip_rounds", "map_epoch_adoptions"):
        assert (jc.metrics.registry.counter_value(name)
                == tc.metrics.registry.counter_value(name)), name
    assert tc.metrics.registry.counter_value("set_collections") > 0
    assert tc.metrics.registry.counter_value("seq_collections") > 0
    assert tc.metrics.registry.counter_value("map_reset_skipped") > 0
    assert jc.set_collect() == tc.set_collect()
    assert jc.seq_collect() == tc.seq_collect()
    assert jc.map_reset() == tc.map_reset()
    assert _sibling_views(jc) == _sibling_views(tc)


def test_typed_cluster_background_loop_runs_sibling_barriers():
    """start/stop with set and sequence barriers from the 0th loop: after
    stop() and a few ticks the siblings converge with floors advanced."""
    _, tc = _clusters(n_replicas=3, seed=1, log_capacity=64, gossip_period_ms=5,
                      set_collect_every=2, seq_collect_every=2)
    for i in range(12):
        tc.set_nodes[i % 3].add(f"s{i}")
        tc.seq_nodes[i % 3].append(f"q{i}")
    tc.set_nodes[0].remove("s0")
    tc.start()
    try:
        import time

        deadline = time.monotonic() + 20
        while (not tc.set_nodes[0].vv_snapshot()[1] or not tc.seq_nodes[0].vv_snapshot()[1]) \
                and time.monotonic() < deadline:
            time.sleep(0.01)
    finally:
        tc.stop()
    assert tc.set_nodes[0].vv_snapshot()[1] and tc.seq_nodes[0].vv_snapshot()[1]
    for _ in range(20):
        tc.tick()
    assert tc.set_converged() and tc.seq_converged()
    assert len(tc.seq_nodes[0].items()) == 12
