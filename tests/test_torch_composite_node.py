"""The port's CompositeNode (crdt_tpu_torch.api.compositenode, device="cpu")
against the JAX package's, zero tolerance, on tests/test_composite_node.py's
cases: each case runs once per package and returns what it observed
(answers, items, fingerprints, wire dumps, dispatch counts), and the two
runs must be equal.  Then the NodeHost stack: the HTTP routes, the agent's
pulls, the fused round's one merge, and the checkpoint round trip."""
import json
import threading
import urllib.request

import pytest

from crdt_tpu.api import compositenode as jcomp
from crdt_tpu_torch.api import compositenode as tcomp


def _make(pkg):
    if pkg == "j":
        return lambda rid, **kw: jcomp.CompositeNode(rid=rid, **kw)
    return lambda rid, **kw: tcomp.CompositeNode(rid=rid, device="cpu", **kw)


def _cls(pkg):
    return jcomp.CompositeNode if pkg == "j" else tcomp.CompositeNode


def _pull(dst, src):
    return dst.receive(src.gossip_payload())


def case_upd_rem_readd(mk):
    n = mk(0)
    out = [n.upd("x", 5), n.upd("x", -2), n.upd("y", 7), n.items(), n.value("x"),
           n.rem("x"), n.items(), n.value("x"), n.rem("x"), n.rem("never-seen"),
           n.upd("x", 1), n.items(), n.upd_many([("z", 3), ("x", -1), ("z", 2)])]
    return out + [n.gossip_payload(), n.fingerprint()]


def case_down_node(mk):
    n = mk(0)
    n.upd("x", 1)
    n.set_alive(False)
    out = [n.ping(), n.upd("x", 1), n.rem("x"), n.items(), n.gossip_payload(),
           n.upd_many([("x", 1)]), n.merge_decoded([])]
    n.set_alive(True)
    return out + [n.items()]


def case_capacity_growth(mk):
    n = mk(0, n_keys=2, n_writers=2)
    for i in range(9):
        n.upd(f"k{i}", i)
    peers = [mk(r) for r in range(3, 8)]
    for p in peers:
        p.upd("shared", 1)
        _pull(n, p)
    return [n.items(), n.gossip_payload(), n.fingerprint()]


def case_empty_payload(mk):
    a, b = mk(0), mk(1)
    return [_pull(a, b), a.items(), a.gossip_payload()]


def case_one_merge_for_k_payloads(mk):
    n = mk(0)
    n.upd("x", 1)
    payloads = []
    for r in range(1, 6):
        p = mk(r)
        p.upd("x", 1)
        p.upd(f"only-{r}", r)
        payloads.append(type(n).decode(p.gossip_payload()))
    before = n.merge_dispatches
    return [n.merge_decoded(payloads), n.merge_dispatches - before,
            n.metrics.registry.counter_value("composite_merge_dispatches"), n.items(),
            n.fingerprint()]


def case_two_node_convergence(mk):
    a, b = mk(0), mk(9)
    a.upd("x", 5)
    a.upd("z", 1)
    b.upd("x", -2)
    b.upd("y", 7)
    out = [_pull(a, b), _pull(b, a), a.items(), b.items(), a.fingerprint() == b.fingerprint(),
           _pull(a, b), a.gossip_payload(), b.gossip_payload()]
    return out


def case_observed_remove(mk):
    a, b = mk(0), mk(1)
    a.upd("x", 4)
    _pull(b, a)
    out = [b.rem("x")]
    a.upd("x", 2)
    _pull(a, b)
    _pull(b, a)
    out += [a.items(), b.items(), a.rem("x")]
    _pull(b, a)
    return out + [a.items(), b.items(), a.fingerprint(), b.fingerprint()]


def case_three_node_ring(mk):
    nodes = [mk(r) for r in (2, 5, 11)]
    nodes[0].upd("a", 1)
    nodes[1].upd("a", 10)
    nodes[1].rem("a")
    nodes[2].upd("b", -3)
    for _ in range(2):
        for i, src in enumerate(nodes):
            _pull(nodes[(i + 1) % 3], src)
    return [n.fingerprint() for n in nodes] + [nodes[0].items()]


def case_snapshot(mk):
    n = mk(3)
    n.upd("x", 5)
    n.upd("y", -1)
    n.rem("y")
    snap = n.to_snapshot()
    fresh = mk(3)
    fresh.from_snapshot(snap)
    out = [snap, fresh.fingerprint() == n.fingerprint(), fresh.items()]
    peer = mk(4)
    peer.upd("x", 1)
    _pull(fresh, peer)
    return out + [fresh.items(), fresh.to_snapshot()]


CASES = [case_upd_rem_readd, case_down_node, case_capacity_growth, case_empty_payload,
         case_one_merge_for_k_payloads, case_two_node_convergence, case_observed_remove,
         case_three_node_ring, case_snapshot]


@pytest.mark.parametrize("case", CASES, ids=lambda f: f.__name__[5:])
def test_case_equals_the_jax_package(case):
    assert case(_make("t")) == case(_make("j"))


def test_merge_decoded_is_one_dispatch_for_k_payloads():
    """Folding k peer payloads is one reduction of the registered join:
    the port's tree_reduce_join runs once, however many payloads."""
    from crdt_tpu_torch.ops import joins

    calls = []
    real = joins.tree_reduce_join

    def counting(*a, **kw):
        calls.append(a[0])
        return real(*a, **kw)

    n = tcomp.CompositeNode(rid=0, device="cpu")
    peers = [tcomp.CompositeNode(rid=r, device="cpu") for r in range(1, 6)]
    for p in peers:
        p.upd("x", 1)
    joins.tree_reduce_join = counting
    try:
        assert n.merge_decoded([n.decode(p.gossip_payload()) for p in peers]) == 1
    finally:
        joins.tree_reduce_join = real
    assert calls == [tcomp.COMPOSITE_JOIN] and n.merge_dispatches == 1
    assert n.items() == {"x": 5}


def test_decode_rejects_nemesis_corruption():
    n = tcomp.CompositeNode(rid=0, device="cpu")
    n.upd("x", 1)
    good = n.gossip_payload()
    for bad in ({**good, "keys": "corrupted-by-nemesis", "__nemesis_corrupt__": 1},
                {**good, "__nemesis_corrupt__": 1}, {**good, "keys": "corrupted-by-nemesis"}):
        with pytest.raises(ValueError):
            tcomp.CompositeNode.decode(bad)
        with pytest.raises(ValueError):
            jcomp.CompositeNode.decode(bad)


@pytest.mark.parametrize("mutate", [
    lambda p: 42,
    lambda p: {**p, "writers": ["zero"]},
    lambda p: {**p, "keys": p["keys"] * 2},
    lambda p: {**p, "tok": [[1, 2, 3]]},
    lambda p: {**p, "obs": p["tok"]},
    lambda p: {**p, "pos": "corrupted-by-nemesis"},
    lambda p: {k: v for k, v in p.items() if k != "neg"},
], ids=["not-object", "str-rids", "dup-keys", "tok-shape", "obs-axis", "poisoned", "dropped"])
def test_decode_rejects_malformed_payloads(mutate):
    n = tcomp.CompositeNode(rid=0, device="cpu")
    n.upd("x", 1)
    bad = mutate(n.gossip_payload())
    with pytest.raises(ValueError) as t_err:
        tcomp.CompositeNode.decode(bad)
    with pytest.raises(ValueError) as j_err:
        jcomp.CompositeNode.decode(bad)
    assert str(t_err.value) == str(j_err.value)


def test_corrupt_snapshot_fails_restore():
    n = tcomp.CompositeNode(rid=0, device="cpu")
    n.upd("x", 1)
    snap = n.to_snapshot()
    snap["tok"] = "corrupted"
    with pytest.raises(ValueError):
        tcomp.CompositeNode(rid=0, device="cpu").from_snapshot(snap)


def test_planes_live_on_the_nodes_device():
    n = tcomp.CompositeNode(rid=0, device="cpu")
    n.upd("x", 1)
    assert {p.device.type for p in (n._tok, n._obs, n._pos, n._neg)} == {"cpu"}


# ---- the NodeHost serving stack ----


def _serve(*hosts):
    from crdt_tpu_torch.api.net import RemotePeer

    for h in hosts:
        h.agent.peers = [RemotePeer(o.url) for o in hosts if o is not h]
        h.start_server()


def _post(url, path, body):
    req = urllib.request.Request(url + path, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"}, method="POST")
    with urllib.request.urlopen(req, timeout=30) as res:
        return json.loads(res.read())


def test_nodehost_http_surface_and_pull():
    from crdt_tpu_torch.api.net import NodeHost

    a, b = NodeHost(rid=0, peers=[], device="cpu"), NodeHost(rid=1, peers=[], device="cpu")
    _serve(a, b)
    try:
        assert _post(a.url, "/composite/upd", {"key": "x", "delta": 5}) == {"value": 5}
        assert _post(b.url, "/composite/upd", {"key": "x", "delta": -2}) == {"value": -2}
        assert _post(b.url, "/composite/upd", {"key": "y", "delta": 7}) == {"value": 7}
        a.agent.gossip_once()
        b.agent.gossip_once()
        want = {"x": 3, "y": 7}
        assert a.composite_node.items() == b.composite_node.items() == want
        with urllib.request.urlopen(a.url + "/composite", timeout=5) as res:
            assert json.loads(res.read()) == {"items": want}
        assert _post(a.url, "/composite/rem", {"key": "y"}) == {"removed": True}
        assert _post(b.url, "/admin/composite_pull", {}) == {"pulled": True}
        assert b.composite_node.items() == {"x": 3}
        with urllib.request.urlopen(a.url + "/metrics", timeout=5) as res:
            body = res.read().decode()
        assert "crdt_composite_keys{" in body and "crdt_composite_merge_dispatches_total" in body
        assert [e["event"] for e in a.node.events.find(event="composite_merge")]
    finally:
        a.stop()
        b.stop()


def test_fused_round_folds_composite_in_one_merge():
    from crdt_tpu_torch.api.net import NodeHost
    from crdt_tpu_torch.utils.config import ClusterConfig

    cfg = ClusterConfig(fuse_pull_k=2)
    hosts = [NodeHost(rid=r, peers=[], config=cfg, device="cpu") for r in range(3)]
    _serve(*hosts)
    try:
        for i, h in enumerate(hosts):
            h.composite_node.upd("x", i + 1)
        before = hosts[0].composite_node.merge_dispatches
        hosts[0].agent.gossip_once()
        assert hosts[0].composite_node.merge_dispatches == before + 1
        assert hosts[0].composite_node.items() == {"x": 6}
    finally:
        for h in hosts:
            h.stop()


def test_nodehost_checkpoint_roundtrips_composite(tmp_path):
    from crdt_tpu_torch.api.net import NodeHost

    d = str(tmp_path / "ckpt")
    a = NodeHost(rid=0, peers=[], checkpoint_dir=d, device="cpu")
    a.composite_node.upd("x", 5)
    a.composite_node.upd("y", 1)
    a.composite_node.rem("y")
    assert a.checkpoint_now() is not None
    fp = a.composite_node.fingerprint()
    a._server.server_close()
    b = NodeHost(rid=0, peers=[], checkpoint_dir=d, device="cpu")
    try:
        assert b.restored
        assert b.composite_node.fingerprint() == fp
        assert b.composite_node.items() == {"x": 5}
    finally:
        b._server.server_close()


def test_composite_lane_of_the_front_door():
    """admit_composite_upd through the door's composite lane == direct
    upd calls, in both packages."""
    from crdt_tpu.api import node as jnode
    from crdt_tpu.ingest import admission as jadm
    from crdt_tpu_torch.api import node as tnode
    from crdt_tpu_torch.ingest import admission as tadm

    out = []
    for node, cn, adm in (
            (jnode.ReplicaNode(rid=0, capacity=16), jcomp.CompositeNode(rid=0), jadm),
            (tnode.ReplicaNode(rid=0, capacity=16, device="cpu"),
             tcomp.CompositeNode(rid=0, device="cpu"), tadm)):
        door = adm.front_door_from_config(node, composite_node=cn)
        got = [door.admit_composite_upd(f"k{i % 3}", i - 2) for i in range(7)]
        threads = [threading.Thread(target=door.admit_composite_upd, args=("z", 1))
                   for _ in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        out.append((got, cn.items(), [q.name for q in door.lanes],
                    node.metrics.registry.counter_value("ingest_ops_admitted",
                                                        lane="composite", node="0")))
    assert out[0] == out[1]
