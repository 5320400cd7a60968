"""The port's HTTP surface (crdt_tpu_torch.api.http_shim over the port's
LocalCluster, device="cpu") against the JAX package's HttpCluster in demo
mode: the same request sequence goes to both, each served on loopback, and
every response must carry the same status, the same Content-Type,
Content-Length, Retry-After, X-CRDT-Session-Token, X-CRDT-Stability and
X-CRDT-Trace headers, and the same body bytes.

Both clusters run on a ManualClock (epoch 0) advanced in step, so wire
timestamps are equal as served.  ``/metrics`` is compared series by series
(names, labels, values) with these exemptions, each a measurement of
elapsed time or of the device rather than of the replicated state:

* the buckets and sums of the time histograms TIME_HISTOGRAMS (their
  counts are compared);
* the merge's device attribution, JOIN_DEVICE: ``join_flops_per_dispatch``
  and ``join_bytes_per_dispatch`` come from XLA's cost model in the JAX
  package and from the tensors' bytes in the port (which exports no FLOPs),
  ``join_hbm_utilization`` divides bytes by a time;
* the wall-clock gauges ``last_merge_unixtime`` and
  ``seconds_since_last_merge`` (present in both).

``/fleet`` serves the fleet rollup in both packages alike.
"""
import http.client
import json
import threading
import urllib.parse

import numpy as np
import pytest

from crdt_tpu.api import cluster as jcluster
from crdt_tpu.api import http_shim as jshim
from crdt_tpu.api.node import stable_frontier_host as j_stable_frontier
from crdt_tpu.ingest import wire as jwire
from crdt_tpu.ops import union_engine as jue
from crdt_tpu.utils import clock as jclock
from crdt_tpu.utils import config as jconfig
from crdt_tpu_torch.api import cluster as tcluster
from crdt_tpu_torch.api import http_shim as tshim
from crdt_tpu_torch.api.node import stable_frontier_host as t_stable_frontier
from crdt_tpu_torch.ingest import wire as twire
from crdt_tpu_torch.ops import union_engine as tue
from crdt_tpu_torch.utils import clock as tclock
from crdt_tpu_torch.utils import config as tconfig
from tests.test_parity import _rand_cmd

HEADERS = ("Content-Type", "Content-Length", "Retry-After", "X-CRDT-Session-Token",
           "X-CRDT-Stability", "X-CRDT-Trace")
TIME_HISTOGRAMS = ("crdt_write_seconds", "crdt_merge_seconds", "crdt_join_device_seconds",
                   "crdt_ingest_admit_latency_seconds", "crdt_ingest_drain_seconds_seconds",
                   "crdt_op_propagation_seconds")
JOIN_DEVICE = ("crdt_join_flops_per_dispatch", "crdt_join_bytes_per_dispatch",
               "crdt_join_hbm_utilization")
WALL_GAUGES = ("crdt_last_merge_unixtime", "crdt_seconds_since_last_merge")


def request(port, method, path, body=None, headers=None):
    c = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        c.request(method, path, body=body, headers=headers or {})
        r = c.getresponse()
        data = r.read()
        return r.status, {k: r.getheader(k) for k in HEADERS}, data
    finally:
        c.close()


class Served:
    """A JAX HttpCluster and a port HttpCluster over clusters built from
    the same ClusterConfig, each node on its cluster's ManualClock."""

    def __init__(self, **kw):
        jue.reset_tallies()
        tue.reset_tallies()
        self.jc = jcluster.LocalCluster(jconfig.ClusterConfig(**kw))
        self.tc = tcluster.LocalCluster(tconfig.ClusterConfig(**kw), device="cpu")
        self.jclock, self.tclock = jclock.ManualClock(), tclock.ManualClock()
        for n in self.jc.nodes:
            n.clock = self.jclock
        for n in self.tc.nodes:
            n.clock = self.tclock
        self.jh, self.th = jshim.HttpCluster(self.jc), tshim.HttpCluster(self.tc)
        self.jp, self.tp = self.jh.start(), self.th.start()
        self.n = 0

    def stop(self):
        # every server's serve_forever polls its shutdown flag every 0.5 s:
        # signal all ten at once, then let each HttpCluster close its own
        signals = [threading.Thread(target=srv.shutdown)
                   for srv in self.jh.servers + self.th.servers]
        for t in signals:
            t.start()
        for t in signals:
            t.join()
        self.jh.stop()
        self.th.stop()

    def tick_clock(self, ms: int = 1):
        self.jclock.advance(ms)
        self.tclock.advance(ms)

    def both(self, i, method, path, body=None, headers=None):
        """One request to replica ``i`` of both clusters: equal answers."""
        a = request(self.jp[i], method, path, body, headers)
        b = request(self.tp[i], method, path, body, headers)
        assert a == b, (method, path, body, a, b)
        self.n += 1
        return a

    def json(self, i, method, path, body=None, headers=None):
        status, _, data = self.both(i, method, path, body, headers)
        return status, (json.loads(data) if data[:1] in (b"{", b"[") else data)


@pytest.fixture
def served():
    s = Served(log_capacity=64)
    yield s
    s.stop()


def vv_query(vv) -> str:
    return urllib.parse.quote(json.dumps(vv))


def post_json(obj) -> bytes:
    return json.dumps(obj).encode()


def test_writes_condition_and_502s(served):
    """Writes to every replica (multi-key, non-numeric, unicode, nested
    values coerced), replica 4 down: its 502s on every route, then up."""
    rng = np.random.default_rng(0)
    for k in range(20):
        served.tick_clock(int(rng.integers(0, 3)))
        status, hdr, body = served.both(k % 5, "POST", "/data", post_json(_rand_cmd(rng)))
        assert status == 200 and body == b"Inserted" and hdr["X-CRDT-Session-Token"]
    served.both(0, "POST", "/data", post_json({"ü€": "ßtext\n\"q\"", "k": {"nested": 1}}))
    assert served.both(4, "GET", "/condition/false")[0] == 200
    for method, path, body in (("POST", "/data", post_json({"a": "1"})), ("GET", "/data", None),
                               ("GET", "/ping", None), ("GET", "/gossip", None),
                               ("GET", "/vv", None), ("POST", "/compact", b"{}"),
                               ("POST", "/push", post_json({"payload": {}})),
                               ("POST", "/ingest/page", b"x")):
        assert served.both(4, method, path, body)[0] == 502
    assert served.both(4, "GET", "/condition?alive_status=1")[0] == 200
    assert served.both(4, "GET", "/condition/banana")[0] == 500
    assert served.both(4, "GET", "/condition")[0] == 500
    for i in range(5):
        assert served.both(i, "GET", "/ping")[0] == 200
        assert served.both(i, "GET", "/data")[0] == 200
        assert served.both(i, "GET", "/vv")[0] == 200


def test_gossip_full_delta_and_trace(served):
    """Full and delta gossip, with and without X-CRDT-Trace (echoed, and
    recorded as gossip_serve on both), and the bad vv queries."""
    for k in range(12):
        served.tick_clock()
        served.both(k % 3, "POST", "/data", post_json({"k%d" % (k % 4): str(k)}))
    for i in range(3):
        served.both(i, "GET", "/gossip")
        served.both(i, "GET", "/gossip?vv=" + vv_query({"0": 1, "2": 0}))
        _, hdr, _ = served.both(i, "GET", "/gossip?vv=" + vv_query({}),
                                headers={"X-CRDT-Trace": f"trace-{i}"})
        assert hdr["X-CRDT-Trace"] == f"trace-{i}" and hdr["X-CRDT-Stability"]
    for q in ("garbage", "%5B1%5D", vv_query({"a": "b"})):
        assert served.both(0, "GET", "/gossip?vv=" + q)[0] == 400
    for c in (served.jc, served.tc):
        assert [e["trace"] for e in c.nodes[1].events.find(event="gossip_serve")] == ["trace-1"]


def test_pull_rounds_barrier_and_push_over_http(served):
    """Pull rounds over HTTP (GET a peer's /gossip?vv= with the puller's
    /vv, POST it to the puller's /push), barriers over HTTP (/vv from
    everyone, stable_frontier_host, /compact), gossip after the fold (its
    summary sections), and malformed pushes."""
    rng = np.random.default_rng(1)
    for k in range(15):
        served.tick_clock(int(rng.integers(0, 2)))
        served.both(int(rng.integers(0, 5)), "POST", "/data", post_json(_rand_cmd(rng)))
    for rnd in range(12):
        for i in range(5):
            peer = int(rng.integers(0, 5))
            _, vvs = served.json(i, "GET", "/vv")
            status, hdr, body = served.both(
                peer, "GET", "/gossip?vv=" + vv_query(vvs["vv"]),
                headers={"X-CRDT-Trace": f"r{rnd}-{i}"})
            assert status == 200 and hdr["X-CRDT-Trace"] == f"r{rnd}-{i}"
            served.both(i, "POST", "/push", b'{"payload": ' + body + b', "trace": "t"}')
        if rnd % 4 == 3:
            snaps = [served.json(i, "GET", "/vv")[1] for i in range(5)]
            vvs = [{int(r): s for r, s in x["vv"].items()} for x in snaps]
            folds = [{int(r): s for r, s in x["frontier"].items()} for x in snaps]
            frontier = t_stable_frontier(vvs, folds)
            assert frontier == j_stable_frontier(vvs, folds)
            for i in range(5):
                assert served.both(i, "POST", "/compact", post_json(
                    {"frontier": {str(r): s for r, s in frontier.items()}}))[0] == 200
    assert served.tc.nodes[0].frontier  # the barriers folded
    for i in range(5):
        served.both(i, "GET", "/gossip")
        served.both(i, "GET", "/gossip?vv=" + vv_query({"0": 0}))
        served.both(i, "GET", "/data")
    for body in (b"nope", b'{"payload": 3}', b'{"payload": {}, "fences": {"a": 1}}',
                 b'{"payload": {"bad-key": {"a": "1"}}}'):
        assert served.both(0, "POST", "/push", body)[0] == 400
    for body in (b"nope", b'{"frontier": "x"}', b'{"frontier": {"a": "b"}}'):
        assert served.both(0, "POST", "/compact", body)[0] == 400


def _page_pair(origin, page_seq, rows):
    """The same op page from both packages' builders: equal bytes."""
    pages = []
    for w in (jwire, twire):
        b = w.PageBuilder(origin=origin, page_size=1 << 20)
        b._page_seq = page_seq
        for key, value in rows:
            b.add(key, value)
        pages.append(b.flush())
    assert pages[0] == pages[1]
    return pages[0]


def test_pages_duplicates_corruption_and_sheds():
    """Op pages through /ingest/page: admitted, a duplicate page, corrupt
    and truncated pages (400, quarantined whole), and a page over the
    high-water mark (429 + Retry-After)."""
    served = Served(log_capacity=64, ingest_high_water=600)
    try:
        rng = np.random.default_rng(2)
        for p in range(4):
            rows = [(f"k{int(x)}", str(int(v))) for x, v in
                    zip(rng.integers(0, 9, 40), rng.integers(-20, 20, 40))]
            raw = _page_pair(1000 + p % 2, p // 2, rows)
            status, body = served.json(p % 5, "POST", "/ingest/page", raw)
            assert status == 200 and body["admitted"] == 40
        status, body = served.json(3, "POST", "/ingest/page", raw)  # replayed
        assert status == 200 and body["dup"]
        raw = _page_pair(7, 0, [("a", "1"), ("b", "2")])
        bad = bytearray(raw)
        bad[-1] ^= 0xFF
        for broken in (bytes(bad), raw[:-3], raw[:20], b"", b"CRDTPAGE" + raw[8:12]):
            assert served.both(1, "POST", "/ingest/page", broken)[0] == 400
        big = _page_pair(9, 0, [(f"k{i % 7}", "1") for i in range(700)])
        status, hdr, _ = served.both(2, "POST", "/ingest/page", big)
        assert status == 429 and hdr["Retry-After"] == "0.050"
        for i in range(5):
            served.both(i, "GET", "/data")
            served.both(i, "GET", "/gossip")
        for c in (served.jc, served.tc):
            reg = c.metrics.registry
            assert reg.counter_value("ingest_pages_duplicate", node="3") == 1
            assert reg.counter_value("ingest_pages_quarantined", node="1") == 5
            assert reg.counter_value("ingest_shed", lane="kv", node="2") == 1
    finally:
        served.stop()


def test_sibling_routes(served):
    """The demo mode's /set, /seq and /map routes over the cluster's typed
    siblings, with bad bodies, bad indexes and floors, down siblings."""
    for k in range(6):
        served.both(k % 2, "POST", "/set/add", post_json({"elem": f"e{k % 4}"}))
        served.both(k % 2, "POST", "/seq/insert", post_json({"elem": f"q{k}", "index": k % 3}))
        served.both(k % 2, "POST", "/map/upd", post_json({"key": f"m{k % 3}", "delta": k - 2}))
    served.both(0, "POST", "/set/remove", post_json({"elem": "e1"}))
    served.both(0, "POST", "/set/remove", post_json({"elem": "absent"}))
    served.both(1, "POST", "/seq/remove", post_json({"index": 0}))
    served.both(1, "POST", "/seq/remove", post_json({"index": 99}))
    served.both(0, "POST", "/map/rem", post_json({"key": "m1"}))
    served.both(0, "POST", "/seq/insert", post_json({"elem": "tail", "index": None}))
    for kind in ("set", "seq", "map"):
        for i in range(3):
            served.both(i, "GET", f"/{kind}")
            served.both(i, "GET", f"/{kind}/gossip")
            served.both(i, "GET", f"/{kind}/gossip?vv=" + vv_query({"0": 0}))
            served.both(i, "GET", f"/{kind}/vv")
        assert served.both(0, "GET", f"/{kind}/gossip?vv=%7Bbad")[0] == 400
        assert served.both(0, "GET", f"/{kind}/nope")[0] == 404
        assert served.both(0, "POST", f"/{kind}/nope", b"{}")[0] == 404
    _, setvv = served.json(0, "GET", "/set/vv")
    served.both(0, "POST", "/set/collect", post_json({"floor": setvv["vv"]}))
    served.both(1, "POST", "/seq/collect", post_json({"floor": {}}))
    _, mapvv = served.json(0, "GET", "/map/vv")
    served.both(2, "POST", "/map/reset", post_json({"epochs": mapvv["epochs"]}))
    for bad in (b'{"epochs": {"a": "x"}}', b"[]", b"{bad"):
        assert served.both(2, "POST", "/map/reset", bad)[0] == 400
    assert served.both(0, "POST", "/map/upd", b'{"key": "m", "delta": "x"}')[0] == 400
    for c in (served.jc, served.tc):
        c.set_nodes[3].set_alive(False)
        c.seq_nodes[3].set_alive(False)
        c.map_nodes[3].set_alive(False)
    for path, body in (("/set/add", {"elem": "x"}), ("/set/remove", {"elem": "x"}),
                       ("/set/collect", {}), ("/seq/insert", {"elem": "x"}),
                       ("/seq/remove", {"index": 0}), ("/seq/collect", {}),
                       ("/map/upd", {"key": "m", "delta": 1}), ("/map/rem", {"key": "m"}),
                       ("/map/reset", {})):
        assert served.both(3, "POST", path, post_json(body))[0] == 502
    for path in ("/set", "/set/gossip", "/set/vv", "/seq", "/seq/vv", "/map", "/map/vv"):
        assert served.both(3, "GET", path)[0] == 502


@pytest.mark.parametrize("path,bodies", [
    ("/data", [b"not json at all", b"[1, 2, 3]", b'"just a string"', b"{", b"{\x00}"]),
    ("/set/add", [b"", b"[]", b"42", b"{bad", b'{"elem": {"a": 1}}']),
    ("/set/collect", [b"{bad", b'{"floor": "x"}', b'{"floor": {"a": "b"}}']),
    ("/seq/insert", [b"", b"[]", b"{bad", b'{"elem": "x", "index": "q"}']),
    ("/seq/remove", [b"{bad", b'{"index": null}', b'{"index": "x"}']),
    ("/seq/collect", [b"{bad", b'{"floor": {"a": "b"}}']),
])
def test_fuzz_bodies(served, path, bodies):
    """tests/test_http_fuzz.py's malformed bodies: the same answers."""
    for body in bodies:
        served.both(0, "POST", path, body)
    for p in ("/ping", "/data", "/set", "/seq", "/nope", "/data/extra"):
        served.both(0, "GET", p)


def test_demo_mode_404s(served):
    """The routes that need a daemon's host answer 404 in both."""
    for method, path in (("GET", "/read?key=a"), ("POST", "/cas"), ("POST", "/lease/grant"),
                         ("GET", "/ks/gossip?shard=0"), ("GET", "/ks/data"),
                         ("POST", "/ks/compact"), ("POST", "/ks/migrate"),
                         ("GET", "/composite"), ("POST", "/composite/upd"),
                         ("GET", "/audit"), ("POST", "/admin/pull"), ("GET", "/nope"),
                         ("POST", "/set"), ("POST", "/nope")):
        assert served.both(0, method, path, b"{}" if method == "POST" else None)[0] == 404


def _series(text: str) -> dict:
    kinds, out = {}, {}
    for line in text.splitlines():
        if line.startswith("# TYPE "):
            _, _, name, kind = line.split()
            kinds[name] = kind
            continue
        key, value = line.rsplit(" ", 1)
        out[key] = value
    return kinds, out


def _exempt(key: str) -> bool:
    name = key.split("{")[0]
    if name in JOIN_DEVICE or name in WALL_GAUGES:
        return True
    return any(name in (h + "_bucket", h + "_sum") for h in TIME_HISTOGRAMS)


def test_metrics_parity(served):
    """GET /metrics after writes, pages, sibling ops and pull rounds: the
    same series (names and labels) and every value, bar the exemptions of
    the module docstring."""
    rng = np.random.default_rng(3)
    for k in range(10):
        served.tick_clock()
        served.both(k % 5, "POST", "/data", post_json(_rand_cmd(rng)))
    served.both(1, "POST", "/ingest/page", _page_pair(5, 0, [("a", "1"), ("b", "-2")]))
    served.both(0, "POST", "/map/upd", post_json({"key": "m", "delta": 4}))
    served.both(0, "POST", "/set/add", post_json({"elem": "s"}))
    for i in range(5):
        _, vvs = served.json(i, "GET", "/vv")
        _, _, body = served.both((i + 1) % 5, "GET", "/gossip?vv=" + vv_query(vvs["vv"]))
        served.both(i, "POST", "/push", b'{"payload": ' + body + b"}")
    for i in (0, 3):
        jtext = request(served.jp[i], "GET", "/metrics")
        ttext = request(served.tp[i], "GET", "/metrics")
        assert jtext[0] == ttext[0] == 200
        assert jtext[1]["Content-Type"] == ttext[1]["Content-Type"]
        jk, js = _series(jtext[2].decode())
        tk, ts = _series(ttext[2].decode())
        assert {k: v for k, v in jk.items() if k not in JOIN_DEVICE} == \
            {k: v for k, v in tk.items() if k not in JOIN_DEVICE}
        assert {k for k in js if not k.startswith(JOIN_DEVICE)} == \
            {k for k in ts if not k.startswith(JOIN_DEVICE)}
        assert {k: v for k, v in js.items() if not _exempt(k)} == \
            {k: v for k, v in ts.items() if not _exempt(k)}
        assert any(k.startswith("crdt_ingest_ops_admitted_total{") for k in ts)
        assert any(k.startswith("crdt_vv_ops_known{") for k in ts)


def test_fleet_is_the_one_route_that_differs(served):
    """The fleet rollup, the one route that differed until obs/fleet was
    ported: demo mode serves it in both packages with the same status,
    headers and body, the SLO query included, and a bad threshold's 400."""
    for path in ("/fleet", "/fleet?shed_ratio=0.5&admit_p99_ms=1", "/fleet?shed_ratio=x"):
        j = request(served.jp[0], "GET", path)
        t = request(served.tp[0], "GET", path)
        assert j == t, path
    assert j[0] == 400 and json.loads(request(served.tp[0], "GET", "/fleet")[2])["n_members"] == 1


def test_admin_routes_serve_a_daemon():
    """A handler built with a daemon's NodeHost as ``admin`` serves the
    /admin routes (demo mode answers them 404, test_demo_mode_404s);
    HttpCluster takes no admin, as in the JAX package."""
    from crdt_tpu_torch.api import net as tnet

    hosts = [tnet.NodeHost(rid=r, peers=[], device="cpu") for r in range(2)]
    for h in hosts:
        h.agent.peers = [tnet.RemotePeer(o.url) for o in hosts if o is not h]
        h.start_server()
    try:
        port = lambda h: int(h.url.rsplit(":", 1)[1])  # noqa: E731
        assert request(port(hosts[0]), "POST", "/data", post_json({"a": "1"}))[0] == 200
        status, _, body = request(port(hosts[1]), "POST", "/admin/pull", b"{}")
        assert (status, json.loads(body)) == (200, {"pulled": True})
        assert hosts[1].node.get_state() == {"a": "1"}
        assert request(port(hosts[1]), "POST", "/admin/checkpoint", b"{}")[0] == 400
    finally:
        for h in hosts:
            h.stop()
    with pytest.raises(TypeError):
        tshim.HttpCluster(tcluster.LocalCluster(tconfig.ClusterConfig(n_replicas=1),
                                                device="cpu"), admin=object())


def test_concurrent_posts_land_once():
    """More client threads than cores post to the port's surface under a
    shortened switch interval: every acknowledged write lands exactly once
    (distinct session tokens, the converged state == the oracle's fold of
    them, the lanes' admitted count == the posts)."""
    import os
    import sys

    from crdt_tpu_torch.oracle import OracleReplica, Quirks

    tc = tcluster.LocalCluster(tconfig.ClusterConfig(log_capacity=64), device="cpu")
    server = tshim.HttpCluster(tc)
    server.start()
    n_threads = max(8, 2 * (os.cpu_count() or 1))
    oracles = [OracleReplica(r, Quirks()) for r in range(5)]
    tokens, lock = [], threading.Lock()

    def client(t):
        for k in range(6):
            cmd, target = {f"k{(t + k) % 7}": str(t - k)}, (t + k) % 5
            status, hdr, body = request(server.ports[target], "POST", "/data", post_json(cmd))
            assert status == 200 and body == b"Inserted"
            with lock:
                tokens.append(hdr["X-CRDT-Session-Token"])
                oracles[target].add_command(cmd, len(tokens))

    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=client, args=(t,)) for t in range(n_threads)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=120)
        assert not any(th.is_alive() for th in threads)
    finally:
        sys.setswitchinterval(switch)
        server.stop()
    assert len(tokens) == len(set(tokens)) == 6 * n_threads
    for _ in range(40):
        if tc.converged():
            break
        tc.tick()
    assert tc.states() == [OracleReplica.converged_state(oracles)] * 5
    admitted = sum(tc.metrics.registry.counter_value("ingest_ops_admitted", lane="kv",
                                                     node=str(r)) for r in range(5))
    assert admitted == 6 * n_threads
