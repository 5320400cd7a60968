"""The port's network daemon (crdt_tpu_torch.api.net, device="cpu") against
the JAX package's, zero tolerance.

* A JAX pair of NodeHosts and a port pair get the same request sequence
  over loopback (each host's node on its own ManualClock, set on the
  instance before the first write): status, the compared headers and the
  bodies are equal, with each host's own URL and checkpoint dir written as
  a placeholder.  ``/metrics`` is compared series by series with
  tests/test_torch_http.py's exemptions and the fetch timer; the lease
  series (``crdt_lease_*``) and, with the keyspace tier, the
  ``crdt_keyspace_*`` and ``crdt_ks_reshard_*`` series are compared too.
* With ``keyspace_shards=4`` the pairs serve the tier's routes alike:
  /ks/gossip, /ks/data, /ks/compact, /ks/migrate, /read at all four
  levels, /cas, /lease/grant, /push with fence stamps and /admin/ks_pull,
  /admin/ks_gc and /admin/ks_reshard.
* A mixed fleet (a JAX daemon and a port daemon) gossips both ways, folds
  and converges with equal GET /data, vv and digests; a go_compat_gossip
  pair serves the same bytes and trades with the Go-semantics oracle shim
  of tests/test_go_golden.py.
* network_compact (and its skip and missed-/compact heal), quarantined
  payloads, the backoff and circuit states, NetworkSoakRunner and
  ``python -m crdt_tpu_torch --daemon`` as processes.

Rounds are driven with admin_pull / gossip_once, never by sleeping on the
1500 ms loop.
"""
import http.client
import json
import os
import random
import signal
import subprocess
import sys
import threading
import urllib.parse
from pathlib import Path

import numpy as np
import pytest

from crdt_tpu.api import net as jnet
from crdt_tpu.ops import union_engine as jue
from crdt_tpu.utils import clock as jclock
from crdt_tpu.utils import config as jconfig
from crdt_tpu_torch.api import net as tnet
from crdt_tpu_torch.ops import union_engine as tue
from crdt_tpu_torch.utils import clock as tclock
from crdt_tpu_torch.utils import config as tconfig
from tests.test_parity import _rand_cmd
from tests.test_torch_http import HEADERS, JOIN_DEVICE, TIME_HISTOGRAMS, WALL_GAUGES, _page_pair

ROOT = Path(__file__).resolve().parent.parent
FETCH_TIMER = "crdt_net_fetch_seconds"
# the tier's scrape-time series, compared like every other
LEASE_SERIES = ("crdt_lease_state", "crdt_lease_fence_epoch")
KS_SERIES = ("crdt_keyspace_", "crdt_ks_reshard_")
# the tier's time histograms: buckets and sums are elapsed time (their
# counts are compared)
TIER_TIMERS = ("crdt_strong_read_quorum_seconds_seconds", "crdt_ks_admit_latency_seconds")


def _jhost(rid, **kw):
    return jnet.NodeHost(rid=rid, peers=[], config=jconfig.ClusterConfig(**kw.pop("cfg", {})),
                         **kw)


def _thost(rid, **kw):
    return tnet.NodeHost(rid=rid, peers=[], config=tconfig.ClusterConfig(**kw.pop("cfg", {})),
                         device="cpu", **kw)


def _wire(hosts, net):
    for h in hosts:
        h.agent.peers = [net.RemotePeer(o.url) for o in hosts if o is not h]
        h.agent.stability.members = [p.url for p in h.agent.peers]
        h.start_server()


def _stop(hosts):
    signals = [threading.Thread(target=h._server.shutdown) for h in hosts]
    for t in signals:
        t.start()
    for t in signals:
        t.join()
    for h in hosts:
        h._server.server_close()


def request(url, method, path, body=None, headers=None):
    u = urllib.parse.urlparse(url)
    c = http.client.HTTPConnection(u.hostname, u.port, timeout=60)
    try:
        c.request(method, path, body=body, headers=headers or {})
        r = c.getresponse()
        return r.status, {k: r.getheader(k) for k in HEADERS}, r.read()
    finally:
        c.close()


class Fleets:
    """A JAX pair and a port pair of NodeHosts (host 0 the coordinator),
    each node on its own ManualClock, each host with its checkpoint dir."""

    def __init__(self, tmp_path, **cfg):
        # the union-path tallies are process-global: start both at zero
        jue.reset_tallies()
        tue.reset_tallies()
        self.j = [_jhost(r, cfg=dict(cfg), coordinator=r == 0,
                         checkpoint_dir=str(tmp_path / f"j{r}")) for r in range(2)]
        self.t = [_thost(r, cfg=dict(cfg), coordinator=r == 0,
                         checkpoint_dir=str(tmp_path / f"t{r}")) for r in range(2)]
        for h in self.j:
            h.node.clock = jclock.ManualClock()
        for h in self.t:
            h.node.clock = tclock.ManualClock()
        _wire(self.j, jnet)
        _wire(self.t, tnet)
        self.tmp = tmp_path
        self.n = 0

    def stop(self):
        _stop(self.j + self.t)

    def tick(self, ms=1):
        for h in self.j + self.t:
            h.node.clock.advance(ms)

    def _norm(self, hosts, pkg, data: bytes) -> bytes:
        for i, h in enumerate(hosts):
            data = data.replace(h.url.encode(), f"URL{i}".encode())
            data = data.replace(h.checkpoint_dir.encode(), f"CKPT{i}".encode())
        return data

    def _one(self, hosts, pkg, i, method, path, body, headers):
        status, hdr, data = request(hosts[i].url, method, path, body, headers)
        assert hdr["Content-Length"] == str(len(data))
        data = self._norm(hosts, pkg, data)
        hdr["Content-Length"] = str(len(data))  # of the normalized body
        return status, hdr, data

    def both(self, i, method, path, body=None, headers=None):
        a = self._one(self.j, "j", i, method, path, body, headers)
        b = self._one(self.t, "t", i, method, path, body, headers)
        assert a == b, (method, path, body, a, b)
        self.n += 1
        return a

    def json(self, i, method, path, body=None):
        status, _, data = self.both(i, method, path, body)
        return status, json.loads(data) if data[:1] in (b"{", b"[") else data


def post(obj) -> bytes:
    return json.dumps(obj).encode()


@pytest.fixture
def fleets(tmp_path):
    f = Fleets(tmp_path, log_capacity=64)
    yield f
    f.stop()


def test_daemon_requests_equal_the_jax_daemon(fleets):
    """Writes, gossip with its stability and digest header, admin pulls,
    a barrier, stability GC, the siblings' routes and pulls, the
    composite, pages, /audit, a checkpoint, bad admin bodies: the same
    answers from a JAX daemon pair and a port daemon pair."""
    f = fleets
    rng = np.random.default_rng(0)
    for k in range(16):
        f.tick(int(rng.integers(0, 3)))
        status, hdr, body = f.both(k % 2, "POST", "/data", post(_rand_cmd(rng)))
        assert status == 200 and hdr["X-CRDT-Session-Token"]
    f.both(1, "POST", "/ingest/page", _page_pair(7, 0, [("pk", "1"), ("pk", "-3")]))
    for i in range(2):
        f.both(i, "GET", "/gossip")
        _, hdr, _ = f.both(i, "GET", "/gossip?vv=" + urllib.parse.quote('{"0": 2}'),
                           headers={"X-CRDT-Trace": f"t{i}"})
        assert json.loads(hdr["X-CRDT-Stability"])["digest"]
    assert f.json(0, "POST", "/admin/pull", b"{}") == (200, {"pulled": True})
    assert f.json(1, "POST", "/admin/pull", b"{}") == (200, {"pulled": True})
    f.both(1, "POST", "/admin/pull", post({"peer": f.j[0].url}))  # a no-op either way
    status, out = f.json(0, "POST", "/admin/barrier", b"{}")
    assert status == 200 and out["frontier"]
    for i in range(2):
        f.both(i, "GET", "/gossip?vv=" + urllib.parse.quote("{}"))
        f.both(i, "GET", "/vv")
        f.both(i, "GET", "/data")
    f.tick()
    f.both(1, "POST", "/data", post({"late": "1"}))
    f.both(0, "POST", "/admin/pull", b"{}")
    f.both(1, "POST", "/admin/pull", b"{}")
    f.both(0, "POST", "/admin/stability_gc", b"{}")
    # the siblings
    for k in range(4):
        f.both(k % 2, "POST", "/set/add", post({"elem": f"e{k}"}))
        f.both(k % 2, "POST", "/seq/insert", post({"elem": f"q{k}", "index": 0}))
        f.both(k % 2, "POST", "/map/upd", post({"key": f"m{k % 2}", "delta": k - 1}))
        f.both(k % 2, "POST", "/composite/upd", post({"key": f"c{k % 3}", "delta": k}))
    f.both(0, "POST", "/composite/rem", post({"key": "c0"}))
    for route in ("set_pull", "seq_pull", "map_pull", "composite_pull"):
        for i in range(2):
            f.both(i, "POST", f"/admin/{route}", b"{}")
    for route in ("set_barrier", "seq_barrier", "map_barrier"):
        f.both(0, "POST", f"/admin/{route}", b"{}")
    for kind in ("set", "seq", "map", "composite"):
        for i in range(2):
            f.both(i, "GET", f"/{kind}")
            f.both(i, "GET", f"/{kind}/gossip")
    assert f.both(0, "POST", "/composite/upd", b'{"key": "x", "delta": "q"}')[0] == 400
    assert f.both(0, "POST", "/composite/nope", b"{}")[0] == 404
    assert f.both(0, "GET", "/composite/nope")[0] == 404
    # the audit report and a checkpoint
    for i in range(2):
        status, rep = f.json(i, "GET", "/audit")
        assert status == 200 and rep["planes"]["host"]["digest"]
    assert f.json(1, "POST", "/admin/checkpoint", b"{}")[1] == {
        "snapshot": "CKPT1/snap-00000000"}
    assert f.both(0, "POST", "/admin/pull", b"{bad")[0] == 400
    assert f.both(0, "POST", "/admin/pull", b"[]")[0] == 500
    assert f.both(0, "POST", "/admin/nope", b"{}")[0] == 404
    f.both(1, "GET", "/condition/false")
    assert f.json(0, "POST", "/admin/pull", b"{}") == (200, {"pulled": False})
    assert f.both(1, "POST", "/admin/pull", b"{}")[0] == 200
    f.both(1, "GET", "/condition/true")
    for i in range(2):
        f.both(i, "GET", "/data")
    for h in f.t:
        assert h.node.log.ts.device.type == "cpu"


def _series(text: str):
    kinds, out = {}, {}
    for line in text.splitlines():
        if line.startswith("# TYPE "):
            _, _, name, kind = line.split()
            kinds[name] = kind
        elif line:
            key, value = line.rsplit(" ", 1)
            out[key] = value
    return kinds, out


def _exempt(key: str) -> bool:
    name = key.split("{")[0]
    if name in JOIN_DEVICE or name in WALL_GAUGES:
        return True
    return any(name in (h + "_bucket", h + "_sum")
               for h in TIME_HISTOGRAMS + (FETCH_TIMER,) + TIER_TIMERS)


def compare_metrics(f, must=()):
    """GET /metrics of each host pair: the same series and values, bar
    the time and device exemptions; every prefix in ``must`` present."""
    for i in range(2):
        texts = [f._norm(hosts, pkg, request(hosts[i].url, "GET", "/metrics")[2]).decode()
                 for hosts, pkg in ((f.j, "j"), (f.t, "t"))]
        (jk, js), (tk, ts) = _series(texts[0]), _series(texts[1])
        assert {k: v for k, v in jk.items() if k not in JOIN_DEVICE} == \
            {k: v for k, v in tk.items() if k not in JOIN_DEVICE}
        assert {k for k in js if not k.startswith(JOIN_DEVICE)} == \
            {k for k in ts if not k.startswith(JOIN_DEVICE)}
        assert {k: v for k, v in js.items() if not _exempt(k)} == \
            {k: v for k, v in ts.items() if not _exempt(k)}
        for name in must:
            assert any(k.startswith(name) for k in ts), name


def test_daemon_metrics_equal_the_jax_daemon(fleets):
    """GET /metrics after writes, pulls, a barrier and sibling ops: the
    same series and values, bar the time and device exemptions, the
    lease series included."""
    f = fleets
    rng = np.random.default_rng(1)
    for k in range(10):
        f.tick()
        f.both(k % 2, "POST", "/data", post(_rand_cmd(rng)))
    f.both(0, "POST", "/composite/upd", post({"key": "c", "delta": 2}))
    f.both(1, "POST", "/map/upd", post({"key": "m", "delta": 2}))
    for i in (0, 1, 0):
        f.both(i, "POST", "/admin/pull", b"{}")
    f.both(0, "POST", "/admin/barrier", b"{}")
    compare_metrics(f, ("crdt_net_gossip_rounds_total", "crdt_audit_state",
                        "crdt_net_peer_circuit_state{", "crdt_stability_lag_ops{",
                        "crdt_composite_keys{") + LEASE_SERIES)


@pytest.fixture
def ks_fleets(tmp_path):
    """Fleets with the keyspace tier (4 shards, the host path in both
    packages), every shard on a ManualClock of its own and the leases
    ranking the hosts' stable names, so routing and wire bytes match."""
    f = Fleets(tmp_path, log_capacity=64, keyspace_shards=4, keyspace_mesh="off")
    for hosts, clock in ((f.j, jclock), (f.t, tclock)):
        names = {h.url: f"member-{i}" for i, h in enumerate(hosts)}
        for h in hosts:
            h.leases.member_key = names.get
            for s in h.keyspace.shards:
                s.clock = clock.ManualClock()
            for t in h.agent.ks_trackers:
                t.members = [p.url for p in h.agent.peers]
    yield f
    f.stop()


def test_the_fleet_tier_routes_differ(ks_fleets):
    """The tier's routes on a JAX pair and a port pair with
    keyspace_shards=4 (they differed until the tier was ported, the port
    answering 404): tenant writes, /ks/gossip, /ks/data, /ks/compact,
    /read at all four levels, /cas (applied, conflict, forwarded, multi
    key, bad bodies), /lease/grant, fenced /push, /admin/ks_pull,
    /admin/ks_gc and the reshard machine through /admin/ks_reshard give
    equal statuses, headers and bodies, and equal /metrics."""
    f = ks_fleets
    tenant = {"X-CRDT-Tenant": "t-acme"}
    for k in range(12):
        f.both(k % 2, "POST", "/data", post({f"k{k}": f"v{k}"}), headers=tenant)
    f.both(0, "POST", "/data", post({"h": "1"}))
    f.both(0, "POST", "/data", post({"k": "v"}), headers={"X-CRDT-Tenant": "bad:t"})
    f.both(1, "POST", "/ingest/page", _page_pair(9, 0, [("p1", "a"), ("p2", "b")]),
           headers=tenant)
    f.both(1, "POST", "/map/upd", post({"key": "m", "delta": 2}), headers=tenant)
    f.both(0, "GET", "/data", headers=tenant)
    for i in range(2):
        assert f.json(i, "POST", "/admin/ks_pull", b"{}")[0] == 200
        f.both(i, "GET", "/ks/data")
        f.both(i, "GET", "/ks/data?tenant=t-acme")
        for s in range(4):
            f.both(i, "GET", f"/ks/gossip?shard={s}")
            f.both(i, "GET", f"/ks/gossip?shard={s}&vv=" + urllib.parse.quote('{"0": 0}'),
                   headers={"X-CRDT-Trace": f"tr{s}"})
    for path in ("/ks/gossip?shard=9", "/ks/gossip?shard=0&vv=bad", "/ks/gossip?shard=0&epoch=3",
                 "/ks/nope"):
        f.both(0, "GET", path)
    f.both(0, "POST", "/ks/compact", post({"shard": 0, "frontier": {"0": 0}}))
    f.both(0, "POST", "/ks/compact", post({"shard": 7}))
    f.both(0, "POST", "/ks/compact", post({"shard": 0, "frontier": {}, "epoch": 2}))
    f.both(0, "POST", "/ks/migrate", post({"shard": 0, "payload": {}}))
    f.both(0, "POST", "/ks/migrate", post({"shard": 0}))
    assert f.json(0, "POST", "/admin/ks_gc", b"{}")[0] == 200
    token = f.both(0, "POST", "/data", post({"r": "1"}))[1]["X-CRDT-Session-Token"]
    for i in range(2):
        for level in ("eventual", "bounded", "linearizable"):
            f.both(i, "GET", f"/read?key=r&level={level}")
        f.both(i, "GET", "/read?key=r&level=session", headers={"X-CRDT-Session-Token": token})
    for path in ("/read", "/read?key=r&level=session", "/read?key=r&level=strong",
                 "/read?key=r&level=bounded&staleness=x"):
        f.both(0, "GET", path)
    for k in range(6):
        status, out = f.json(k % 2, "POST", "/cas",
                             post({"key": f"c{k % 3}", "expect": None, "update": str(k)}))
        assert status in (200, 409), out
    f.both(1, "POST", "/cas", post({"ops": {"m1": {"expect": None, "update": "a"},
                                            "m2": {"expect": None, "update": "b"}}}))
    for bad in (b"{}", b"[]", post({"ops": {}}), post({"key": "x", "update": "1", "hops": -1})):
        f.both(0, "POST", "/cas", bad)
    f.both(0, "POST", "/lease/grant", post({"slot": 1, "holder": "h", "fence": 9, "ttl": 1}))
    f.both(0, "POST", "/lease/grant", post({"slot": 99, "holder": "h", "fence": 1, "ttl": 1}))
    f.both(1, "POST", "/push", post({"payload": {}, "fences": {"1": 3}}))
    f.both(0, "POST", "/push", post({"payload": {}, "fences": {"1": 8}}))
    # a member down: the strong routes' 503s (Retry-After, the refusal's
    # fields), on both sides of the routing
    f.both(1, "GET", "/condition/false")
    refused = []
    for i in range(2):
        for level in ("bounded", "linearizable", "eventual"):
            refused.append(f.both(i, "GET", f"/read?key=r&level={level}"))
        for k in range(3):
            refused.append(f.both(i, "POST", "/cas",
                                  post({"key": f"c{k}", "expect": "x", "update": "y"})))
    f.both(1, "GET", "/condition/true")
    assert sum(1 for st, hdr, _ in refused if st == 503 and hdr["Retry-After"]) >= 6
    compare_metrics(f, LEASE_SERIES + KS_SERIES)
    for action in ({"action": "status"}, {"action": "start", "shards": 6},
                   {"action": "start", "shards": 5}, {"action": "stream"}):
        for i in range(2):
            f.both(i, "POST", "/admin/ks_reshard", post(action))
    f.both(0, "POST", "/ks/migrate", post({"shard": 5, "epoch": 0, "payload": {"1:0:0": "x"}}))
    for i in range(2):
        f.both(i, "POST", "/admin/ks_reshard", post({"action": "cutover"}))
    f.both(0, "POST", "/admin/ks_reshard", post({"action": "nope"}))
    f.both(0, "GET", "/ks/gossip?shard=0")
    for i in range(2):
        f.both(i, "POST", "/admin/ks_pull", b"{}")
        f.both(i, "GET", "/ks/data?tenant=t-acme")
    compare_metrics(f, LEASE_SERIES + KS_SERIES)
    assert f.t[0].keyspace.n_shards == 6 and f.t[0].keyspace.epoch == 1


def test_daemon_without_the_tier_and_its_refusals(fleets):
    """Without ``keyspace_shards`` the /ks routes are the demo mode's
    404s in both packages, while the leases and the plane serve; the
    keyspace refuses ``mesh="on"`` naming ROADMAP Queue 1 item 6."""
    f = fleets
    for method, path in (("GET", "/ks/gossip?shard=0"), ("POST", "/ks/compact"),
                         ("POST", "/ks/migrate"), ("GET", "/ks/data")):
        assert f.both(0, method, path, b"{}" if method == "POST" else None)[0] == 404
    assert f.json(0, "POST", "/admin/ks_pull", b"{}") == (200, {"fresh": 0})
    assert f.both(0, "POST", "/admin/ks_reshard", b"{}")[0] == 400
    assert f.json(0, "POST", "/admin/ks_gc", b"{}") == (200, {"shards": {}})
    assert f.t[0].keyspace is None and f.t[0].leases is not None
    with pytest.raises(NotImplementedError, match="Queue 1 item 6"):
        _thost(5, cfg=dict(keyspace_shards=2, keyspace_mesh="on"))


def test_mixed_fleet_converges(tmp_path):
    """One JAX daemon and one port daemon on loopback (different epochs):
    they gossip both ways, the port coordinator's barrier folds both, and
    GET /data, vv, frontier and the digest at the frontier are equal."""
    j = jnet.NodeHost(rid=0, peers=[])
    t = tnet.NodeHost(rid=1, peers=[], device="cpu", coordinator=True)
    j.node.clock.epoch_ms -= 5_000
    _wire([j, t], jnet)
    t.agent.peers = [tnet.RemotePeer(j.url)]
    t.agent.stability.members = [j.url]
    try:
        rng = np.random.default_rng(2)
        for k in range(20):
            h = (j, t)[k % 2]
            assert request(h.url, "POST", "/data", post(_rand_cmd(rng)))[0] == 200
        for _ in range(2):
            assert t.admin_pull() is not None and j.admin_pull() is not None
        assert j.node.get_state() == t.node.get_state()
        frontier = t.admin_barrier()
        assert frontier and j.node.frontier == t.node.frontier == frontier
        request(j.url, "POST", "/data", post({"after": "3"}))
        t.admin_pull()
        j.admin_pull()
        assert json.loads(request(j.url, "GET", "/data")[2]) == \
            json.loads(request(t.url, "GET", "/data")[2])
        assert j.node.version_vector() == t.node.version_vector()
        assert j.node.audit_digest_at(frontier) == t.node.audit_digest_at(frontier) is not None
        _, jf, jd = j.node.audit_snapshot()
        _, tf, td = t.node.audit_snapshot()
        assert (jf, jd) == (tf, td)
        # each watchdog compared the other's piggybacked digest and agrees
        t.admin_pull()
        j.admin_pull()
        assert t.agent.watchdog.state == j.agent.watchdog.state == 1
    finally:
        _stop([j, t])


def test_mixed_fleet_pulls_shards_and_forwards_cas():
    """A JAX daemon and two port daemons with keyspace_shards=4: tenant
    writes on each, keyspace pulls both ways until every shard's vv is
    equal and every tenant reads alike everywhere; CAS sent to every
    member routes to its slot's coordinator across the packages (forwards
    one way and the other), decides under a lease whose votes cross the
    packages, and leaves one value and one fence table on all three."""
    cfg = dict(keyspace_shards=4, keyspace_mesh="off")
    hosts = [jnet.NodeHost(rid=0, peers=[], config=jconfig.ClusterConfig(**cfg))] + \
        [tnet.NodeHost(rid=r, peers=[], device="cpu", config=tconfig.ClusterConfig(**cfg))
         for r in (1, 2)]
    for h in hosts:
        net = jnet if isinstance(h, jnet.NodeHost) else tnet
        h.agent.peers = [net.RemotePeer(o.url) for o in hosts if o is not h]
        h.start_server()
    try:
        tenant = {"X-CRDT-Tenant": "t-mix"}
        for k in range(18):
            assert request(hosts[k % 3].url, "POST", "/data", post({f"k{k}": str(k)}),
                           tenant)[0] == 200
        for _ in range(2):
            for h in hosts:
                for p in h.agent.peers:
                    assert h.admin_ks_pull(p.url) >= 0
        want = {f"k{k}": str(k) for k in range(18)}
        for h in hosts:
            assert h.keyspace.tenant_state("t-mix") == want
        for s in range(4):
            assert len({json.dumps(h.keyspace.version_vector(s), sort_keys=True)
                        for h in hosts}) == 1
        # every (host, key) pair: two of the three CAS on each key reach a
        # non-coordinator, whatever ports the OS gave the members; each
        # call's forward count (a delta, not the running counter) is the
        # one its host's routing view predicts
        forwards = []
        for k in range(9):
            h, key = hosts[k % 3], f"c{k // 3}"
            slot = h.leases.slot_of(key)
            predicted = int(h.leases.coordinator_of(slot) != h.url)
            before = h.node.metrics.registry.counter_value("cas_forwarded") or 0
            cur = json.loads(request(h.url, "GET", f"/read?key={key}&level=linearizable")[2])
            status, _, body = request(h.url, "POST", "/cas", post(
                {"key": key, "expect": cur["value"], "update": f"n{k}"}))
            assert status == 200, body
            got = (h.node.metrics.registry.counter_value("cas_forwarded") or 0) - before
            forwards.append((got, predicted))
        assert all(got == predicted for got, predicted in forwards), forwards
        assert sum(got for got, _ in forwards) == 6, forwards
        for key in ("c0", "c1", "c2"):
            values = {json.loads(request(h.url, "GET", f"/read?key={key}&level=linearizable")[2])
                      ["value"] for h in hosts}
            assert len(values) == 1 and values != {None}, (key, values)
        coords = {h.leases.coordinator_of(s) for h in hosts for s in range(8)}
        assert coords <= {h.url for h in hosts}
    finally:
        _stop(hosts)


def test_go_compat_pair_and_the_go_oracle(tmp_path):
    """go_compat_gossip daemons, one per package, on ManualClocks: the
    same writes serve the same bare-ms full dump; the Go-semantics oracle
    shim (tests/test_go_golden.py's) adopts either dump to the same state;
    and each daemon pulling the oracle's Go-format log lands on the same
    state."""
    from crdt_tpu_torch.oracle.shim import OracleHttpCluster
    from crdt_tpu_torch.utils.clock import ManualClock

    cfg = dict(go_compat_gossip=True)
    hosts = {"j": _jhost(3, cfg=dict(cfg)), "t": _thost(3, cfg=dict(cfg))}
    for pkg, h in hosts.items():
        h.node.clock = (jclock if pkg == "j" else tclock).ManualClock(start=1_000_100)
        h.start_server()
    oracle = OracleHttpCluster(n=1, clock=ManualClock(start=1_000_000))
    oracle.start()
    try:
        for k in range(5):
            for h in hosts.values():
                h.node.clock.advance(2)
                request(h.url, "POST", "/data", post({f"k{k % 2}": str(k), "s": f"<{k}>"}))
        dumps = {pkg: request(h.url, "GET", "/gossip")[2] for pkg, h in hosts.items()}
        assert dumps["j"] == dumps["t"] and b'"1000102":' in dumps["t"]
        request(oracle.urls[0], "POST", "/data", b'{"g":"5"}')
        peer_states = {}
        for pkg, h in hosts.items():
            net = jnet if pkg == "j" else tnet
            assert h.agent.pull_from(net.RemotePeer(oracle.urls[0]))
            peer_states[pkg] = (h.node.get_state(), request(h.url, "GET", "/gossip")[2])
        assert peer_states["j"] == peer_states["t"]
        adopted = []
        for pkg in ("j", "t"):
            o = OracleHttpCluster(n=1, clock=ManualClock(start=2_000_000))
            o.nodes[0].receive_wire(dumps[pkg].decode())
            adopted.append((o.nodes[0].get_state(), o.nodes[0].gossip_wire()))
        assert adopted[0] == adopted[1] and adopted[1]
    finally:
        oracle.stop()
        _stop(list(hosts.values()))


def _trio(net, make):
    hosts = [make(r) for r in range(3)]
    _wire(hosts, net)
    return hosts


def test_network_compact_skip_and_heal():
    """tests/test_net_compact.py's cases on a JAX trio and a port trio:
    the barrier folds everyone, is skipped while a member is down, and a
    member that missed the /compact POST folds at the next barrier; a
    fresh member reconstructs from the summary sections.  Every frontier,
    state and log size equal across the packages."""
    out = {}
    for pkg, net, make in (("j", jnet, lambda r: _jhost(r)), ("t", tnet, lambda r: _thost(r))):
        a, b, c = hosts = _trio(net, make)
        log = []
        try:
            for h, cmd in ((a, {"x": "5"}), (b, {"x": "2"}), (c, {"y": "hi"})):
                net.RemotePeer(h.url).add_command(cmd)
            for _ in range(4):
                for h in hosts:
                    h.agent.gossip_once()
            log.append(net.network_compact(a.node, a.agent.peers))
            log.append([(h.node.get_state(), len(h.node._commands)) for h in hosts])
            net.RemotePeer(a.url).add_command({"x": "1"})
            c.node.set_alive(False)
            log.append(net.network_compact(a.node, a.agent.peers))
            log.append(a.agent.compact_once())
            c.node.set_alive(True)
            for _ in range(3):
                for h in hosts:
                    h.agent.gossip_once()
            # the missed POST: a and b fold, c does not
            f2 = dict(a.node.version_vector())
            a.node.compact(f2)
            assert net.RemotePeer(b.url).compact(f2)
            log.append((c.node.frontier, c.node.get_state() == a.node.get_state()))
            net.RemotePeer(c.url).add_command({"z": "9"})
            for _ in range(3):
                for h in hosts:
                    h.agent.gossip_once()
            log.append(net.network_compact(a.node, a.agent.peers))
            log.append([(h.node.frontier, h.node.get_state()) for h in hosts])
            fresh = make(9)
            fresh.agent.peers = [net.RemotePeer(a.url)]
            fresh.start_server()
            try:
                log.append((fresh.agent.gossip_once(), fresh.node.frontier,
                            fresh.node.get_state()))
            finally:
                _stop([fresh])
            log.append([h.agent.metrics.registry.counter_value(n) for h in hosts
                        for n in ("net_compactions", "net_compact_skipped", "compactions",
                                  "frontier_adoptions")])
        finally:
            _stop(hosts)
        out[pkg] = log
    assert out["t"] == out["j"]
    assert out["t"][2] == {} and out["t"][3] == {}


class BadPeer:
    """A peer shim serving a fixed (malformed) payload."""

    def __init__(self, url, payload):
        self.url, self.payload = url, payload

    def gossip_payload(self, since=None, trace=None):
        return dict(self.payload)

    def backed_off(self):
        return False

    def set_gossip_payload(self, since=None):
        return None

    seq_gossip_payload = map_gossip_payload = set_gossip_payload

    def composite_gossip_payload(self):
        return {"keys": "corrupted-by-nemesis"}

    serves_set = serves_seq = serves_map = serves_composite = None


@pytest.mark.parametrize("fuse", [1, 2])
def test_malformed_payloads_are_quarantined(fuse):
    """A malformed payload (a bad wire key; a non-dict command) is
    quarantined: {prefix}_quarantined and a payload_quarantine event,
    nothing merged, the loop lives on; in a fused round the good payload
    still merges.  Counters and events equal the JAX agent's."""
    good = {"1000:5:0": {"g": "1"}}
    bads = [{"not-a-key": {"a": "1"}}, {"1000:6:0": "x"}]
    out = {}
    for pkg, make in (("j", lambda: _jhost(0, cfg=dict(fuse_pull_k=fuse))),
                      ("t", lambda: _thost(0, cfg=dict(fuse_pull_k=fuse)))):
        h = make()
        try:
            h.node.clock = (jclock if pkg == "j" else tclock).ManualClock()
            got = []
            for bad in bads:
                h.agent.peers = [BadPeer("http://bad", bad)] + (
                    [BadPeer("http://good", good)] if fuse > 1 else [])
                got.append(h.agent.gossip_once())
            if fuse == 1:
                got.append(h.agent.pull_from(BadPeer("http://good", good)))
            events = [{k: v for k, v in e.items() if k not in ("ts_ms", "trace", "error")}
                      for e in h.node.events.find(event="payload_quarantine")]
            snap = h.agent.metrics.snapshot()
            out[pkg] = (got, h.node.get_state(), events,
                        {k: v for k, v in snap.items() if "quarantined" in k or "rounds" in k})
        finally:
            h._server.server_close()
    assert out["t"] == out["j"]
    assert out["t"][1] == {"g": "1"}
    assert out["t"][3]["net_gossip_quarantined"] == 2


def test_backoff_and_circuit_states():
    """RemotePeer against a port nothing listens on, with a seeded rng and
    a manual clock: the failure count, breaker state, jittered windows and
    the half-open probe follow the JAX peer's step for step; an agent
    skips the backed-off peer loudly; a peer that answers any status
    closes the breaker."""
    trail = {}
    for pkg, net in (("j", jnet), ("t", tnet)):
        now = [0.0]
        p = net.RemotePeer("http://127.0.0.1:1", timeout=0.5, backoff_base_s=0.5,
                           backoff_cap_s=4.0, failure_threshold=2,
                           rng=random.Random(3), clock=lambda: now[0])
        steps = []
        for t in (0.0, 0.1, 0.2, 1.0, 3.0, 9.0, 9.1, 30.0):
            now[0] = t
            off = p.backed_off()
            if not off:
                p.ping()
            steps.append((t, off, p.circuit_state(), p.failure_count(), round(p.retry_at, 9),
                          p.backoff_peek()))
        trail[pkg] = steps
    assert trail["t"] == trail["j"]
    assert {s[2] for s in trail["t"]} >= {"closed", "open"}
    h = _thost(0, cfg=dict(peer_timeout_s=0.5))
    try:
        h.agent.peers = [tnet.RemotePeer("http://127.0.0.1:1", timeout=0.5)]
        assert not h.agent.gossip_once()
        assert not h.agent.gossip_once()
        assert h.agent.metrics.registry.counter_value("net_peer_backoff_skips") == 1
        assert h.agent.peers[0].circuit_state() == "open"
        [ev] = h.node.events.find(event="peer_backoff_skip")
        assert ev["circuit"] == "open"
        h.start_server()
        live = tnet.RemotePeer(h.url)
        live._note_transport_failure()
        assert live.circuit_state() == "open"
        h.node.set_alive(False)
        live._state = tnet.CIRCUIT_HALF_OPEN
        assert not live.ping() and live.circuit_state() == "closed"  # a 502 closes it
    finally:
        _stop([h])


def test_network_soak_report_equals_the_jax_soak():
    """NetworkSoakRunner on one seed, single-op and paged writes under
    kill/revive: the port's report (every count and the final state) ==
    the JAX runner's."""
    from crdt_tpu.harness.soak import NetworkSoakRunner as JRunner
    from crdt_tpu_torch.harness.soak import NetworkSoakRunner as TRunner

    reports = []
    for runner in (JRunner(n=3, seed=0, p_page=0.25),
                   TRunner(n=3, seed=0, p_page=0.25, device="cpu")):
        r = runner.run(120)
        counts = {k: v for k, v in r.metrics.items()
                  if k.startswith(("net_gossip", "net_compact", "compactions", "ops_ingested",
                                   "ingest_pages", "frontier_adoptions"))}
        reports.append((r.steps, r.writes_offered, r.writes_accepted, r.writes_rejected_dead,
                        r.gossip_rounds, r.kills, r.revivals, r.barriers, r.barriers_skipped,
                        r.rounds_to_converge, r.final_state, r.pages_admitted, counts))
    assert reports[1] == reports[0]
    assert reports[1][11] > 0 and reports[1][5] > 0


def _daemon(*args):
    return subprocess.Popen([sys.executable, "-m", "crdt_tpu_torch", "--daemon", "--device",
                             "cpu", *args], cwd=ROOT, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def _serving(proc):
    line = proc.stdout.readline()
    assert " serving on http://127.0.0.1:" in line, (line, proc.poll())
    return line


def _admin(url, path, body=b"{}"):
    return request(url, "POST", path, body)


def test_run_daemon_processes_crash_and_restore(tmp_path):
    """Two ``python -m crdt_tpu_torch --daemon --device cpu`` processes on
    ephemeral ports: writes, admin pulls to equal GET /data, a checkpoint,
    kill -9 of one, and its restart on the same dir at incarnation 1 (rid
    1 + 64), restored, serving and taking writes, then equal again."""
    procs, urls = [], [None, None]

    def boot(i, *extra):
        args = ["--rid", str(i), "--port", "0",
                "--checkpoint-dir", str(tmp_path / f"c{i}"),
                "--event-log", str(tmp_path / f"e{i}.jsonl"), "--gossip-ms", "60000", *extra]
        p = _daemon(*args)
        procs.append(p)
        line = _serving(p)
        urls[i] = line.split(" serving on ")[1].split(",")[0]
        return line

    def pull_both():
        # each pulls the other by URL: the ports are picked at boot
        for i in range(2):
            assert _admin(urls[i], "/admin/pull", post({"peer": urls[1 - i]}))[0] == 200

    try:
        boot(0, "--coordinator", "--compact-every", "8")
        assert "rid=1 (base 1, incarnation 0, restored=False)" in boot(1, "--peers", urls[0])
        for k in range(6):
            assert request(urls[k % 2], "POST", "/data", post({f"k{k % 3}": str(k)}))[0] == 200
        pull_both()
        assert json.loads(request(urls[0], "GET", "/data")[2]) == \
            json.loads(request(urls[1], "GET", "/data")[2])
        status, _, body = _admin(urls[1], "/admin/checkpoint")
        assert status == 200 and b"snap-00000000" in body
        procs[1].send_signal(signal.SIGKILL)
        procs[1].wait(30)
        assert "rid=65 (base 1, incarnation 1, restored=True)" in boot(1, "--peers", urls[0])
        assert request(urls[1], "POST", "/data", post({"k9": "1"}))[0] == 200
        pull_both()
        data = [json.loads(request(u, "GET", "/data")[2]) for u in urls]
        assert data[0] == data[1] and "k9" in data[0]
        vv = json.loads(request(urls[0], "GET", "/vv")[2])["vv"]
        assert set(vv) == {"0", "1", "65"}
        assert (tmp_path / "c1" / "boot.json").read_text() == '{"incarnation": 2}'
        events = [json.loads(x)["event"] for x in (tmp_path / "e1.jsonl").read_text().splitlines()]
        assert events.count("boot") == 2 and "snapshot_restore" in events
    finally:
        for p in procs:
            if p.poll() is None:
                p.send_signal(signal.SIGINT)
        for p in procs:
            try:
                p.wait(30)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()


@pytest.mark.parametrize("args,msg", [
    (["--set-collect-every", "4"], "requires --coordinator"),
    (["--compact-every", "4"], "requires --coordinator"),
    (["--checkpoint-dir", "x", "--rid", "70"], "--rid-stride"),
])
def test_run_daemon_refusals(args, msg):
    out = subprocess.run([sys.executable, "-m", "crdt_tpu_torch", "--daemon", "--device", "cpu",
                          "--port", "0", *args], cwd=ROOT, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 2 and msg in out.stderr and "serving" not in out.stdout


def test_daemon_serves_the_keyspace(tmp_path):
    """``python -m crdt_tpu_torch --daemon --keyspace-shards 2`` (the
    refusal until the tier was ported) serves tenant writes from its
    shards: /ks/data answers the tenant's state and two shards' stats,
    and a SIGINT stops it with exit 0."""
    proc = subprocess.Popen([sys.executable, "-m", "crdt_tpu_torch", "--daemon", "--device",
                             "cpu", "--port", "0", "--keyspace-shards", "2"], cwd=ROOT,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        line = proc.stdout.readline()
        assert " serving on " in line, proc.stderr.read() if proc.poll() is not None else line
        url = line.split(" serving on ")[1].split(",")[0]
        tenant = {"X-CRDT-Tenant": "t-acme"}
        for k in range(6):
            assert request(url, "POST", "/data", post({f"k{k}": str(k)}), tenant)[0] == 200
        status, _, body = request(url, "GET", "/ks/data?tenant=t-acme")
        assert status == 200 and json.loads(body) == {
            "tenant": "t-acme", "state": {f"k{k}": str(k) for k in range(6)}}
        shards = json.loads(request(url, "GET", "/ks/data")[2])["shards"]
        assert len(shards) == 2 and sum(s["keys"] for s in shards) == 6
        assert json.loads(request(url, "GET", "/read?key=x&level=linearizable")[2]) == {
            "key": "x", "value": None, "level": "linearizable"}
    finally:
        proc.send_signal(signal.SIGINT)
        assert proc.wait(60) == 0


def test_daemon_without_a_card_fails_rather_than_fall_back(monkeypatch):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is the card")
    out = subprocess.run([sys.executable, "-m", "crdt_tpu_torch", "--daemon", "--port", "0"],
                         cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert out.returncode == 2 and "no CUDA device" in out.stderr
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tnet.NodeHost(rid=0, peers=[])


def test_stop_raises_a_request_handlers_failure():
    """A handler thread that raised (a device error in a merge served on
    it, say) is recorded by the daemon's server and raised by stop()."""
    h = _thost(0)
    h.start_server()

    def broken(payload):
        raise RuntimeError("device fault in flight")

    h.node.receive = broken
    with pytest.raises(http.client.RemoteDisconnected):
        request(h.url, "POST", "/push", post({"payload": {"1:0:0": {"a": "1"}}}))
    with pytest.raises(RuntimeError, match="request handler") as err:
        h.stop()
    assert "device fault in flight" in repr(err.value.__cause__)


def test_soak_cli_equals_the_jax_cli():
    """``python -m crdt_tpu_torch.harness.soak --network`` prints the JAX
    CLI's report line for the same seed, and its JSON companion lines."""
    args = ["--network", "--paged", "0.25", "--steps", "60", "--seeds", "1", "--replicas", "3"]
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    outs = [subprocess.run([sys.executable, "-m", mod, *args, *extra], cwd=ROOT, env=env,
                           capture_output=True, text=True, timeout=300)
            for mod, extra in (("crdt_tpu.harness.soak", []),
                               ("crdt_tpu_torch.harness.soak", ["--device", "cpu"]))]
    for out in outs:
        assert out.returncode == 0, out.stderr
    lines = [o.stdout.splitlines() for o in outs]
    assert lines[1][0] == lines[0][0] and lines[1][0].startswith("seed 0: soak: 60 steps")
    assert json.loads(lines[1][1])["steps"] == 60 and "propagation" in json.loads(lines[1][2])
