"""The port's quirk-compat surface (crdt_tpu_torch.oracle.shim) held to the
Go byte fixtures of tests/test_go_golden.py (its table, imported) and to
the JAX package's OracleHttpCluster on tests/test_blackbox_quirks.py's
cases, over real sockets; go_json_dumps equal to JAX's on seeded payloads
with the characters Go escapes."""
import json
import random
import urllib.error
import urllib.request

import pytest

from crdt_tpu.oracle import shim as jshim
from crdt_tpu.utils import clock as jclock
from crdt_tpu_torch.oracle import shim as tshim
from crdt_tpu_torch.utils import clock as tclock
from tests.test_go_golden import FIXTURES, TEXT


def _req(url, method="GET", data=None):
    req = urllib.request.Request(url, data=data, method=method)
    try:
        with urllib.request.urlopen(req, timeout=10) as res:
            return res.status, res.read(), res.headers.get("Content-Type")
    except urllib.error.HTTPError as e:
        return e.code, e.read(), e.headers.get("Content-Type")


def _cluster(pkg, clock_pkg, n=1, start=1_000_000):
    c = pkg.OracleHttpCluster(n=n, clock=clock_pkg.ManualClock(start=start))
    c.start()
    return c


@pytest.fixture
def pair():
    """A JAX and a port shim of one replica each, at the same clock."""
    cs = [_cluster(jshim, jclock), _cluster(tshim, tclock)]
    yield cs
    for c in cs:
        c.stop()


@pytest.mark.parametrize("name,setup,request_,want,citation", FIXTURES,
                         ids=[f[0] for f in FIXTURES])
def test_golden_fixtures(pair, name, setup, request_, want, citation):
    got = []
    for c in pair:
        for advance_ms, body in setup:
            c.nodes[0].clock.advance(advance_ms)
            _req(c.urls[0] + "/data", "POST", body)
        method, path, body = request_
        got.append(_req(c.urls[0] + path, method, body))
    assert got[1] == want, citation
    assert got[1] == got[0]


def test_gossip_keys_are_string_ordered():
    c = _cluster(tshim, tclock, start=999)
    try:
        u = c.urls[0]
        _req(u + "/data", "POST", b'{"a":"1"}')
        c.nodes[0].clock.advance(1)
        _req(u + "/data", "POST", b'{"b":"2"}')
        assert _req(u + "/gossip")[1] == b'{"1000":{"b":"2"},"999":{"a":"1"}}'
    finally:
        c.stop()


def test_gossip_null_entry_roundtrip():
    """The invalid-body Put's nil command travels as null and adopts
    silently, in the port's shim as in the JAX one."""
    results = []
    for pkg, clk in ((jshim, jclock), (tshim, tclock)):
        c, peer = _cluster(pkg, clk), _cluster(pkg, clk, start=2_000_000)
        try:
            _req(c.urls[0] + "/data", "POST", b"not json")
            wire = _req(c.urls[0] + "/gossip")[1]
            _req(peer.urls[0] + "/data", "POST", b'{"z":"9"}')
            peer.nodes[0].receive_wire(wire.decode())
            results.append((wire, _req(peer.urls[0] + "/data"),
                            _req(peer.urls[0] + "/gossip")))
        finally:
            c.stop()
            peer.stop()
    assert results[1][0] == b'{"1000000":null}'
    assert json.loads(results[1][1][1]) == {}
    assert results[0] == results[1]


def test_dead_node_502_everywhere(pair):
    for c in pair:
        c.nodes[0].oracle.alive = False
    for method, path, body in (("GET", "/ping", None), ("GET", "/data", None),
                               ("GET", "/gossip", None), ("POST", "/data", b'{"x":"1"}')):
        got = [_req(c.urls[0] + path, method, body) for c in pair]
        assert got[1] == (502, b"Unreachable", TEXT) == got[0]


def _scenario_surface(c, req):
    u = c.urls[0]
    for path in ("/ping", "/data", "/condition", "/condition?alive_status=false", "/nope"):
        req(u + path)
    req(u + "/data", "POST", b"not json")
    inserted = req(u + "/data", "POST", json.dumps({"x": "5"}).encode())
    req(u + "/nope", "POST", b"{}")
    return inserted[:2]


def _scenario_multikey(c, req):
    u0, u1 = c.urls
    req(u0 + "/data", "POST", json.dumps({"a": "1", "b": "2"}).encode())
    req(u0 + "/data")
    req(u0 + "/gossip")
    c.nodes[0].clock.advance(10)
    req(u1 + "/data", "POST", json.dumps({"z": "9"}).encode())
    c.nodes[0].clock.advance(10)
    assert c.gossip_once(1, 0)
    return req(u1 + "/data")[1]


def _scenario_tail_drop(c, req):
    u0, u1 = c.urls
    req(u0 + "/data", "POST", json.dumps({"x": "5"}).encode())
    c.nodes[0].clock.advance(10)
    assert c.gossip_once(1, 0)
    return req(u1 + "/data")[1]


def _scenario_local_exclusion(c, req):
    u0, u1 = c.urls
    req(u0 + "/data", "POST", json.dumps({"x": "5"}).encode())
    c.nodes[0].clock.advance(10)
    req(u1 + "/data", "POST", json.dumps({"z": "9"}).encode())
    c.nodes[0].clock.advance(10)
    assert c.gossip_once(1, 0)
    req(u1 + "/data")
    req(u0 + "/data")
    assert c.gossip_once(0, 1)
    req(u0 + "/data")
    reading = req(u1 + "/data")[1]
    req(u0 + "/gossip")
    req(u1 + "/gossip")
    return reading


def _scenario_same_ms(c, req):
    u = c.urls[0]
    req(u + "/data", "POST", json.dumps({"x": "1"}).encode())
    req(u + "/data", "POST", json.dumps({"y": "2"}).encode())
    return req(u + "/gossip")[1]


def _scenario_numeric(c, req):
    u0, u1 = c.urls
    for delta in ("-11", "-20", "5"):
        req(u0 + "/data", "POST", json.dumps({"k": delta}).encode())
        c.nodes[0].clock.advance(10)
    req(u1 + "/data", "POST", json.dumps({"z": "1"}).encode())
    c.nodes[0].clock.advance(10)
    assert c.gossip_once(1, 0)
    return req(u1 + "/data")[1]


SCENARIOS = {
    "surface": (_scenario_surface, (200, b"Inserted")),
    "multikey_early_return": (_scenario_multikey, b'{"a":"1","b":"2"}'),
    "tail_drop_empty_replica": (_scenario_tail_drop, b"{}"),
    "local_op_exclusion": (_scenario_local_exclusion, b'{"x":"5"}'),
    "same_ms_overwrite": (_scenario_same_ms, b'{"1000000":{"y":"2"}}'),
    "numeric_convergence": (_scenario_numeric, b'{"k":"-26"}'),
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_blackbox_quirk_cases_alike(name):
    """tests/test_blackbox_quirks.py's cases on a 2-replica shim in each
    package: every response equal, and the quirk's reading as pinned
    there."""
    scenario, want = SCENARIOS[name]
    seen = []
    for pkg, clk in ((jshim, jclock), (tshim, tclock)):
        c = _cluster(pkg, clk, n=2)
        got = []

        def req(*a, got=got):
            got.append(_req(*a))
            return got[-1]

        try:
            reading = scenario(c, req)
        finally:
            c.stop()
        seen.append(got)
    assert seen[0] == seen[1]
    assert reading == want


SPECIALS = ["<", ">", "&", "\b", "\f", "\u2028", "\u2029", '"', "\\", "\n", "\r", "\t",
            "\x00", "\x1f", "\x7f", "é", "😀", "a<b>&c"]


@pytest.mark.parametrize("seed", range(5))
def test_go_json_dumps_alike(seed):
    rng = random.Random(seed)

    def text():
        return "".join(rng.choice(SPECIALS + list("ab019")) for _ in range(rng.randrange(6)))

    payload = {str(rng.randrange(1, 2000)): rng.choice([
        None, {text(): text() for _ in range(rng.randrange(4))}]) for _ in range(12)}
    payload.update({"999": {"k": "1"}, "1000": None})
    for obj in (payload, {text(): text() for _ in range(5)}, text(), None, {}):
        assert tshim.go_json_dumps(obj) == jshim.go_json_dumps(obj)
    assert list(json.loads(tshim.go_json_dumps(payload))) == sorted(payload)
    with pytest.raises(TypeError):
        tshim.go_json_dumps(3)
