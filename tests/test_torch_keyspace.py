"""The port's sharded keyspace (crdt_tpu_torch.keyspace, device="cpu")
against the JAX package's, zero tolerance: the same seeded inputs go
through both and the answers, exceptions and their fields, events,
counters, per-shard states and vvs must be equal.  Follows
tests/test_keyspace.py case by case.

The JAX package runs 8 virtual CPU devices under pytest, so its
``ShardedKeyspace`` with ``mesh="auto"`` and at least 2 shards folds
through its device-mesh plane.  The twins build the JAX side with
``mesh="off"`` (the port's only path: its mesh plane is ROADMAP Queue 1
item 6); one test holds JAX's ``"auto"`` (mesh) shard states and vvs
equal to the port's host path.
"""
from __future__ import annotations

import collections
import json
import pathlib
import subprocess
import sys
import threading
import urllib.error
import urllib.request

import pytest

from crdt_tpu import keyspace as jks
from crdt_tpu.api import net as jnet
from crdt_tpu.ingest import PageBuilder as JPageBuilder
from crdt_tpu.ingest import PageFormatError as JPageFormatError
from crdt_tpu.ingest import ShedError as JShedError
from crdt_tpu.ingest.shed import ShedPolicy as JShedPolicy
from crdt_tpu.keyspace import reshard as jreshard
from crdt_tpu.keyspace import routing as jrouting
from crdt_tpu.keyspace import shards as jshards
from crdt_tpu.obs.events import EventLog as JEventLog
from crdt_tpu.utils.clock import ManualClock as JClock
from crdt_tpu.utils.config import ClusterConfig as JConfig
from crdt_tpu_torch import keyspace as tks
from crdt_tpu_torch.api import net as tnet
from crdt_tpu_torch.ingest import PageBuilder as TPageBuilder
from crdt_tpu_torch.ingest import PageFormatError as TPageFormatError
from crdt_tpu_torch.ingest import ShedError as TShedError
from crdt_tpu_torch.ingest.shed import ShedPolicy as TShedPolicy
from crdt_tpu_torch.keyspace import reshard as treshard
from crdt_tpu_torch.keyspace import routing as trouting
from crdt_tpu_torch.keyspace import shards as tshards
from crdt_tpu_torch.obs.events import EventLog as TEventLog
from crdt_tpu_torch.utils.clock import ManualClock as TClock
from crdt_tpu_torch.utils.config import ClusterConfig as TConfig

ROUTING_PY = str(pathlib.Path(__file__).resolve().parent.parent
                 / "crdt_tpu_torch" / "keyspace" / "routing.py")
PKG = {
    "j": dict(ks=jks, routing=jrouting, shards=jshards, reshard=jreshard,
              PageBuilder=JPageBuilder, PageFormatError=JPageFormatError,
              ShedError=JShedError, ShedPolicy=JShedPolicy, EventLog=JEventLog,
              Config=JConfig, net=jnet),
    "t": dict(ks=tks, routing=trouting, shards=tshards, reshard=treshard,
              PageBuilder=TPageBuilder, PageFormatError=TPageFormatError,
              ShedError=TShedError, ShedPolicy=TShedPolicy, EventLog=TEventLog,
              Config=TConfig, net=tnet),
}


def _keys(n: int, prefix: str = "u") -> list:
    return [f"{prefix}{i:06d}" for i in range(n)]


def make_ks(pkg: str, rid: int, n_shards: int, mesh: str = "off", **kw):
    """A keyspace of either package on the host path (the port's on the
    CPU), its shards on one ManualClock (epoch 0), so wire timestamps are
    equal across the packages."""
    if pkg == "j":
        return jks.ShardedKeyspace(rid, n_shards, mesh=mesh, clock=JClock(), **kw)
    return tks.ShardedKeyspace(rid, n_shards, device="cpu", mesh=mesh, clock=TClock(), **kw)


def events(log, name=None) -> list:
    """An EventLog's records without the wall-clock and version fields."""
    return [{k: v for k, v in e.items() if k not in ("ts_ms", "v")}
            for e in log.find(event=name)]


def both(fn):
    """fn(pkg) for the JAX package and the port; the results must be equal."""
    out = {p: fn(p) for p in ("j", "t")}
    assert out["t"] == out["j"]
    return out["t"]


def raised(fn):
    """(exception type name, message) of fn(), or None."""
    try:
        fn()
    except Exception as e:  # noqa: BLE001 — the comparison is the point
        return type(e).__name__, str(e)
    return None


# ---- routing properties ----

def test_route_key_unambiguous_and_tenant_validation():
    for pkg in ("j", "t"):
        r = PKG[pkg]["routing"]
        assert r.route_key("ab", "c") != r.route_key("a", "bc")
        assert r.validate_tenant("t-acme") == "t-acme"
    for bad in (None, "", 7, "with:colon", "ctrl\x01char", "nl\nname"):
        errs = both(lambda p: raised(lambda: PKG[p]["routing"].validate_tenant(bad)))
        assert errs[0] == "ValueError"
    assert both(lambda p: PKG[p]["routing"].route_key("t", "k")) == "t\x00k"


def test_rendezvous_deterministic_across_processes():
    """The port's routing.py, loaded by path in a subprocess under two
    PYTHONHASHSEEDs, names the JAX package's owners."""
    members = [f"shard-{i}" for i in range(5)]
    keys = _keys(64)
    want = [jrouting.RendezvousRouter(members).owner_index(k) for k in keys]
    code = (
        "import importlib.util, json\n"
        f"spec = importlib.util.spec_from_file_location('r', {ROUTING_PY!r})\n"
        "mod = importlib.util.module_from_spec(spec)\n"
        "spec.loader.exec_module(mod)\n"
        f"r = mod.RendezvousRouter({members!r})\n"
        f"print(json.dumps([r.owner_index(k) for k in {keys!r}]))\n"
    )
    for seed in ("0", "4242"):
        out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                             env={"PYTHONHASHSEED": seed, "PATH": "/usr/bin:/bin"},
                             check=True)
        assert json.loads(out.stdout) == want, f"PYTHONHASHSEED={seed}"


@pytest.mark.parametrize("n", [1, 4, 64, 128])
def test_rendezvous_owners_equal_the_jax_package(n):
    """Owner, owner index (twice: the memo) and the ranking of 512 keys
    at 1, 4, 64 and 128 members, and the ±20% balance band at 4."""
    members = [f"shard-{i}" for i in range(n)]
    keys = [trouting.route_key(t, k) for t in ("t-acme", "t-bolt") for k in _keys(256)]
    owners = both(lambda p: [PKG[p]["routing"].RendezvousRouter(members).owner(k)
                             for k in keys])
    t = trouting.RendezvousRouter(members)
    assert [t.owner_index(k) for k in keys] == [t.owner_index(k) for k in keys] == \
        [members.index(o) for o in owners]
    if n == 4:
        counts = collections.Counter(owners)
        assert len(counts) == n and all(0.8 * 128 <= c <= 1.2 * 128 for c in counts.values())
    assert both(lambda p: [PKG[p]["routing"].RendezvousRouter(members).ranked(k, 3)
                           for k in keys[:32]])


def test_rendezvous_minimal_remap_on_join():
    keys = _keys(3000)

    def moved(p):
        before = PKG[p]["routing"].RendezvousRouter([f"shard-{i}" for i in range(5)])
        after = before.with_member("shard-5")
        return [(k, after.owner(k)) for k in keys if before.owner(k) != after.owner(k)]

    out = both(moved)
    assert all(o == "shard-5" for _, o in out)
    assert 0.7 * 500 <= len(out) <= 1.3 * 500


def test_rendezvous_minimal_remap_on_leave():
    keys = _keys(2000)

    def owners(p):
        before = PKG[p]["routing"].RendezvousRouter([f"shard-{i}" for i in range(5)])
        after = before.without_member("shard-2")
        return [(before.owner(k), after.owner(k), before.ranked(k)[1]) for k in keys]

    for old, new, second in both(owners):
        assert new == (second if old == "shard-2" else old)


def test_rendezvous_ranked_and_member_hygiene():
    def run(p):
        R = PKG[p]["routing"].RendezvousRouter
        router = R(["a", "b", "c"])
        ranked = [(router.ranked(k), router.ranked(k, 2), router.owner(k)) for k in _keys(32)]
        errs = [raised(lambda: R([])), raised(lambda: R(["a", "a"])),
                raised(lambda: router.without_member("nope"))]
        return ranked, errs

    ranked, errs = both(run)
    assert all(r[0][0] == r[2] and r[1] == r[0][:2] for r in ranked)
    assert [e[0] for e in errs] == ["ValueError"] * 3


def test_ranked_members_is_the_shared_rendezvous_seam():
    urls_a = [f"http://127.0.0.1:{7000 + i}" for i in range(4)]
    ident_a = {u: f"member-{i}" for i, u in enumerate(urls_a)}

    def run(p):
        r = PKG[p]["routing"]
        out = []
        for members in ([f"shard-{i}" for i in range(6)], urls_a):
            for k in _keys(48) + [f"lease-slot-{s}" for s in range(8)]:
                out.append(r.ranked_members(members, k))
                assert r.RendezvousRouter(members).ranked(k) == out[-1]
        for k in [f"lease-slot-{s}" for s in range(8)]:
            out.append(r.ranked_members(urls_a, k, ident=ident_a.get))
            out.append(r.ranked_members(urls_a, k, 1))
        return out

    both(run)


# ---- qualified keys & shard routing ----

def test_qualify_split_roundtrip_and_tenant_of_cmd():
    def run(p):
        s = PKG[p]["shards"]
        out = [s.split_qualified(s.qualify(t, k))
               for t, k in (("t", "k"), ("t-acme", "a:b:c"), ("x", ""))]
        out += [s.tenant_of_cmd(c) for c in ({"t-a:k": "1"}, {"bare": "1"}, {})]
        return out

    assert both(run)[:3] == [("t", "k"), ("t-acme", "a:b:c"), ("x", "")]


def test_shard_routing_agrees_across_instances_and_packages():
    def run(p):
        a = make_ks(p, 0, 8, capacity=64)
        b = make_ks(p, 3, 8, capacity=64)
        out = [a.shard_of(t, k) for t in ("t-acme", "t-bolt") for k in _keys(128)]
        assert out == [b.shard_of(t, k) for t in ("t-acme", "t-bolt") for k in _keys(128)]
        return out

    both(run)


def door_writes(p, n_shards=4, n=24, max_batch=8):
    ks = make_ks(p, 0, n_shards, capacity=64)
    door = PKG[p]["ks"].KeyspaceFrontDoor(ks, max_batch=max_batch)
    idents = [door.admit_kv("t-acme", f"k{i}", f"v{i}", timeout=5.0) for i in range(n)]
    return ks, door, idents


def test_shard_scoped_gossip_converges_and_is_idempotent():
    def run(p):
        ks, _, idents = door_writes(p)
        twin = make_ks(p, 1, 4, capacity=64)
        out = [idents]
        for i in range(4):
            payload = ks.gossip_payload(i, None)
            out.append((payload, twin.receive(i, payload), twin.receive(i, payload)))
            assert twin.shards[i].get_state() == ks.shards[i].get_state()
            assert twin.version_vector(i) == ks.version_vector(i)
            out.append((twin.version_vector(i), twin.vv_snapshot(i)))
        out.append((twin.tenant_state("t-acme"), twin.state(), twin.shard_stats(),
                    ks.shard_stats(), twin.tenants(), ks.get("t-acme", "k3")))
        return out

    out = both(run)
    assert out[-1][0] == {f"k{i}": f"v{i}" for i in range(24)}


def test_receive_all_folds_and_quarantines_per_shard():
    def run(p):
        ks, _, _ = door_writes(p)
        twin = make_ks(p, 1, 4, capacity=64)
        payloads = [ks.gossip_payload(i, None) for i in range(4)]
        payloads[1] = None
        payloads[2] = {"1:0:0": "not a command"}
        out = [twin.receive_all(payloads, quarantine=True)]
        out.append([twin.shards[i].get_state() for i in range(4)])
        out.append(raised(lambda: twin.receive_all(payloads[:2])))
        return out

    out = both(run)
    assert isinstance(out[0][2], str) and out[0][1] == 0


def test_mesh_auto_states_equal_the_port_host_path():
    """JAX's mesh="auto" keyspace (8 virtual CPU devices: its device-mesh
    fold) and the port's host path hold the same shard states and vvs
    after the same door writes and a shard-scoped fold both ways."""
    ks_j = make_ks("j", 0, 4, mesh="auto", capacity=64)
    ks_t = make_ks("t", 0, 4, capacity=64)
    for ks, p in ((ks_j, "j"), (ks_t, "t")):
        door = PKG[p]["ks"].KeyspaceFrontDoor(ks, max_batch=8)
        for i in range(40):
            door.admit_cmd(("t-acme", "t-bolt")[i % 2], {f"k{i % 13}": f"v{i}"}, timeout=5.0)
        door.flush_all()
    assert ks_j.mesh_active and not ks_t.mesh_active
    src = make_ks("t", 5, 4, capacity=64)
    door = tks.KeyspaceFrontDoor(src, max_batch=8)
    door.admit_cmd("t-crab", {"x": "1", "y": "2", "z": "3"}, timeout=5.0)
    payloads = [src.gossip_payload(i, None) or None for i in range(4)]
    assert ks_j.receive_all(payloads) == ks_t.receive_all(payloads)
    for i in range(4):
        assert ks_j.shards[i].get_state() == ks_t.shards[i].get_state()
        assert ks_j.version_vector(i) == ks_t.version_vector(i)
        assert ks_j.gossip_payload(i, None) == ks_t.gossip_payload(i, None)
    assert ks_j.state() == ks_t.state()


def test_mesh_on_and_no_card_refuse():
    with pytest.raises(NotImplementedError, match="Queue 1 item 6"):
        tks.ShardedKeyspace(0, 2, device="cpu", mesh="on")
    with pytest.raises(ValueError, match="auto"):
        tks.ShardedKeyspace(0, 2, device="cpu", mesh="sometimes")
    assert both(lambda p: raised(lambda: make_ks(p, 0, 0)))[0] == "ValueError"
    assert tks.keyspace_from_config(0, TConfig()) is None
    ks = tks.keyspace_from_config(0, TConfig(keyspace_shards=3, keyspace_capacity=32,
                                             keyspace_mesh="off"), device="cpu")
    assert (ks.n_shards, ks.capacity, ks.mesh_engine) == (3, 32, None)


# ---- tenant door: isolation, quota slices, labeled provenance ----

def test_door_tenant_views_are_disjoint():
    def run(p):
        ks = make_ks(p, 0, 4, capacity=64)
        door = PKG[p]["ks"].KeyspaceFrontDoor(ks, max_batch=4)
        out = [door.admit_cmd("t-acme", {"shared-key": "acme", "a1": "1"}, timeout=5.0),
               door.admit_cmd("t-bolt", {"shared-key": "bolt", "b1": "2"}, timeout=5.0),
               door.admit_cmd("t-bolt", {}, timeout=5.0)]
        return out + [ks.tenant_state("t-acme"), ks.tenant_state("t-bolt"),
                      ks.get("t-acme", "shared-key"), ks.get("t-bolt", "shared-key"),
                      door.tenant_depths()]

    out = both(run)
    assert out[3:7] == [{"shared-key": "acme", "a1": "1"}, {"shared-key": "bolt", "b1": "2"},
                        "acme", "bolt"]


def test_tenant_quota_shed_is_labeled_and_isolated():
    def run(p):
        P = PKG[p]
        ks = make_ks(p, 0, 2, capacity=64)
        policy = P["ShedPolicy"](high_water=1024, tenant_high_water={"t-noisy": 2})
        ev = P["EventLog"](node="0")
        door = P["ks"].KeyspaceFrontDoor(ks, max_batch=4, policy=policy, node="0", events=ev)
        with pytest.raises(P["ShedError"]) as ei:
            door.admit_cmd("t-noisy", {f"k{i}": "v" for i in range(3)}, timeout=5.0)
        e = ei.value
        out = [(e.tenant, e.lane, e.n_ops, e.depth, e.high_water, e.retry_after_s, str(e))]
        out.append(door.admit_kv("t-acme", "k", "v", timeout=5.0))
        out.append(door.admit_cmd("t-noisy", {"k0": "v"}, timeout=5.0))
        with pytest.raises(P["ShedError"]) as ei:
            door.admit_cmd("t-noisy", {"a": "1", "b": "2", "c": "3"}, timeout=5.0)
        reg = door.metrics.registry
        out.append([reg.counter_value("ingest_shed", lane=P["ks"].TENANT_LANE, node="0",
                                      tenant="t-noisy"),
                    reg.counter_value("ingest_shed_ops", lane=P["ks"].TENANT_LANE, node="0",
                                      tenant="t-noisy"),
                    reg.counter_value("keyspace_tenant_ops", tenant="t-acme", node="0")])
        out.append(events(ev, "ingest_shed") + events(ev, "ks_births"))
        return out

    out = both(run)
    assert out[0][:2] == ("t-noisy", "tenant") and out[0][4] == 2
    assert out[3][:2] == [2, 6]


def test_page_quarantine_is_tenant_labeled_and_whole():
    def run(p):
        P = PKG[p]
        ks = make_ks(p, 0, 2, capacity=64)
        ev = P["EventLog"](node="0")
        door = P["ks"].KeyspaceFrontDoor(ks, max_batch=8, node="0", events=ev)
        pager = P["PageBuilder"](origin=7, page_size=1 << 16)
        for i in range(4):
            pager.add(f"k{i}", "v")
        raw = bytearray(pager.flush())
        raw[len(raw) // 2] ^= 0xFF
        with pytest.raises(P["PageFormatError"]) as ei:
            door.admit_page(bytes(raw), "t-acme", timeout=5.0)
        bad = raised(lambda: door.admit_page(b"x", "bad:tenant"))
        reg = door.metrics.registry
        return [str(ei.value), bad,
                reg.counter_value("ingest_pages_quarantined", node="0", tenant="t-acme"),
                events(ev, "ingest_page_quarantine"), ks.state()]

    out = both(run)
    assert out[2] == 1 and out[4] == {}


def test_page_admission_fans_out_and_dedups():
    def run(p):
        P = PKG[p]
        ks = make_ks(p, 0, 4, capacity=64)
        door = P["ks"].KeyspaceFrontDoor(ks, max_batch=64, node="0")
        pager = P["PageBuilder"](origin=7, page_size=1 << 16)
        for i in range(16):
            pager.add(f"k{i}", f"v{i}")
        raw = pager.flush()
        out = [door.admit_page(raw, "t-acme", timeout=5.0),
               door.admit_page(raw, "t-acme", timeout=5.0)]
        return out + [ks.tenant_state("t-acme"),
                      [ks.gossip_payload(i, None) for i in range(4)],
                      door.metrics.registry.counter_value("ingest_pages_duplicate", node="0")]

    out = both(run)
    assert out[0]["admitted"] == 16 and out[0]["shards"] > 1 and out[1]["dup"]


def test_door_from_config_flush_and_map_lane():
    """keyspace_front_door_from_config's knobs; flush_all and
    flush_expired on the host path; the tenant map write without an inner
    map lane raises, with one it lands qualified."""
    def run(p):
        P = PKG[p]
        cfg = P["Config"](keyspace_shards=2, ingest_flush_ops=1000, ingest_flush_ms=1e6,
                          ingest_high_water=99, keyspace_tenant_quota={"t-q": 5})
        ks = make_ks(p, 0, 2, capacity=64)
        door = P["ks"].keyspace_front_door_from_config(ks, config=cfg, node="9")
        out = [(door.policy.high_water, dict(door.policy.tenant_high_water),
                door._max_batch, door._flush_deadline_s, [q.name for q in door.lanes])]
        tickets = door._submit_groups({0: [(None, {"t-a:x": "1"}, "t-a")],
                                       1: [(None, {"t-a:y": "2"}, "t-a")]}, "t-a")
        out.append(door.tenant_depths())
        out.append(door.flush_all())
        out.append([t.wait(5.0) for _, t in tickets])
        out.append((door.flush_expired(), door.tenant_depths(), ks.tenant_state("t-a")))
        out.append(raised(lambda: door.admit_map_upd("t-a", "m", 1)))
        return out

    out = both(run)
    assert out[2] == 2 and out[4][2] == {"x": "1", "y": "2"}


# ---- end-to-end: HTTP tenant routing + shard-scoped anti-entropy ----

def test_http_tenant_routing_and_ks_pull():
    """X-CRDT-Tenant writes, tenant reads, a quota shed's labeled 429,
    /ks/data, a bad tenant's 400 and agent.ks_pull over real sockets: the
    same statuses, headers and bodies from a JAX pair and a port pair."""
    def run(p):
        P = PKG[p]
        cfg = dict(keyspace_shards=2, keyspace_capacity=64, keyspace_mesh="off",
                   keyspace_tenant_quota={"t-noisy": 2})
        kw = {} if p == "j" else {"device": "cpu"}
        a = P["net"].NodeHost(rid=0, peers=[], config=P["Config"](**cfg), **kw)
        b = P["net"].NodeHost(rid=1, peers=[], config=P["Config"](**cfg), **kw)
        for h in (a, b):
            threading.Thread(target=h._server.serve_forever, daemon=True).start()
        out = []

        def call(url, body=None, tenant=None):
            req = urllib.request.Request(url, data=None if body is None else
                                         json.dumps(body).encode(),
                                         method="GET" if body is None else "POST")
            if tenant is not None:
                req.add_header(P["ks"].TENANT_HEADER, tenant)
            try:
                with urllib.request.urlopen(req, timeout=5) as r:
                    return r.status, r.headers.get("Retry-After"), r.read()
            except urllib.error.HTTPError as e:
                return e.code, e.headers.get("Retry-After"), e.read()

        try:
            out.append(call(a.url + "/data", {"k1": "v1", "k2": "v2"}, tenant="t-acme")[::2])
            out.append(call(a.url + "/data", tenant="t-acme"))
            out.append(a.node.get_state())
            out.append(call(a.url + "/data", {f"k{i}": "v" for i in range(3)},
                            tenant="t-noisy"))
            out.append(call(a.url + "/data", {"k": "v"}, tenant="bad:tenant"))
            out.append(call(a.url + "/ks/data"))
            out.append(call(a.url + "/ks/data?tenant=t-acme"))
            out.append(b.agent.ks_pull(P["net"].RemotePeer(a.url)))
            out.append(b.keyspace.tenant_state("t-acme"))
            out.append([b.keyspace.version_vector(i) == a.keyspace.version_vector(i)
                        for i in range(2)])
        finally:
            for h in (a, b):
                h._server.shutdown()
                h._server.server_close()
        return out

    out = both(run)
    assert out[3][0] == 429 and float(out[3][1]) > 0 and out[7] == 2 and all(out[9])


def test_config_keyspace_knobs_validated():
    for kw in (dict(keyspace_shards=-1), dict(keyspace_shards=2, keyspace_capacity=0),
               dict(keyspace_shards=2, keyspace_tenant_quota={"bad:name": 8}),
               dict(keyspace_shards=2, keyspace_tenant_quota={"t-acme": 0}),
               dict(keyspace_shards=2, keyspace_tenant_quota=[("t", 1)]),
               dict(keyspace_mesh="sometimes")):
        err = both(lambda p: raised(lambda: PKG[p]["Config"](**kw)))
        assert err[0] == "ValueError", kw
    assert both(lambda p: raised(lambda: PKG[p]["Config"](
        keyspace_shards=2, keyspace_capacity=64, keyspace_tenant_quota={"t-acme": 8},
        keyspace_mesh="on"))) is None


# ---- online resharding: migration-plan properties ----

def test_reshard_migration_plan_properties():
    """Random S -> S' (grow and shrink): the same plans as the JAX
    package, each moving exactly the owner-changed keys once, to new
    shards on a grow and from departing ones on a shrink."""
    import random

    rng = random.Random("reshard-plan-properties")
    tenants = ("t-acme", "t-bolt", "t-crab")
    qkeys = [tshards.qualify(tenants[i % 3], f"k{i:05d}") for i in range(400)]
    for _ in range(12):
        s = rng.randint(1, 9)
        sp = rng.choice([n for n in range(1, 10) if n != s])

        def run(p):
            R, rs = PKG[p]["routing"], PKG[p]["reshard"]
            old = R.RendezvousRouter(rs.shard_members(s))
            new = rs.next_router(old, sp)
            assert list(new.members) == rs.shard_members(sp)
            return rs.migration_plan(old, new, qkeys)

        plan = both(run)
        listed = [k for group in plan.values() for k in group]
        assert len(listed) == len(set(listed))
        if sp > s:
            assert all(dst >= s for (_, dst) in plan)
        else:
            assert all(src >= sp for (src, _) in plan)
    assert both(lambda p: raised(lambda: PKG[p]["reshard"].next_router(
        PKG[p]["routing"].RendezvousRouter(["shard-0"]), 0)))[0] == "ValueError"
