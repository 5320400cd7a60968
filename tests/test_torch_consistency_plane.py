"""The port's consistency plane (crdt_tpu_torch.consistency.plane) against
the JAX package's, zero tolerance, following the plane's cases of
tests/test_consistency.py: eventual, session, bounded and linearizable
reads, CAS and multi-key CAS, and with coordinator leases the forwarding
to a slot's coordinator and the fenced synchronous pushes.

Every wait loop takes an injectable clock and sleep (FakeTime: time moves
only when the code sleeps), the peers are in-process stand-ins over real
nodes, and each node runs on a ManualClock, so a scenario is exactly
repeatable.  Each runs once over JAX nodes and planes and once over the
port's; answers, exceptions with every field, events, counters, states
and vvs must be equal."""
from __future__ import annotations

import re

import pytest

from crdt_tpu.api.node import ReplicaNode as JNode
from crdt_tpu.consistency import leases as jleases
from crdt_tpu.consistency import plane as jplane
from crdt_tpu.consistency import session as jsession
from crdt_tpu.ingest.admission import IngestFrontDoor as JDoor
from crdt_tpu.utils.clock import ManualClock as JClock
from crdt_tpu_torch import consistency as tconsistency
from crdt_tpu_torch.api.node import ReplicaNode as TNode
from crdt_tpu_torch.consistency import leases as tleases
from crdt_tpu_torch.consistency import plane as tplane
from crdt_tpu_torch.consistency import session as tsession
from crdt_tpu_torch.ingest.admission import IngestFrontDoor as TDoor
from crdt_tpu_torch.utils.clock import ManualClock as TClock

PKG = {"j": dict(plane=jplane, session=jsession, leases=jleases, Door=JDoor),
       "t": dict(plane=tplane, session=tsession, leases=tleases, Door=TDoor)}
MINTED = re.compile(r"^-?\d+-[0-9a-f]+-[0-9a-f]+$")
COUNTERS = ("reads_eventual", "reads_session", "reads_bounded", "reads_linearizable",
            "consistency_unavailable", "consistency_proxy_quarantine", "cas_applied",
            "cas_conflicts", "cas_forwarded", "lease_grants", "cas_fenced_rejects")


class FakeTime:
    """Manual clock + sleep: time advances only when the code sleeps."""

    def __init__(self):
        self.t = 0.0
        self.sleeps = 0

    def now(self) -> float:
        return self.t

    def sleep(self, dt: float) -> None:
        self.sleeps += 1
        self.t += max(dt, 1e-6)


class FakePeer:
    """RemotePeer stand-in over a backing node: an OPEN breaker
    (``backed``), a dead transport (``down``), a peer that acks vv probes
    but serves no delta, one that drops pushes; with ``plane`` /
    ``leases`` it also takes CAS forwards, lease votes and fenced
    pushes the way a daemon's routes do."""

    def __init__(self, node, url: str):
        self.node, self.url = node, url
        self.backed = self.down = False
        self.serve_deltas = self.accept_push = True
        self.vv_calls = 0
        self.plane = self.leases = None

    def backed_off(self) -> bool:
        return self.backed

    def backoff_peek(self) -> bool:
        return self.backed

    def version_vector(self):
        self.vv_calls += 1
        return None if self.down else self.node.vv_snapshot()

    def gossip_payload(self, since=None):
        if self.down or not self.serve_deltas:
            return None
        return self.node.gossip_payload(since=since)

    def push_payload(self, payload) -> bool:
        if self.down or not self.accept_push:
            return False
        self.node.receive(payload)
        return True

    def lease_grant(self, *, slot, holder, fence, ttl):
        return None if self.down else self.leases.grant(slot, holder, fence, ttl)

    def push_fenced(self, payload, fences, trace=None):
        if self.down or not self.accept_push:
            return {"ok": False}
        stale = self.leases.check_push_fences(fences, trace=trace)
        if stale is not None:
            return {"ok": False, "fenced": True, **stale}
        self.node.receive(payload)
        return {"ok": True}

    def cas_forward(self, body):
        """The daemon's POST /cas over this peer's plane: status and body."""
        if self.down:
            return None
        ops = {k: (v["expect"], v["update"]) for k, v in body["ops"].items()}
        mod = self.plane.__class__.__module__
        pkg = tplane if mod.startswith("crdt_tpu_torch") else jplane
        try:
            token = self.plane.cas_multi(ops, timeout=body.get("timeout"),
                                         hops=body["hops"], trace=body.get("trace"))
        except pkg.CasConflict as e:
            return {"status": 409, "body": {"conflict": True, "key": e.key, "expect": e.expect,
                                            "actual": e.actual, "coordinator": e.coordinator,
                                            "fence": e.fence}}
        except pkg.ConsistencyUnavailable as e:
            b = {"reason": e.reason, "level": e.level, "op": e.op, "acks": e.acks,
                 "quorum": e.quorum, "indeterminate": e.indeterminate,
                 "retry_after_s": e.retry_after_s}
            if e.token:
                b["token"] = {str(r): s for r, s in e.token.items()}
            return {"status": 503, "body": b}
        return {"status": 200, "body": {"token": {str(r): s for r, s in token.items()}}}


def mk_node(pkg, rid: int):
    if pkg == "j":
        return JNode(rid=rid, capacity=64, clock=JClock())
    return TNode(rid=rid, capacity=64, clock=TClock(), device="cpu")


def mk_plane(pkg, node, peers, ft, **kw):
    kw.setdefault("strong_timeout", 0.2)
    kw.setdefault("session_timeout", 0.2)
    kw.setdefault("poll", 0.02)
    return PKG[pkg]["plane"].ConsistencyPlane(node, peers=lambda: peers, clock=ft.now,
                                              sleep=ft.sleep, **kw)


def exc(fn):
    """The call's value, or its exception with every field the HTTP routes
    serve."""
    try:
        return ("ok", fn())
    except Exception as e:  # noqa: BLE001 — the comparison is the point
        fields = {k: getattr(e, k) for k in ("reason", "level", "op", "acks", "quorum",
                                             "indeterminate", "retry_after_s", "token", "key",
                                             "expect", "actual", "coordinator", "fence")
                  if hasattr(e, k)}
        return type(e).__name__, str(e), fields


def _event(e) -> dict:
    """An event without its wall clock; a minted trace id (``rid-<process
    nonce>-<count>``) as its rid alone."""
    out = {k: v for k, v in e.items() if k not in ("ts_ms", "v")}
    if MINTED.match(str(out.get("trace"))):
        out["trace"] = "minted-" + out["trace"].split("-")[0]
    return out


def record(*nodes):
    """Each node's events (no wall clock), counters, state and vv."""
    out = []
    for n in nodes:
        reg = n.metrics.registry
        out.append(([_event(e) for e in n.events.find()],
                    {c: reg.counter_value(c) for c in COUNTERS},
                    n.get_state(), n.vv_snapshot()))
    return out


def both(fn):
    out = {p: fn(p) for p in ("j", "t")}
    assert out["t"] == out["j"]
    return out["t"]


def test_exports_equal_the_jax_package():
    import crdt_tpu.consistency as jconsistency

    assert sorted(tconsistency.__all__) == sorted(jconsistency.__all__)
    assert tplane.LEVELS == jplane.LEVELS
    assert tconsistency.LEASE_STATE == jconsistency.LEASE_STATE


def test_wait_for_dominance_on_fake_clock():
    class StubNode:
        def __init__(self, vv):
            self.vv = dict(vv)

        def vv_snapshot(self):
            return dict(self.vv), {}

    def run(p):
        s = PKG[p]["session"]
        ft, node = FakeTime(), StubNode({0: 2})
        out = [s.wait_for_dominance(node, {0: 5}, timeout=0.5, poll=0.1, clock=ft.now,
                                    sleep=ft.sleep), ft.t, ft.sleeps]
        ft2, node2 = FakeTime(), StubNode({0: 2})
        out += [s.wait_for_dominance(node2, {0: 5}, timeout=0.5, poll=0.1, clock=ft2.now,
                                     sleep=ft2.sleep, proxy=lambda: node2.vv.update({0: 9})),
                ft2.sleeps]
        return out

    out = both(run)
    assert out[0] is False and out[2] == 5 and out[3] is True and out[4] == 0


def test_session_reads_proxy_time_out_and_refuse():
    def run(p):
        a, b = mk_node(p, 0), mk_node(p, 1)
        token = PKG[p]["session"].mint_token(a.add_commands([{"k": "v1"}]))
        ft = FakeTime()
        out = [exc(lambda: mk_plane(p, b, [FakePeer(a, "a")], ft).read(
            "k", level="session", token=token))]
        c = mk_node(p, 2)
        lonely = mk_plane(p, c, [], ft)
        out += [exc(lambda: lonely.read("k", level="session", token=token)),
                exc(lambda: lonely.read("k", level="session")),
                exc(lambda: lonely.read("k", level="strong")), ft.t, ft.sleeps]
        return out + record(b, c)

    out = both(run)
    assert out[0] == ("ok", "v1") and out[1][2]["reason"] == "token_timeout"
    assert out[2][0] == out[3][0] == "ValueError"


def test_read_your_writes_through_ingest_lane():
    def run(p):
        a, b = mk_node(p, 0), mk_node(p, 1)
        door = PKG[p]["Door"](a, max_batch=4, flush_deadline_s=0.001)
        ident = door.admit_kv({"k": "from-lane"}, timeout=5.0)
        token = PKG[p]["session"].mint_token([ident])
        ft = FakeTime()
        return [ident, exc(lambda: mk_plane(p, b, [FakePeer(a, "a")], ft).read(
            "k", level="session", token=token))] + record(b)

    assert both(run)[1] == ("ok", "from-lane")


def test_eventual_reads_local_and_dead():
    def run(p):
        n = mk_node(p, 0)
        n.add_commands([{"k": "v"}])
        ft = FakeTime()
        peer = FakePeer(mk_node(p, 1), "p")
        plane = mk_plane(p, n, [peer], ft)
        out = [exc(lambda: plane.read("k")), exc(lambda: plane.read("missing")), peer.vv_calls]
        n.set_alive(False)
        out.append(exc(lambda: plane.read("k")))
        return out + record(n)

    out = both(run)
    assert out[:3] == [("ok", "v"), ("ok", None), 0] and out[3][2]["reason"] == "node_down"


def test_linearizable_reads():
    """Catch-up to the quorum, quorum loss (never stale), open breakers
    as missing acks, the catch-up timeout, a quorum of one, and a
    corrupt proxied payload quarantined like the pull loop's."""
    def run(p):
        out = []
        a, b, c = mk_node(p, 0), mk_node(p, 1), mk_node(p, 2)
        a.add_commands([{"k": "newest"}])
        ft = FakeTime()
        out.append(exc(lambda: mk_plane(p, b, [FakePeer(a, "a"), FakePeer(c, "c")], ft).read(
            "k", level="linearizable")))
        h = b.metrics.registry.histogram("strong_read_quorum_seconds")
        out.append(h.count)
        d, e = mk_node(p, 3), mk_node(p, 4)
        pa, pc = FakePeer(a, "a"), FakePeer(c, "c")
        pa.down = pc.down = True
        out.append(exc(lambda: mk_plane(p, d, [pa, pc], ft).read("k", level="linearizable")))
        pa.down = pc.down = False
        pa.backed = pc.backed = True
        calls = (pa.vv_calls, pc.vv_calls)
        out.append(exc(lambda: mk_plane(p, e, [pa, pc], ft).read("k", level="linearizable")))
        out.append((pa.vv_calls - calls[0], pc.vv_calls - calls[1]))
        f = mk_node(p, 5)
        slow = FakePeer(a, "a")
        slow.serve_deltas = False
        ft2 = FakeTime()
        out.append(exc(lambda: mk_plane(p, f, [slow], ft2, strong_timeout=0.1).read(
            "k", level="linearizable")))
        out.append((ft2.t, ft2.sleeps))
        out.append(exc(lambda: mk_plane(p, a, [], ft, quorum=1).read("k", level="linearizable")))

        class CorruptPeer(FakePeer):
            def gossip_payload(self, since=None):
                q = dict(super().gossip_payload(since=since) or {})
                q["nemesis:corrupt:key"] = {"Key": "x", "Value": "y"}
                return q

        g = mk_node(p, 6)
        out.append(exc(lambda: mk_plane(p, g, [CorruptPeer(a, "a")], FakeTime(),
                                        strong_timeout=0.1).read("k", level="linearizable")))
        return out + record(b, d, e, f, g)

    out = both(run)
    assert out[0] == ("ok", "newest") and out[1] == 1
    assert out[2][2]["reason"] == out[3][2]["reason"] == "quorum_lost"
    assert out[4] == (0, 0) and out[5][2]["reason"] == "catchup_timeout"
    assert out[7] == ("ok", "newest")


def test_bounded_reads():
    """level="bounded": served within the Δ op lag of the quorum max, else
    proxied down to it, else 503 at the deadline; a negative Δ refused."""
    def run(p):
        a, b = mk_node(p, 0), mk_node(p, 1)
        for i in range(6):
            a.add_commands([{f"k{i}": str(i)}])
        ft = FakeTime()
        pa = FakePeer(a, "a")
        plane = mk_plane(p, b, [pa], ft, bounded_staleness=3)
        out = [exc(lambda: plane.read("k5", level="bounded", staleness=10)),
               b.version_vector(),
               exc(lambda: plane.read("k5", level="bounded")), b.version_vector(),
               exc(lambda: plane.read("k0", level="bounded", staleness=-1))]
        c = mk_node(p, 2)
        pa.serve_deltas = False
        out.append(exc(lambda: mk_plane(p, c, [pa], ft).read("k0", level="bounded",
                                                             staleness=0)))
        return out + record(b, c)

    out = both(run)
    assert out[0] == ("ok", None) and out[2] == ("ok", "5")
    assert out[4][0] == "ValueError" and out[5][2]["reason"] == "catchup_timeout"


def test_cas_without_leases():
    """The lease-less plane: the CAS matrix, a remote write seen before
    deciding, quorum lost before the mint (clean) and the write quorum
    lost after it (indeterminate, with the minted op's token)."""
    def run(p):
        a, b = mk_node(p, 0), mk_node(p, 1)
        ft = FakeTime()
        pb = FakePeer(b, "b")
        plane = mk_plane(p, a, [pb], ft)
        out = [exc(lambda: plane.cas("k", None, "v1")),
               exc(lambda: plane.cas("k", None, "v2")),
               exc(lambda: plane.cas("k", "nope", "v2")),
               exc(lambda: plane.cas("k", "v1", "v2")),
               exc(lambda: plane.cas_multi({"x": (None, "1"), "y": (None, "2")})),
               exc(lambda: plane.cas_multi({"x": ("1", "3"), "y": ("bad", "4")})),
               exc(lambda: plane.cas_multi({}))]
        b.add_commands([{"r": "remote"}])
        out.append(exc(lambda: plane.cas("r", None, "v")))
        pb.down = True
        out.append(exc(lambda: plane.cas("z", None, "v1")))
        pb.down, pb.accept_push = False, False
        out.append(exc(lambda: plane.cas("z", None, "v1")))
        return out + record(a, b)

    out = both(run)
    assert out[0][0] == "ok" and out[1][2]["actual"] == "v1" and out[3][0] == "ok"
    assert out[5][2]["key"] == "y" and out[6][0] == "ValueError"
    assert out[7][2]["actual"] == "remote" and out[8][2]["reason"] == "quorum_lost"
    assert out[9][2]["indeterminate"] is True and out[9][2]["token"]


def lease_fleet(p, n=3, duration=10.0):
    """n nodes, each with a LeaseManager and a plane on one fake time,
    meshed over FakePeers that serve CAS forwards, votes and fenced
    pushes."""
    ft = FakeTime()
    nodes = [mk_node(p, i) for i in range(n)]
    mgrs = [PKG[p]["leases"].LeaseManager(nodes[i], n_slots=4, duration=duration,
                                          clock=ft.now) for i in range(n)]
    peers = {i: [FakePeer(nodes[j], f"http://n{j}") for j in range(n) if j != i]
             for i in range(n)}
    planes = [mk_plane(p, nodes[i], peers[i], ft, leases=mgrs[i], forward_hops=2)
              for i in range(n)]
    for i in range(n):
        mgrs[i].attach(f"http://n{i}", (lambda i=i: peers[i]))
        for peer in peers[i]:
            j = int(peer.url[-1])
            peer.plane, peer.leases = planes[j], mgrs[j]
    return ft, nodes, mgrs, peers, planes


def test_cas_routes_to_the_slot_coordinator_under_a_fenced_lease():
    """With leases every CAS routes to its slot's coordinator (forwarded
    from the others), decides under a quorum lease and stamps its fence on
    the synchronous pushes; a zombie's stale stamp is refused; the hop
    budget and an unreachable coordinator refuse loudly."""
    def run(p):
        ft, nodes, mgrs, peers, planes = lease_fleet(p)
        out = []
        for k in range(8):
            key = f"c{k % 3}"
            i = k % 3
            cur = nodes[0].get_state().get(key)
            out.append(exc(lambda: planes[i].cas(key, cur, f"n{k}", trace=f"tr-{k}")))
        out.append(exc(lambda: planes[1].cas("c0", "stale", "x")))
        out.append(exc(lambda: planes[2].cas_multi({"m1": (None, "a"), "m2": (None, "b")})))
        out.append([m.fences_snapshot() for m in mgrs])
        slot = mgrs[0].slot_of("c0")
        coord = int(mgrs[0].coordinator_of(slot)[-1])
        other = (coord + 1) % 3
        out.append(mgrs[other].check_push_fences({slot: 0}))
        out.append(exc(lambda: planes[other].cas("c0", None, "x", hops=2)))
        for peer in peers[other]:
            if peer.url.endswith(str(coord)):
                peer.down = True
        out.append(exc(lambda: planes[other].cas("c0", None, "x")))
        return out + record(*nodes)

    out = both(run)
    assert sum(1 for o in out[:8] if o[0] == "ok") >= 3
    assert out[8][2]["coordinator"] and out[8][2]["fence"] >= 1
    assert out[12][2]["reason"] == "forward_hops_exhausted"
    assert out[13][2]["reason"] == "forward_unreachable"


def test_lease_unavailable_and_zombie_fence():
    """A coordinator that cannot reach a quorum of voters refuses with
    lease_unavailable; a successor after expiry opens fence 2, and the
    old holder's push stamped 1 is refused by the replicas."""
    def run(p):
        ft, nodes, mgrs, peers, planes = lease_fleet(p, duration=1.0)
        slot = mgrs[0].slot_of("z")
        coord = int(mgrs[0].coordinator_of(slot)[-1])
        out = [exc(lambda: planes[coord].cas("z", None, "1"))]
        for peer in peers[coord]:
            peer.down = True
        ft.t += 5.0
        out.append(exc(lambda: planes[coord].cas("z", "1", "2")))
        for peer in peers[coord]:
            peer.down = False
        out.append([m.ensure(slot) for m in mgrs])
        out.append([m.check_push_fences({slot: 1}) for m in mgrs])
        return out + record(*nodes)

    out = both(run)
    assert out[0][0] == "ok" and out[1][2]["reason"] == "lease_unavailable"


@pytest.mark.parametrize("seed", range(3))
def test_random_strong_schedules_equal_the_jax_package(seed):
    """Seeded mixes of writes, reads at every level, CAS and multi-key
    CAS, transport and breaker faults, clock moves and pushes over a
    3-node lease fleet."""
    import random

    def run(p):
        rng = random.Random(seed)
        ft, nodes, mgrs, peers, planes = lease_fleet(p, duration=2.0)
        out = []
        for step in range(40):
            i = rng.randrange(3)
            op = rng.randrange(7)
            key = f"k{rng.randrange(4)}"
            if op == 0:
                out.append(nodes[i].add_commands([{key: f"w{step}"}]))
            elif op == 1:
                level = rng.choice(("eventual", "bounded", "linearizable"))
                out.append(exc(lambda: planes[i].read(key, level=level)))
            elif op == 2:
                cur = nodes[i].get_state().get(key)
                out.append(exc(lambda: planes[i].cas(key, cur, f"c{step}")))
            elif op == 3:
                out.append(exc(lambda: planes[i].cas_multi(
                    {key: (None, f"m{step}"), f"k{rng.randrange(4)}x": (None, "y")})))
            elif op == 4:
                peer = rng.choice(peers[i])
                peer.down = not peer.down
            elif op == 5:
                peer = rng.choice(peers[i])
                peer.backed = not peer.backed
            else:
                ft.t += rng.choice((0.1, 1.5, 3.0))
                j = rng.randrange(3)
                nodes[j].receive(nodes[i].gossip_payload(since=nodes[j].version_vector()))
        return out + [m.fences_snapshot() for m in mgrs] + record(*nodes)

    both(run)


def test_stability_cases_of_the_consistency_tests():
    """tests/test_consistency.py's stability cases on both packages: a
    frontier stalls without summaries and on a stale one, is the
    pointwise min over the fleet, drops writers a member never saw, merges
    late summaries monotonically, mints a ledger row, counts the lag above
    it; the chain rule stalls an incomparable fold."""
    from crdt_tpu.api.node import stable_frontier_host as jfrontier
    from crdt_tpu.consistency.stability import StabilityTracker as JTracker
    from crdt_tpu.obs.events import EventLog as JEvents
    from crdt_tpu_torch.api.node import stable_frontier_host as tfrontier
    from crdt_tpu_torch.consistency.stability import StabilityTracker as TTracker
    from crdt_tpu_torch.obs.events import EventLog as TEvents

    class StubNode:
        def __init__(self, vv):
            self.vv = dict(vv)

        def vv_snapshot(self):
            return dict(self.vv), {}

    def run(p):
        Tracker, Events, frontier = (JTracker, JEvents, jfrontier) if p == "j" else \
            (TTracker, TEvents, tfrontier)
        ft, ev = FakeTime(), Events(node="t")
        out = []
        tr = Tracker(StubNode({0: 5}), ["a", "b"], clock=ft.now, events=ev)
        out += [tr.frontier(), tr.stale_members()]
        tr = Tracker(StubNode({0: 5, 1: 9}), ["a", "b"], clock=ft.now)
        tr.note("a", {0: 3, 1: 9}, {})
        tr.note("b", {0: 5, 1: 7}, {})
        out.append(tr.frontier())
        tr = Tracker(StubNode({0: 5, 2: 4}), ["a"], clock=ft.now)
        tr.note("a", {0: 2}, {})
        out.append(tr.frontier())
        tr = Tracker(StubNode({0: 5}), ["a"], max_staleness=10.0, clock=ft.now, events=ev)
        tr.note("a", {0: 5}, {})
        out.append(tr.frontier())
        ft.t += 11.0
        out += [tr.stale_members(), tr.frontier()]
        tr = Tracker(StubNode({0: 9, 1: 9}), ["a"], clock=ft.now)
        tr.note("a", {0: 7, 1: 2}, {})
        tr.note("a", {0: 3, 1: 5}, {})
        out += [tr.observed()["a"]["vv"], tr.frontier()]
        tr = Tracker(StubNode({0: 9, 1: 4}), ["a"], clock=ft.now)
        out.append(tr.mint(step=1))
        tr.note("a", {0: 5, 1: 4}, {})
        out += [tr.mint(step=2), tr.ledger, tr.last_frontier, tr.lag_ops()]
        out += [frontier([{0: 5}, {0: 3}], [{0: 4}, {}]),
                frontier([{0: 5}, {0: 4}], [{0: 4}, {}])]
        out.append([{k: v for k, v in e.items() if k not in ("ts_ms", "v")}
                    for e in ev.find(event="stability_stalled")])
        return out

    out = both(run)
    assert out[0] == {} and out[2] == {0: 3, 1: 7} and out[3] == {0: 2}
    assert out[-3] == {} and out[-2] == {0: 4} and out[13] == 4
