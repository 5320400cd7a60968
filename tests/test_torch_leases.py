"""The port's coordinator leases and fences (crdt_tpu_torch.consistency
.leases) against the JAX package's, zero tolerance, following
tests/test_leases.py case by case on the same fake-clock fleets: every
manager runs on a manual clock that moves only when the test moves it,
and every "wire" grant lands directly on the target manager's voter side.
Each scenario runs once on JAX managers and once on the port's, and the
grants, fences, refusals, slot states, events and counters are equal."""
from __future__ import annotations

import pytest

from crdt_tpu.consistency import leases as jleases
from crdt_tpu.keyspace import routing as jrouting
from crdt_tpu.obs.events import EventLog as JEventLog
from crdt_tpu_torch.consistency import leases as tleases
from crdt_tpu_torch.keyspace import routing as trouting
from crdt_tpu_torch.obs.events import EventLog as TEventLog

PKG = {"j": (jleases, JEventLog, jrouting), "t": (tleases, TEventLog, trouting)}


class ManualClock:
    def __init__(self):
        self.t = 0.0

    def now(self) -> float:
        return self.t


class CountMetrics:
    def __init__(self):
        self.counts = {}

    def inc(self, name, *a, **kw):
        self.counts[name] = self.counts.get(name, 0) + 1


class LeasePeer:
    """RemotePeer stand-in: ``lease_grant`` lands on the target manager's
    voter side, as POST /lease/grant does; switches for a dead transport
    and an open breaker."""

    def __init__(self, mgr, url: str):
        self.mgr, self.url = mgr, url
        self.backed = self.down = False
        self.grant_calls = 0

    def backed_off(self) -> bool:
        return self.backed

    def backoff_peek(self) -> bool:
        return self.backed

    def lease_grant(self, *, slot, holder, fence, ttl):
        self.grant_calls += 1
        return None if self.down else self.mgr.grant(slot, holder, fence, ttl)


class Fleet:
    """n managers of one package fully meshed over LeasePeers."""

    def __init__(self, pkg: str, n: int, *, duration: float = 10.0, shared_clock=True):
        leases, EventLog, _ = PKG[pkg]
        self.leases, self.EventLog = leases, EventLog
        self.clocks = [ManualClock() for _ in range(n)]
        if shared_clock:
            self.clocks = [self.clocks[0]] * n
        self.m = [leases.LeaseManager(None, n_slots=4, duration=duration,
                                      clock=self.clocks[i].now,
                                      events=EventLog(node=f"n{i}"), metrics=CountMetrics())
                  for i in range(n)]
        self.peers = {i: [LeasePeer(self.m[j], f"http://n{j}") for j in range(n) if j != i]
                      for i in range(n)}
        for i, mgr in enumerate(self.m):
            mgr.attach(f"http://n{i}", (lambda i=i: self.peers[i]))

    def holders(self, slot):
        return [i for i, mgr in enumerate(self.m) if mgr.held_fence(slot) is not None]

    def record(self):
        """Every manager's events (no wall clock), counters and fences."""
        return [([{k: v for k, v in e.items() if k not in ("ts_ms", "v")}
                  for e in mgr.events.find()], mgr.metrics.counts, mgr.fences_snapshot(),
                 mgr.slot_states()) for mgr in self.m]


def both(fn):
    out = {p: fn(p) for p in ("j", "t")}
    assert out["t"] == out["j"]
    return out["t"]


def test_slot_of_key_deterministic_and_in_range():
    keys = ["reg-a", "reg-b", "user:42", ""] + [f"k{i}" for i in range(64)]
    slots = both(lambda p: [PKG[p][0].slot_of_key(k, n) for k in keys for n in (1, 8, 13)])
    assert all(s >= 0 for s in slots) and len(set(slots[13::3])) > 1
    assert both(lambda p: PKG[p][0].LEASE_STATE) == {"follower": 0, "held": 1, "expired": 2}


def test_coordinator_view_is_shared_across_members():
    def run(p):
        f = Fleet(p, 3)
        views = [[mgr.coordinator_of(s) for mgr in f.m] for s in range(4)]
        f.peers[0][1].backed = True  # an open breaker leaves n0's view
        views.append([f.m[0].live_members(), f.m[0].coordinator_of(0), f.peers[0][1].grant_calls])
        return views

    out = both(run)
    assert all(len(set(v)) == 1 for v in out[:4])


def test_rendezvous_seam_matches_router_for_urls():
    for members in ([f"shard-{i}" for i in range(5)],
                    [f"http://10.0.0.{i}:8430" for i in range(1, 6)],
                    ["http://n0", "http://n1", "http://n2"]):
        both(lambda p: [(PKG[p][2].RendezvousRouter(members).ranked(k),
                         PKG[p][2].ranked_members(members, k))
                        for k in ("reg-a", "lease-slot-3", "tenant\x00k1", "x")])


def test_ranked_members_ident_ranks_over_stable_names():
    ident_a = {"http://h:1111": "member-0", "http://h:2222": "member-1"}
    ident_b = {"http://h:9999": "member-0", "http://h:8888": "member-1"}

    def run(p):
        r = PKG[p][2]
        return [([ident_a[m] for m in r.ranked_members(sorted(ident_a), k, ident=ident_a.get)],
                 [ident_b[m] for m in r.ranked_members(sorted(ident_b), k, ident=ident_b.get)])
                for k in ("lease-slot-0", "lease-slot-1", "reg-c")]

    assert all(a == b for a, b in both(run))


def test_single_holder_while_lease_unexpired():
    def run(p):
        f = Fleet(p, 3)
        out = [f.m[0].ensure(0), f.holders(0), f.m[1].ensure(0), f.m[2].ensure(0),
               f.holders(0), f.m[0].ensure(0)]
        return out + f.record()

    assert both(run)[:6] == [1, [0], None, None, [0], 1]


def test_reacquire_before_expiry_keeps_same_fence():
    def run(p):
        f = Fleet(p, 3)
        out = [f.m[0].ensure(1)]
        f.clocks[0].t = 6.0
        out.append(f.m[0].ensure(1))
        f.clocks[0].t = 12.0
        return out + [f.m[0].held_fence(1)] + f.record()

    assert both(run)[:3] == [1, 1, 1]


def test_expiry_mid_renewal_keeps_lease_until_ttl_then_drops():
    def run(p):
        f = Fleet(p, 3)
        out = [f.m[0].ensure(2)]
        for peer in f.peers[0]:
            peer.down = True
        f.clocks[0].t = 6.0
        out.append(f.m[0].ensure(2))
        f.clocks[0].t = 10.0
        out += [f.m[0].held_fence(2), f.m[0].ensure(2)]
        return out + f.record()

    out = both(run)
    assert out[:4] == [1, 1, None, None]
    assert out[4][1].get("lease_renew_failures", 0) >= 1
    assert any(e["event"] == "lease_expire" for e in out[4][0])


def test_handoff_after_expiry_bumps_fence():
    def run(p):
        f = Fleet(p, 3)
        out = [f.m[0].ensure(0)]
        f.clocks[0].t = 11.0
        out += [f.m[1].ensure(0), f.holders(0), f.m[1].check_push_fences({0: 1}, trace="t-1"),
                f.m[1].check_push_fences({0: 3, 1: 1})]
        return out + f.record()

    out = both(run)
    assert out[:4] == [1, 2, [1], {"slot": 0, "fence": 2}] and out[4] is None


def test_fence_monotone_across_repeated_handoffs():
    def run(p):
        f = Fleet(p, 3)
        fences = []
        for round_i in range(6):
            fences.append(f.m[round_i % 3].ensure(3))
            f.clocks[0].t += 11.0
        return [fences] + f.record()

    fences = both(run)[0]
    assert fences == sorted(fences) and len(set(fences)) == len(fences)


def test_restored_fences_keep_refusing_after_crash():
    def run(p):
        f = Fleet(p, 3)
        for _ in range(3):
            f.m[0].ensure(0)
            f.clocks[0].t += 11.0
            f.m[1].ensure(0)
            f.clocks[0].t += 11.0
        snap = f.m[1].fences_snapshot()
        reborn = f.leases.LeaseManager(None, n_slots=4, duration=10.0, clock=f.clocks[0].now,
                                       events=f.EventLog(node="reborn"), metrics=CountMetrics())
        reborn.restore_fences({str(s): v for s, v in snap.items()})
        floor = snap[0]
        return [snap, reborn.fence_of(0), reborn.check_push_fences({0: floor - 1}),
                reborn.grant(0, "http://zombie", floor - 1, 10.0),
                reborn.grant(0, "http://next", floor + 1, 10.0), reborn.fences_snapshot()]

    out = both(run)
    assert out[1] == out[0][0] >= 2 and out[2] is not None and not out[3]["granted"]


def test_skewed_zombie_view_is_fenced_not_trusted():
    def run(p):
        f = Fleet(p, 3, shared_clock=False)
        out = [f.m[0].ensure(0)]
        f.clocks[1].t = f.clocks[2].t = 12.0
        out += [f.m[1].ensure(0), f.m[0].held_fence(0), f.m[1].held_fence(0),
                f.m[1].check_push_fences({0: 1}), f.m[2].check_push_fences({0: 1})]
        f.m[0].note_fence(0, 2)
        return out + [f.m[0].held_fence(0)] + f.record()

    assert both(run)[:7] == [1, 2, 1, 2, {"slot": 0, "fence": 2}, {"slot": 0, "fence": 2}, None]


def test_skewed_voter_refuses_equal_fence_other_holder():
    def run(p):
        f = Fleet(p, 2, shared_clock=False)
        out = [f.m[1].grant(1, "http://n0", 1, 10.0), f.m[1].grant(1, "http://n0", 1, 10.0)]
        f.clocks[1].t = 20.0
        out += [f.m[1].grant(1, "http://other", 1, 10.0), f.m[1].grant(1, "http://n0", 1, 10.0),
                f.m[1].grant(1, "http://n0", 2, 10.0)]
        return out + f.record()

    out = both(run)
    assert out[0]["granted"] and out[1]["granted"] and not out[2]["granted"]
    assert out[2]["fence"] == 1 and not out[3]["granted"] and out[4]["granted"]


def test_taught_fence_retry_recovers_in_one_round():
    def run(p):
        f = Fleet(p, 3)
        for mgr in f.m[1:]:
            mgr.note_fence(2, 7)
        fence = f.m[0].ensure(2)
        return [fence, [peer.grant_calls for peer in f.peers[0]]] + f.record()

    out = both(run)
    assert out[0] == 8 and sum(out[1]) <= 4


def test_slot_states_gauge_encoding():
    def run(p):
        f = Fleet(p, 3)
        out = [f.m[0].ensure(0), f.m[0].slot_states()]
        f.clocks[0].t = 11.0
        out += [f.m[0].slot_states()[0], f.m[0].held_fence(0), f.m[0].slot_states()[0]]
        return out + f.record()

    out = both(run)
    assert out[1][0] == {"state": 1, "fence": 1} and out[2]["state"] == 2
    assert out[4]["state"] == 0


@pytest.mark.parametrize("seed", range(4))
def test_random_schedules_equal_the_jax_package(seed):
    """Seeded random schedules of ensure, grant, note_fence,
    check_push_fences, transport and breaker faults and clock moves over
    a skewed 4-member fleet: every answer, event, counter and fence equal."""
    import random

    def run(p):
        rng = random.Random(seed)
        f = Fleet(p, 4, duration=5.0, shared_clock=False)
        out = []
        for _ in range(120):
            i, slot = rng.randrange(4), rng.randrange(4)
            op = rng.randrange(7)
            if op == 0:
                out.append(f.m[i].ensure(slot))
            elif op == 1:
                out.append(f.m[i].grant(slot, f"http://n{rng.randrange(4)}",
                                        rng.randrange(1, 6), 5.0))
            elif op == 2:
                f.m[i].note_fence(slot, rng.randrange(0, 8))
            elif op == 3:
                out.append(f.m[i].check_push_fences({slot: rng.randrange(0, 8)}))
            elif op == 4:
                peer = rng.choice(f.peers[i])
                peer.down = not peer.down
            elif op == 5:
                peer = rng.choice(f.peers[i])
                peer.backed = not peer.backed
            else:
                f.clocks[i].t += rng.choice((0.5, 2.0, 3.0, 6.0))
            out.append(f.m[i].coordinator_of(slot))
        return out + f.record()

    both(run)
