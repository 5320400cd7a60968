"""The port's session tokens and stability summaries
(crdt_tpu_torch.consistency.session, .stability) against the JAX package's
on seeded inputs, garbage included, and the StabilityTracker's frontier,
mint, stale members and lag on seeded notes, at zero tolerance."""
import random

import pytest

from crdt_tpu.api import node as jnode
from crdt_tpu.consistency import session as jsession
from crdt_tpu.consistency import stability as jstab
from crdt_tpu.utils import clock as jclock
from crdt_tpu_torch.api import node as tnode
from crdt_tpu_torch.consistency import session as tsession
from crdt_tpu_torch.consistency import stability as tstab
from crdt_tpu_torch.utils import clock as tclock

GARBAGE = [None, "", "{", "[]", "17", "null", '{"0": "x"}', '{"a": 1}', '{"1": 2.5}',
           '{"rid": 1}', '{"rid": "x", "vv": {}}', '{"rid": 2, "vv": [1]}',
           '{"rid": 2, "vv": {"1": 3}, "frontier": {"0": 1}, "digest": "ab"}',
           '{"rid": 2, "vv": null, "frontier": null}', " ", '{"5": 7, "-1": 0}']


def seeded_vv(rng, n=6):
    return {rng.randrange(-2, 40): rng.randrange(-1, 1000) for _ in range(rng.randrange(n))}


@pytest.mark.parametrize("seed", range(4))
def test_tokens_alike(seed):
    rng = random.Random(seed)
    idents = [(rng.randrange(8), rng.randrange(100)) for _ in range(20)]
    a, b = jsession.mint_token(idents), tsession.mint_token(idents)
    assert a == b
    c, d = seeded_vv(rng), seeded_vv(rng)
    assert jsession.token_join(c, d) == tsession.token_join(c, d)
    for vv in (c, d, jsession.token_join(a, c)):
        assert jsession.vv_dominates(vv, a) == tsession.vv_dominates(vv, a)
    for tok in (a, c, d, {}):
        raw = jsession.encode_token(tok)
        assert tsession.encode_token(tok) == raw
        assert jsession.decode_token(raw) == tsession.decode_token(raw)
    assert jsession.SESSION_TOKEN_HEADER == tsession.SESSION_TOKEN_HEADER


def outcome(fn, raw):
    """("ok", value) or ("raises", the exception's type name)."""
    try:
        return "ok", fn(raw)
    except Exception as e:  # noqa: BLE001 — compared across the packages
        return "raises", type(e).__name__


@pytest.mark.parametrize("raw", GARBAGE)
def test_garbage_decodes_alike(raw):
    """Garbage decodes to None in both, or raises the same error in both
    (a summary whose vv is a JSON list raises AttributeError in each)."""
    assert outcome(jsession.decode_token, raw) == outcome(tsession.decode_token, raw)
    assert outcome(jstab.decode_summary, raw) == outcome(tstab.decode_summary, raw)


@pytest.mark.parametrize("seed", range(4))
def test_summaries_alike(seed):
    rng = random.Random(seed)
    for _ in range(10):
        rid, vv, fr = rng.randrange(50), seeded_vv(rng), seeded_vv(rng)
        dig = rng.choice([None, "deadbeef", "x" * 8])
        raw = jstab.encode_summary(rid, vv, fr, digest=dig)
        assert tstab.encode_summary(rid, vv, fr, digest=dig) == raw
        assert jstab.decode_summary(raw) == tstab.decode_summary(raw)
    assert jstab.STABILITY_HEADER == tstab.STABILITY_HEADER


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def _nodes_with_writes(rng):
    """A JAX node and a port node holding the same writes and fold."""
    jn = jnode.ReplicaNode(rid=0, capacity=16, clock=jclock.ManualClock(), use_native=False)
    tn = tnode.ReplicaNode(rid=0, capacity=16, clock=tclock.ManualClock(), use_native=False,
                           device="cpu")
    for i in range(rng.randrange(3, 9)):
        for n in (jn, tn):
            n.add_command({f"k{i % 3}": str(i)}, ts=i)
    return jn, tn


@pytest.mark.parametrize("seed", range(3))
def test_stability_tracker_alike(seed):
    """Seeded notes (reordered and delayed summaries, a stale member, a
    folded frontier off the chain) through a tracker in each package:
    the same frontier, mint, ledger, stale members and lag after each."""
    rng = random.Random(seed)
    jn, tn = _nodes_with_writes(rng)
    members = ["a", "b", "c"]
    jclk, tclk = FakeClock(), FakeClock()
    jt = jstab.StabilityTracker(jn, members, max_staleness=5.0, clock=jclk)
    tt = tstab.StabilityTracker(tn, members, max_staleness=5.0, clock=tclk)
    for step in range(30):
        jclk.t = tclk.t = step * 0.7
        m = rng.choice(members + ["outsider"])
        vv = {0: rng.randrange(-1, 10), rng.randrange(1, 4): rng.randrange(0, 6)}
        fr = {0: rng.randrange(-1, 2)} if rng.random() < 0.3 else {}
        if rng.random() < 0.8 and not (step % 11 == 10 and m == "c"):
            jt.note(m, vv, fr)
            tt.note(m, vv, fr)
        assert jt.stale_members() == tt.stale_members()
        assert jt.frontier() == tt.frontier()
        assert jt.mint(step=step) == tt.mint(step=step)
        assert jt.lag_ops() == tt.lag_ops()
        assert jt.last_frontier == tt.last_frontier
        assert jt.observed() == tt.observed()
    assert [dict(r, t=None) for r in jt.ledger] == [dict(r, t=None) for r in tt.ledger]
    assert tt.ledger  # some mint went through
