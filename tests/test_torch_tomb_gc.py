"""The port's tombstone GC (crdt_tpu_torch.models.tomb_gc), the GC-aware
columnar RSeq engine (models.rseq_engine), the swarm's stable frontier and
compaction barrier (parallel.swarm) and the seeded RSeq workload, against
the JAX package's — with the RSeq adapter, one OR-Set adapter case, and the
whole slice (plan, gossip with a dead lane, converge, GC barrier, revival)
on the same peers.  Zero tolerance; the JAX side always runs its generic
engine (its columnar one needs the Pallas kernel in interpret mode)."""
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crdt_tpu.models import orset as jorset, rseq as jrseq, rseq_engine as jre
from crdt_tpu.models import tomb_gc as jgc
from crdt_tpu.parallel import swarm as jswarm
from crdt_tpu_torch import convert, workload
from crdt_tpu_torch.models import orset as torset, rseq as trseq, rseq_columnar as trc
from crdt_tpu_torch.models import rseq_engine as tre, tomb_gc as tgc
from crdt_tpu_torch.models.oplog_engine import EngineFallback
from crdt_tpu_torch.ops import hopper_union as hu
from crdt_tpu_torch.parallel import swarm as tswarm
from crdt_tpu_torch.utils.tree import leaves
from tests.test_torch_rseq import assert_same, branch, to_jax

CAP, W, R = 64, 4, 4
TAD, JAD = trseq.GC_ADAPTER, jrseq.GC_ADAPTER


def stacked(states):
    return trseq.RSeq(*(torch.stack([getattr(s, f) for s in states])
                        for f in ("keys", "elem", "removed")))


def gc_j(g: tgc.Gc) -> jgc.Gc:
    return jgc.Gc(inner=to_jax(g.inner), floor=jnp.asarray(g.floor.numpy()))


def assert_gc(j: jgc.Gc, t: tgc.Gc):
    assert_same(j.inner, t.inner)
    np.testing.assert_array_equal(np.asarray(j.floor), t.floor.numpy())


def lane(g, i):
    return tgc.Gc(inner=trseq.RSeq(g.inner.keys[i], g.inner.elem[i], g.inner.removed[i]),
                  floor=g.floor[i])


def edited_swarm(seed, alive=None):
    """R lanes of Gc[RSeq] branched off one base by writers 0..W-1 (per
    writer contiguous seqs), then one generic barrier on the port so the
    floors are non-trivial, then more edits and removes on lane 0."""
    base = branch(trseq.empty(CAP, device="cpu"), 0, seed)
    states = stacked([branch(base, k, seed * 10 + k) for k in range(R)])
    g = tgc.Gc(inner=states, floor=torch.full((R, W), -1, dtype=torch.int32))
    alive = torch.ones(R, dtype=torch.bool) if alive is None else alive
    g = tgc.gc_round(tswarm.make(g, alive), TAD, trseq.empty(CAP, device="cpu"),
                     engine="generic").state
    a = lane(g, 0)
    w = trseq.SeqWriter(a.inner, rid=0, seq_start=tgc.next_seq(a, TAD, 0))
    for k in range(6):
        w.insert_at(0, 900 + k)
    for _ in range(3):
        w.delete_at(1)
    g.inner.keys[0], g.inner.elem[0], g.inner.removed[0] = (
        w.state.keys, w.state.elem, w.state.removed)
    return g


@pytest.fixture(scope="module")
def gswarm():
    return edited_swarm(1)


def test_received_vv_next_seq_and_collect_match_jax(gswarm):
    a = lane(gswarm, 0)
    np.testing.assert_array_equal(np.asarray(jgc.received_vv(gc_j(a), JAD)),
                                  tgc.received_vv(a, TAD).numpy())
    for rid in range(W):
        assert tgc.next_seq(a, TAD, rid) == jgc.next_seq(gc_j(a), JAD, rid)
    floor = torch.tensor([40, 3, 99, -1], dtype=torch.int32)
    assert_gc(jgc.collect(gc_j(a), jnp.asarray(floor.numpy()), JAD),
              tgc.collect(a, floor, TAD))
    np.testing.assert_array_equal(  # batched over the lanes at once
        np.asarray(jax.vmap(lambda g: jgc.received_vv(g, JAD))(gc_j(gswarm))),
        tgc.received_vv(gswarm, TAD).numpy())
    w = tgc.wrap(a.inner, W, device="cpu")
    assert w.n_writers == W and w.floor.tolist() == [-1] * W
    back = convert.gc_from_numpy(convert.gc_to_numpy(a, convert.rseq_to_numpy),
                                 convert.rseq_from_numpy, device="cpu")
    assert_gc(gc_j(a), back)


@pytest.mark.parametrize("pair", [(0, 1), (1, 0), (0, 3)])
def test_join_checked_matches_jax_and_the_columnar_join(gswarm, pair):
    a, b = lane(gswarm, pair[0]), lane(gswarm, pair[1])
    want, wnu = jgc.join_checked(gc_j(a), gc_j(b), JAD)
    got, nu = tgc.join_checked(a, b, TAD)
    assert_gc(want, got)
    assert int(nu) == int(wnu)
    col, cnu = tre.gc_join_checked(a, b)
    assert_gc(want, col)
    assert int(cnu) == int(wnu)
    assert_gc(want, tgc.join(a, b, TAD))


def test_join_refuses_overflow_and_mismatched_layouts(gswarm):
    a = lane(gswarm, 0)
    none = torch.full((W,), -1, dtype=torch.int32)
    w1 = trseq.SeqWriter(trseq.empty(8, device="cpu"), rid=1)
    w2 = trseq.SeqWriter(trseq.empty(8, device="cpu"), rid=2)
    for i in range(6):
        w1.append(i)
        w2.append(i)
    with pytest.raises(tgc.GcOverflow, match="needs 12 rows"):
        tgc.join(tgc.Gc(w1.state, none), tgc.Gc(w2.state, none), TAD)
    with pytest.raises(ValueError, match="identical key layouts"):
        tgc.join_checked(a, tgc.Gc(trseq.widen(a.inner, 7), a.floor), TAD)
    with pytest.raises(ValueError, match="equal writer counts"):
        tgc.join_checked(a, tgc.Gc(a.inner, a.floor[:3]), TAD)
    with pytest.raises(ValueError, match="equal writer counts"):
        tre.gc_join_checked(a, tgc.Gc(a.inner, a.floor[:3]))


def test_gc_round_matches_jax_on_both_engines(gswarm):
    """Lane 2 dead: the generic barrier and the columnar one (the default,
    no fallback allowed) equal the JAX package's generic barrier."""
    alive = torch.tensor([True, True, False, True])
    neutral = trseq.empty(CAP, device="cpu")
    want = jgc.gc_round(jswarm.make(gc_j(gswarm), jnp.asarray(alive.numpy())), JAD,
                        jrseq.empty(CAP), engine="generic")
    gen = tgc.gc_round(tswarm.make(gswarm, alive), TAD, neutral, engine="generic")
    with warnings.catch_warnings():
        warnings.simplefilter("error", EngineFallback)
        col = tgc.gc_round(tswarm.make(gswarm, alive), TAD, neutral)
    assert_gc(want.state, gen.state)
    assert_gc(want.state, col.state)
    assert_gc(gc_j(lane(gswarm, 2)), lane(col.state, 2))  # the dead lane
    with pytest.raises(ValueError, match="engine"):
        tgc.gc_round(tswarm.make(gswarm, alive), TAD, neutral, engine="columnar")


def test_gc_merge_checked_matches_jax_vmapped_join(gswarm):
    """Lane-wise GC joins of the swarm against its lanes rolled by one."""
    other = tgc.Gc(inner=trseq.RSeq(*(x.roll(1, 0) for x in (gswarm.inner.keys,
                                                           gswarm.inner.elem,
                                                           gswarm.inner.removed))),
                   floor=gswarm.floor.roll(1, 0))
    bits = tre.fit_joint_seq_bits(gswarm.inner, other.inner)
    assert bits == jre.fit_joint_seq_bits(to_jax(gswarm.inner), to_jax(other.inner))
    ca, cb = tre.stack(gswarm, bits), tre.stack(other, bits)
    want_col = jre.stack(gc_j(gswarm), seq_bits=bits)
    got_np = convert.columnar_gc_to_numpy(ca)
    np.testing.assert_array_equal(np.asarray(want_col.col.keys), got_np["col"]["keys"])
    np.testing.assert_array_equal(np.asarray(want_col.floor), got_np["floor"])
    out, nu = tre.gc_merge_checked(ca, cb)
    want, wnu = jax.vmap(lambda x, y: jgc.join_checked(x, y, JAD))(gc_j(gswarm), gc_j(other))
    assert_gc(want, tre.unstack(out))
    np.testing.assert_array_equal(np.asarray(wnu), nu.numpy())
    back = convert.columnar_gc_from_numpy(convert.columnar_gc_to_numpy(ca), device="cpu")
    assert_gc(gc_j(gswarm), tre.unstack(back))


def test_columnar_engine_falls_back_loudly():
    bad = tgc.wrap(trseq.empty(96, depth=4, device="cpu"), 3, device="cpu")
    st = tgc.Gc(inner=stacked([bad.inner] * 2), floor=torch.stack([bad.floor] * 2))
    with pytest.warns(EngineFallback, match="power of two"):
        assert tre.gc_converge_swarm(tswarm.make(st)) is None
    with pytest.warns(EngineFallback, match="power of two"):
        _, nu = tre.gc_join_checked_auto(bad, bad)
    assert int(nu) == 0


@pytest.mark.parametrize("entry", ["gc_join_checked_auto", "gc_converge_swarm"])
def test_kernel_refusal_raises_and_does_not_fall_back(monkeypatch, entry):
    """Only an ineligible layout falls back.  On the card's route a kernel
    that refuses to launch (a depth-10 RSeq in a GC join: 30 key words and
    3 value planes, past the 32 a launch takes) raises, and no
    EngineFallback hides it behind the generic engine."""
    def no_build(_name):
        raise AssertionError("the library was loaded")

    monkeypatch.setattr(hu, "_route", lambda _name, _device: False)
    monkeypatch.setattr(hu, "smem_limit", lambda _device: hu.HOPPER_SMEM_OPTIN)
    monkeypatch.setattr(hu._build, "load", no_build)
    g = tgc.wrap(trseq.empty(16, depth=10, device="cpu"), W, device="cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("error", EngineFallback)
        with pytest.raises(ValueError, match="33 key and value planes .* 32"):
            if entry == "gc_join_checked_auto":
                tre.gc_join_checked_auto(g, g)
            else:
                st = tgc.Gc(inner=stacked([g.inner] * 2), floor=torch.stack([g.floor] * 2))
                tre.gc_converge_swarm(tswarm.make(st))


def test_orset_adapter_gc_matches_jax():
    """One OR-Set case: a removed tag collected by a barrier that replica 2
    misses, then its rejoin must not resurrect the tag."""
    tad, jad = torset.GC_ADAPTER, jorset.GC_ADAPTER

    def sets(*rows):
        s = torset.empty(16, device="cpu")
        for elem, rid, seq in rows:
            s = torset.add(s, elem, rid, seq)
        return s

    c = tgc.wrap(sets((5, 2, 0), (7, 1, 0), (8, 1, 1)), W, device="cpu")
    a = tgc.Gc(inner=torset.remove(c.inner, 5), floor=c.floor)
    st = tgc.Gc(inner=torset.ORSet(*(torch.stack([getattr(x.inner, f) for x in (a, a, c)])
                                     for f in ("elem", "rid", "seq", "removed"))),
                floor=torch.stack([a.floor, a.floor, c.floor]))
    alive = torch.tensor([True, True, False])

    def js(g):
        return jgc.Gc(inner=jorset.ORSet(*(jnp.asarray(getattr(g.inner, f).numpy())
                                           for f in ("elem", "rid", "seq", "removed"))),
                      floor=jnp.asarray(g.floor.numpy()))

    got = tgc.gc_round(tswarm.make(st, alive), tad, torset.empty(16, device="cpu"))
    want = jgc.gc_round(jswarm.make(js(st), jnp.asarray(alive.numpy())), jad,
                        jorset.empty(16))
    for x, y in zip(jax.tree.leaves(want.state), leaves(got.state)):
        np.testing.assert_array_equal(np.asarray(x), y.numpy())
    a2 = tgc.Gc(inner=torset.ORSet(*(getattr(got.state.inner, f)[0] for f in
                                     ("elem", "rid", "seq", "removed"))),
                floor=got.state.floor[0])
    c2 = tgc.Gc(inner=torset.ORSet(*(getattr(got.state.inner, f)[2] for f in
                                     ("elem", "rid", "seq", "removed"))),
                floor=got.state.floor[2])
    rejoined = tgc.join(c2, a2, tad)
    for x, y in zip(jax.tree.leaves(jgc.join(js(c2), js(a2), jad)), leaves(rejoined)):
        np.testing.assert_array_equal(np.asarray(x), y.numpy())
    assert int(torset.size(rejoined.inner)) == 2
    assert not bool(torset.contains(rejoined.inner, 5))


@pytest.mark.parametrize("case", ["plain", "chain_ok", "chain_blocked", "none_alive"])
def test_stable_frontier_and_compaction_round_match_jax(case):
    rng = np.random.default_rng(len(case))
    received = rng.integers(-1, 30, (5, W)).astype(np.int32)
    alive = rng.random(5) < 0.7
    alive[0] = case != "none_alive"
    if case == "none_alive":
        alive[:] = False
    frontiers = None
    if case.startswith("chain"):
        frontiers = np.minimum(received, 2).astype(np.int32)
        if case == "chain_blocked":
            frontiers[~alive.argmax() if alive.any() else 0, 1] = 100
    want = jswarm.stable_frontier(jnp.asarray(received), jnp.asarray(alive),
                                  None if frontiers is None else jnp.asarray(frontiers))
    got = tswarm.stable_frontier(torch.from_numpy(received), torch.from_numpy(alive),
                                 None if frontiers is None else torch.from_numpy(frontiers))
    np.testing.assert_array_equal(np.asarray(want), got.numpy())
    assert got.dtype == torch.int32

    # the barrier over a stacked vector-clock-like state: fold = min
    def jfold(st, f):
        return jnp.minimum(st, f)

    st = rng.integers(0, 40, (5, W)).astype(np.int32)
    fr = np.minimum(st, 3).astype(np.int32)
    jsw = jswarm.make(jnp.asarray(st), jnp.asarray(alive))
    want_sw = jswarm.compaction_round(jsw, lambda s: s, jfold, lambda s: jnp.minimum(s, 3))
    got_sw = tswarm.compaction_round(
        tswarm.make(torch.from_numpy(st), torch.from_numpy(alive)),
        lambda s: s, torch.minimum, lambda s: torch.from_numpy(fr))
    np.testing.assert_array_equal(np.asarray(want_sw.state), got_sw.state.numpy())


def test_seq_workload_is_deterministic_and_its_view_is_the_fold():
    pool = workload.seq_pool(11, n_elements=200)
    again = workload.seq_pool(11, n_elements=200)
    for f in ("keys", "elem", "removable"):
        np.testing.assert_array_equal(getattr(pool, f), getattr(again, f))
    assert len(pool) == 200 and int(pool.removable.sum()) == 50
    assert not np.array_equal(workload.seq_pool(12, n_elements=200).keys, pool.keys)
    rows = [tuple(r) for r in pool.keys.tolist()]
    assert rows == sorted(rows) and len(set(rows)) == 200
    hist = pool.depth_histogram()
    assert sum(hist.values()) == 200 and max(hist) >= 2
    assert sorted(pool.elem.tolist()) == list(range(200))

    a = workload.seq_swarm(pool, 6, 128, 5, device="cpu")
    b = workload.seq_swarm(pool, 6, 128, 5, device="cpu")
    for x, y in zip(leaves(a.states) + [a.held, a.seen], leaves(b.states) + [b.held, b.seen]):
        assert torch.equal(x, y)
    assert bool((a.seen <= a.held).all())
    assert bool((a.seen <= torch.from_numpy(pool.removable)).all())
    small = workload.seq_swarm(pool, 6, 32, 5, device="cpu")  # capacity cuts
    assert int(small.held.sum(dim=1).max()) == 32
    for i in range(6):
        s = trseq.RSeq(a.states.keys[i], a.states.elem[i], a.states.removed[i])
        tombs, live = workload.seq_view(pool, a.held[i].numpy(), a.seen[i].numpy())
        assert trseq.to_list(s) == live
        assert len(tombs) == int(trseq.n_rows(s))
    t = trseq.RSeq(small.states.keys[0], small.states.elem[0], small.states.removed[0])
    assert trseq.to_list(t) == workload.seq_view(pool, small.held[0].numpy(),
                                                 small.seen[0].numpy())[1]


def test_whole_slice_matches_jax():
    """plan → 3 gossip rounds with lane 3 dead → converge → gc_round (the
    columnar engine) → revive lane 3 by one GC-aware pull, on the same
    seeded peers through both packages."""
    pool = workload.seq_pool(21, n_elements=60)
    sw = workload.seq_swarm(pool, R, CAP, 22, device="cpu")
    alive = torch.tensor([True, True, True, False])
    peers = [torch.from_numpy(np.random.default_rng(k).permutation(R)) for k in range(3)]

    with warnings.catch_warnings():
        warnings.simplefilter("error", EngineFallback)
        col, _ = trc.plan(sw.states)
        for p in peers:
            col = trc.gossip_round(col, p, alive)
        col, max_nu = trc.converge_checked(col, alive)
        conv = trc.unstack(col)
        g = tgc.Gc(inner=conv, floor=torch.full((R, 16), -1, dtype=torch.int32))
        gc = tgc.gc_round(tswarm.make(g, alive), TAD, trseq.empty(CAP, device="cpu")).state

    j = to_jax(sw.states)
    ja = jnp.asarray(alive.numpy())
    for p in peers:
        joined = jax.vmap(jrseq.join)(j, jax.tree.map(lambda x: x[jnp.asarray(p.numpy())], j))
        ok = ja & ja[jnp.asarray(p.numpy())]
        j = jax.tree.map(lambda m, x: jnp.where(ok.reshape((-1,) + (1,) * (x.ndim - 1)), m, x),
                         joined, j)
    j = jswarm.converge(jswarm.make(j, ja), jax.vmap(jrseq.join), jrseq.empty(CAP)).state
    assert_same(j, conv)
    assert int(max_nu) <= CAP
    jg = jgc.Gc(inner=j, floor=jnp.full((R, 16), -1, jnp.int32))
    jg = jgc.gc_round(jswarm.make(jg, ja), JAD, jrseq.empty(CAP), engine="generic").state
    assert_gc(jg, gc)

    held, seen = sw.held.numpy(), sw.seen.numpy()
    tombs, live = workload.seq_view(pool, held[:3], seen[:3])
    assert trseq.to_list(lane(gc, 0).inner) == live
    revived, nu = tre.gc_join_checked(lane(gc, 3), lane(gc, 0))
    want, wnu = jgc.join_checked(jax.tree.map(lambda x: x[3], jg),
                                 jax.tree.map(lambda x: x[0], jg), JAD)
    assert_gc(want, revived)
    assert int(nu) == int(wnu)

    def idents(g):
        rid, seq = TAD.rid_seq(g.inner)
        valid = TAD.valid(g.inner)
        return {(int(r), int(s)) for r, s in zip(rid[valid], seq[valid])}

    # the alive lanes kept exactly the live identities; the revived lane
    # holds them all and brings no collected (removed) identity back
    assert idents(lane(gc, 0)) == {k for k, dead in tombs.items() if not dead}
    assert idents(lane(gc, 0)) <= idents(revived)
    assert not idents(revived) & {k for k, dead in tombs.items() if dead}
