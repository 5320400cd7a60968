"""The columnar GC swarm of the port's RSeq engine (``rseq_engine.plan_gc``
→ ``GcSwarm``: pull rounds and the whole GC barrier on the planes) against
the JAX package's ``tomb_gc.join_checked`` (gated on both ends up) and
``gc_round`` with ``rseq.GC_ADAPTER``, and against the port's generic
engine: tables, floors, unique counts, collected rows and overflow, bit
for bit.  The swarm has ragged lanes (12, no power of two), lanes whose
floors lag on either side of a pull, a dead lane and its revival."""
import json
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crdt_tpu.models import rseq as jrseq, tomb_gc as jgc
from crdt_tpu.ops import joins as jjoins
from crdt_tpu.parallel import swarm as jswarm
from crdt_tpu_torch.models import rseq as trseq, rseq_engine as tre, tomb_gc as tgc
from crdt_tpu_torch.models.oplog_engine import EngineFallback
from crdt_tpu_torch.ops import hopper_union as hu
from crdt_tpu_torch.parallel import swarm as tswarm
from crdt_tpu_torch.utils import tracing
from crdt_tpu_torch.utils.tree import tree_map
from tests.test_torch_rseq import branch
from tests.seq_gc_planted import PLANTED_COUNTS, planted_pairs, staged_planted
from tests.test_torch_tomb_gc import JAD, TAD, assert_gc, gc_j, lane, stacked

CAP, W, R = 64, 4, 12
# lane 3 was down at both earlier barriers, lane 7 at the second: their
# floors lag, and they hold rows the others collected
STALE = (3, 7)


def _set_lane(g: tgc.Gc, i: int, s: trseq.RSeq) -> None:
    g.inner.keys[i], g.inner.elem[i], g.inner.removed[i] = s.keys, s.elem, s.removed


def _edit(g: tgc.Gc, i: int, rid: int, inserts: int, deletes: int) -> None:
    """Writer ``rid`` types ``inserts`` elements at the head of lane i, then
    removes ``deletes``; its seqs resume above lane i's watermark."""
    a = lane(g, i)
    w = trseq.SeqWriter(a.inner, rid=rid, seq_start=tgc.next_seq(a, TAD, rid))
    for k in range(inserts):
        w.insert_at(0, 700 + 10 * rid + k)
    for _ in range(deletes):
        w.delete_at(1)
    _set_lane(g, i, w.state)


def gc_swarm(seed: int, cap: int = CAP) -> tgc.Gc:
    """R lanes of Gc[RSeq]: W writers' branches of one base, the rest
    joins of two branches; a generic barrier with lane 3 down, edits, a
    second with lanes 3 and 7 down, and fresh edits on lanes 1 and 5."""
    rng = np.random.default_rng(seed)
    base = branch(trseq.empty(cap, device="cpu"), 0, seed)
    heads = [branch(base, k, seed * 10 + k) for k in range(W)]
    rest = [trseq.join(heads[a], heads[b])
            for a, b in (rng.choice(W, 2, replace=False) for _ in range(R - W))]
    g = tgc.Gc(inner=stacked(heads + rest), floor=torch.full((R, W), -1, dtype=torch.int32))
    neutral = trseq.empty(cap, device="cpu")
    for k in range(len(STALE)):
        alive = torch.ones(R, dtype=torch.bool)
        alive[list(STALE[:k + 1])] = False
        g = tgc.gc_round(tswarm.make(g, alive), TAD, neutral, engine="generic").state
        _edit(g, 0, 0, inserts=4, deletes=3)
        _edit(g, 5 + k, 2, inserts=2, deletes=2)
    _edit(g, 1, 1, inserts=3, deletes=1)
    _edit(g, 5, 3, inserts=2, deletes=2)
    return g


@pytest.fixture(scope="module")
def swarm():
    return gc_swarm(3)


def peer_draw(seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return ((np.arange(R) + rng.integers(1, R, R)) % R).astype(np.int64)


def jax_pull(g: jgc.Gc, peers: np.ndarray, alive: np.ndarray):
    """The JAX package's GC join of every lane with its peer, kept where
    both are up; the unique count 0 where the pull was gated off."""
    joined, nu = jax.vmap(lambda x, y: jgc.join_checked(x, y, JAD))(
        g, jax.tree.map(lambda x: x[peers], g))
    ok = alive & alive[peers]
    out = jax.tree.map(
        lambda j, x: jnp.where(ok.reshape((-1,) + (1,) * (x.ndim - 1)), j, x), joined, g)
    return out, np.where(ok, np.asarray(nu), 0)


def jax_lub(g: jgc.Gc, alive: np.ndarray, cap: int = CAP):
    """gc_round's tree reduction of the alive lanes, level by level as the
    JAX package's generic barrier runs it: (the bound's one lane, the
    largest unique count of any level)."""
    neutral = jgc.wrap(jrseq.empty(cap), W)
    state = jjoins.pad_to_pow2(
        jswarm.mask_dead_with_neutral(g, jnp.asarray(alive), neutral), neutral)
    jbc = jax.vmap(lambda x, y: jgc.join_checked(x, y, JAD))
    p, most = jax.tree.leaves(state)[0].shape[0], 0
    while p > 1:
        p //= 2
        state, nu = jbc(jax.tree.map(lambda x: x[:p], state),
                        jax.tree.map(lambda x: x[p:2 * p], state))
        most = max(most, int(nu.max()))
    return jax.tree.map(lambda x: x[0], state), most


def n_rows(keys) -> np.ndarray:
    return np.sum(np.asarray(keys)[..., 0] != 2**31 - 1, axis=-1)


def engines(g: tgc.Gc, alive: torch.Tensor):
    with warnings.catch_warnings():
        warnings.simplefilter("error", EngineFallback)
        col = tre.plan_gc(g, alive)
    gen = tre.plan_gc(g, alive, force_generic=True)
    assert (col.engine, gen.engine) == ("columnar", "generic")
    return col, gen


def test_the_swarm_has_lagging_floors_and_rows_others_collected(swarm):
    """The fixture's lanes: three floors, and each stale lane holds rows
    that the newest floor covers and an up-to-date lane no longer holds
    (collected there): what a pull must suppress."""
    floors = {tuple(f) for f in swarm.floor.tolist()}
    assert len(floors) == 3 and tuple([-1] * W) in floors
    newest = lane(swarm, 0)
    held = {tuple(k) for k in newest.inner.keys.tolist()}
    for s in STALE:
        keys = swarm.inner.keys[s]
        covered = tgc._covered(keys[:, -2], keys[:, -1], keys[:, 0] != 2**31 - 1,
                               newest.floor)
        assert any(tuple(keys[i].tolist()) not in held for i in covered.nonzero()[:, 0])


@pytest.mark.parametrize("draw", [0, 1, 2])
def test_gossip_round_matches_jax_and_the_generic_engine(swarm, draw):
    peers = peer_draw(draw)
    alive = np.ones(R, bool)
    alive[draw + 8] = False
    col, gen = engines(swarm, torch.from_numpy(alive))
    want, want_nu = jax_pull(gc_j(swarm), peers, alive)
    for sw in (col, gen):
        out, nu = sw.gossip_round(torch.from_numpy(peers))
        assert_gc(want, out.rows())
        np.testing.assert_array_equal(want_nu, nu.numpy())
    # the counter: the rows the floors took out of the kept pulls' unions
    _, union = trseq.join_checked(swarm.inner, tree_map(lambda x: x[peers], swarm.inner))
    ok = alive & alive[peers]
    assert col.counts.read()["suppressed"] == int((union.numpy() - nu.numpy())[ok].sum()) > 0


@pytest.mark.parametrize("dead", [None, 2, 3])
def test_gc_barrier_matches_jax_gc_round_and_the_generic_engine(swarm, dead):
    """The barrier's tables and floors equal gc_round's, its unique count
    the tree's largest, and its collected rows those the collect dropped
    from the bound on every up lane; a down lane is left as it was."""
    alive = np.ones(R, bool)
    if dead is not None:
        alive[dead] = False
    want = jgc.gc_round(jswarm.make(gc_j(swarm), jnp.asarray(alive)), JAD, jrseq.empty(CAP),
                        engine="generic")
    top, want_nu = jax_lub(gc_j(swarm), alive)
    after = n_rows(want.state.inner.keys)[alive]
    want_collected = int((n_rows(top.inner.keys) - after).sum())
    assert want_collected > 0
    col, gen = engines(swarm, torch.from_numpy(alive))
    for sw in (col, gen):
        out, nu, collected = sw.gc_barrier()
        assert_gc(want.state, out.rows())
        assert (nu, collected) == (want_nu, want_collected)
        if dead is not None:
            assert_gc(gc_j(lane(swarm, dead)), lane(out.rows(), dead))
    # the counter holds the pulls' suppressed rows alone: a barrier adds none
    assert col.counts.read() == {"suppressed": 0}


def test_rounds_barrier_and_revival_match_jax(swarm):
    """Three pull rounds with lane 6 down, the barrier, then lane 6 back
    up: one pull catches it up, as one JAX GC join does."""
    alive = np.ones(R, bool)
    alive[6] = False
    col, gen = engines(swarm, torch.from_numpy(alive))
    jg = gc_j(swarm)
    for draw in (4, 5, 6):
        peers = peer_draw(draw)
        jg, _ = jax_pull(jg, peers, alive)
        col, _ = col.gossip_round(torch.from_numpy(peers))
        gen, _ = gen.gossip_round(torch.from_numpy(peers))
    jg = jgc.gc_round(jswarm.make(jg, jnp.asarray(alive)), JAD, jrseq.empty(CAP),
                      engine="generic").state
    col, _, _ = col.gc_barrier()
    gen, _, _ = gen.gc_barrier()
    assert_gc(jg, col.rows())
    assert_gc(jg, gen.rows())
    peers = np.roll(np.arange(R), 1)  # lane 6 pulls lane 5
    alive[6] = True
    jg, want_nu = jax_pull(jg, peers, alive)
    for sw in (col, gen):
        out, nu = sw.set_alive(6, True).gossip_round(torch.from_numpy(peers))
        assert_gc(jg, out.rows())
        np.testing.assert_array_equal(want_nu, nu.numpy())


def test_overflow_is_reported_by_the_pull_and_raised_by_the_barrier():
    """Four writers' runs of 6 on tables of 8 rows: each pull reports 12
    unique rows (as join_checked does), and the barrier raises GcOverflow
    on both engines where gc_round does (its second level joins two
    truncated lanes of 8)."""
    tables = []
    for rid in range(4):
        w = trseq.SeqWriter(trseq.empty(8, device="cpu"), rid=rid)
        for i in range(6):
            w.append(i)
        tables.append(w.state)
    g = tgc.Gc(inner=stacked(tables), floor=torch.full((4, W), -1, dtype=torch.int32))
    alive = torch.ones(4, dtype=torch.bool)
    with pytest.raises(tgc.GcOverflow, match="needs 16 rows but capacity is 8"):
        tgc.gc_round(tswarm.make(g, alive), TAD, trseq.empty(8, device="cpu"))
    col, gen = engines(g, alive)
    peers = torch.tensor([1, 0, 3, 2])
    for sw in (col, gen):
        _, nu = sw.gossip_round(peers)
        assert nu.tolist() == [12] * 4
        with pytest.raises(tgc.GcOverflow, match="needs 16 rows but capacity is 8"):
            sw.gc_barrier()
        _, nu, _ = sw.gc_barrier_checked()
        assert int(nu) == 16


def test_plan_falls_back_loudly_and_serves_the_same_results():
    g = gc_swarm(4, cap=96)
    alive = torch.ones(R, dtype=torch.bool)
    with pytest.warns(EngineFallback, match="power of two"):
        sw = tre.plan_gc(g, alive)
    assert sw.engine == "generic" and "power of two" in sw.fallback_reason
    assert sw.counts is None and sw.columnar is None
    peers = peer_draw(7)
    want, want_nu = jax_pull(gc_j(g), peers, np.ones(R, bool))
    out, nu = sw.gossip_round(torch.from_numpy(peers))
    assert_gc(want, out.rows())
    np.testing.assert_array_equal(want_nu, nu.numpy())
    with pytest.warns(EngineFallback, match="power of two"):
        tgc.gc_round(tswarm.make(g, alive), TAD, trseq.empty(96, device="cpu"))


# ---- the GC join's route: the twin on the CPU, the fused kernel by shape ------


def test_a_cpu_tensor_takes_the_twin(swarm, monkeypatch):
    """On the CPU every GC join (pulls and the barrier's halvings) is the
    composition, never the fused kernel, whose entry point refuses CPU
    tensors."""
    def no_kernel(*args, **kwargs):
        raise AssertionError("the fused GC union was called on the CPU")

    a, b = staged_planted()
    with pytest.raises(ValueError, match="CUDA tensors"):
        hu.gc_union_columnar_lexn(a.col.keys, (a.col.elem, a.col.removed), a.floor,
                                  b.col.keys, (b.col.elem, b.col.removed), b.floor,
                                  a.col.seq_bits)
    monkeypatch.setattr(hu, "gc_union_columnar_lexn", no_kernel)
    alive = torch.ones(R, dtype=torch.bool)
    col, _ = engines(swarm, alive)
    assert not tre._fused(col.columnar)
    peers = peer_draw(9)
    want, want_nu = jax_pull(gc_j(swarm), peers, alive.numpy())
    out, nu = col.gossip_round(torch.from_numpy(peers))
    assert_gc(want, out.rows())
    np.testing.assert_array_equal(want_nu, nu.numpy())
    out.gc_barrier()


@pytest.mark.parametrize("n_keys, c, n_writers, plan", [
    (18, 1024, 16, (8, 0, 1)),    # the gc cell: one CTA of 1,024 threads an SM
    (18, 512, 16, (8, 0, 2)),
    (18, 64, 16, (8, 0, 8)),
    (18, 2048, 16, None),         # 18 words at C = 2048: the union is striped
    (18, 1024, 7_280, (8, 0, 1)),  # the widest floors that fit at C = 1024 ...
    (18, 1024, 7_281, None),      # ... one writer more does not
    (31, 64, 4, None),            # 31 keys and 2 values pass the 32 planes a launch
])
def test_gc_union_plan_at_the_h100_limit(n_keys, c, n_writers, plan):
    """Where the fused route takes the GC join: the wide body's layout
    plus a floor word a writer a side within the card's 232,448 B, the
    planes within a launch's, 2C within its threads' reach; elsewhere the
    composition serves (on the card too)."""
    assert hu.lexn_gc_union_plan(n_keys, 2, c, n_writers, hu.HOPPER_SMEM_OPTIN) == plan
    smem = hu.lexn_gc_union_smem_bytes(n_keys, c, n_writers)
    assert smem == hu.lexn_wide_smem_bytes(n_keys, c) + 8 * n_writers
    if plan is None and n_keys + 2 <= hu.MAX_PLANES:
        assert smem > hu.HOPPER_SMEM_OPTIN


@pytest.mark.parametrize("i", range(len(PLANTED_COUNTS[0])))
def test_planted_joins_on_the_twin_match_jax(i):
    """The planted cases of the card's tests (lane 0: a union of 12 rows
    that fits C = 8 only after the floor rule) on the twin: the pairwise GC
    join equals the JAX package's ``tomb_gc.join_checked`` and the port's
    generic one, and the batch's unique and dropped counts are the planted
    ones."""
    a, b = planted_pairs()
    want, want_nu = jgc.join_checked(gc_j(lane(a, i)), gc_j(lane(b, i)), JAD)
    got, nu = tre.gc_join_checked(lane(a, i), lane(b, i))
    assert_gc(want, got)
    assert int(nu) == int(want_nu) == PLANTED_COUNTS[0][i]
    gen, gen_nu = tgc.join_checked(lane(a, i), lane(b, i), TAD)
    assert_gc(want, gen)
    assert int(gen_nu) == int(want_nu)
    _, n_unique, dropped = tre._gc_join(*staged_planted())
    assert (n_unique.tolist(), dropped.tolist()) == PLANTED_COUNTS


# ---- spans: opened only while a profiler records ------------------------------

GC_SPANS = {
    "rseq_engine.gc_gossip_round": None,
    "rseq_engine.gc_gossip_round.gather": "rseq_engine.gc_gossip_round",
    "rseq_engine.gc_gossip_round.union": "rseq_engine.gc_gossip_round",
    "rseq_engine.gc_gossip_round.suppress": "rseq_engine.gc_gossip_round",
    "rseq_engine.gc_gossip_round.gate": "rseq_engine.gc_gossip_round",
    "rseq_engine.gc_barrier": None,
    "rseq_engine.gc_converge": "rseq_engine.gc_barrier",
    "rseq_engine.gc_barrier.floor": "rseq_engine.gc_barrier",
    "rseq_engine.gc_barrier.collect": "rseq_engine.gc_barrier",
    "rseq_engine.gc_barrier.broadcast": "rseq_engine.gc_barrier",
}


def _round_and_barrier(sw, peers):
    out, nu = sw.gossip_round(peers)
    return (out, nu) + out.gc_barrier_checked()


def test_gc_spans_open_only_under_a_profiler(swarm, monkeypatch, tmp_path):
    opened = []
    real = tracing.record_function
    monkeypatch.setattr(tracing, "record_function",
                        lambda name: opened.append(name) or real(name))
    sw, _ = engines(swarm, torch.ones(R, dtype=torch.bool))
    peers = torch.from_numpy(peer_draw(8))
    untraced = _round_and_barrier(sw, peers)
    assert opened == []
    with tracing.trace_to(str(tmp_path)):
        traced = _round_and_barrier(sw, peers)
    # and the union dispatcher's own span, once a union
    assert set(opened) == set(GC_SPANS) | {"crdt.union_lexn"}
    spans = {}
    [path] = list(tmp_path.glob("*.json"))
    for e in json.loads(path.read_text())["traceEvents"]:
        if e.get("cat") == "user_annotation" and e.get("ph") == "X":
            spans.setdefault(e["name"], []).append((e["ts"], e["ts"] + e.get("dur", 0)))
    for name, parent in GC_SPANS.items():
        assert len(spans[name]) == 1, name
        if parent is not None:
            (start, end), = spans[name]
            assert spans[parent][0][0] <= start and end <= spans[parent][0][1], name
    assert_gc(gc_j(untraced[2].rows()), traced[2].rows())
    for a, b in zip(untraced[1:], traced[1:]):
        if isinstance(a, torch.Tensor):
            assert torch.equal(a, b)
