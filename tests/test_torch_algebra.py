"""The port's CRDT algebra (crdt_tpu_torch.ops.algebra, models.composite)
and the OR-Map with its epoch-reset GC (models.ormap, models.ormap_gc)
against the JAX package on tests/test_algebra.py's, tests/test_ormap.py's
and tests/test_gc_soak.py's op traces: the four combinators and the four
composites, ``.at[]`` index rules, reset barriers and the convert
carriers.  Zero tolerance."""
import dataclasses
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crdt_tpu.models import composite as jcomp
from crdt_tpu.models import lww as jlww
from crdt_tpu.models import mvregister as jmv
from crdt_tpu.models import ormap as jom
from crdt_tpu.models import ormap_gc as jomg
from crdt_tpu.models import orset as jorset
from crdt_tpu.models import pncounter as jpn
from crdt_tpu.ops import joins as jjoins
from crdt_tpu.parallel import swarm as jswarm
from crdt_tpu_torch import convert
from crdt_tpu_torch.models import composite as tcomp
from crdt_tpu_torch.models import gcounter as tgc
from crdt_tpu_torch.models import lww as tlww
from crdt_tpu_torch.models import mvregister as tmv
from crdt_tpu_torch.models import ormap as tom
from crdt_tpu_torch.models import ormap_gc as tomg
from crdt_tpu_torch.models import orset as torset
from crdt_tpu_torch.models import pncounter as tpn
from crdt_tpu_torch.models.composite import Pair
from crdt_tpu_torch.ops import algebra, joins
from crdt_tpu_torch.ops import randstate as rs
from crdt_tpu_torch.parallel import swarm as tswarm
from crdt_tpu_torch.utils.tree import leaves, tree_map

CPU = "cpu"


def _np(x):
    if dataclasses.is_dataclass(x):
        return {f.name: _np(getattr(x, f.name)) for f in dataclasses.fields(x)}
    if isinstance(x, dict):
        return {k: _np(v) for k, v in x.items()}
    if isinstance(x, torch.Tensor):
        return x.numpy()
    if isinstance(x, (int, bool)):
        return x
    return np.asarray(x)


def assert_same(want, got):
    want, got = _np(want), _np(got)
    if isinstance(want, dict):
        assert want.keys() == got.keys()
        for k in want:
            assert_same(want[k], got[k])
    elif isinstance(want, int):
        assert want == got
    else:
        assert want.dtype == got.dtype, (want.dtype, got.dtype)
        np.testing.assert_array_equal(want, got)


def equal(x, y) -> bool:
    return all(torch.equal(a, b) for a, b in zip(leaves(x), leaves(y)))


def _spec(name):
    return joins.registered_joins()[name]


def _jspec(name):
    return jjoins.registered_joins()[name]


# ---- combinators and metadata ----


def test_product_of_new_parts_registers_with_derived_metadata():
    """tests/test_algebra.py's product over a non-commutative part: the
    claim is the AND, neutral and rand derive from the parts."""
    name = "product(gcounter,lww)"
    try:
        spec = algebra.product("gcounter", "lww")
        assert spec.name == name and spec.parts == ("gcounter", "lww")
        assert not spec.structurally_commutative and spec.combinator == "product"
        n = spec.neutral(device=CPU)
        assert equal(n.fst, tgc.zero(8, device=CPU)) and equal(n.snd, tlww.zero(device=CPU))
        assert equal(spec.join(n, n), n)
        rng_j, rng_t = np.random.default_rng(4), np.random.default_rng(4)
        assert name not in jjoins.registered_joins()  # the JAX registry is not touched
        want = jcomp.Pair(fst=jjoins.registered_joins()["gcounter"].rand(rng_j),
                          snd=jjoins.registered_joins()["lww"].rand(rng_j))
        assert_same(want, spec.rand(rng_t, device=CPU))
    finally:
        joins._JOIN_REGISTRY.pop(name, None)


def test_resolve_unknown_part_raises():
    with pytest.raises(KeyError):
        algebra.product("pncounter", "no_such_lattice")


def test_act_and_rank_side_tables():
    assert algebra.act_of("semidirect(gcounter,pncounter)") is tcomp.reset_act
    assert algebra.rank_of("lexicographic(lww,mvregister)") is tcomp.lww_rank
    assert algebra.act_of("gcounter") is None and algebra.rank_of("gcounter") is None


# ---- mapof <-> ormap ----


def _rand_trace(rng, n_ops, n_keys, n_writers):
    ops = []
    for _ in range(n_ops):
        key = int(rng.integers(0, n_keys))
        writer = int(rng.integers(0, n_writers))
        if rng.random() < 0.25:
            ops.append(("rem", key, writer, 0))
        else:
            ops.append(("upd", key, writer, int(rng.integers(-9, 10))))
    return ops


def _apply_trace(om, pn, state, ops):
    for op, key, writer, delta in ops:
        if op == "rem":
            state = om.remove(state, key, writer)
        else:
            state = om.update(state, key, writer,
                              lambda v, _w=writer, _d=delta: pn.add(v, _w, _d))
    return state


def test_mapof_pncounter_matches_jax_and_the_bespoke_ormap():
    """tests/test_algebra.py's trace parity: the composed join on states
    built from seeded traces equals JAX's and the port's bespoke
    ``ormap.joiner``, with equal contains and counter values."""
    spec, jspec = _spec("mapof(pncounter)"), _jspec("mapof(pncounter)")
    n_keys, n_writers = 4, 3
    bespoke = tom.joiner(tpn.join)
    rng = np.random.default_rng(42)
    for _ in range(10):
        tr_a = _rand_trace(rng, 12, n_keys, n_writers)
        tr_b = _rand_trace(rng, 12, n_keys, n_writers)
        je = jom.empty(n_keys, n_writers, jpn.zero(n_writers))
        te = tom.empty(n_keys, n_writers, tpn.zero(n_writers, device=CPU), device=CPU)
        ja, jb = _apply_trace(jom, jpn, je, tr_a), _apply_trace(jom, jpn, je, tr_b)
        a, b = _apply_trace(tom, tpn, te, tr_a), _apply_trace(tom, tpn, te, tr_b)
        assert_same(ja, a)
        want = jspec.join(ja, jb)
        got = spec.join(a, b)
        assert_same(want, got)
        assert equal(got, bespoke(a, b))
        assert_same(jom.contains(want), tom.contains(got))
        assert_same(jpn.value(want.values), tpn.value(got.values))


def test_mapof_join_is_shape_generic():
    spec = _spec("mapof(pncounter)")
    e = tom.empty(6, 2, tpn.zero(2, device=CPU), device=CPU)
    a = tom.update(e, 5, 1, lambda v: tpn.add(v, 1, 7))
    b = tom.update(e, 0, 0, lambda v: tpn.add(v, 0, -2))
    m = spec.join(a, b)
    assert tom.contains(m).tolist() == [True, False, False, False, False, True]
    assert tpn.value(m.values).tolist() == [-2, 0, 0, 0, 0, 7]


# ---- lexicographic ----


def test_lexicographic_dominance_and_tiebreak_match_jax():
    spec, jspec = _spec("lexicographic(lww,mvregister)"), _jspec("lexicographic(lww,mvregister)")

    def both(fn_j, fn_t, *args):
        return fn_j(*args), fn_t(*args)

    jhi = jlww.write(jlww.zero(), ts=20, rid=1, payload=7)
    jlo = jlww.write(jlww.zero(), ts=10, rid=2, payload=8)
    hi = tlww.write(tlww.zero(device=CPU), ts=20, rid=1, payload=7)
    lo = tlww.write(tlww.zero(device=CPU), ts=10, rid=2, payload=8)
    jma = jmv.write(jmv.zero(4), writer=0, ts=20, payload=70)
    jmb = jmv.write(jmv.zero(4), writer=1, ts=10, payload=80)
    ma = tmv.write(tmv.zero(4, device=CPU), writer=0, ts=20, payload=70)
    mb = tmv.write(tmv.zero(4, device=CPU), writer=1, ts=10, payload=80)
    cases = [((jhi, jma), (jlo, jmb), (hi, ma), (lo, mb)),
             ((jlo, jmb), (jhi, jma), (lo, mb), (hi, ma)),
             ((jhi, jma), (jhi, jmb), (hi, ma), (hi, mb)),   # equal rank: the b-parts join
             ((jlo, jmb), (jlo, jma), (lo, mb), (lo, ma))]
    for (jx, jy, tx, ty) in cases:
        want = jspec.join(jcomp.Pair(*jx), jcomp.Pair(*jy))
        got = spec.join(Pair(*tx), Pair(*ty))
        assert_same(want, got)
    out = spec.join(Pair(hi, ma), Pair(lo, mb))
    assert equal(out.fst, hi) and equal(out.snd, ma)
    tie = spec.join(Pair(hi, ma), Pair(hi, mb))
    assert equal(tie.snd, tmv.join(ma, mb)) and int(tmv.n_siblings(tie.snd)) == 2
    # rank is the packed (ts, rid) key, ties compared in int32
    assert int(tcomp.lww_rank(hi)) == int(jcomp.lww_rank(jhi))


# ---- semidirect ----


def test_semidirect_epoch_reset_counter_matches_jax():
    spec, jspec = _spec("semidirect(gcounter,pncounter)"), _jspec("semidirect(gcounter,pncounter)")
    for comp, sp, kw in ((jcomp, jspec, {}), (tcomp, spec, {"device": CPU})):
        zero = sp.neutral(**kw)
        a = comp.epoch_add(zero, node=0, amount=5)
        b = comp.epoch_add(comp.epoch_bump(zero, node=1), node=1, amount=3)
        merged = sp.join(a, b)
        c = comp.epoch_add(merged, node=0, amount=4)
        vals = [int(comp.epoch_value(x)) for x in (merged, sp.join(merged, c), sp.join(c, a))]
        assert vals == [3, 7, 7]
        if comp is jcomp:
            want = (merged, sp.join(c, a))
        else:
            assert_same(want[0], merged)
            assert_same(want[1], sp.join(c, a))


def test_semidirect_act_laws():
    """identity, composition along monotone frame chains,
    join-homomorphism (tests/test_algebra.py), on the port."""
    rng = np.random.default_rng(9)
    act = tcomp.reset_act
    for _ in range(20):
        f1 = rs.rand_gcounter(rng, device=CPU)
        f2 = tgc.join(f1, rs.rand_gcounter(rng, device=CPU))
        f3 = tgc.join(f2, rs.rand_gcounter(rng, device=CPU))
        b1, b2 = rs.rand_pncounter(rng, device=CPU), rs.rand_pncounter(rng, device=CPU)
        assert equal(act(f1, f1, b1), b1), "identity"
        assert equal(act(f3, f2, act(f2, f1, b1)), act(f3, f1, b1)), "composition"
        assert equal(act(f3, f1, tpn.join(b1, b2)),
                     tpn.join(act(f3, f1, b1), act(f3, f1, b2))), "join-homomorphism"


@pytest.mark.parametrize("name", ["mapof(pncounter)", "lexicographic(lww,mvregister)",
                                  "semidirect(gcounter,pncounter)",
                                  "product(gcounter,pncounter)"])
def test_converge_composite_from_registry_matches_jax(name):
    """tests/test_algebra.py's registry-driven converge: every replica on
    the same least upper bound, dominating each input, equal to JAX's."""
    spec, jspec = _spec(name), _jspec(name)
    rj, rt = np.random.default_rng(3), np.random.default_rng(3)
    js = [jspec.rand(rj) for _ in range(5)]
    ts = [spec.rand(rt, device=CPU) for _ in range(5)]
    want = jjoins.converge(name, jax.tree.map(lambda *xs: jnp.stack(xs), *js))
    out = joins.converge(name, tree_map(lambda *xs: torch.stack(xs), *ts))
    assert_same(want, out)
    first = tree_map(lambda x: x[0], out)
    for s in ts:
        assert equal(spec.join(first, s), first)


# ---- ormap ----

K, W, NODES = 6, 4, 4
KEYS = [0, K - 1, -1, -K, K, -K - 1]
WRITERS = [0, W - 1, -1, W, -W - 1]


def _empties():
    return (jom.empty(K, W, jpn.zero(NODES)),
            tom.empty(K, W, tpn.zero(NODES, device=CPU), device=CPU))


@pytest.mark.parametrize("key", KEYS)
def test_ormap_ops_follow_jax_index_rules(key):
    """update / remove / get at in-range, wrapped and out-of-range keys and
    writers: a negative index wraps once, an out-of-range update drops,
    ``get`` clamps as JAX's gather does."""
    je, te = _empties()
    je = jom.update(je, 2, 1, lambda v: jpn.add(v, 1, 5))
    te = tom.update(te, 2, 1, lambda v: tpn.add(v, 1, 5))
    for w in WRITERS:
        ju = jom.update(je, key, w, lambda v, _w=w: jpn.add(v, _w % NODES, -3))
        tu = tom.update(te, key, w, lambda v, _w=w: tpn.add(v, _w % NODES, -3))
        assert_same(ju, tu)
        jr, tr = jom.remove(ju, key, w), tom.remove(tu, key, w)
        assert_same(jr, tr)
        assert_same(jom.contains(jr), tom.contains(tr))
    assert_same(jom.get(je, key), tom.get(te, key))


def test_ormap_scripts_match_jax():
    """tests/test_ormap.py's add-wins, accumulate-on-re-add, LWW-valued and
    OR-Set-valued maps, on both packages."""
    je, te = _empties()
    jpj, tpj = jom.joiner(jpn.join), tom.joiner(tpn.join)
    jb = jom.update(je, 1, 0, lambda v: jpn.add(v, 0, 7))
    tb = tom.update(te, 1, 0, lambda v: tpn.add(v, 0, 7))
    ja, ta = jom.remove(jb, 1, 1), tom.remove(tb, 1, 1)
    jc = jom.update(jb, 1, 2, lambda v: jpn.add(v, 2, 1))
    tc = tom.update(tb, 1, 2, lambda v: tpn.add(v, 2, 1))
    jm, tm = jpj(ja, jc), tpj(ta, tc)
    assert_same(jm, tm)
    assert bool(tom.contains(tm)[1]) and int(tpn.value(tom.get(tm, 1))) == 8
    assert_same(jom.remove(jm, 1, 1), tom.remove(tm, 1, 1))
    # a removed key's value accumulates; a re-add surfaces it
    jx = jom.update(jom.remove(jom.update(je, 3, 0, lambda v: jpn.add(v, 0, 10)), 3, 0),
                    3, 0, lambda v: jpn.add(v, 0, 1))
    tx = tom.update(tom.remove(tom.update(te, 3, 0, lambda v: tpn.add(v, 0, 10)), 3, 0),
                    3, 0, lambda v: tpn.add(v, 0, 1))
    assert_same(jx, tx) and int(tpn.value(tom.get(tx, 3))) == 11
    # LWW values
    jl = jom.joiner(jlww.join)
    tl = tom.joiner(tlww.join)
    jm1 = jom.update(jom.empty(K, W, jlww.zero()), 0, 1,
                     lambda v: jlww.write(v, ts=10, rid=1, payload=111))
    jm2 = jom.update(jom.empty(K, W, jlww.zero()), 0, 2,
                     lambda v: jlww.write(v, ts=11, rid=2, payload=222))
    tm1 = tom.update(tom.empty(K, W, tlww.zero(device=CPU), device=CPU), 0, 1,
                     lambda v: tlww.write(v, ts=10, rid=1, payload=111))
    tm2 = tom.update(tom.empty(K, W, tlww.zero(device=CPU), device=CPU), 0, 2,
                     lambda v: tlww.write(v, ts=11, rid=2, payload=222))
    assert_same(jl(jm1, jm2), tl(tm1, tm2))
    assert int(tom.get(tl(tm1, tm2), 0).payload) == 222
    # OR-Set values: the batched value join is the set join over [K, C]
    jo = jom.joiner(jax.vmap(jorset.join))
    to = tom.joiner(torset.join)
    ja = jom.update(jom.empty(K, W, jorset.empty(8)), 2, 0,
                    lambda s: jorset.add(jorset.add(s, 5, 0, 0), 6, 0, 1))
    jb2 = jom.update(jom.empty(K, W, jorset.empty(8)), 2, 1,
                     lambda s: jorset.add(jorset.add(s, 6, 1, 0), 7, 1, 1))
    ta = tom.update(tom.empty(K, W, torset.empty(8, device=CPU), device=CPU), 2, 0,
                    lambda s: torset.add(torset.add(s, 5, 0, 0), 6, 0, 1))
    tb2 = tom.update(tom.empty(K, W, torset.empty(8, device=CPU), device=CPU), 2, 1,
                     lambda s: torset.add(torset.add(s, 6, 1, 0), 7, 1, 1))
    assert_same(jo(ja, jb2), to(ta, tb2))
    assert_same(jo(jb2, ja), to(tb2, ta))


def test_ormap_joiner_recorded_tallies_the_path():
    from crdt_tpu_torch.ops import union_engine

    _, te = _empties()
    before = union_engine.union_path_counts().get("sort", 0)
    tom.joiner_recorded(tpn.join)(te, te)
    assert union_engine.union_path_counts()["sort"] == before + 1


def test_ormap_swarm_converge_matches_jax():
    """tests/test_ormap.py's swarm converge: one writer's update reaches
    every replica."""
    rows_j, rows_t = [], []
    for r in range(4):
        je, te = _empties()
        if r == 2:
            je = jom.update(je, 0, r, lambda v: jpn.add(v, r, r + 1))
            te = tom.update(te, 0, r, lambda v: tpn.add(v, r, r + 1))
        rows_j.append(je)
        rows_t.append(te)
    jsw = jswarm.converge(jswarm.make(jax.tree.map(lambda *xs: jnp.stack(xs), *rows_j)),
                          jax.vmap(jom.joiner(jpn.join)), _empties()[0])
    tsw = tswarm.converge(tswarm.make(tree_map(lambda *xs: torch.stack(xs), *rows_t)),
                          tom.joiner(tpn.join), _empties()[1])
    assert_same(jsw.state, tsw.state)


# ---- ormap_gc ----


def _mk_mapgc(seed):
    """tests/test_gc_soak.py's test_map_gc_join_laws state: 12 seeded ops
    and a reset mask, in both packages."""
    rng = random.Random(seed)
    jz, tz = jpn.zero(3), tpn.zero(3, device=CPU)
    jg = jomg.wrap(jom.empty(6, 3, jz))
    tg = tomg.wrap(tom.empty(6, 3, tz, device=CPU), device=CPU)
    for _ in range(12):
        k, w = rng.randrange(6), rng.randrange(3)
        if rng.random() < 0.7:
            d = rng.randint(-4, 4)
            jg = jomg.update(jg, k, w, lambda v: jpn.add(v, w, d))
            tg = tomg.update(tg, k, w, lambda v: tpn.add(v, w, d))
        else:
            jg = jomg.remove(jg, k, w)
            tg = tomg.remove(tg, k, w)
    mask = [rng.random() < 0.3 for _ in range(6)]
    return (jomg.reset_keys(jg, jnp.asarray(mask), jz),
            tomg.reset_keys(tg, torch.tensor(mask), tz))


def test_mapgc_epoch_join_and_laws_match_jax():
    """The epoch-guarded join on mixed epochs: equal to JAX's, and ACI
    with absorption on the port."""
    (ja, a), (jb, b), (jc, c) = _mk_mapgc(1), _mk_mapgc(2), _mk_mapgc(3)
    for x, y in ((ja, a), (jb, b), (jc, c)):
        assert_same(x, y)
    jj = lambda x, y: jomg.join(x, y, jax.vmap(jpn.join))
    tj = lambda x, y: tomg.join(x, y, tpn.join)
    assert_same(jj(ja, jb), tj(a, b))
    assert_same(jj(jj(ja, jb), jc), tj(tj(a, b), c))
    assert equal(tj(a, b), tj(b, a))
    assert equal(tj(tj(a, b), c), tj(a, tj(b, c)))
    assert equal(tj(a, a), a) and equal(tj(tj(a, b), b), tj(a, b))
    assert_same(jomg.contains(ja), tomg.contains(a))
    assert_same(jomg.get(ja, 4), tomg.get(a, 4))


@pytest.mark.parametrize("dead", [None, 1])
def test_reset_barrier_matches_jax(dead):
    """ormap_gc.reset_barrier over a 3-replica swarm: with everyone alive
    the converged removals reset (epochs bumped, planes pristine), with a
    dead member the full-fleet rule makes it a no-op."""
    states = [_mk_mapgc(s) for s in (4, 5, 6)]
    # replica 0 learns everything and then removes keys 0 and 1: those
    # removals are in the converged state
    jl, tl = states[0]
    for jx, tx in states[1:]:
        jl, tl = jomg.join(jl, jx, jax.vmap(jpn.join)), tomg.join(tl, tx, tpn.join)
    for k in (0, 1):
        jl, tl = jomg.remove(jl, k, 0), tomg.remove(tl, k, 0)
    states[0] = (jl, tl)
    alive = [i != dead for i in range(3)]
    jsw, jn = jomg.reset_barrier(
        jswarm.make(jax.tree.map(lambda *xs: jnp.stack(xs), *[s[0] for s in states]),
                    jnp.asarray(alive)), jax.vmap(jpn.join), jpn.zero(3))
    tsw, tn = tomg.reset_barrier(
        tswarm.make(tree_map(lambda *xs: torch.stack(xs), *[s[1] for s in states]),
                    torch.tensor(alive)), tpn.join, tpn.zero(3, device=CPU))
    assert jn == tn
    assert (tn > 0) == (dead is None)
    assert_same(jsw.state, tsw.state)


def test_convert_carriers_round_trip_and_take_jax_states():
    """VVClock, ORMap, MapGc and Pair carriers: from JAX states as numpy
    and back, generic over the parts."""
    ja, a = _mk_mapgc(7)
    d = {"map": {"presence": {"tok": np.asarray(ja.map.presence.tok),
                              "obs": np.asarray(ja.map.presence.obs)},
                 "values": {"pos": np.asarray(ja.map.values.pos),
                            "neg": np.asarray(ja.map.values.neg)}},
         "epoch": np.asarray(ja.epoch)}
    got = convert.mapgc_from_numpy(d, convert.pncounter_from_numpy, device=CPU)
    assert equal(got, a)
    back = convert.mapgc_to_numpy(got, convert.pncounter_to_numpy)
    assert equal(convert.mapgc_from_numpy(back, convert.pncounter_from_numpy, device=CPU), a)
    assert equal(convert.ormap_from_numpy(d["map"], convert.pncounter_from_numpy, device=CPU),
                 a.map)
    p = rs.rand_pncounter(np.random.default_rng(1), device=CPU)
    g = rs.rand_gcounter(np.random.default_rng(2), device=CPU)
    pd = convert.pair_to_numpy(Pair(g, p), convert.gcounter_to_numpy, convert.pncounter_to_numpy)
    assert equal(convert.pair_from_numpy(pd, convert.gcounter_from_numpy,
                                         convert.pncounter_from_numpy, device=CPU), Pair(g, p))
