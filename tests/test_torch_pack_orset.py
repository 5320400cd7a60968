"""The port's tag packing, OR-Set, G-Set / 2P-Set, their numpy carriers and
the OR-Set swarm workload (crdt_tpu_torch.ops.pack, models.orset,
models.gset, convert, workload) against the JAX package, bit for bit on
seeded inputs."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crdt_tpu.models import gset as jgs
from crdt_tpu.models import orset as jos
from crdt_tpu.ops import pack as jpack
from crdt_tpu.ops import union_engine as jue
from crdt_tpu_torch import convert, workload
from crdt_tpu_torch.models import gset as tgs
from crdt_tpu_torch.models import orset as tos
from crdt_tpu_torch.ops import pack as tpack
from crdt_tpu_torch.ops import union_engine as tue

S = 2**31 - 1
FIELDS = ("elem", "rid", "seq", "removed")


# ---- pack -------------------------------------------------------------------


def test_pack_and_unpack_match_including_wrapping_padding():
    rng = np.random.default_rng(0)
    cols = [rng.integers(0, 1 << b, 200).astype(np.int32) for b in (14, 6, 11)]
    for c in cols:
        c[:3] = [S, 0, (1 << 13)]      # padding rows wrap in both packages
    want = jpack.pack_tags(*map(jnp.asarray, cols))
    got = tpack.pack_tags(*map(torch.from_numpy, cols))
    np.testing.assert_array_equal(np.asarray(want), got.numpy())
    for w, g in zip(jpack.unpack_tags(want), tpack.unpack_tags(got)):
        np.testing.assert_array_equal(np.asarray(w), g.numpy())
    assert int(tpack.pack_tags(*(torch.tensor(x) for x in (16383, 63, 2047)))) == S


@pytest.mark.parametrize("field, value", [
    ("elem", 1 << 14), ("rid", 64), ("seq", 1 << 11), ("rid", -1), ("elem", -7),
])
def test_pack_tags_checked_raises_the_same_error(field, value):
    cols = {f: np.array([1, 2], np.int32) for f in ("elem", "rid", "seq")}
    cols[field][1] = value
    with pytest.raises(ValueError) as want:
        jpack.pack_tags_checked(cols["elem"], cols["rid"], cols["seq"])
    with pytest.raises(ValueError) as got:
        tpack.pack_tags_checked(*(torch.from_numpy(cols[f]) for f in ("elem", "rid", "seq")))
    assert str(got.value) == str(want.value)


def test_pack_tags_checked_exempts_padding_and_empty():
    elem, rid, seq = (np.array(x, np.int32) for x in ([3, 1 << 20], [2, 99], [7, -5]))
    valid = np.array([True, False])
    want = jpack.pack_tags_checked(elem, rid, seq, valid=valid)
    got = tpack.pack_tags_checked(torch.from_numpy(elem), torch.from_numpy(rid),
                                  torch.from_numpy(seq), valid=torch.from_numpy(valid))
    np.testing.assert_array_equal(np.asarray(want), got.numpy())
    empty = torch.zeros((0,), dtype=torch.int32)
    assert tpack.pack_tags_checked(empty, empty, empty).numel() == 0


def test_check_budget():
    tpack.check_budget(1 << 14, 1 << 6, 1 << 11)
    for args in ((1 << 14 | 1, 1, 1), (1, 65, 1), (1, 1, 2049)):
        with pytest.raises(ValueError, match="exceeds the packed budget"):
            tpack.check_budget(*args)
        with pytest.raises(ValueError, match="exceeds the packed budget"):
            jpack.check_budget(*args)


# ---- the single-instance OR-Set ----------------------------------------------


def _ops(rng, n_ops, n_elems=8):
    """A seeded script of adds (fresh tags) and removes."""
    ops, seqs = [], {}
    for _ in range(n_ops):
        if rng.random() < 0.7:
            rid = int(rng.integers(0, 4))
            seqs[rid] = seqs.get(rid, -1) + 1
            ops.append(("add", int(rng.integers(0, n_elems)), rid, seqs[rid]))
        else:
            ops.append(("remove", int(rng.integers(0, n_elems))))
    return ops


def _apply(mod, s, ops):
    for op in ops:
        s = mod.add(s, *op[1:]) if op[0] == "add" else mod.remove(s, op[1])
    return s


def _both_sets(seed, cap=16, n_ops=10):
    ops = _ops(np.random.default_rng(seed), n_ops)
    return _apply(jos, jos.empty(cap), ops), _apply(tos, tos.empty(cap, device="cpu"), ops)


def _assert_set(j, t, fields=FIELDS):
    got = convert.orset_to_numpy(t) if isinstance(t, tos.ORSet) else {
        f: getattr(t, f).numpy() for f in fields}
    for f in fields:
        np.testing.assert_array_equal(np.asarray(getattr(j, f)), got[f], err_msg=f)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_orset_ops_and_join_match(seed):
    ja, ta = _both_sets(seed)
    jb, tb = _both_sets(seed + 100)
    _assert_set(ja, ta)
    _assert_set(jos.join(ja, jb), tos.join(ta, tb))
    jj, jn = jos.join_checked(ja, jb)
    tj, tn = tos.join_checked(ta, tb)
    _assert_set(jj, tj)
    assert int(jn) == int(tn)
    assert int(jos.size(ja)) == int(tos.size(ta))
    for e in range(9):
        assert bool(jos.contains(ja, e)) == bool(tos.contains(ta, e))
    np.testing.assert_array_equal(np.asarray(jos.member_mask(jj, 6)),
                                  tos.member_mask(tj, 6).numpy())
    _assert_set(jos.grow(ja, 24), tos.grow(ta, 24))
    with pytest.raises(ValueError, match="shrink"):
        tos.grow(ta, 8)


def test_orset_batched_join_matches_vmap():
    pairs = [_both_sets(s, cap=8, n_ops=6) for s in range(6)]
    stack_j = [jax.tree.map(lambda *x: jnp.stack(x), *[p[0] for p in pairs[k::2]])
               for k in (0, 1)]
    stack_t = [tos.ORSet(*(torch.stack([getattr(p[1], f) for p in pairs[k::2]])
                           for f in FIELDS)) for k in (0, 1)]
    want, wn = jax.vmap(jos.join_checked)(*stack_j)
    got, gn = tos.join_checked(*stack_t)
    _assert_set(want, got)
    np.testing.assert_array_equal(np.asarray(wn), gn.numpy())


def test_orset_join_strict_raises_and_tallies():
    tue.reset_tallies()
    a = tos.add(tos.add(tos.empty(2, device="cpu"), 1, 0, 0), 2, 0, 1)
    b = tos.add(tos.empty(2, device="cpu"), 3, 1, 0)
    with pytest.raises(tue.UnionOverflow, match="3 rows > capacity 2"):
        tos.join_strict(a, b)
    assert tue.truncation_count() == 1
    _assert_set(tos.join_strict(a, a), a)
    assert tue.truncation_count() == 1


def test_gc_adapter_matches():
    ja, ta = _both_sets(5)
    mask_np = np.arange(16) % 3 == 0
    for name in ("key_cols", "rid_seq"):
        for w, g in zip(getattr(jos.GC_ADAPTER, name)(ja), getattr(tos.GC_ADAPTER, name)(ta)):
            np.testing.assert_array_equal(np.asarray(w), g.numpy())
    for name in ("vals", "valid", "removed_of"):
        np.testing.assert_array_equal(np.asarray(getattr(jos.GC_ADAPTER, name)(ja)),
                                      getattr(tos.GC_ADAPTER, name)(ta).numpy())
    np.testing.assert_array_equal(
        np.asarray(jos.GC_ADAPTER.vals_zero_like(ja, jnp.asarray(mask_np))),
        tos.GC_ADAPTER.vals_zero_like(ta, torch.from_numpy(mask_np)).numpy())
    assert tos.GC_ADAPTER.capacity_of(ta) == jos.GC_ADAPTER.capacity_of(ja) == 16
    keys = tos.GC_ADAPTER.key_cols(ta)
    _assert_set(ja, tos.GC_ADAPTER.from_union(keys, tos.GC_ADAPTER.combine(
        ta.removed, torch.zeros_like(ta.removed))))


# ---- the columnar swarm path --------------------------------------------------


def _swarm(seed, n, cap=16):
    sets = [_both_sets(seed * 100 + r, cap=cap, n_ops=int(4 + r % 5)) for r in range(n)]
    return [s[0] for s in sets], [s[1] for s in sets]


def test_stack_to_columnar_matches_list_batched_and_single():
    js, ts = _swarm(1, 5)
    _assert_columnar(jos.stack_to_columnar(js), tos.stack_to_columnar(ts))
    batched = tos.ORSet(*(torch.stack([getattr(s, f) for s in ts]) for f in FIELDS))
    _assert_columnar(jos.stack_to_columnar(js), tos.stack_to_columnar(batched))
    _assert_columnar(jos.stack_to_columnar(js[2]), tos.stack_to_columnar(ts[2]))


def _assert_columnar(want, got):
    for w, g in zip(want, got):
        np.testing.assert_array_equal(np.asarray(w), g.numpy())


def test_stack_to_columnar_rejects_over_budget_tags():
    s = tos.add(tos.empty(8, device="cpu"), 5, 1, (1 << 11) + 3)
    with pytest.raises(ValueError, match="seq"):
        tos.stack_to_columnar([s])
    s = tos.add(tos.empty(8, device="cpu"), 1, 999, 0)
    with pytest.raises(ValueError, match="rid"):
        tos.stack_to_columnar(s)


def test_columnar_join_and_member_mask_match():
    js_a, ts_a = _swarm(2, 128)
    js_b, ts_b = _swarm(3, 128)
    ja, jb = jos.stack_to_columnar(js_a), jos.stack_to_columnar(js_b)
    ta, tb = tos.stack_to_columnar(ts_a), tos.stack_to_columnar(ts_b)
    want = jos.columnar_join(*ja, *jb, out_size=16, interpret=True)
    got = tos.columnar_join(*ta, *tb, out_size=16)
    _assert_columnar(want, got)
    np.testing.assert_array_equal(np.asarray(jos.columnar_member_mask(*want[:2], 10)),
                                  tos.columnar_member_mask(*got[:2], 10).numpy())


def test_columnar_join_engines_on_ragged_lanes():
    js_a, ts_a = _swarm(4, 5)
    js_b, ts_b = _swarm(5, 5)
    ja, jb = jos.stack_to_columnar(js_a), jos.stack_to_columnar(js_b)
    ta, tb = tos.stack_to_columnar(ts_a), tos.stack_to_columnar(ts_b)
    want = jos.columnar_join(*ja, *jb, out_size=16, interpret=True)
    tue.reset_tallies()
    for engine, universe in (("sort", None), ("bitmap", 1 << 20), ("auto", 1 << 20)):
        _assert_columnar(want, tos.columnar_join(*ta, *tb, out_size=16, engine=engine,
                                                 universe=universe))
    # a 2^20-tag universe is past the 32·C traffic bound at C=16: auto sorts
    assert tue.union_path_counts() == {"sort": 2, "bitmap": 1}


def test_sentinel_tag_is_padding_in_the_columnar_join():
    """(16383, 63, 2047) packs to SENTINEL: stack_to_columnar keeps its
    tombstone on the value plane in both packages; the join treats the row
    as padding (keys, n_unique equal; the port's padding values are 0)."""
    s = tos.remove(tos.add(tos.add(tos.empty(4, device="cpu"), 16383, 63, 2047), 3, 1, 1),
                   16383)
    j = jos.remove(jos.add(jos.add(jos.empty(4), 16383, 63, 2047), 3, 1, 1), 16383)
    want, got = jos.stack_to_columnar(j), tos.stack_to_columnar(s)
    _assert_columnar(want, got)
    assert got[0][1, 0] == S and got[1][1, 0] == 1
    jw = jos.columnar_join(*want, *want, interpret=True)
    tw = tos.columnar_join(*got, *got)
    np.testing.assert_array_equal(np.asarray(jw[0]), tw[0].numpy())
    np.testing.assert_array_equal(np.asarray(jw[2]), tw[2].numpy())
    assert tw[1].tolist() == [[0]] * 4 and int(tw[2][0]) == 1


# ---- resident layouts --------------------------------------------------------


def test_bitmap_resident_set_matches():
    ja, ta = _both_sets(7)
    jb, tb = _both_sets(8)
    universe = 1 << 20
    want = jos.bitmap_join(jos.to_bitmap(ja, universe), jos.to_bitmap(jb, universe))
    got = tos.bitmap_join(tos.to_bitmap(ta, universe), tos.to_bitmap(tb, universe))
    _assert_set(want, got, ("present", "removed"))
    assert int(jos.bitmap_size(want)) == int(tos.bitmap_size(got))
    assert got.universe == want.universe
    _assert_set(jos.from_bitmap(want, 16), tos.from_bitmap(got, 16))
    _assert_set(jos.join(ja, jb), tos.from_bitmap(got, 16))
    _assert_set(jos.bitmap_empty(100), tos.bitmap_empty(100, device="cpu"),
                ("present", "removed"))
    with pytest.raises(ValueError, match="universe"):
        tos.to_bitmap(ta, 64)


def test_bucketed_resident_set_matches():
    ja, ta = _both_sets(9)
    jb, tb = _both_sets(10)
    jba, tba = jos.to_bucketed(ja, 2, key_bits=20), tos.to_bucketed(ta, 2, key_bits=20)
    _assert_set(jba, tba, ("keys", "removed"))
    jbb, tbb = jos.to_bucketed(jb, 2, key_bits=20), tos.to_bucketed(tb, 2, key_bits=20)
    wj, wmax = jos.bucketed_join_checked(jba, jbb)
    gj, gmax = tos.bucketed_join_checked(tba, tbb)
    _assert_set(wj, gj, ("keys", "removed"))
    assert int(wmax) == int(gmax)
    _assert_set(jos.bucketed_join(jba, jbb), tos.bucketed_join(tba, tbb), ("keys", "removed"))
    _assert_set(jos.from_bucketed(wj), tos.from_bucketed(gj))
    _assert_set(jos.join(ja, jb), tos.from_bucketed(gj))
    _assert_set(jos.bucketed_empty(16, 4), tos.bucketed_empty(16, 4, device="cpu"),
                ("keys", "removed"))
    with pytest.raises(ValueError, match="equal layouts"):
        tos.bucketed_join(tba, tos.bucketed_empty(16, 4, device="cpu"))


def test_to_bucketed_refuses_bucket_overflow():
    tue.reset_tallies()
    s = tos.empty(8, device="cpu")
    for i in range(5):
        s = tos.add(s, 0, 0, i)
    with pytest.raises(tue.UnionOverflow, match="overflow their bucket"):
        tos.to_bucketed(s, 4, key_bits=20)
    assert tue.truncation_count() == 1


# ---- G-Set and 2P-Set ---------------------------------------------------------


def test_gset_and_twopset_match():
    rng = np.random.default_rng(11)
    jg, tg = jgs.g_empty(8), tgs.g_empty(8, device="cpu")
    jt, tt = jgs.tp_empty(8), tgs.tp_empty(8, device="cpu")
    for _ in range(12):
        e = int(rng.integers(0, 10))
        jg, tg = jgs.g_add(jg, e), tgs.g_add(tg, e)
        if rng.random() < 0.4:
            jt, tt = jgs.tp_remove(jt, e), tgs.tp_remove(tt, e)
        else:
            jt, tt = jgs.tp_add(jt, e), tgs.tp_add(tt, e)
        np.testing.assert_array_equal(np.asarray(jg.elem), tg.elem.numpy())
        np.testing.assert_array_equal(np.asarray(jt.elem), tt.elem.numpy())
        np.testing.assert_array_equal(np.asarray(jt.removed), tt.removed.numpy())
    jg2 = jgs.GSet(elem=jnp.asarray([1, 5, 9, S, S, S, S, S], jnp.int32))
    tg2 = tgs.GSet(elem=torch.tensor([1, 5, 9, S, S, S, S, S], dtype=torch.int32))
    np.testing.assert_array_equal(np.asarray(jgs.g_join(jg, jg2).elem),
                                  tgs.g_join(tg, tg2).elem.numpy())
    wj, wn = jgs.g_join_checked(jg, jg2)
    gj, gn = tgs.g_join_checked(tg, tg2)
    assert int(wn) == int(gn)
    jt2, tt2 = jgs.tp_remove(jgs.tp_empty(8), 5), tgs.tp_remove(tgs.tp_empty(8, device="cpu"), 5)
    for w, g in ((jgs.tp_join(jt, jt2), tgs.tp_join(tt, tt2)),
                 (jgs.tp_join_checked(jt, jt2)[0], tgs.tp_join_checked(tt, tt2)[0])):
        np.testing.assert_array_equal(np.asarray(w.elem), g.elem.numpy())
        np.testing.assert_array_equal(np.asarray(w.removed), g.removed.numpy())
    for e in range(10):
        assert bool(jgs.g_contains(jg, e)) == bool(tgs.g_contains(tg, e))
        assert bool(jgs.tp_contains(jt, e)) == bool(tgs.tp_contains(tt, e))
    assert int(jgs.g_size(jg)) == int(tgs.g_size(tg))
    assert int(jgs.tp_size(jt)) == int(tgs.tp_size(tt))


def test_gset_strict_joins_raise():
    a = tgs.GSet(elem=torch.tensor([1, 2], dtype=torch.int32))
    b = tgs.GSet(elem=torch.tensor([3, 4], dtype=torch.int32))
    with pytest.raises(tue.UnionOverflow, match="G-Set join needs 4 rows"):
        tgs.g_join_strict(a, b)
    assert tgs.g_join_strict(a, a).elem.tolist() == [1, 2]
    ta = tgs.TwoPSet(elem=a.elem, removed=torch.zeros(2, dtype=torch.bool))
    tb = tgs.TwoPSet(elem=b.elem, removed=torch.zeros(2, dtype=torch.bool))
    with pytest.raises(tue.UnionOverflow, match="2P-Set join needs 4 rows"):
        tgs.tp_join_strict(ta, tb)


def test_gset_join_auto_matches_and_tallies():
    a_np = np.array([1, 5, 9, S], np.int32)
    b_np = np.array([2, 5, 30, S], np.int32)
    ja, jb = jgs.GSet(elem=jnp.asarray(a_np)), jgs.GSet(elem=jnp.asarray(b_np))
    ta, tb = tgs.GSet(elem=torch.from_numpy(a_np)), tgs.GSet(elem=torch.from_numpy(b_np))
    tue.reset_tallies()
    jue.reset_tallies()
    for universe in (64, None):
        np.testing.assert_array_equal(np.asarray(jgs.g_join_auto(ja, jb, universe).elem),
                                      tgs.g_join_auto(ta, tb, universe).elem.numpy())
    assert tue.union_path_counts() == jue.union_path_counts() == {"bitmap": 1, "sort": 1}


# ---- convert and workload ----------------------------------------------------


def test_convert_round_trips():
    ja, ta = _both_sets(12)
    d = {f: np.asarray(getattr(ja, f)) for f in FIELDS}
    _assert_set(ja, convert.orset_from_numpy(d, device="cpu"))
    bm = jos.to_bitmap(ja, 1 << 20)
    tb = convert.bitmap_from_numpy({"present": np.asarray(bm.present),
                                    "removed": np.asarray(bm.removed)}, device="cpu")
    _assert_set(bm, tb, ("present", "removed"))
    assert set(convert.bitmap_to_numpy(tb)) == {"present", "removed"}
    bk = jos.to_bucketed(ja, 2, key_bits=20)
    tk = convert.bucketed_from_numpy({"keys": np.asarray(bk.keys),
                                      "removed": np.asarray(bk.removed)}, 2, 20, device="cpu")
    _assert_set(bk, tk, ("keys", "removed"))
    back = convert.bucketed_to_numpy(tk)
    assert (back["n_buckets"], back["key_bits"]) == (2, 20)


def test_set_swarm_reproduces_from_its_seed():
    pool = workload.set_pool(3)
    a = workload.set_swarm(pool, 70, 1024, 5, device="cpu")
    b = workload.set_swarm(pool, 70, 1024, 5, device="cpu")
    c = workload.set_swarm(pool, 70, 1024, 6, device="cpu")
    for f in FIELDS:
        assert torch.equal(getattr(a.sets, f), getattr(b.sets, f))
    assert torch.equal(a.held, b.held) and torch.equal(a.seen, b.seen)
    assert not torch.equal(a.held, c.held)
    assert len(pool) == 1280 and int(pool.removable.sum()) == 320
    n = a.held.sum(dim=1)
    assert 400 < int(n.min()) and int(n.max()) < 620
    assert torch.equal(tos.size(a.sets), n.to(torch.int32))
    assert bool((a.seen <= a.held).all())     # tombstones only on held tags


def test_set_swarm_keeps_the_first_capacity_tags():
    pool = workload.set_pool(3)
    sw = workload.set_swarm(pool, 4, 256, 5, device="cpu")
    assert bool((sw.held.sum(dim=1) == 256).all())
    assert bool((tos.size(sw.sets) == 256).all())


def test_set_view_agrees_with_a_jax_orset_join_fold():
    pool = workload.set_pool(4)
    a = workload.set_swarm(pool, 6, 1024, 1, device="cpu")
    b = workload.set_swarm(pool, 6, 1024, 2, device="cpu")
    for lane in range(6):
        lanes = [{f: getattr(sw.sets, f)[lane].numpy() for f in FIELDS} for sw in (a, b)]
        j = jos.join(*(jos.ORSet(**{f: jnp.asarray(x[f]) for f in FIELDS}) for x in lanes))
        tags, members = workload.set_view(
            pool, np.stack([a.held[lane].numpy(), b.held[lane].numpy()]),
            np.stack([a.seen[lane].numpy(), b.seen[lane].numpy()]))
        elem, rid, seq, removed = (np.asarray(getattr(j, f)) for f in FIELDS)
        live = elem != S
        assert tags == {(int(e), int(r), int(s)): bool(x) for e, r, s, x in
                        zip(elem[live], rid[live], seq[live], removed[live])}
        assert members == set(np.nonzero(np.asarray(jos.member_mask(j, 1024)))[0].tolist())


def test_strided_columns_are_legal_in_every_layout():
    keys, vals = workload.strided_columns(64, 9, 32, 2048, 3, device="cpu")
    live = keys != S
    assert bool((live.sum(dim=0) == 32).all())
    assert bool((keys[1:32] > keys[:31]).all())
    assert bool((vals[~live] == 0).all()) and bool((vals[live] == (keys[live] & 1)).all())
    _, _, dropped = tue.sorted_to_bucketed(keys, vals, 4, 11)
    assert int(dropped.max()) == 0
