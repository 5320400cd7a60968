"""The counter and register family of the port (crdt_tpu_torch.models:
gcounter, pncounter, lww, flags, mvregister) against the JAX package's on
the same numpy inputs, bit for bit: every function, JAX's ``.at[]`` index
rules (a negative index counts from the end once, one still out of range
changes nothing), the int32 edges, the LWW pack budget at both limits and
the packed join; then the join laws on seeded states and the numpy
carriers of convert.py."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crdt_tpu.models import flags as jfl
from crdt_tpu.models import gcounter as jgc
from crdt_tpu.models import lww as jlww
from crdt_tpu.models import mvregister as jmv
from crdt_tpu.models import pncounter as jpn
from crdt_tpu_torch import convert, workload
from crdt_tpu_torch.models import flags, gcounter, lww, mvregister, pncounter

I32_MAX, I32_MIN = 2**31 - 1, -2**31
INDICES = [0, 3, -1, -4, 4, -5, 9]  # with 4 slots: -1 is slot 3; 4, -5, 9 drop


def _np(x):
    """A JAX or port state as nested numpy (a dataclass by its fields)."""
    if dataclasses.is_dataclass(x):
        return {f.name: _np(getattr(x, f.name)) for f in dataclasses.fields(x)}
    if isinstance(x, dict):
        return {k: _np(v) for k, v in x.items()}
    if isinstance(x, torch.Tensor):
        return x.numpy()
    if isinstance(x, (int, bool)):
        return x
    return np.asarray(x)


def _assert_same(want, got):
    want, got = _np(want), _np(got)
    if isinstance(want, dict):
        assert want.keys() == got.keys()
        for k in want:
            _assert_same(want[k], got[k])
    elif isinstance(want, int):
        assert want == got
    else:
        assert want.dtype == got.dtype, (want.dtype, got.dtype)
        np.testing.assert_array_equal(want, got)


def _pair(jcls, from_numpy, d):
    """The same state in both packages."""
    jax_state = jcls(**{k: jnp.asarray(v) for k, v in d.items()})
    return jax_state, from_numpy(d, device="cpu")


def _counts(seed, batch=(5,), n=4):
    return workload.counter_bank(seed, (*batch, n))


# ---- G-Counter ----


@pytest.mark.parametrize("node", INDICES)
def test_gcounter_increment_follows_jax_index_rules(node):
    j, t = _pair(jgc.GCounter, convert.gcounter_from_numpy, {"counts": _counts(1)})
    _assert_same(jgc.increment(j, node, 7), gcounter.increment(t, node, 7))
    per_replica = np.arange(5, dtype=np.int32) * 3
    _assert_same(jgc.increment(j, node, jnp.asarray(per_replica)),
                 gcounter.increment(t, node, torch.from_numpy(per_replica)))


def test_gcounter_zero_join_value_and_int32_wrap():
    _assert_same(jgc.zero(8, (3, 2)), gcounter.zero(8, (3, 2), device="cpu"))
    d = {"counts": np.array([[I32_MAX - 2, I32_MAX, 5, 0], [1, 2, 3, 4]], np.int32)}
    j, t = _pair(jgc.GCounter, convert.gcounter_from_numpy, d)
    _assert_same(jgc.increment(j, 0, 5), gcounter.increment(t, 0, 5))  # wraps
    _assert_same(jgc.value(j), gcounter.value(t))                      # sum wraps
    j2, t2 = _pair(jgc.GCounter, convert.gcounter_from_numpy, {"counts": _counts(2, (2,))})
    _assert_same(jgc.join(j, j2), gcounter.join(t, t2))
    _assert_same(jgc.value(jgc.join(j, j2)), gcounter.value(gcounter.join(t, t2)))


# ---- PN-Counter ----


@pytest.mark.parametrize("node", INDICES)
@pytest.mark.parametrize("amount", [5, -9, 0, I32_MIN, I32_MAX])
def test_pncounter_add_follows_jax_index_rules_and_wraps(node, amount):
    d = {"pos": _counts(3), "neg": _counts(4)}
    j, t = _pair(jpn.PNCounter, convert.pncounter_from_numpy, d)
    _assert_same(jpn.add(j, node, amount), pncounter.add(t, node, amount))
    _assert_same(jpn.value(jpn.add(j, node, amount)),
                 pncounter.value(pncounter.add(t, node, amount)))


def test_pncounter_zero_join_value_and_batched_amounts():
    _assert_same(jpn.zero(4, (2,)), pncounter.zero(4, (2,), device="cpu"))
    d = {"pos": _counts(5), "neg": _counts(6)}
    e = {"pos": _counts(7), "neg": _counts(8)}
    (ja, ta), (jb, tb) = (_pair(jpn.PNCounter, convert.pncounter_from_numpy, x) for x in (d, e))
    _assert_same(jpn.join(ja, jb), pncounter.join(ta, tb))
    _assert_same(jpn.value(jpn.join(ja, jb)), pncounter.value(pncounter.join(ta, tb)))
    amounts = np.array([-3, 0, 4, I32_MIN, I32_MAX], np.int32)
    _assert_same(jpn.add(ja, 2, jnp.asarray(amounts)),
                 pncounter.add(ta, 2, torch.from_numpy(amounts)))
    for too_wide in (2**31, -2**31 - 1):  # both refuse an amount past int32
        with pytest.raises(OverflowError):
            jpn.add(ja, 0, too_wide)
        with pytest.raises(OverflowError):
            pncounter.add(ta, 0, too_wide)
    wrap = {"pos": np.full((1, 4), I32_MAX, np.int32), "neg": np.full((1, 4), I32_MIN, np.int32)}
    jw, tw = _pair(jpn.PNCounter, convert.pncounter_from_numpy, wrap)
    _assert_same(jpn.value(jw), pncounter.value(tw))


# ---- LWW-Register ----


def _lww(seed, shape=(6,)):
    return workload.lww_bank(seed, shape)


def test_lww_zero_write_join_value_is_set():
    _assert_same(jlww.zero((2, 3)), lww.zero((2, 3), device="cpu"))
    _assert_same(jlww.zero(), lww.zero(device="cpu"))
    d = {"ts": np.array([-1, 5, 5, 5, 7, 9], np.int32),
         "rid": np.array([-1, 2, 2, 2, 1, 0], np.int32),
         "payload": np.array([0, 10, 11, 12, 13, 14], np.int32)}
    j, t = _pair(jlww.LWWRegister, convert.lww_from_numpy, d)
    for ts, rid, pay in ((5, 3, 99), (5, 1, 98), (6, 0, 97), (4, 9, 96)):
        _assert_same(jlww.write(j, ts, rid, pay), lww.write(t, ts, rid, pay))
    e = _lww(1)
    je, te = _pair(jlww.LWWRegister, convert.lww_from_numpy, e)
    _assert_same(jlww.join(j, je), lww.join(t, te))
    _assert_same(jlww.join_local_wins(j, je), lww.join_local_wins(t, te))
    _assert_same(jlww.value(j), lww.value(t))
    _assert_same(jlww.is_set(j), lww.is_set(t))
    # equal timestamps: join breaks ties by rid, join_local_wins keeps local
    tie = dict(d, rid=np.array([-1, 3, 1, 2, 1, 0], np.int32),
               payload=np.arange(20, 26, dtype=np.int32))
    jt, tt = _pair(jlww.LWWRegister, convert.lww_from_numpy, tie)
    _assert_same(jlww.join(j, jt), lww.join(t, tt))
    _assert_same(jlww.join_local_wins(j, jt), lww.join_local_wins(t, tt))


@pytest.mark.parametrize("rid_bits", [6, 7])
@pytest.mark.parametrize("field, offset, ok", [
    ("ts", -1, True), ("ts", 0, False), ("-ts", -1, True), ("-ts", 0, False),
    ("rid", -1, True), ("rid", 0, False), ("rid_low", 0, True), ("rid_low", -1, False),
], ids=["ts=lim-1", "ts=lim", "ts=-(lim-1)", "ts=-lim", "rid=2^b-2", "rid=2^b-1",
        "rid=-1", "rid=-2"])
def test_lww_pack_budget_at_both_limits(rid_bits, field, offset, ok):
    """lim = 2^(30 - rid_bits) is strict on both sides; rid spans
    [-1, 2^rid_bits - 1)."""
    lim = 1 << (30 - rid_bits)
    d = _lww(2)
    d["rid"] %= (1 << rid_bits) - 1  # every other register inside the budget
    if field == "ts":
        d["ts"][1] = lim + offset
    elif field == "-ts":
        d["ts"][1] = -(lim + offset)
    elif field == "rid":
        d["rid"][1] = (1 << rid_bits) - 1 + offset
    else:
        d["rid"][1] = -1 + offset
    j, t = _pair(jlww.LWWRegister, convert.lww_from_numpy, d)
    assert bool(jlww.pack_budget_ok(j, rid_bits)) is ok
    _assert_same(jlww.pack_budget_ok(j, rid_bits), lww.pack_budget_ok(t, rid_bits))
    _assert_same(jlww.pack(j, rid_bits), lww.pack(t, rid_bits))
    if ok:  # the pack is exact inside the budget
        _assert_same(j, lww.unpack(lww.pack(t, rid_bits)))
        _assert_same(jlww.unpack(jlww.pack(j, rid_bits)), lww.unpack(lww.pack(t, rid_bits)))


@pytest.mark.parametrize("rid_bits", [6, 7])
def test_lww_join_packed_equals_join(rid_bits):
    """Negative ts at the budget's edge, the unset sentinel, equal ts with
    every rid order: unpack(join_packed(pack a, pack b)) == join(a, b)."""
    lim = 1 << (30 - rid_bits)
    rng = np.random.default_rng(rid_bits)
    n = 512
    ts_pool = np.array([-(lim - 1), -5, -1, 0, 1, 7, lim - 1], np.int32)

    def reg():
        ts = rng.choice(ts_pool, n).astype(np.int32)
        rid = rng.integers(-1, (1 << rid_bits) - 1, n).astype(np.int32)
        return {"ts": ts, "rid": rid, "payload": (ts * 3 + rid).astype(np.int32)}

    (ja, ta), (jb, tb) = (_pair(jlww.LWWRegister, convert.lww_from_numpy, reg()) for _ in "ab")
    assert bool(lww.pack_budget_ok(ta, rid_bits)) and bool(lww.pack_budget_ok(tb, rid_bits))
    got = lww.join_packed(lww.pack(ta, rid_bits), lww.pack(tb, rid_bits))
    _assert_same(jlww.join_packed(jlww.pack(ja, rid_bits), jlww.pack(jb, rid_bits)), got)
    _assert_same(lww.join(ta, tb), lww.unpack(got))
    _assert_same(jlww.join(ja, jb), lww.unpack(got))
    with pytest.raises(ValueError, match="pack layouts differ"):
        lww.join_packed(lww.pack(ta, rid_bits), lww.pack(tb, rid_bits + 1))


# ---- EW/DW flags ----

W = 4


def _plane(seed, batch=(3,)):
    rng = np.random.default_rng(seed)
    return {"tok": rng.integers(-1, 5, (*batch, W)).astype(np.int32),
            "obs": rng.integers(-1, 5, (*batch, W, W)).astype(np.int32)}


def _jplane(d):
    return jfl.TokenPlane(tok=jnp.asarray(d["tok"]), obs=jnp.asarray(d["obs"]))


@pytest.mark.parametrize("writer", INDICES)
def test_token_plane_ops_follow_jax_index_rules(writer):
    d = _plane(1)
    j, t = _jplane(d), convert.token_plane_from_numpy(d, device="cpu")
    _assert_same(jfl.plane_token(j, writer), flags.plane_token(t, writer))
    _assert_same(jfl.plane_clear(j, writer), flags.plane_clear(t, writer))
    _assert_same(jfl.ew_enable(jfl.EWFlag(j), writer), flags.ew_enable(flags.EWFlag(t), writer))
    _assert_same(jfl.ew_disable(jfl.EWFlag(j), writer), flags.ew_disable(flags.EWFlag(t), writer))
    touched = np.array([True, False, False])
    jd = jfl.DWFlag(plane=j, touched=jnp.asarray(touched))
    td = flags.DWFlag(plane=t, touched=torch.from_numpy(touched))
    _assert_same(jfl.dw_enable(jd, writer), flags.dw_enable(td, writer))  # touched: all ones
    _assert_same(jfl.dw_disable(jd, writer), flags.dw_disable(td, writer))


def test_token_plane_zero_join_active_and_flag_values():
    _assert_same(jfl.plane_zero(W, (2,)), flags.plane_zero(W, (2,), device="cpu"))
    _assert_same(jfl.ew_zero(W, (2,)), flags.ew_zero(W, (2,), device="cpu"))
    _assert_same(jfl.dw_zero(W, (2,)), flags.dw_zero(W, (2,), device="cpu"))
    a, b = _plane(2), _plane(3)
    ja, jb = _jplane(a), _jplane(b)
    ta, tb = (convert.token_plane_from_numpy(x, device="cpu") for x in (a, b))
    _assert_same(jfl.plane_join(ja, jb), flags.plane_join(ta, tb))
    _assert_same(jfl.plane_active(ja), flags.plane_active(ta))
    _assert_same(jfl.ew_join(jfl.EWFlag(ja), jfl.EWFlag(jb)),
                 flags.ew_join(flags.EWFlag(ta), flags.EWFlag(tb)))
    _assert_same(jfl.ew_value(jfl.EWFlag(ja)), flags.ew_value(flags.EWFlag(ta)))
    touched = [np.array([True, False, True]), np.array([False, False, True])]
    jd = [jfl.DWFlag(p, jnp.asarray(x)) for p, x in zip((ja, jb), touched)]
    td = [flags.DWFlag(p, torch.from_numpy(x)) for p, x in zip((ta, tb), touched)]
    _assert_same(jfl.dw_join(*jd), flags.dw_join(*td))
    _assert_same(jfl.dw_value(jd[0]), flags.dw_value(td[0]))


def test_flag_scripts_resolve_concurrent_ops_as_jax():
    """enable||disable: the enable-wins flag reads True, the disable-wins
    flag False, in both packages, over a seeded op script on 3 replicas."""
    rng = np.random.default_rng(4)
    j_ew, t_ew = jfl.ew_zero(W, (3,)), flags.ew_zero(W, (3,), device="cpu")
    j_dw, t_dw = jfl.dw_zero(W, (3,)), flags.dw_zero(W, (3,), device="cpu")
    for _ in range(12):
        w, on = int(rng.integers(-W, W + 2)), bool(rng.integers(0, 2))
        if on:
            j_ew, t_ew = jfl.ew_enable(j_ew, w), flags.ew_enable(t_ew, w)
            j_dw, t_dw = jfl.dw_enable(j_dw, w), flags.dw_enable(t_dw, w)
        else:
            j_ew, t_ew = jfl.ew_disable(j_ew, w), flags.ew_disable(t_ew, w)
            j_dw, t_dw = jfl.dw_disable(j_dw, w), flags.dw_disable(t_dw, w)
        _assert_same(j_ew, t_ew)
        _assert_same(j_dw, t_dw)
        _assert_same(jfl.ew_value(j_ew), flags.ew_value(t_ew))
        _assert_same(jfl.dw_value(j_dw), flags.dw_value(t_dw))
    e1 = flags.ew_enable(flags.ew_zero(W, device="cpu"), 0)
    e2 = flags.ew_disable(flags.ew_zero(W, device="cpu"), 1)
    assert bool(flags.ew_value(flags.ew_join(e1, e2)))
    d1 = flags.dw_enable(flags.dw_zero(W, device="cpu"), 0)
    d2 = flags.dw_disable(flags.dw_zero(W, device="cpu"), 1)
    assert not bool(flags.dw_value(flags.dw_join(d1, d2)))


# ---- MV-Register ----


def _mv(seed, batch=(3,)):
    rng = np.random.default_rng(seed)
    return {"seq": rng.integers(-1, 3, (*batch, W)).astype(np.int32),
            "ts": rng.integers(0, 5, (*batch, W)).astype(np.int32),
            "payload": rng.integers(0, 5, (*batch, W)).astype(np.int32),
            "obs": rng.integers(-1, 3, (*batch, W, W)).astype(np.int32)}


def _jmv(d):
    return jmv.MVRegister(**{k: jnp.asarray(v) for k, v in d.items()})


@pytest.mark.parametrize("writer", INDICES)
def test_mvregister_write_follows_jax_index_rules(writer):
    d = _mv(1)
    j, t = _jmv(d), convert.mvregister_from_numpy(d, device="cpu")
    _assert_same(jmv.write(j, writer, 17, 42), mvregister.write(t, writer, 17, 42))


def test_mvregister_zero_join_ties_visible_values_siblings():
    _assert_same(jmv.zero(W, (2,)), mvregister.zero(W, (2,), device="cpu"))
    a, b = _mv(2), _mv(3)  # seqs in [-1, 3): many ties, broken by elementwise max
    ja, jb = _jmv(a), _jmv(b)
    ta, tb = (convert.mvregister_from_numpy(x, device="cpu") for x in (a, b))
    _assert_same(jmv.join(ja, jb), mvregister.join(ta, tb))
    _assert_same(jmv.join(jb, ja), mvregister.join(tb, ta))
    _assert_same(jmv.visible(ja), mvregister.visible(ta))
    _assert_same(jmv.values(ja), mvregister.values(ta))
    _assert_same(jmv.n_siblings(ja), mvregister.n_siblings(ta))
    # concurrent writes surface as siblings; a write that saw both collapses them
    x = mvregister.write(mvregister.zero(W, device="cpu"), 0, 1, 10)
    y = mvregister.write(mvregister.zero(W, device="cpu"), 1, 2, 20)
    both = mvregister.join(x, y)
    assert int(mvregister.n_siblings(both)) == 2
    assert int(mvregister.n_siblings(mvregister.write(both, 2, 3, 30))) == 1


# ---- join laws on seeded states ----


def _state(kind, seed):
    rng = np.random.default_rng(seed)
    if kind == "gcounter":
        return convert.gcounter_from_numpy({"counts": _counts(seed)}, device="cpu")
    if kind == "pncounter":
        return convert.pncounter_from_numpy(
            {"pos": _counts(seed), "neg": _counts(seed + 100)}, device="cpu")
    if kind in ("lww", "lww_packed"):
        # reachable states: a (ts, rid) pair names one write, one payload
        ts = rng.integers(-1, 6, 64).astype(np.int32)
        rid = rng.integers(-1, 4, 64).astype(np.int32)
        reg = convert.lww_from_numpy({"ts": ts, "rid": rid, "payload": ts * 8 + rid},
                                     device="cpu")
        return lww.pack(reg) if kind == "lww_packed" else reg
    if kind == "ew":
        return flags.EWFlag(convert.token_plane_from_numpy(_plane(seed), device="cpu"))
    if kind == "dw":
        return flags.DWFlag(convert.token_plane_from_numpy(_plane(seed), device="cpu"),
                            torch.from_numpy(rng.random(3) < 0.5))
    return convert.mvregister_from_numpy(_mv(seed), device="cpu")


JOINS = {"gcounter": gcounter.join, "pncounter": pncounter.join, "lww": lww.join,
         "lww_packed": lww.join_packed, "ew": flags.ew_join, "dw": flags.dw_join,
         "mvregister": mvregister.join}


@pytest.mark.parametrize("kind", list(JOINS))
@pytest.mark.parametrize("seed", [0, 1])
def test_join_laws_on_seeded_states(kind, seed):
    join = JOINS[kind]
    a, b, c = (_state(kind, 3 * seed + i) for i in range(3))
    _assert_same(join(a, b), join(b, a))
    _assert_same(join(join(a, b), c), join(a, join(b, c)))
    _assert_same(join(a, a), a)


# ---- convert round trips ----


@pytest.mark.parametrize("kind, to_numpy, from_numpy", [
    ("gcounter", convert.gcounter_to_numpy, convert.gcounter_from_numpy),
    ("pncounter", convert.pncounter_to_numpy, convert.pncounter_from_numpy),
    ("lww", convert.lww_to_numpy, convert.lww_from_numpy),
    ("lww_packed", convert.packed_lww_to_numpy, convert.packed_lww_from_numpy),
    ("ew", convert.ewflag_to_numpy, convert.ewflag_from_numpy),
    ("dw", convert.dwflag_to_numpy, convert.dwflag_from_numpy),
    ("mvregister", convert.mvregister_to_numpy, convert.mvregister_from_numpy),
])
def test_convert_round_trips(kind, to_numpy, from_numpy):
    state = _state(kind, 5)
    _assert_same(state, from_numpy(to_numpy(state), device="cpu"))


def test_convert_takes_jax_states_as_numpy():
    j = jfl.DWFlag(plane=jfl.plane_token(jfl.plane_zero(W, (2,)), 1),
                   touched=jnp.asarray([True, False]))
    d = {"plane": {"tok": np.asarray(j.plane.tok), "obs": np.asarray(j.plane.obs)},
         "touched": np.asarray(j.touched)}
    _assert_same(j, convert.dwflag_from_numpy(d, device="cpu"))
    p = jlww.pack(jlww.write(jlww.zero((3,)), 4, 2, 9), 7)
    d = {"key": np.asarray(p.key), "payload": np.asarray(p.payload), "rid_bits": p.rid_bits}
    _assert_same(p, convert.packed_lww_from_numpy(d, device="cpu"))


def test_counter_banks_are_seeded_and_in_range():
    a, b = workload.counter_bank(3, (4, 8)), workload.counter_bank(3, (4, 8))
    assert a.dtype == np.int32 and np.array_equal(a, b)
    assert 0 <= a.min() and a.max() < 1 << 20
    bank = workload.lww_bank(3, (1000,))
    assert bank["rid"].min() >= 0 and bank["rid"].max() < 64
    assert bank["ts"].max() < 1 << 20 and bank["payload"].dtype == np.int32
    script = workload.register_script(3, 5, 100, 8)
    assert [op["ts"] for op in script] == list(range(5))
    assert all(0 <= op["writer"] < 8 and op["mask"].shape == (100,) for op in script)
