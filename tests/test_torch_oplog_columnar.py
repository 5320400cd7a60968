"""The port's OpLog swarm path — oplog_columnar, parallel.swarm and
oplog_engine — against the JAX package's (the Pallas kernel in interpret
mode), against the port's own generic engine, and against the reference
oracle.  Zero tolerance: every plane, n_unique and the materialized view
equal bit for bit."""
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crdt_tpu.models import oplog as jlog, oplog_columnar as joc, oplog_engine as jeng
from crdt_tpu.oracle.replica import OracleReplica
from crdt_tpu_torch import convert, workload
from crdt_tpu_torch.models import oplog as tlog, oplog_columnar as toc
from crdt_tpu_torch.models import oplog_engine as teng
from crdt_tpu_torch.parallel import swarm as tswarm

BITS = (4, 22, 5)  # 16 writers x 4M seqs x 32 keys
FIELDS = ("ts", "rid", "seq", "key", "val", "payload", "is_num")
KV = ("present", "is_num", "num", "num_count", "payload")


def _op_pool(rng, n, n_writers=8, n_keys=16):
    ids = rng.choice(n * 4, size=n, replace=False)
    return {
        "ts": (ids // 16).astype(np.int32),
        "rid": rng.integers(0, n_writers, n).astype(np.int32),
        "seq": ids.astype(np.int32),
        "key": rng.integers(0, n_keys, n).astype(np.int32),
        "val": rng.integers(-20, 20, n).astype(np.int32),
        "payload": rng.integers(0, 1000, n).astype(np.int32),
        "is_num": rng.integers(0, 2, n).astype(bool),
    }


def _batch(rng, r, c, pool):
    """([R, C] JAX OpLog, the same as a torch OpLog on the CPU)."""
    n = len(pool["ts"])
    logs = []
    for _ in range(r):
        take = np.nonzero(rng.random(n) < rng.random())[0][:c]
        logs.append(jlog.from_ops(c, {k: jnp.asarray(v[take]) for k, v in pool.items()}))
    j = jax.tree.map(lambda *xs: jnp.stack(xs), *logs)
    t = convert.oplog_from_numpy({f: np.asarray(getattr(j, f)) for f in FIELDS},
                                 device="cpu")
    return j, t


def _assert_col(jcol, tcol):
    got = convert.columnar_to_numpy(tcol)
    assert got["bits"] == tuple(jcol.bits)
    for p in ("hi", "lo", "val", "pay"):
        np.testing.assert_array_equal(np.asarray(getattr(jcol, p)), got[p], err_msg=p)


def _assert_log(j, t):
    got = convert.oplog_to_numpy(t)
    for f in FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(j, f)), got[f], err_msg=f)


def _assert_kv(j, t):
    got = convert.kvstate_to_numpy(t)
    for f in KV:
        np.testing.assert_array_equal(np.asarray(getattr(j, f)), got[f], err_msg=f)


def test_stack_unstack_round_trip_matches_jax():
    rng = np.random.default_rng(0)
    j, t = _batch(rng, 6, 32, _op_pool(rng, 40))
    tcol = toc.stack(t, bits=BITS)
    _assert_col(joc.stack(j, bits=BITS), tcol)
    _assert_log(j, toc.unstack(tcol))
    # payload sign bit carries is_num: -2^31 | payload in int32
    assert (tcol.pay < 0).sum() == t.is_num.sum()


@pytest.mark.parametrize("field, bits, match", [
    ("key", BITS, "key range"),
    ("rid", BITS, "rid range"),
    ("seq", (4, 3, 5), "seq range"),
])
def test_stack_rejects_out_of_budget_fields(field, bits, match):
    rng = np.random.default_rng(1)
    pool = _op_pool(rng, 10)
    pool[field][:] = 1 << 6 if field != "seq" else 1 << 4
    _, t = _batch(rng, 2, 16, pool)
    with pytest.raises(ValueError, match=match):
        toc.stack(t, bits=bits)


def test_check_bits_and_fit_bits_match_jax():
    with pytest.raises(ValueError, match="sign bit"):
        toc.check_bits((16, 16, 8))
    with pytest.raises(ValueError, match="non-positive"):
        toc.check_bits((0, 16, 8))
    for n_writers, n_keys in ((5, 62), (10_240, 62), (1, 1)):
        assert toc.fit_bits(n_writers, n_keys) == joc.fit_bits(n_writers, n_keys)


def test_grow_and_empty_match():
    rng = np.random.default_rng(2)
    j, t = _batch(rng, 3, 16, _op_pool(rng, 20))
    jcol, tcol = joc.stack(j, bits=BITS), toc.stack(t, bits=BITS)
    _assert_col(joc.grow(jcol, 32), toc.grow(tcol, 32))
    _assert_col(joc.empty(8, 3, BITS), toc.empty(8, 3, BITS, device="cpu"))
    with pytest.raises(ValueError, match="power of two"):
        toc.grow(tcol, 24)


@pytest.mark.parametrize("c, fill", [(16, 1), (32, 3)])
def test_merge_checked_matches_jax(c, fill):
    """fill=3: a pool of 3C ops, so lanes overflow and drop their newest."""
    rng = np.random.default_rng(c)
    pool = _op_pool(rng, fill * c)
    ja, ta = _batch(rng, 8, c, pool)
    jb, tb = _batch(rng, 8, c, pool)
    jm, jn = joc.merge_checked(joc.stack(ja, BITS), joc.stack(jb, BITS), interpret=True)
    tm, tn = toc.merge_checked(toc.stack(ta, BITS), toc.stack(tb, BITS))
    _assert_col(jm, tm)
    np.testing.assert_array_equal(np.asarray(jn), tn.numpy())
    if fill == 3:
        assert int(tn.max()) > c
    # the columnar merge equals the row-major keep-first merge
    rm, rn = tlog.merge_checked(ta, tb)
    _assert_log(jax.vmap(jlog.merge)(ja, jb), rm)
    np.testing.assert_array_equal(rn.numpy(), tn.numpy())


def test_duplicate_rules_differ_when_copies_differ():
    """The columnar kernel ORs a duplicate's values into the kept copy; the
    row-major merge keeps the first copy.  With equal copies (op identity)
    they agree; with copies that differ they part, each as in the JAX
    package."""
    rng = np.random.default_rng(4)
    pool = _op_pool(rng, 12)
    ja, ta = _batch(rng, 2, 16, pool)
    pool_b = dict(pool, val=pool["val"] ^ 4)
    rng_b = np.random.default_rng(4)
    _op_pool(rng_b, 12)
    jb, tb = _batch(rng_b, 2, 16, pool_b)
    tcm, _ = toc.merge_checked(toc.stack(ta, BITS), toc.stack(tb, BITS))
    jcm, _ = joc.merge_checked(joc.stack(ja, BITS), joc.stack(jb, BITS), interpret=True)
    _assert_col(jcm, tcm)
    trm, _ = tlog.merge_checked(ta, tb)
    _assert_log(jax.vmap(jlog.merge)(ja, jb), trm)
    assert not torch.equal(toc.unstack(tcm).val, trm.val)


@pytest.mark.parametrize("r", [5, 8])
def test_converge_checked_with_alive_mask_matches_jax(r):
    rng = np.random.default_rng(10 + r)
    j, t = _batch(rng, r, 16, _op_pool(rng, 24))
    alive = np.ones(r, bool)
    alive[[1, r - 1]] = False
    jc, jn = joc.converge_checked(joc.stack(j, BITS), jnp.asarray(alive), interpret=True)
    tc, tn = toc.converge_checked(toc.stack(t, BITS), torch.from_numpy(alive))
    _assert_col(jc, tc)
    assert int(jn) == int(tn)
    assert all(x.is_contiguous() for x in (tc.hi, tc.lo, tc.val, tc.pay))
    jc2, _ = joc.converge_checked(joc.stack(j, BITS), interpret=True)
    tc2, _ = toc.converge_checked(toc.stack(t, BITS))
    _assert_col(jc2, tc2)
    assert tc2.hi.is_contiguous()


def test_gossip_round_with_numpy_peers_matches_jax():
    rng = np.random.default_rng(21)
    r = 7
    j, t = _batch(rng, r, 16, _op_pool(rng, 24))
    alive = np.ones(r, bool)
    alive[2] = False
    jcol, tcol = joc.stack(j, BITS), toc.stack(t, BITS)
    for _ in range(3):
        peers = ((np.arange(r) + rng.integers(1, r, r)) % r).astype(np.int32)
        jcol = joc.gossip_round(jcol, jnp.asarray(peers), jnp.asarray(alive), interpret=True)
        tcol = toc.gossip_round(tcol, torch.from_numpy(peers), torch.from_numpy(alive))
        _assert_col(jcol, tcol)
    _assert_kv(joc.rebuild(jcol, 16), toc.rebuild(tcol, 16))


def test_swarm_helpers_match_jax_swarm():
    from crdt_tpu.parallel import swarm as jswarm

    rng = np.random.default_rng(22)
    r = 6
    j, t = _batch(rng, r, 16, _op_pool(rng, 20))
    alive = np.array([1, 1, 0, 1, 1, 1], bool)
    peers = np.array([1, 2, 3, 4, 5, 0], np.int32)
    js = jswarm.set_alive(jswarm.make(j), 2, False)
    ts = tswarm.set_alive(tswarm.make(t), 2, False)
    np.testing.assert_array_equal(np.asarray(js.alive), ts.alive.numpy())
    np.testing.assert_array_equal(alive, ts.alive.numpy())
    js = jswarm.gossip_round(js, jnp.asarray(peers), jax.vmap(jlog.merge))
    ts = tswarm.gossip_round(ts, torch.from_numpy(peers), tlog.merge)
    _assert_log(js.state, ts.state)
    jn, tn = jlog.empty(16), tlog.empty(16, device="cpu")
    assert int(jswarm.n_diverged(js, jax.vmap(jlog.merge), jn)) == int(
        tswarm.n_diverged(ts, tlog.merge, tn))
    js = jswarm.converge(js, jax.vmap(jlog.merge), jn)
    ts = tswarm.converge(ts, tlog.merge, tn)
    _assert_log(js.state, ts.state)
    assert int(tswarm.n_diverged(ts, tlog.merge, tn)) == 0
    g = torch.Generator().manual_seed(0)
    for include_self in (False, True):
        p = tswarm.random_peers(g, r, include_self, device="cpu")
        assert p.shape == (r,) and int(p.min()) >= 0 and int(p.max()) < r
        if not include_self:
            assert not bool((p == torch.arange(r)).any())


def test_plan_picks_columnar_and_falls_back_loudly_with_jax_reasons():
    rng = np.random.default_rng(30)
    j, t = _batch(rng, 4, 16, _op_pool(rng, 20))
    sw = teng.plan(t)
    assert sw.engine == "columnar" and sw.fallback_reason is None
    assert teng.columnar_plan(t) == jeng.columnar_plan(j)
    assert teng.plan(t, force_generic=True).fallback_reason == "forced by caller"
    assert teng.plan(t, bits=BITS).columnar.bits == BITS

    pool = _op_pool(rng, 20)
    cases = {
        "nonpow2": (24, pool),
        "rid": (16, dict(pool, rid=np.where(np.arange(20) == 0, -1, pool["rid"]).astype(np.int32))),
        "budget": (16, dict(pool, seq=(pool["seq"] + (1 << 29)).astype(np.int32),
                            rid=np.full(20, 255, np.int32))),
    }
    for name, (cap, p) in cases.items():
        jb, tb = _batch(np.random.default_rng(1), 3, cap, p)
        want = jeng.columnar_plan(jb)
        assert want[0] is None, name
        assert teng.columnar_plan(tb) == want, name
        with pytest.warns(teng.EngineFallback, match="generic engine"):
            tsw = teng.plan(tb)
        assert tsw.engine == "generic" and tsw.fallback_reason == want[1]
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            jsw = jeng.plan(jb, interpret=True)
        _assert_kv(jsw.converge().rebuild(16), tsw.converge().rebuild(16))


def _slice_run(sw, peer_rounds, n_keys):
    for peers in peer_rounds:
        sw = sw.gossip_round(peers)
    sw, nu = sw.converge_checked()
    return sw, int(nu), sw.rebuild(n_keys)


def test_whole_slice_matches_jax_generic_engine_and_oracle():
    """plan → 3 gossip rounds (one replica dead) → converge_checked →
    rebuild → materialize on reference-shaped writes: the port's columnar
    engine equals the JAX package's, the port's generic engine, and the
    oracle's converged state over the alive replicas."""
    r, c = 8, 64
    w = workload.reference_writes(n_writes=60, n_replicas=r, seed=3)
    ops = w.ops
    logs_t = []
    for rid in range(r):
        mine = ops["rid"] == rid
        logs_t.append(tlog.from_ops(c, {k: v[mine] for k, v in ops.items()}, device="cpu"))
    t = tlog.OpLog(*(torch.stack([getattr(lg, f) for lg in logs_t]) for f in FIELDS))
    j = jlog.OpLog(**{k: jnp.asarray(v) for k, v in convert.oplog_to_numpy(t).items()})
    alive = np.ones(r, bool)
    alive[5] = False
    rng = np.random.default_rng(8)
    rounds = [((np.arange(r) + rng.integers(1, r, r)) % r).astype(np.int32) for _ in range(3)]

    tsw = teng.plan(t, alive=torch.from_numpy(alive))
    assert tsw.engine == "columnar"
    tsw, tnu, tkv = _slice_run(tsw, [torch.from_numpy(p) for p in rounds], w.n_keys)
    jsw = jeng.plan(j, alive=jnp.asarray(alive), interpret=True)
    jsw, jnu, jkv = _slice_run(jsw, [jnp.asarray(p) for p in rounds], w.n_keys)
    _assert_col(jsw.columnar, tsw.columnar)
    _assert_kv(jkv, tkv)
    assert tnu == jnu <= c

    gsw = teng.plan(t, alive=torch.from_numpy(alive), force_generic=True)
    gsw, gnu, gkv = _slice_run(gsw, [torch.from_numpy(p) for p in rounds], w.n_keys)
    _assert_kv(jkv, gkv)
    assert gnu == tnu
    _assert_log(tsw.rows(), gsw.rows())

    replicas = [OracleReplica(rid=i) for i in range(r)]
    for writer, cmd, ts in w.commands:
        replicas[writer].add_command(cmd, ts)
    want = OracleReplica.converged_state([replicas[i] for i in range(r) if alive[i]])
    assert want == workload.converged_view(
        ops, alive[ops["rid"]], w.keys, w.values)
    for lane in range(r):
        kv = tlog.KVState(*(getattr(tkv, f)[lane] for f in KV))
        got = tlog.materialize(kv, w.keys, w.values)
        if alive[lane]:
            assert got == want
        else:
            mine = ops["rid"] == lane
            assert got == workload.converged_view(ops, mine, w.keys, w.values)


def test_subset_swarm_keeps_first_capacity_held_rows():
    """A replica that draws more than capacity ops keeps the first capacity
    of them in log order; ``held`` says exactly which, and every replica's
    log equals the JAX package's from_ops over its held ops."""
    r, c = 6, 8
    w = workload.reference_writes(n_writes=24, n_replicas=r, seed=11)
    logs, held = workload.subset_swarm(w.ops, r, c, 0.35, seed=12, device="cpu")
    drawn = (np.random.default_rng(12).random((r, 24)) < 0.35).sum(axis=1)
    assert drawn.max() > c and drawn.min() < c  # lanes past and under capacity
    np.testing.assert_array_equal(held.sum(axis=1), np.minimum(drawn, c))
    got = convert.oplog_to_numpy(logs)
    for lane in range(r):
        mine = {k: jnp.asarray(v[held[lane]]) for k, v in w.ops.items()}
        want = jlog.from_ops(c, mine)
        for f in FIELDS:
            np.testing.assert_array_equal(np.asarray(getattr(want, f)), got[f][lane],
                                          err_msg=f"lane {lane} {f}")


# ---- the sharded converge over a gloo world (tests/torch_world.py) ----


@pytest.fixture(scope="module")
def sharded_world(tmp_path_factory):
    """The JAX package's sharded converge on make_mesh(4) and make_mesh(3)
    (its kernel in interpret mode) beside the port's over a gloo world of
    4 ranks, on the same planes: C = 32, R = 16 and 12, one lane dead."""
    from crdt_tpu.parallel import mesh as jmesh
    from tests import torch_world

    rng = np.random.default_rng(11)
    pool = _op_pool(rng, 24)
    inputs, want = {}, {}
    for n, r in ((4, 16), (3, 12)):
        j, _ = _batch(rng, r, 32, pool)
        jcol = joc.stack(j, bits=BITS)
        alive = np.ones(r, bool)
        alive[r - 2] = False
        m = jmesh.make_mesh(n)
        sharded = jax.device_put(jcol, jax.sharding.NamedSharding(
            m, jax.sharding.PartitionSpec(None, "replica")))
        got, nu = joc.sharded_converge(m, bits=BITS)(sharded, jnp.asarray(alive))
        single, snu = joc.converge_checked(jcol, jnp.asarray(alive), interpret=True)
        want[n] = (got, int(nu), single, int(snu))
        inputs[n] = {**{p: np.asarray(getattr(jcol, p)) for p in ("hi", "lo", "val", "pay")},
                     "bits": BITS, "alive": alive}
    ranks = torch_world.run_world(tmp_path_factory.mktemp("oplog_columnar_world"),
                                  [("oplog_columnar", inputs)])
    return ranks, want, inputs


@pytest.mark.parametrize("n", [4, 3])
def test_sharded_converge_matches_jax_mesh(sharded_world, n):
    """Every rank's lanes, concatenated in rank order, equal JAX's sharded
    converge on a mesh of the same size and the single-device converge;
    max_n_unique equals JAX's on every rank."""
    ranks, want, inputs = sharded_world
    got_j, nu_j, single, _ = want[n]
    assert not any(r["_jax_imported"] for r in ranks)
    parts = [ranks[r]["oplog_columnar"][n] for r in range(n)]
    for p in ("hi", "lo", "val", "pay"):
        got = np.concatenate([x[0][p] for x in parts], axis=1)
        np.testing.assert_array_equal(got, np.asarray(getattr(got_j, p)), err_msg=p)
        np.testing.assert_array_equal(got, np.asarray(getattr(single, p)), err_msg=p)
    assert [x[1] for x in parts] == [nu_j] * n
    assert nu_j <= 32


def test_sharded_converge_one_rank_mesh_is_the_single_converge():
    """No process group: the one-rank mesh's step equals converge_checked
    (its all_gather and all_reduce are identities)."""
    from crdt_tpu_torch.parallel import mesh as tmesh

    rng = np.random.default_rng(12)
    _, t = _batch(rng, 6, 16, _op_pool(rng, 20))
    col = toc.stack(t, bits=BITS)
    alive = torch.tensor([True, True, False, True, True, True])
    got, nu = toc.sharded_converge(tmesh.make_mesh(device="cpu"), bits=BITS)(col, alive)
    want, wnu = toc.converge_checked(col, alive)
    for p in ("hi", "lo", "val", "pay"):
        assert torch.equal(getattr(got, p), getattr(want, p)), p
    assert int(nu) == int(wnu)
    with pytest.raises(ValueError, match="bits"):
        toc.sharded_converge(tmesh.make_mesh(device="cpu"))(col, alive)
