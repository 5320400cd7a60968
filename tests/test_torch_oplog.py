"""The port's OpLog (crdt_tpu_torch.models.oplog) against the JAX
package's (crdt_tpu.models.oplog): every plane, n_unique and the
materialized view equal bit for bit on seeded inputs."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crdt_tpu.models import oplog as jlog
from crdt_tpu.utils import intern as jintern
from crdt_tpu_torch import convert
from crdt_tpu_torch.models import oplog as tlog
from crdt_tpu_torch.utils import intern as tintern

FIELDS = ("ts", "rid", "seq", "key", "val", "payload", "is_num")
KV = ("present", "is_num", "num", "num_count", "payload")


def _ops(rng, n, n_writers=6, n_keys=12, val_range=(-20, 20)):
    """n ops with unique (ts, rid, seq) identities and colliding ts."""
    ids = rng.choice(n * 4, size=n, replace=False)
    return {
        "ts": (ids // 8).astype(np.int32),
        "rid": rng.integers(0, n_writers, n).astype(np.int32),
        "seq": ids.astype(np.int32),
        "key": rng.integers(0, n_keys, n).astype(np.int32),
        "val": rng.integers(*val_range, n).astype(np.int32),
        "payload": rng.integers(0, 500, n).astype(np.int32),
        "is_num": rng.integers(0, 2, n).astype(bool),
    }


def _both(cap, ops):
    j = jlog.from_ops(cap, {k: jnp.asarray(v) for k, v in ops.items()})
    t = tlog.from_ops(cap, ops, device="cpu")
    return j, t


def _assert_log(j, t):
    got = convert.oplog_to_numpy(t)
    for f in FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(j, f)), got[f], err_msg=f)


def _assert_kv(j, t):
    got = convert.kvstate_to_numpy(t)
    for f in KV:
        np.testing.assert_array_equal(np.asarray(getattr(j, f)), got[f], err_msg=f)


@pytest.mark.parametrize("n", [0, 5, 32])
def test_from_ops_matches(n):
    rng = np.random.default_rng(n)
    j, t = _both(32, _ops(rng, n))
    _assert_log(j, t)
    assert int(jlog.size(j)) == int(tlog.size(t)) == n


def test_from_ops_rejects_oversized_batch():
    with pytest.raises(ValueError, match="exceeds log capacity"):
        tlog.from_ops(4, _ops(np.random.default_rng(0), 5), device="cpu")


@pytest.mark.parametrize("na,nb,cap", [(10, 12, 32), (20, 20, 24), (0, 7, 8)])
def test_merge_checked_matches_including_overflow(na, nb, cap):
    rng = np.random.default_rng(na * 100 + nb)
    pool = _ops(rng, na + nb + 8)
    a_ids = rng.choice(len(pool["ts"]), na, replace=False)
    b_ids = rng.choice(len(pool["ts"]), nb, replace=False)
    ja, ta = _both(cap, {k: v[a_ids] for k, v in pool.items()})
    jb, tb = _both(cap, {k: v[b_ids] for k, v in pool.items()})
    jm, jn = jlog.merge_checked(ja, jb)
    tm, tn = tlog.merge_checked(ta, tb)
    _assert_log(jm, tm)
    assert int(jn) == int(tn)
    td, tdn = tlog.merge_checked_donating(ta, tb)
    _assert_log(jm, td)
    assert int(tdn) == int(tn)
    _assert_log(jlog.merge(ja, jb), tlog.merge(ta, tb))
    if (na, nb, cap) == (20, 20, 24):
        assert int(tn) > cap  # overflow: newest ops dropped, detectably


def test_version_vector_covered_by_delta_since():
    rng = np.random.default_rng(5)
    ops = _ops(rng, 24, n_writers=5)
    ops["rid"][:2] = [-1, 9]          # foreign writers: never covered
    j, t = _both(32, ops)
    jvv = jlog.version_vector(j, 5)
    tvv = tlog.version_vector(t, 5)
    np.testing.assert_array_equal(np.asarray(jvv), tvv.numpy())
    peer_vv = (tvv.numpy() // 2).astype(np.int32)
    np.testing.assert_array_equal(
        np.asarray(jlog.covered_by(j, jnp.asarray(peer_vv))),
        tlog.covered_by(t, torch.from_numpy(peer_vv)).numpy(),
    )
    _assert_log(jlog.delta_since(j, jnp.asarray(peer_vv)),
                tlog.delta_since(t, torch.from_numpy(peer_vv)))


def test_append_batch_and_grow():
    rng = np.random.default_rng(9)
    pool = _ops(rng, 30)
    first = {k: v[:10] for k, v in pool.items()}
    batch = {k: v[10:18] for k, v in pool.items()}
    j, t = _both(16, first)
    j2 = jlog.append_batch(j, {k: jnp.asarray(v) for k, v in batch.items()}, 8)
    t2 = tlog.append_batch(t, batch, 8)
    _assert_log(j2, t2)
    _assert_log(jlog.grow(j2, 32), tlog.grow(t2, 32))
    with pytest.raises(ValueError, match="cannot shrink"):
        tlog.grow(t2, 8)


def test_rebuild_matches_with_int32_wrap_and_out_of_range_keys():
    """Sums wrap as XLA's int32 adds do; key ids at K, past K+1 and
    negative map to the JAX scatter's slots (dropped or wrapped)."""
    k = 10
    rng = np.random.default_rng(11)
    ops = _ops(rng, 28, n_keys=k)
    ops["is_num"][:] = True
    ops["key"][:6] = 3
    ops["val"][:6] = [2**31 - 5, 2**31 - 7, 100, -(2**31) + 1, 2**30, 2**30]
    ops["key"][6:12] = [k, k + 1, k + 5, -1, -(k + 1), -(k + 7)]
    j, t = _both(32, ops)
    _assert_kv(jlog.rebuild(j, k), tlog.rebuild(t, k))


def test_rebuild_batched_matches_vmap():
    rng = np.random.default_rng(12)
    ops_list = [_ops(rng, int(rng.integers(0, 16))) for _ in range(4)]
    js = [jlog.from_ops(16, {k: jnp.asarray(v) for k, v in o.items()}) for o in ops_list]
    jstack = jax.tree.map(lambda *xs: jnp.stack(xs), *js)
    tstack = convert.oplog_from_numpy(
        {f: np.asarray(getattr(jstack, f)) for f in FIELDS}, device="cpu")
    _assert_kv(jax.vmap(lambda lg: jlog.rebuild(lg, 12))(jstack), tlog.rebuild(tstack, 12))


def test_materialize_matches():
    """The port's own interner copy encodes like the JAX package's, and the
    decoded {key: value} views are equal."""
    jk, jv = jintern.Interner(), jintern.Interner()
    tk, tv = tintern.Interner(), tintern.Interner()
    rng = np.random.default_rng(13)
    cols = {f: [] for f in FIELDS}
    for i in range(40):
        key = f"k{rng.integers(0, 6)}"
        value = (f"s{rng.integers(0, 4)}" if rng.random() < 0.2
                 else str(int(rng.integers(-20, -10))))
        if i == 3:
            value = "007"   # verbatim until an addition canonicalizes it
        kid = jk.intern(key)
        assert tk.intern(key) == kid
        enc = jintern.encode_value(value, jv)
        assert tintern.encode_value(value, tv) == enc
        val, payload, is_num = enc
        for f, x in (("ts", i // 2), ("rid", i % 3), ("seq", i), ("key", kid),
                     ("val", val), ("payload", payload), ("is_num", is_num)):
            cols[f].append(x)
    ops = {f: np.asarray(v, bool if f == "is_num" else np.int32) for f, v in cols.items()}
    j, t = _both(64, ops)
    want = jlog.materialize(jlog.rebuild(j, len(jk)), jk, jv)
    got = tlog.materialize(tlog.rebuild(t, len(tk)), tk, tv)
    assert got == want and len(got) > 0


def test_empty_and_convert_round_trip():
    e = tlog.empty(8, device="cpu")
    _assert_log(jlog.empty(8), e)
    d = convert.oplog_to_numpy(e)
    _assert_log(jlog.empty(8), convert.oplog_from_numpy(d, device="cpu"))
