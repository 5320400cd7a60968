"""The port's compacted log (crdt_tpu_torch.models.compactlog) against the
JAX package's (crdt_tpu.models.compactlog): summaries, frontiers, tails and
views equal bit for bit on the seeded writer histories of
tests/test_compactlog.py (W = 3 writers, K = 8 keys, capacity 64)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crdt_tpu.models import compactlog as jclog
from crdt_tpu.models import oplog as jlog
from crdt_tpu_torch import convert
from crdt_tpu_torch.models import compactlog as tclog
from crdt_tpu_torch.models import oplog as tlog

W = 3
K = 8
CAP = 64
FIELDS = ("ts", "rid", "seq", "key", "val", "payload", "is_num")
KV = ("present", "is_num", "num", "num_count", "payload")


def writer_histories(rng, max_per_writer=8, n_keys=K, val_range=(-20, 21)):
    """Per-writer op columns as tests/test_compactlog.py draws them: seq
    contiguous from 0, ts strictly increasing with seq."""
    cols = {n: [] for n in FIELDS}
    for w in range(W):
        for s in range(int(rng.integers(1, max_per_writer + 1))):
            cols["ts"].append(10 * s + w)
            cols["rid"].append(w)
            cols["seq"].append(s)
            cols["key"].append(int(rng.integers(0, n_keys)))
            is_num = bool(rng.random() < 0.7)
            cols["val"].append(int(rng.integers(*val_range)) if is_num else 0)
            cols["payload"].append(int(rng.integers(0, 100)))
            cols["is_num"].append(is_num)
    return {n: np.asarray(c, bool if n == "is_num" else np.int32) for n, c in cols.items()}


def rand_prefixes(rng, ops):
    return [int(rng.integers(0, int((ops["rid"] == w).sum()) + 1)) for w in range(W)]


def prefix_logs(ops, prefix):
    """One replica's log in both packages: the per-writer prefix of each
    history."""
    keep = ops["seq"] < np.asarray(prefix)[ops["rid"]]
    sub = {k: v[keep] for k, v in ops.items()}
    return (jlog.from_ops(CAP, {k: jnp.asarray(v) for k, v in sub.items()}),
            tlog.from_ops(CAP, sub, device="cpu"))


def fresh_both(pair):
    return jclog.fresh(pair[0], K, W), tclog.fresh(pair[1], K, W)


def jnumpy(c) -> dict:
    """A JAX CompactedLog as convert.compactlog_from_numpy takes it."""
    return {"summary": {f: np.asarray(getattr(c.summary, f)) for f in tclog.SUMMARY_FIELDS},
            "frontier": np.asarray(c.frontier),
            "tail": {f: np.asarray(getattr(c.tail, f)) for f in FIELDS}}


def assert_clog(j, t):
    want, got = jnumpy(j), convert.compactlog_to_numpy(t)
    for f in tclog.SUMMARY_FIELDS:
        np.testing.assert_array_equal(want["summary"][f], got["summary"][f], err_msg=f)
    np.testing.assert_array_equal(want["frontier"], got["frontier"], err_msg="frontier")
    for f in FIELDS:
        np.testing.assert_array_equal(want["tail"][f], got["tail"][f], err_msg=f)


def assert_kv(j, t):
    got = convert.kvstate_to_numpy(t)
    for f in KV:
        np.testing.assert_array_equal(np.asarray(getattr(j, f)), got[f], err_msg=f)


def stable_frontier(rng, *logs):
    """A frontier every given (JAX) log can fold, drawn as
    tests/test_compactlog.py draws it."""
    vvs = np.stack([np.asarray(jlog.version_vector(lg, W)) for lg in logs])
    lo = vvs.min(axis=0)
    return np.asarray([int(rng.integers(-1, lo[w] + 1)) if lo[w] >= 0 else -1
                       for w in range(W)], np.int32)


def compact_both(pair, frontier):
    return (jclog.compact(pair[0], jnp.asarray(frontier)),
            tclog.compact(pair[1], torch.tensor(frontier)))


def test_empty_and_fresh_match():
    assert_clog(jclog.empty(CAP, K, W), tclog.empty(CAP, K, W, device="cpu"))
    rng = np.random.default_rng(0)
    ops = writer_histories(rng)
    j, t = fresh_both(prefix_logs(ops, rand_prefixes(rng, ops)))
    assert_clog(j, t)
    assert j.capacity == t.capacity and j.n_keys == t.n_keys and j.n_writers == t.n_writers
    assert int(jclog.size(j)) == int(tclog.size(t))


@pytest.mark.parametrize("seed", range(4))
def test_received_vv_matches(seed):
    rng = np.random.default_rng(seed)
    ops = writer_histories(rng)
    pair = fresh_both(prefix_logs(ops, rand_prefixes(rng, ops)))
    np.testing.assert_array_equal(np.asarray(jclog.received_vv(pair[0])),
                                  tclog.received_vv(pair[1]).numpy())
    f = stable_frontier(rng, pair[0].tail)
    j, t = compact_both(pair, f)
    np.testing.assert_array_equal(np.asarray(jclog.received_vv(j)),
                                  tclog.received_vv(t).numpy())


@pytest.mark.parametrize("seed", range(6))
def test_compact_and_rebuild_match(seed):
    """Two successive advances, each equal to the JAX fold; rebuild equals
    both packages' oplog.rebuild of the uncompacted log."""
    rng = np.random.default_rng(100 + seed)
    ops = writer_histories(rng)
    logs = prefix_logs(ops, rand_prefixes(rng, ops))
    want = jlog.rebuild(logs[0], K)
    assert_kv(want, tlog.rebuild(logs[1], K))
    c1 = compact_both(fresh_both(logs), stable_frontier(rng, logs[0]))
    assert_clog(*c1)
    assert_kv(jclog.rebuild(c1[0]), tclog.rebuild(c1[1]))
    assert_kv(want, tclog.rebuild(c1[1]))
    c2 = compact_both(c1, np.asarray(jlog.version_vector(logs[0], W)))
    assert_clog(*c2)
    assert_kv(want, tclog.rebuild(c2[1]))
    assert int(tclog.size(c2[1])) == 0


def test_compact_clamps_to_received():
    rng = np.random.default_rng(3)
    ops = writer_histories(rng)
    logs = prefix_logs(ops, rand_prefixes(rng, ops))
    j, t = compact_both(fresh_both(logs), np.full(W, 10_000, np.int32))
    assert_clog(j, t)
    np.testing.assert_array_equal(t.frontier.numpy(),
                                  tlog.version_vector(logs[1], W).numpy())
    assert_kv(jlog.rebuild(logs[0], K), tclog.rebuild(t))


@pytest.mark.parametrize("seed", range(6))
def test_merge_across_frontier_chain_matches(seed):
    """A revived replica (frontier f0) merged with one further ahead (f1 >=
    f0), both orders: equal to JAX, and to the raw union's view."""
    rng = np.random.default_rng(200 + seed)
    ops = writer_histories(rng)
    a_logs = prefix_logs(ops, rand_prefixes(rng, ops))
    b_logs = prefix_logs(ops, rand_prefixes(rng, ops))
    want = jlog.rebuild(jlog.merge(a_logs[0], b_logs[0]), K)
    f0 = stable_frontier(rng, a_logs[0], b_logs[0])
    f1 = np.maximum(f0, stable_frontier(rng, b_logs[0]))
    a = compact_both(fresh_both(a_logs), f0)
    b = compact_both(compact_both(fresh_both(b_logs), f0), f1)
    for x, y in ((a, b), (b, a)):
        j, t = jclog.merge(x[0], y[0]), tclog.merge(x[1], y[1])
        assert_clog(j, t)
        assert_kv(want, tclog.rebuild(t))
        np.testing.assert_array_equal(t.frontier.numpy(),
                                      np.maximum(a[1].frontier.numpy(), b[1].frontier.numpy()))


def test_merge_incomparable_frontiers_adopts_the_winning_side():
    """Off the chain the JAX merge adopts b's side (a does not dominate);
    the port does the same, never the elementwise max."""
    rng = np.random.default_rng(7)
    ops = writer_histories(rng)
    full = [int((ops["rid"] == w).sum()) for w in range(W)]
    logs = prefix_logs(ops, full)
    a = compact_both(fresh_both(logs), np.asarray([0, -1, -1], np.int32))
    b = compact_both(fresh_both(logs), np.asarray([-1, 0, -1], np.int32))
    for x, y in ((a, b), (b, a)):
        j, t = jclog.merge(x[0], y[0]), tclog.merge(x[1], y[1])
        assert_clog(j, t)
        np.testing.assert_array_equal(t.frontier.numpy(), y[1].frontier.numpy())


def test_merge_laws_same_frontier_match():
    rng = np.random.default_rng(5)
    ops = writer_histories(rng)
    logs = [prefix_logs(ops, rand_prefixes(rng, ops)) for _ in range(3)]
    f = stable_frontier(rng, *(lg[0] for lg in logs))
    a, b, c = (compact_both(fresh_both(lg), f) for lg in logs)

    def both(op, *xs):
        return op[0](*(x[0] for x in xs)), op[1](*(x[1] for x in xs))

    m = (jclog.merge, tclog.merge)
    assert_clog(*both(m, a, b))
    for got, want in ((both(m, a, b), both(m, b, a)),
                      (both(m, both(m, a, b), c), both(m, a, both(m, b, c))),
                      (both(m, a, a), a)):
        assert_clog(*got)
        assert_clog(want[0], got[1])


def test_num_wraps_int32_like_jax():
    """Deltas near 2^31: the fold's sums and the rebuild wrap mod 2^32 in
    int32 as JAX's scatter-add does."""
    rng = np.random.default_rng(11)
    ops = writer_histories(rng, n_keys=2, val_range=(2**31 - 40, 2**31 - 1))
    ops["is_num"][:] = True
    logs = prefix_logs(ops, [int((ops["rid"] == w).sum()) for w in range(W)])
    half = np.asarray(jlog.version_vector(logs[0], W)) // 2
    j, t = compact_both(fresh_both(logs), half.astype(np.int32))
    assert_clog(j, t)
    assert_kv(jclog.rebuild(j), tclog.rebuild(t))
    assert (t.summary.num.numpy() < 0).any()  # the fold wrapped


@pytest.mark.parametrize("keys", [[-1, -2, -(K + 1), -(K + 2)], [K, K + 1, 5 * K, 2**31 - 2]],
                         ids=["negative", "out_of_range"])
def test_key_ids_outside_the_key_space_match(keys):
    """JAX's .at[] rules on the K + 1-slot fold tables: a negative key wraps
    once (-1 lands in the spare slot, -2 on key K - 1), one still negative
    or past the table is dropped."""
    rng = np.random.default_rng(13)
    ops = writer_histories(rng)
    ops["key"][: len(keys)] = keys
    ops["key"][-len(keys):] = keys
    logs = prefix_logs(ops, [int((ops["rid"] == w).sum()) for w in range(W)])
    j, t = compact_both(fresh_both(logs), stable_frontier(rng, logs[0]))
    assert_clog(j, t)
    assert_kv(jclog.rebuild(j), tclog.rebuild(t))
    j2, t2 = compact_both((j, t), np.asarray(jlog.version_vector(logs[0], W)))
    assert_clog(j2, t2)
    assert_kv(jlog.rebuild(logs[0], K), tclog.rebuild(t2))


def test_lex_gt_ties_and_signs():
    """Every tie pattern of (ts, rid, seq), with signed int32 extremes."""
    vals = np.asarray([-2**31, -1, 0, 1, 2**31 - 1], np.int32)
    grid = np.stack(np.meshgrid(vals, vals[:3], vals[:3], indexing="ij"), 0).reshape(3, -1)
    a = grid[:, :, None].repeat(grid.shape[1], 2).reshape(3, -1)
    b = grid[:, None, :].repeat(grid.shape[1], 1).reshape(3, -1)
    want = np.asarray(jclog._lex_gt(tuple(jnp.asarray(x) for x in a),
                                    tuple(jnp.asarray(x) for x in b)))
    got = tclog._lex_gt(tuple(torch.from_numpy(x) for x in a),
                        tuple(torch.from_numpy(x) for x in b)).numpy()
    np.testing.assert_array_equal(want, got)
    assert want.any() and not want.all()


def test_convert_round_trip_of_a_jax_compacted_log():
    """A CompactedLog the JAX package built, carried over as numpy, rebuilds
    to the same view in the port and converts back unchanged."""
    rng = np.random.default_rng(17)
    ops = writer_histories(rng)
    logs = prefix_logs(ops, rand_prefixes(rng, ops))
    j = jclog.compact(jclog.fresh(logs[0], K, W), jnp.asarray(stable_frontier(rng, logs[0])))
    t = convert.compactlog_from_numpy(jnumpy(j), device="cpu")
    assert_clog(j, t)
    assert_kv(jclog.rebuild(j), tclog.rebuild(t))
    back = convert.compactlog_to_numpy(convert.compactlog_from_numpy(
        convert.compactlog_to_numpy(t), device="cpu"))
    assert_clog(j, convert.compactlog_from_numpy(back, device="cpu"))
