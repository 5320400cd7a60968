"""The port's row-major RSeq (crdt_tpu_torch.models.rseq) against the JAX
package's: identity allocation, the editing cursor, join, insert_batch,
delete, grow and widen, bit for bit on every field."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crdt_tpu.models import rseq as jrseq
from crdt_tpu_torch import convert
from crdt_tpu_torch.models import rseq as trseq

CAP = 64


def _edits(seed, n=14):
    """A seeded edit script: (op, index-fraction, elem) triples."""
    rng = np.random.default_rng(seed)
    return [("del" if rng.random() < 0.3 else "ins", float(rng.random()),
             int(rng.integers(0, 500))) for _ in range(n)]


def _apply(w, script, run=False):
    for op, frac, elem in script:
        n = len(w.to_list())
        if op == "del" and n:
            w.delete_at(int(frac * n))
        elif run:
            w.insert_run(int(frac * (n + 1)), [elem, elem + 1, elem + 2])
        else:
            w.insert_at(int(frac * (n + 1)), elem)
    return w.state


def to_jax(s: trseq.RSeq) -> jrseq.RSeq:
    d = convert.rseq_to_numpy(s)
    return jrseq.RSeq(keys=jnp.asarray(d["keys"]), elem=jnp.asarray(d["elem"]),
                      removed=jnp.asarray(d["removed"]))


def to_torch(s: jrseq.RSeq) -> trseq.RSeq:
    return convert.rseq_from_numpy(
        {f: np.asarray(getattr(s, f)) for f in ("keys", "elem", "removed")}, device="cpu")


def assert_same(j: jrseq.RSeq, t: trseq.RSeq):
    got = convert.rseq_to_numpy(t)
    for f in ("keys", "elem", "removed"):
        np.testing.assert_array_equal(np.asarray(getattr(j, f)), got[f], err_msg=f)


def branch(base: trseq.RSeq, rid: int, seed: int, run=False) -> trseq.RSeq:
    return _apply(trseq.SeqWriter(base, rid=rid), _edits(seed), run=run)


@pytest.mark.parametrize("run", [False, True], ids=["insert_at", "insert_run"])
def test_seq_writer_edit_runs_match_jax(run):
    """The same edit script through both packages' SeqWriter (host
    allocation + device union) gives the same table, keys and seqs."""
    script = _edits(1)
    t = _apply(trseq.SeqWriter(trseq.empty(CAP, device="cpu"), rid=3), script, run)
    j = _apply(jrseq.SeqWriter(jrseq.empty(CAP), rid=3), script, run)
    assert_same(j, t)
    assert trseq.to_list(t) == jrseq.to_list(j)
    assert int(trseq.size(t)) == int(jrseq.size(j))
    assert int(trseq.n_rows(t)) == int(jrseq.n_rows(j))


def test_alloc_key_matches_jax_through_collisions_and_depth():
    """Concurrent inserts into one gap, then into each other's runs, drive
    keys down several levels; every allocation equals the JAX package's."""
    rows = []
    rng = np.random.default_rng(7)
    seq = {}
    for _ in range(120):
        at = int(rng.integers(0, len(rows) + 1))
        rid = int(rng.integers(0, 4))
        left = rows[at - 1] if at else None
        right = rows[at] if at < len(rows) else None
        s = seq.get(rid, 0)
        key = trseq.alloc_key(left, right, rid, s, 3)
        assert key == jrseq.alloc_key(left, right, rid, s, 3)
        seq[rid] = s + 1
        rows.insert(at, key)
    assert max(trseq.real_depth(trseq._triples(r, 3)) for r in rows) == 3


def test_join_matches_jax_batched_and_single():
    base = branch(trseq.empty(CAP, device="cpu"), 0, 2)
    a = [branch(base, 10 + k, 20 + k) for k in range(4)]
    b = [branch(base, 20 + k, 30 + k) for k in range(4)]
    ta = trseq.RSeq(*(torch.stack([getattr(s, f) for s in a]) for f in ("keys", "elem", "removed")))
    tb = trseq.RSeq(*(torch.stack([getattr(s, f) for s in b]) for f in ("keys", "elem", "removed")))
    got, nu = trseq.join_checked(ta, tb)
    want, wnu = jax.vmap(jrseq.join_checked)(to_jax(ta), to_jax(tb))
    assert_same(want, got)
    np.testing.assert_array_equal(np.asarray(wnu), nu.numpy())
    one = trseq.join(a[0], b[0])
    assert_same(jrseq.join(to_jax(a[0]), to_jax(b[0])), one)
    with pytest.raises(ValueError, match="shapes differ"):
        trseq.join(a[0], trseq.widen(b[0], 7))


def test_join_overflow_count_matches_jax():
    cap = 16
    a = trseq.SeqWriter(trseq.empty(cap, device="cpu"), rid=1)
    b = trseq.SeqWriter(trseq.empty(cap, device="cpu"), rid=2)
    for i in range(12):
        a.append(i)
        b.append(100 + i)
    got, nu = trseq.join_checked(a.state, b.state)
    want, wnu = jrseq.join_checked(to_jax(a.state), to_jax(b.state))
    assert_same(want, got)
    assert int(nu) == int(wnu) == 24


def test_insert_batch_delete_grow_widen_match_jax():
    s = branch(trseq.empty(CAP, device="cpu"), 5, 40)
    js = to_jax(s)
    keys = np.asarray(js.keys)
    live = np.nonzero(np.asarray(js.keys[:, 0]) != 2**31 - 1)[0]
    rows = [trseq.alloc_key(tuple(int(x) for x in keys[live[0]]),
                            tuple(int(x) for x in keys[live[1]]), 9, k, trseq.DEPTH)
            for k in range(2)]
    pad = [(2**31 - 1,) * (4 * trseq.DEPTH)]
    assert_same(jrseq.insert_batch(js, rows + pad, [7, 8, 0]),
                trseq.insert_batch(s, rows + pad, [7, 8, 0]))
    assert_same(jrseq.insert(js, rows[0], 7), trseq.insert(s, rows[0], 7))
    victim = keys[live[2]]
    assert_same(jrseq.delete(js, victim), trseq.delete(s, victim))
    assert_same(jrseq.grow(js, 128), trseq.grow(s, 128))
    assert_same(jrseq.widen(js, 8), trseq.widen(s, 8))
    assert trseq.widen(s, trseq.DEPTH) is s
    with pytest.raises(ValueError, match="narrow"):
        trseq.widen(s, 4)
    with pytest.raises(ValueError, match="shrink"):
        trseq.grow(s, 32)


def test_gc_adapter_and_seq_writer_resume_match_jax():
    s = branch(trseq.empty(CAP, device="cpu"), 2, 50)
    js = to_jax(s)
    t_rid, t_seq = trseq.GC_ADAPTER.rid_seq(s)
    j_rid, j_seq = jrseq.GC_ADAPTER.rid_seq(js)
    np.testing.assert_array_equal(np.asarray(j_rid), t_rid.numpy())
    np.testing.assert_array_equal(np.asarray(j_seq), t_seq.numpy())
    np.testing.assert_array_equal(np.asarray(jrseq.GC_ADAPTER.valid(js)),
                                  trseq.GC_ADAPTER.valid(s).numpy())
    mask = torch.arange(CAP) % 3 == 0
    z = trseq.GC_ADAPTER.vals_zero_like(s, mask)
    jz = jrseq.GC_ADAPTER.vals_zero_like(js, jnp.asarray(mask.numpy()))
    for f in ("elem", "removed"):
        np.testing.assert_array_equal(np.asarray(jz[f]), z[f].numpy())
    assert trseq.SeqWriter(s, rid=2)._seq == jrseq.SeqWriter(js, rid=2)._seq
    with pytest.raises(TypeError, match="RSeq"):
        trseq.SeqWriter(object(), rid=0)


def test_capacity_exceeded_and_gap_rules():
    w = trseq.SeqWriter(trseq.empty(4, device="cpu"), rid=0)
    w.insert_run(None, [1, 2, 3, 4])
    assert w.to_list() == [1, 2, 3, 4]
    with pytest.raises(trseq.CapacityExceeded):
        w.append(5)
    with pytest.raises(trseq.CapacityExceeded):
        w.insert_run(0, [6])
    with pytest.raises(trseq.GapExhausted):
        trseq._alloc_between(5, 6, open_lo=False, open_hi=False)
