"""The port's columnar RSeq swarm path (crdt_tpu_torch.models.rseq_columnar)
against the JAX package's: stack/unstack against its host stack, the
merges, gossip and converge against its reference join
(``jax.vmap(rseq.join_checked)``) and, at a small depth, its columnar merge
in interpret mode; budget errors and the loud plan fallback.  Zero
tolerance."""
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crdt_tpu.models import rseq as jrseq, rseq_columnar as jrc
from crdt_tpu_torch import convert
from crdt_tpu_torch.models import rseq as trseq, rseq_columnar as trc
from crdt_tpu_torch.models.oplog_engine import EngineFallback
from tests.test_torch_rseq import assert_same, branch, to_jax

CAP = 64


def swarm(seed, r, rid_base, cap=CAP, depth=trseq.DEPTH, base=None):
    """[R, C, 4D] batched RSeq: concurrent branches off a shared base, so
    cross-replica duplicate keys and one-sided tombstones are plentiful
    (writer rids unique across every state ever joined)."""
    if base is None:
        base = branch(trseq.empty(cap, depth, device="cpu"), 0, seed)
    states = [branch(base, rid_base + k, seed * 100 + k) for k in range(r)]
    return trseq.RSeq(*(torch.stack([getattr(s, f) for s in states])
                        for f in ("keys", "elem", "removed")))


def pair(seed, r=4, **kw):
    base = branch(trseq.empty(kw.get("cap", CAP), kw.get("depth", trseq.DEPTH),
                              device="cpu"), 0, seed)
    a = swarm(seed + 1, r, 10, base=base, **kw)
    b = swarm(seed + 2, r, 20, base=base, **kw)
    bits = min(trc.stack(a).seq_bits, trc.stack(b).seq_bits)
    return a, b, bits


def assert_col(jcol, tcol):
    got = convert.columnar_rseq_to_numpy(tcol)
    assert got["seq_bits"] == jcol.seq_bits
    for f in ("keys", "elem", "removed"):
        np.testing.assert_array_equal(np.asarray(getattr(jcol, f)), got[f], err_msg=f)


def lane(s, i):
    return jax.tree.map(lambda x: x[i], s)


def test_stack_unstack_match_jax():
    a = swarm(1, 5, 10)
    tcol = trc.stack(a)
    assert_col(jrc.stack(to_jax(a)), tcol)
    assert tcol.depth == trseq.DEPTH and tcol.lanes == 5
    assert_same(jrc.unstack(jrc.stack(to_jax(a))), trc.unstack(tcol))
    one = trseq.RSeq(a.keys[2], a.elem[2], a.removed[2])
    assert_col(jrc.stack(to_jax(one)), trc.stack(one))
    assert_col(jrc.stack(to_jax(a), seq_bits=24), trc.stack(a, seq_bits=24))
    for n, top in ((1, 0), (21, 99), (10_240, 2000)):
        assert trc.fit_seq_bits(n, top) == jrc.fit_seq_bits(n, top)
    with pytest.raises(ValueError, match="31-bit"):
        trc.fit_seq_bits(1 << 20, 1 << 12)


@pytest.mark.parametrize("seed", [3, 4])
def test_merge_checked_matches_the_reference_join(seed):
    a, b, bits = pair(seed)
    got, nu = trc.merge_checked(trc.stack(a, bits), trc.stack(b, bits))
    want, wnu = jax.vmap(jrseq.join_checked)(to_jax(a), to_jax(b))
    assert_same(want, trc.unstack(got))
    np.testing.assert_array_equal(np.asarray(wnu), nu.numpy())


def test_ragged_lanes_match_the_padded_jax_columnar_merge():
    """Five lanes at depth 2: the JAX merge pads them to 128 for its Pallas
    tile (interpret mode here), the port runs them as they are."""
    a, b, bits = pair(5, r=5, cap=32, depth=2)
    ja, jb = jrc.stack(to_jax(a), seq_bits=bits), jrc.stack(to_jax(b), seq_bits=bits)
    want, wnu = jrc.merge_checked(ja, jb, interpret=True)
    got, nu = trc.merge_checked(trc.stack(a, bits), trc.stack(b, bits))
    assert_col(want, got)
    np.testing.assert_array_equal(np.asarray(wnu), nu.numpy())


def test_overflow_stays_detectable():
    cap = 16
    wa = trseq.SeqWriter(trseq.empty(cap, device="cpu"), rid=1)
    wb = trseq.SeqWriter(trseq.empty(cap, device="cpu"), rid=2)
    for i in range(12):
        wa.append(i)
        wb.append(50 + i)
    two = [trseq.RSeq(*(torch.stack([getattr(w.state, f)] * 2)
                        for f in ("keys", "elem", "removed"))) for w in (wa, wb)]
    bits = min(trc.stack(two[0]).seq_bits, trc.stack(two[1]).seq_bits)
    got, nu = trc.merge_checked(trc.stack(two[0], bits), trc.stack(two[1], bits))
    want, wnu = jax.vmap(jrseq.join_checked)(to_jax(two[0]), to_jax(two[1]))
    assert_same(want, trc.unstack(got))
    assert nu.tolist() == np.asarray(wnu).tolist() == [24, 24]


def test_converge_with_alive_matches_the_reference_tree():
    """Six lanes, lane 2 dead: the port's lane-halving tree (padded to 8)
    against the JAX reference join run over the same tree; the dead lane
    keeps its table."""
    st = swarm(6, 6, 10)
    alive = torch.tensor([True, True, False, True, True, True])
    col = trc.stack(st)
    got, max_nu = trc.converge_checked(col, alive)

    j = to_jax(st)
    neutral = jrseq.empty(CAP)
    work = jax.tree.map(
        lambda x, n: jnp.where(jnp.asarray(alive.numpy()).reshape((-1,) + (1,) * (x.ndim - 1)),
                               x, n[None]), j, neutral)
    work = jax.tree.map(lambda x, n: jnp.concatenate([x, jnp.stack([n, n])]), work, neutral)
    want_nu = 0
    while jax.tree.leaves(work)[0].shape[0] > 1:
        p = jax.tree.leaves(work)[0].shape[0] // 2
        work, nu = jax.vmap(jrseq.join_checked)(lane(work, slice(0, p)),
                                                lane(work, slice(p, 2 * p)))
        want_nu = max(want_nu, int(nu.max()))
    top = lane(work, 0)
    out = trc.unstack(got)
    for i in range(6):
        assert_same(top if alive[i] else lane(j, i),
                    trseq.RSeq(out.keys[i], out.elem[i], out.removed[i]))
    assert int(max_nu) == want_nu <= CAP
    assert_col(jrc.stack(to_jax(out), seq_bits=col.seq_bits),
               trc.converge(col, alive))


def test_gossip_round_matches_the_reference_join():
    st = swarm(7, 4, 10)
    peers = torch.tensor([1, 2, 3, 0])
    alive = torch.tensor([True, True, True, False])
    got = trc.unstack(trc.gossip_round(trc.stack(st), peers, alive))
    j = to_jax(st)
    joined = jax.vmap(jrseq.join)(j, lane(j, jnp.asarray([1, 2, 3, 0])))
    for i in range(4):
        ok = bool(alive[i] and alive[peers[i]])
        assert_same(lane(joined if ok else j, i),
                    trseq.RSeq(got.keys[i], got.elem[i], got.removed[i]))
    free = trc.unstack(trc.gossip_round(trc.stack(st), peers))
    assert_same(joined, free)


def test_stack_budget_errors():
    w = trseq.SeqWriter(trseq.empty(CAP, device="cpu"), rid=1)
    for i in range(6):
        w.append(i)  # seqs 0..5: a 2-bit seq field cannot hold 5
    with pytest.raises(ValueError, match="exceeds the"):
        trc.stack(w.state, seq_bits=2)
    bad = trseq.RSeq(w.state.keys.clone(), w.state.elem, w.state.removed)
    bad.keys[0, 2] = -3
    with pytest.raises(ValueError, match="negative identity"):
        trc.stack(bad)
    bad = trseq.RSeq(w.state.keys.clone(), w.state.elem, w.state.removed)
    bad.keys[1, 4] = 1 << 30
    with pytest.raises(ValueError, match="p_hi range"):
        trc.stack(bad)
    with pytest.raises(ValueError, match="4\\*depth"):
        trc.stack(trseq.RSeq(w.state.keys[:, :5], w.state.elem, w.state.removed))


def test_merge_rejects_mismatched_layouts():
    st = swarm(8, 2, 10)
    with pytest.raises(ValueError, match="pack layouts"):
        trc.merge_checked(trc.stack(st, seq_bits=20), trc.stack(st, seq_bits=21))
    with pytest.raises(ValueError, match="depths differ"):
        trc.merge_checked(trc.stack(st), trc.stack(trseq.widen(st, 7)))
    with pytest.raises(ValueError, match="lane counts"):
        trc.merge_checked(trc.stack(st), trc._slice_lanes(trc.stack(st), 0, 1))


def test_plan_selects_columnar_and_falls_back_loudly():
    st = swarm(9, 3, 10)
    with warnings.catch_warnings():
        warnings.simplefilter("error", EngineFallback)
        col, reason = trc.plan(st)
    assert reason is None
    assert_col(jrc.plan(to_jax(st))[0], col)
    with pytest.warns(EngineFallback, match="exceeds the"):
        col2, reason2 = trc.plan(st, seq_bits=1)
    assert col2 is None and "exceeds the" in reason2
    odd = trseq.RSeq(*(torch.stack([getattr(trseq.empty(96, device="cpu"), f)] * 2)
                       for f in ("keys", "elem", "removed")))
    with pytest.warns(EngineFallback, match="power of two"):
        assert trc.plan(odd) == (None, "capacity 96 is not a power of two (bitonic network)")
