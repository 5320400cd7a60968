"""The columnar GC swarm (``rseq_engine.plan_gc`` → ``GcSwarm``) on the
card, where kernel 1's wide body does every join, against the port's
generic engine and the GC join's plain twin on the CPU, bit for bit: pull
rounds with a dead lane, lanes whose floors lag, and the GC barrier.  The
GC join's fused route (the floor rule in the wide body's flag pass,
``hopper_union.gc_union_columnar_lexn``) is held against the twin on every
plane, the unique and dropped counts and the merged floor: at tiny and
ragged shapes, on planted cases, and at the ``seq-swarm-10k.gc`` cell's
own size through its pull rounds and the barrier's halvings.  Needs a
card (marked ``cuda``; skips without one) and imports no JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_seq_gc_swarm_cuda.py
"""
import pathlib

import pytest
import torch

from crdt_tpu_torch import workload
from crdt_tpu_torch.models import rseq, rseq_engine, tomb_gc
from crdt_tpu_torch.ops import hopper_union as hu
from crdt_tpu_torch.parallel import swarm
from crdt_tpu_torch.utils.tree import tree_map
from tests.seq_gc_planted import PLANTED_COUNTS, staged_planted

W = workload.SEQ_WRITERS
ROOT = pathlib.Path(__file__).resolve().parents[1]


def need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the lexN kernels have no CPU mode")


def gc_states(r: int, c: int, seed: int) -> tomb_gc.Gc:
    """``seq_swarm`` lanes after one generic barrier with a tenth of them
    down (those keep floor -1 and the removed rows the others collected),
    then each lane removes a seeded 5% of the rows it holds."""
    pool = workload.seq_pool(seed, n_elements=c * 3 // 4)
    states = workload.seq_swarm(pool, r, c, seed, device="cpu").states
    g = tomb_gc.Gc(inner=states, floor=torch.full((r, W), -1, dtype=torch.int32))
    alive = torch.arange(r) % 10 != 3
    g = tomb_gc.gc_round(swarm.make(g, alive), rseq.GC_ADAPTER, rseq.empty(c, device="cpu"),
                         engine="generic").state
    valid = g.inner.keys[..., 0] != 2**31 - 1
    fresh = torch.rand(valid.shape, generator=torch.Generator().manual_seed(seed)) < 0.05
    g.inner.removed |= valid & fresh
    return g


def same(a: tomb_gc.Gc, b: tomb_gc.Gc) -> None:
    for x, y in zip((a.inner.keys, a.inner.elem, a.inner.removed, a.floor),
                    (b.inner.keys, b.inner.elem, b.inner.removed, b.floor)):
        assert torch.equal(x.cpu(), y.cpu())


@pytest.mark.cuda
@pytest.mark.parametrize("r, c", [(300, 256), (260, 1024)])
def test_rounds_and_barrier_on_the_card_match_the_generic_engine(r, c):
    need_card()
    g = gc_states(r, c, r + c)
    alive = torch.ones(r, dtype=torch.bool)
    alive[7] = False
    card = rseq_engine.plan_gc(tree_map(lambda x: x.cuda(), g), alive.cuda())
    host = rseq_engine.plan_gc(g, alive, force_generic=True)
    assert card.engine == "columnar"
    gen = torch.Generator().manual_seed(c)
    before = dict(hu.LAUNCHES)
    for _ in range(3):
        peers = swarm.random_peers(gen, r, device="cpu")
        card, nu_card = card.gossip_round(peers.cuda())
        host, nu_host = host.gossip_round(peers)
        assert torch.equal(nu_card.cpu(), nu_host)
        same(card.rows(), host.rows())
    card_out = card.gc_barrier()
    host_out = host.gc_barrier()
    same(card_out[0].rows(), host_out[0].rows())
    assert card_out[1:] == host_out[1:] and card_out[2] > 0
    # every join took the fused route: kernel 1's GC instance, one launch each
    assert hu.LAUNCHES["lexn_gc_union"] - before["lexn_gc_union"] == 3 + (r - 1).bit_length()
    assert hu.LAUNCHES["lexn_union"] == before["lexn_union"]
    assert card.counts.read()["suppressed"] > 0


# ---- the GC join's fused route against its plain twin ----


def joins(a: rseq_engine.ColumnarGc, b: rseq_engine.ColumnarGc):
    """The GC join of a and b on the card (fused) and of their copies on
    the CPU (the plain twin): ((ColumnarGc, n_unique, dropped) × 2)."""
    card = tree_map(lambda x: x.cuda(), (a, b))
    assert rseq_engine._fused(card[0])
    before = hu.LAUNCHES["lexn_gc_union"]
    got = rseq_engine._gc_join(*card)
    assert hu.LAUNCHES["lexn_gc_union"] == before + 1
    want = rseq_engine._gc_join(*tree_map(lambda x: x.cpu(), (a, b)))
    return got, want


def assert_joins_equal(got, want) -> None:
    """Every plane, n_unique, dropped and the merged floor, bit for bit."""
    (g, g_nu, g_drop), (w, w_nu, w_drop) = got, want
    for x, y in zip((g.col.keys, g.col.elem, g.col.removed, g.floor, g_nu, g_drop),
                    (w.col.keys, w.col.elem, w.col.removed, w.floor, w_nu, w_drop)):
        assert x.dtype == y.dtype and torch.equal(x.cpu(), y.cpu())
    assert g.col.seq_bits == w.col.seq_bits


def staged_pair(r: int, c: int, seed: int):
    """Lane j of ``gc_states`` and the lane it pulls from in a seeded peer
    draw, staged; every fifth lane of the puller's side masked dead (empty
    table, floor -1), as the barrier masks its down lanes."""
    cg = rseq_engine.stack(gc_states(r, c, seed))
    peers = torch.randperm(r, generator=torch.Generator().manual_seed(seed))
    alive = torch.arange(r) % 5 != 1
    return rseq_engine.mask_dead(cg, alive), tree_map(lambda x: x[..., peers].contiguous(), cg)


@pytest.mark.cuda
@pytest.mark.parametrize("r, c", [(1, 64), (2, 64), (7, 64), (9, 128), (130, 256), (260, 1024)])
def test_gc_join_on_the_card_matches_the_twin(r, c):
    """Tiny and ragged shapes (clusters of 8 lanes split), C from 64 to
    the cell's 1,024, dead lanes on one side."""
    need_card()
    a, b = staged_pair(r, c, 7 * r + c)
    got, want = joins(a, b)
    assert_joins_equal(got, want)
    if r >= 9:
        assert int(want[2].sum()) > 0


@pytest.mark.cuda
def test_planted_cases_on_the_card_match_the_twin():
    need_card()
    got, want = joins(*staged_planted())
    assert_joins_equal(got, want)
    assert (got[1].tolist(), got[2].tolist()) == PLANTED_COUNTS


@pytest.mark.cuda
def test_a_kernel_that_checks_one_sides_floor_is_caught(monkeypatch):
    """The kernel handed -1 for A's floor drops only A's rows that B's
    floor covers, never B's that A's covers: the comparison fails."""
    need_card()
    real = hu.gc_union_columnar_lexn

    def one_side(keys_a, vals_a, floor_a, keys_b, vals_b, floor_b, seq_bits):
        return real(keys_a, vals_a, torch.full_like(floor_a, -1), keys_b, vals_b, floor_b,
                    seq_bits)

    monkeypatch.setattr(hu, "gc_union_columnar_lexn", one_side)
    got, want = joins(*staged_planted())
    with pytest.raises(AssertionError):
        assert_joins_equal(got, want)
    assert got[2].tolist() != PLANTED_COUNTS[1]


# ---- the cell's own size: its pull rounds and the barrier's halvings ----


def composition(a, b):
    """The GC join's composition on the card: the lossless union at 2C
    (kernel 1 with the side marker), then the floor rule and compaction in
    plain torch."""
    merged, n_unique, drop = rseq_engine._gc_suppress(a, b, *rseq_engine._gc_union(a, b))
    return merged, n_unique, drop.sum(dim=0, dtype=torch.int32)


def fused(a, b):
    before = hu.LAUNCHES["lexn_gc_union"]
    out = rseq_engine._gc_join(a, b)
    assert hu.LAUNCHES["lexn_gc_union"] == before + 1
    return out


@pytest.mark.cuda
def test_the_cells_pulls_and_halvings_match_the_twin():
    """``seq-swarm-10k.gc`` at its own size (R = 10,240, C = 1,024, depth 6,
    W = 16; the benchmark's snapshot 0 under draw 0 at seed 2**31 + 11):
    each of the 8 pull rounds' joins, and each of the barrier's 14 halvings
    (8,192 lane pairs down to 1), fused on the card against the
    composition on the card, and against the plain twin on the CPU for the
    first pull and the halvings of 1,024 lanes or fewer.  The rows the
    floor rule takes out of the kept pulls are the reference's count:
    12,576 from the pullers' side and 13,531 from the peers'."""
    need_card()
    from portbench import harness, reference_seq
    from portbench.systems import seq_gc_swarm

    spec = harness.Spec(ROOT)
    entry = spec.cells["seq-swarm-10k.gc"]
    config = spec.config(entry)
    cell = seq_gc_swarm.Cell(config, spec.traffic(entry), 2**31 + 11, "cuda")
    snap, bank = cell.snaps[0], cell.bank[0]
    cg, alive = cell.states[0].columnar, snap.alive
    assert (cg.lanes, cg.capacity, cg.col.depth, cg.floor.shape[0]) == (10_240, 1_024, 6, 16)

    st = reference_seq.State(snap.held, snap.seen, snap.floor)
    own = theirs = 0
    for peers in bank:
        ok = (alive & alive[peers])[:, None]
        peer = st.lanes(peers)
        own += int((ok & st.held & ~peer.held & reference_seq.covered(peer.floor, cell.ids)).sum())
        theirs += int((ok & peer.held & ~st.held & reference_seq.covered(st.floor, cell.ids)).sum())
        st, _ = reference_seq.pull_round(st, peers, alive, cell.ids, cell.c)
    assert (own, theirs) == (12_576, 13_531)
    del st, peer

    counts = rseq_engine.GcRowCounts(cg.floor.device)
    for i, peers in enumerate(bank):
        peer = tree_map(lambda x: x[..., peers.long()], cg)
        got = fused(cg, peer)
        assert_joins_equal(got, composition(cg, peer))
        if i == 0:
            assert_joins_equal(got, rseq_engine._gc_join(*tree_map(lambda x: x.cpu(), (cg, peer))))
        del got, peer
        cg, _ = rseq_engine.gc_gossip_round(cg, peers, alive, counts)
    assert counts.read()["suppressed"] == own + theirs

    work = rseq_engine._pad_lanes(rseq_engine.mask_dead(cg, alive), 16_384)
    levels = 0
    while work.lanes > 1:
        p = work.lanes // 2
        lo, hi = rseq_engine._slice_lanes(work, 0, p), rseq_engine._slice_lanes(work, p, 2 * p)
        got = fused(lo, hi)
        assert_joins_equal(got, composition(lo, hi))
        if p <= 1024:
            assert_joins_equal(got, rseq_engine._gc_join(*tree_map(lambda x: x.cpu(), (lo, hi))))
        work, levels = got[0], levels + 1
    assert levels == 14
