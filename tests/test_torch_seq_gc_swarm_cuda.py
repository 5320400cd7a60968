"""The columnar GC swarm (``rseq_engine.plan_gc`` → ``GcSwarm``) on the
card, where kernel 1's wide body does every join, against the port's
generic engine on the CPU, bit for bit: pull rounds with a dead lane,
lanes whose floors lag, and the GC barrier.  Needs a card (marked
``cuda``; skips without one) and imports no JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_seq_gc_swarm_cuda.py
"""
import pytest
import torch

from crdt_tpu_torch import workload
from crdt_tpu_torch.models import rseq, rseq_engine, tomb_gc
from crdt_tpu_torch.ops import hopper_union as hu
from crdt_tpu_torch.parallel import swarm
from crdt_tpu_torch.utils.tree import tree_map

W = workload.SEQ_WRITERS


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
    before = hu.LAUNCHES["lexn_union"]
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
    assert hu.LAUNCHES["lexn_union"] - before == 3 + (r - 1).bit_length()
    assert card.counts.read()["suppressed"] > 0
