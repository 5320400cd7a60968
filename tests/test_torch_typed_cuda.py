"""The join registry, the sequence soak's kernel joins and the typed
LocalCluster on the card against the port's CPU runs.  Needs a card
(marked ``cuda``; skips without one) and imports no JAX, so it runs on a
machine that has only PyTorch:

    python -m pytest --noconftest -m cuda tests/test_torch_typed_cuda.py
"""
import dataclasses
import zlib

import numpy as np
import pytest
import torch

from crdt_tpu_torch.api.cluster import LocalCluster
from crdt_tpu_torch.harness.seq_soak import SeqSoakRunner
from crdt_tpu_torch.ops import hopper_union as hu
from crdt_tpu_torch.ops import joins
from crdt_tpu_torch.utils.config import ClusterConfig
from crdt_tpu_torch.utils.tree import leaves, tree_map

NAMES = sorted(joins.registered_joins())


def need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the registry's bucketed join and the soak's "
                    "lexN joins launch hand-written kernels")


def same(x, y) -> bool:
    lx, ly = leaves(x), leaves(y)
    return len(lx) == len(ly) and all(
        a.dtype == b.dtype and torch.equal(a.cpu(), b.cpu()) for a, b in zip(lx, ly))


def cpu(x):
    return tree_map(lambda t: t.cpu(), x)


@pytest.mark.cuda
@pytest.mark.parametrize("name", NAMES)
def test_registered_join_on_the_card_equals_the_cpu(name):
    """Every registered join on states drawn on the card == the same join
    on their CPU copies, and converge by name on the card == on the CPU."""
    need_card()
    spec = joins.registered_joins()[name]
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    drawn = [spec.rand(rng, device="cuda") for _ in range(6)]
    assert all(t.is_cuda for t in leaves(drawn[0]))
    for a, b in zip(drawn[::2], drawn[1::2]):
        assert same(spec.join(a, b), spec.join(cpu(a), cpu(b)))
        assert same(spec.join(a, spec.neutral(device="cuda")), a)
    stacked = tree_map(lambda *xs: torch.stack(xs), *drawn[:5])
    assert same(joins.converge(name, stacked), joins.converge(name, cpu(stacked)))


@pytest.mark.cuda
@pytest.mark.parametrize("capacity,kernels", [(512, ("lexn_union",)),
                                              (1024, ("lexn_merge", "lexn_compact"))])
def test_seq_soak_auto_equals_generic_on_the_card(capacity, kernels):
    """The soak's auto engine (kernel 1 at capacity 512, kernels 4 and 5 at
    1024) gives the generic engine's report, and launched its kernels."""
    need_card()
    for name in hu.LAUNCHES:
        hu.LAUNCHES[name] = 0
    auto = SeqSoakRunner(n=3, seed=1, capacity=capacity, engine="auto", device="cuda").run(80)
    launched = dict(hu.LAUNCHES)
    generic = SeqSoakRunner(n=3, seed=1, capacity=capacity, engine="generic",
                            device="cuda").run(80)
    assert dataclasses.asdict(auto) == dataclasses.asdict(generic)
    assert all(launched[k] > 0 for k in kernels), launched
    assert hu.LAUNCHES == launched  # the generic engine launches nothing


def _typed_run(device):
    cfg = ClusterConfig(n_replicas=3, seed=4, set_collect_every=3, seq_collect_every=3,
                        map_reset_every=4)
    c = LocalCluster(cfg, device=device)
    rng = np.random.default_rng(9)
    for rnd in range(10):
        c.map_nodes[2].set_alive(rnd not in (3, 4))
        for i in range(12):
            r = int(rng.integers(0, 3))
            key = "abcdef"[int(rng.integers(0, 6))]
            c.nodes[r].add_command({key: str(int(rng.integers(-20, -10)))}, ts=rnd * 100 + i)
            c.set_nodes[r].add(f"e{int(rng.integers(0, 9))}")
            if rng.random() < 0.3:
                c.set_nodes[r].remove(f"e{int(rng.integers(0, 9))}")
            c.seq_nodes[r].insert_at(int(rng.integers(0, 8)), f"q{rnd}.{i}")
            if rng.random() < 0.3:
                c.seq_nodes[r].remove_at(int(rng.integers(0, 8)))
            if rng.random() < 0.1:
                c.map_nodes[r].rem(key)
            else:
                c.map_nodes[r].upd(key, int(rng.integers(-20, -10)))
        c.tick()
    for _ in range(20):
        c.tick()
    return c


@pytest.mark.cuda
def test_typed_cluster_on_the_card_equals_the_cpu():
    """A small typed LocalCluster (3 replicas, the three sibling barriers,
    one map sibling down for two rounds) on the card == on the CPU: views,
    vvs, floors and epochs; its tables on the card."""
    need_card()
    views = []
    for device in ("cuda", "cpu"):
        c = _typed_run(device)
        views.append((c.states(), [n.members() for n in c.set_nodes],
                      [n.items() for n in c.seq_nodes], [n.items() for n in c.map_nodes],
                      [n.epochs() for n in c.map_nodes],
                      [n.vv_snapshot() for n in c.set_nodes + c.seq_nodes + c.map_nodes]))
        if device == "cuda":
            assert all(t.is_cuda for n in c.set_nodes + c.seq_nodes for t in leaves(n.gc))
            assert c.set_converged() and c.seq_converged() and c.map_converged()
    assert views[0] == views[1]
