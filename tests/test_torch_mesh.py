"""The port's multi-rank anti-entropy (crdt_tpu_torch.parallel.mesh) over a
real gloo world of 4 ranks on the CPU, against the JAX package's
``parallel.mesh`` on the conftest's virtual CPU devices: a 4-device mesh
(the XOR-partner butterfly) and a 3-device mesh (the all_gather branch),
the twins of tests/test_mesh.py.  Zero tolerance.

The world starts once for the module (tests/torch_world.py); its ranks
import nothing of JAX.  Each rank returns its shard and the twins
concatenate the shards in rank order."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from crdt_tpu.models import gcounter as jgc, oplog as jlog
from crdt_tpu.parallel import mesh as jmesh, swarm as jswarm
from crdt_tpu.parallel.compat import shard_map
from crdt_tpu_torch.parallel import mesh as tmesh, multihost
from tests import helpers, torch_world

FIELDS = ("ts", "rid", "seq", "key", "val", "payload", "is_num")


def _np(tree):
    return jax.tree.map(np.asarray, jax.device_get(tree))


def _log_np(log):
    return {f: np.asarray(getattr(log, f)) for f in FIELDS}


def _counters(seed, r, dead=()):
    rng = np.random.default_rng(seed)
    counts = np.asarray(rng.integers(0, 100, (r, 8)), np.int32)
    alive = np.ones(r, bool)
    alive[list(dead)] = False
    return counts, alive


def _logs(seed, r, cap):
    rng = np.random.default_rng(seed)
    logs = helpers.rand_oplog_family(rng, n_logs=r, capacity=cap, pool=30, take=10)
    return jax.tree.map(lambda *xs: jnp.stack(xs), *logs)


def _jax_pmax(counts, alive, n):
    s = jswarm.make(jgc.GCounter(counts=jnp.asarray(counts)), jnp.asarray(alive))
    m = jmesh.make_mesh(n)
    return np.asarray(jmesh.pmax_converge(m)(jmesh.shard_swarm(s, m)).state.counts)


def _jax_generic(state, alive, n, cap):
    s = jswarm.make(state, jnp.asarray(alive))
    m = jmesh.make_mesh(n)
    step = jmesh.sharded_converge(m, join_batched=jax.vmap(jlog.merge),
                                  join_single=jlog.merge, neutral=jlog.empty(cap))
    return _log_np(step(jmesh.shard_swarm(s, m)).state)


def _jax_allreduce(state, n, cap):
    m = jmesh.make_mesh(n)

    def body(x):
        single = jax.tree.map(lambda leaf: leaf[0], x)
        out = jmesh.allreduce_join(jlog.merge, single, "replica", n, neutral=jlog.empty(cap))
        return jax.tree.map(lambda leaf: leaf[None], out)

    got = jax.jit(shard_map(body, mesh=m, in_specs=P("replica"),
                            out_specs=P("replica")))(state)
    return _log_np(got)


def _jax_gossip(counts, peers, n):
    s = jswarm.make(jgc.GCounter(counts=jnp.asarray(counts)))
    m = jmesh.make_mesh(n)
    sharded = jmesh.shard_swarm(s, m)
    p = jax.device_put(jnp.asarray(peers), NamedSharding(m, P("replica")))
    step = jax.jit(lambda sw, pp: jswarm.gossip_round(sw, pp, jgc.join))
    return np.asarray(step(sharded, p).state.counts)


CASES = {
    # (r, dead lanes) per mesh size
    "pmax": {4: (64, ()), 3: (33, ())},
    "pmax_alive": {4: (32, (5, 17)), 3: (30, (5, 17))},
    "generic": {4: 16, 3: 12},
}
CAP = 64


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """One gloo world of 4 ranks for the module: every case's inputs go
    in, every rank's outputs come back; the JAX references beside them."""
    inputs, want = {}, {}
    for seed, name in enumerate(("pmax", "pmax_alive")):
        for n, (r, dead) in CASES[name].items():
            counts, alive = _counters(10 * seed + n, r, dead)
            inputs.setdefault(name, {})[n] = {"counts": counts, "alive": alive}
            want.setdefault(name, {})[n] = _jax_pmax(counts, alive, n)
    for n, r in CASES["generic"].items():
        state = _logs(2 + n, r, CAP)
        alive = np.ones(r, bool)
        alive[r - 2] = False
        inputs.setdefault("generic_oplog", {})[n] = {"logs": _log_np(state), "alive": alive}
        want.setdefault("generic_oplog", {})[n] = _jax_generic(state, alive, n, 64)
    for n in (4, 3):
        state = _logs(30 + n, n, 32)
        inputs.setdefault("allreduce", {})[n] = {"logs": _log_np(state)}
        want.setdefault("allreduce", {})[n] = _jax_allreduce(state, n, 32)
        counts, _ = _counters(40 + n, 12 * n // 3 * 2)
        peers = np.random.default_rng(n).integers(0, len(counts), len(counts)).astype(np.int32)
        inputs.setdefault("gossip", {})[n] = {"counts": counts, "peers": peers}
        want.setdefault("gossip", {})[n] = _jax_gossip(counts, peers, n)
    ranks = torch_world.run_world(tmp_path_factory.mktemp("mesh_world"),
                                  sorted(inputs.items()))
    return ranks, want


def _concat(ranks, case, n, axis=0):
    parts = [ranks[r][case][n] for r in range(n)]
    if isinstance(parts[0], dict):
        return {k: np.concatenate([p[k] for p in parts], axis=axis) for k in parts[0]}
    return np.concatenate(parts, axis=axis)


def test_ranks_import_no_jax(world):
    ranks, _ = world
    assert [r["_jax_imported"] for r in ranks] == [False] * 4


@pytest.mark.parametrize("n", [4, 3])
@pytest.mark.parametrize("case", ["pmax", "pmax_alive"])
def test_pmax_converge_matches_jax_mesh(world, case, n):
    ranks, want = world
    np.testing.assert_array_equal(_concat(ranks, case, n), want[case][n])
    if n == 3:
        assert ranks[3][case][3] is None  # rank 3 is not on make_mesh(3)


@pytest.mark.parametrize("n", [4, 3])
def test_sharded_converge_generic_join_oplog_matches_jax_mesh(world, n):
    ranks, want = world
    got = _concat(ranks, "generic_oplog", n)
    for f in FIELDS:
        np.testing.assert_array_equal(got[f], want["generic_oplog"][n][f], err_msg=f)
    sizes = (got["ts"] != 2**31 - 1).sum(axis=1)
    alive = np.ones(len(sizes), bool)
    alive[-2] = False
    assert (sizes[alive] == sizes[0]).all()


@pytest.mark.parametrize("n", [4, 3], ids=["butterfly", "all_gather"])
def test_allreduce_join_both_paths_match_jax(world, n):
    """4 ranks: the XOR-partner butterfly; 3 ranks: all_gather + the tree
    reduction.  Every rank ends with JAX's row for its device."""
    ranks, want = world
    for r in range(n):
        for f in FIELDS:
            np.testing.assert_array_equal(ranks[r]["allreduce"][n][f],
                                          want["allreduce"][n][f][r], err_msg=f)


@pytest.mark.parametrize("n", [4, 3])
def test_gathered_gossip_round_matches_jax_gspmd_round(world, n):
    """JAX's jitted gossip round over sharded inputs (GSPMD inserts the
    gathers) against the port's all-gather + plain gossip_round."""
    ranks, want = world
    for r in range(n):
        np.testing.assert_array_equal(ranks[r]["gossip"][n], want["gossip"][n])


def test_one_rank_mesh_without_a_group():
    """No process group: make_mesh is JAX's one-device mesh, its
    collectives identities, and asking for more ranks raises."""
    m = tmesh.make_mesh(device="cpu")
    assert (m.size, m.rank, m.axis, m.backend) == (1, 0, "replica", "")
    with pytest.raises(RuntimeError, match="no torch.distributed process group"):
        tmesh.make_mesh(4, device="cpu")
    counts, alive = _counters(5, 8, (3,))
    from crdt_tpu_torch.models import gcounter as tgc
    from crdt_tpu_torch.parallel import swarm as tswarm

    s = tswarm.make(tgc.GCounter(counts=torch.from_numpy(counts)), torch.from_numpy(alive))
    got = tmesh.pmax_converge(m)(tmesh.shard_swarm(s, m)).state.counts.numpy()
    np.testing.assert_array_equal(got, _jax_pmax(counts, alive, 1))
    assert multihost.process_span() == (0, 1)
    with pytest.raises(ValueError, match="split evenly"):
        tmesh.shard_swarm(s, tmesh.Mesh(axis="replica", size=3, rank=0,
                                        device=torch.device("cpu")))
