"""The port's multi-host helpers (crdt_tpu_torch.parallel.multihost): the
single-process degradation, and a gloo world of 4 ranks started by
``init_from_env`` itself, against the JAX package's ``multihost`` on the
conftest's virtual CPU devices; the twins of tests/test_multihost.py.
Zero tolerance."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from crdt_tpu.models import gcounter as jgc, oplog as jlog, oplog_columnar as joc
from crdt_tpu.parallel import mesh as jmesh, multihost as jmh, swarm as jswarm
from crdt_tpu_torch.parallel import mesh as tmesh, multihost
from tests import torch_world
from tests.test_torch_oplog_columnar import BITS, _batch, _op_pool

ENV = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK",
       "CRDT_TPU_MULTIHOST")


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """A world of 4 gloo ranks, each started by
    ``multihost.init_from_env(init_method=file://..., device="cpu")``,
    beside JAX's global mesh (8 virtual devices) on the same rows."""
    r = 16
    counts = np.arange(r * 4, dtype=np.int32).reshape(r, 4)
    m = jmh.global_mesh()
    jp = np.asarray(jmesh.pmax_converge(m)(jswarm.make(
        jmh.shard_host_local(jgc.GCounter(counts=counts), m))).state.counts)
    logs = jax.tree.map(lambda *xs: jnp.stack(xs), *[jlog.empty(32) for _ in range(8)])
    gen = jmesh.sharded_converge(m, join_batched=jax.vmap(jlog.merge), join_single=jlog.merge,
                                 neutral=jlog.empty(32))(jswarm.make(jmh.shard_host_local(logs, m)))
    rng = np.random.default_rng(0)
    jcol = joc.stack(_batch(rng, 16, 16, _op_pool(rng, 12))[0], bits=BITS)
    sharded = jax.device_put(jcol, NamedSharding(m, P(None, "replica")))
    out, nu = joc.sharded_converge(m, bits=BITS)(sharded, jnp.ones((16,), bool))
    want = {"pmax": jp, "generic_size": int(jax.vmap(jlog.size)(gen.state).sum()),
            "columnar": out, "nu": int(nu), "single": joc.converge(jcol, interpret=True)}
    inputs = {"counts": counts, "cap": 32,
              "col": {**{p: np.asarray(getattr(jcol, p)) for p in ("hi", "lo", "val", "pay")},
                      "bits": BITS}}
    ranks = torch_world.run_world(tmp_path_factory.mktemp("multihost_world"),
                                  [("multihost_world", inputs)], init="multihost")
    return [x["multihost_world"] for x in ranks], want, ranks


def test_init_noop_without_cluster_env(monkeypatch):
    for k in ENV:
        monkeypatch.delenv(k, raising=False)
    assert jmh.init_from_env() is False
    assert multihost.init_from_env(device="cpu") is False


def test_failed_bootstrap_raises(monkeypatch):
    """A configured cluster that cannot start raises (never a quiet single
    host): autodetect with nothing exported, and a bad init method."""
    for k in ENV:
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("CRDT_TPU_MULTIHOST", "1")
    with pytest.raises(RuntimeError, match="WORLD_SIZE"):
        multihost.init_from_env(device="cpu")
    with pytest.raises(RuntimeError, match="rendezvous"):
        multihost.init_from_env(init_method="bogus://x", world_size=1, rank=0,
                                device="cpu")
    assert not torch.distributed.is_initialized()


def test_global_mesh_covers_all_ranks(world):
    outs, _, ranks = world
    assert [(o["size"], o["rank"], o["backend"]) for o in outs] == \
        [(4, r, "gloo") for r in range(4)]
    assert len(jmh.global_mesh().devices.ravel()) == len(jax.devices()) == 8
    m = multihost.global_mesh(device="cpu")  # one process: the one-rank mesh
    assert (m.size, m.rank) == (1, 0)
    assert not any(x["_jax_imported"] for x in ranks)


def test_process_span_and_second_init(world):
    outs, _, _ = world
    assert [o["span"] for o in outs] == [(r, 4) for r in range(4)]
    assert all(o["again"] is True for o in outs)  # a second call is a no-op
    assert multihost.process_span() == jmh.process_span() == (0, 1)


def test_shard_host_local_and_converge(world):
    outs, want, _ = world
    got = np.concatenate([o["pmax"] for o in outs])
    np.testing.assert_array_equal(got, want["pmax"])
    np.testing.assert_array_equal(got, np.broadcast_to(got.max(axis=0), got.shape))


def test_shard_host_local_generic_lattice(world):
    outs, want, _ = world
    assert sum(o["generic_size"] for o in outs) == want["generic_size"] == 0


def test_columnar_sharded_converge_on_global_mesh(world):
    outs, want, _ = world
    for p in ("hi", "lo", "val", "pay"):
        got = np.concatenate([o["columnar"][p] for o in outs], axis=1)
        np.testing.assert_array_equal(got, np.asarray(getattr(want["columnar"], p)), err_msg=p)
        np.testing.assert_array_equal(got, np.asarray(getattr(want["single"], p)), err_msg=p)
    assert [o["nu"] for o in outs] == [want["nu"]] * 4
    assert want["nu"] <= 16


def test_rank_device_defaults_to_the_card(monkeypatch):
    """device=None means cuda:LOCAL_RANK, and without a card it raises."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        multihost.global_mesh()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmesh.make_mesh()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setenv("LOCAL_RANK", "3")
    assert multihost.rank_device() == torch.device("cuda", 3)
    assert multihost.rank_device("cpu") == torch.device("cpu")


def test_init_reads_torchrun_environment(monkeypatch, tmp_path):
    """torchrun's variables drive the bootstrap: MASTER_ADDR/MASTER_PORT
    make the tcp:// method, WORLD_SIZE and RANK the world, and device
    "cpu" picks gloo; a world of 1 from WORLD_SIZE/RANK over a file://
    store is a one-rank global mesh with a group, and a second call is a
    no-op."""
    import torch.distributed as dist

    for k in ENV:
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setattr(multihost, "_DEVICE", None)  # restored to None after
    seen = {}
    monkeypatch.setenv("MASTER_ADDR", "10.1.2.3")
    monkeypatch.setenv("MASTER_PORT", "29500")
    monkeypatch.setenv("WORLD_SIZE", "8")
    monkeypatch.setenv("RANK", "5")
    with monkeypatch.context() as m:
        m.setattr(dist, "init_process_group",
                  lambda backend, **kw: seen.update(backend=backend, **kw))
        assert multihost.init_from_env(device="cpu") is True
    assert seen == {"backend": "gloo", "init_method": "tcp://10.1.2.3:29500",
                    "world_size": 8, "rank": 5}
    for k in ("MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k)
    monkeypatch.setenv("WORLD_SIZE", "1")
    monkeypatch.setenv("RANK", "0")
    try:
        assert multihost.init_from_env(init_method=f"file://{tmp_path}/store",
                                       device="cpu") is True
        assert multihost.init_from_env() is True
        m = multihost.global_mesh()
        assert (m.size, m.rank, m.backend, m.device) == (1, 0, "gloo", torch.device("cpu"))
        assert multihost.process_span() == (0, 1)
        x = torch.arange(4, dtype=torch.int32)
        assert torch.equal(tmesh.all_gather_leaf(m, x), x)  # runs through gloo
    finally:
        dist.destroy_process_group()
