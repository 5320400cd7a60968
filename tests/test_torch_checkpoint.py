"""The port's checkpoints (crdt_tpu_torch.utils.checkpoint) against the
JAX package's, zero tolerance: the same ops on a JAX node and a port node
(device="cpu") and their siblings write the same snapshot files (every
JSON file byte for byte, log.npz's arrays equal); a JAX snapshot restores
into a port node booted at another epoch and a port snapshot into a JAX
node, with equal state, vv, frontier, summary, commands and audit digest;
``bump_incarnation``; a corrupt generation is quarantined and the one
before restored in both; a restored node's seq counter continues; the
swarm snapshot round trips; the keyspace's shard files, its reshard
ledger and the lease fences cross both ways, across a reshard epoch."""
import json
import pathlib

import numpy as np
import pytest
import torch

from crdt_tpu.api import compositenode as jcomp
from crdt_tpu.api import mapnode as jmap
from crdt_tpu.api import node as jnode
from crdt_tpu.api import seqnode as jseq
from crdt_tpu.api import setnode as jset
from crdt_tpu.obs import audit as jaudit
from crdt_tpu.utils import checkpoint as jckpt
from crdt_tpu.utils import clock as jclock
from crdt_tpu_torch.api import compositenode as tcomp
from crdt_tpu_torch.api import mapnode as tmap
from crdt_tpu_torch.api import node as tnode
from crdt_tpu_torch.api import seqnode as tseq
from crdt_tpu_torch.api import setnode as tset
from crdt_tpu_torch.models import gcounter, oplog
from crdt_tpu_torch.obs import audit as taudit
from crdt_tpu_torch.utils import checkpoint as tckpt
from crdt_tpu_torch.utils import clock as tclock

JSON_FILES = ("meta.json", "set.json", "seq.json", "map.json", "composite.json")


def _replica(pkg: str, rid: int, epoch: int):
    """A node and its four siblings, in one package, driven by the same
    seeded ops."""
    if pkg == "j":
        node = jnode.ReplicaNode(rid=rid, capacity=32, clock=jclock.ManualClock())
        sibs = dict(set_node=jset.SetNode(rid=rid), seq_node=jseq.SeqNode(rid=rid),
                    map_node=jmap.MapNode(rid=rid), composite_node=jcomp.CompositeNode(rid=rid))
    else:
        node = tnode.ReplicaNode(rid=rid, capacity=32, clock=tclock.ManualClock(), device="cpu")
        sibs = dict(set_node=tset.SetNode(rid=rid, device="cpu"),
                    seq_node=tseq.SeqNode(rid=rid, device="cpu"),
                    map_node=tmap.MapNode(rid=rid, device="cpu"),
                    composite_node=tcomp.CompositeNode(rid=rid, device="cpu"))
    node.clock.epoch_ms = epoch
    return node, sibs


def _drive(node, sibs, peer_payload=None, seed=0):
    rng = np.random.default_rng(seed)
    for i in range(12):
        node.clock.advance(int(rng.integers(0, 3)))
        node.add_command({f"k{int(rng.integers(0, 5))}": str(int(rng.integers(-9, 9))),
                          "s": f"v{i}"} if i % 4 == 0 else
                         {f"k{int(rng.integers(0, 5))}": str(int(rng.integers(-9, 9)))})
    node.add_commands([{"k1": "3"}, {"k2": "x"}], [40, 41])
    if peer_payload is not None:
        node.receive(peer_payload)
    node.compact({node.rid: 6})
    sibs["set_node"].add("a")
    sibs["set_node"].add("b")
    sibs["set_node"].remove("a")
    sibs["seq_node"].insert_at(0, "x")
    sibs["seq_node"].insert_at(1, "y")
    sibs["map_node"].upd("m", 4)
    sibs["map_node"].rem("m")
    sibs["map_node"].upd("n", -2)
    sibs["composite_node"].upd("c", 5)
    sibs["composite_node"].upd("d", -1)
    sibs["composite_node"].rem("d")


def _state(node, mod_audit):
    return (node.get_state(), node.version_vector(), node.frontier, node._summary,
            node._commands, node._seq.count, node.clock.epoch_ms,
            mod_audit.store_digest_hex(node))


def _sibling_views(sibs):
    return (sibs["set_node"].members(), sibs["seq_node"].items(), sibs["map_node"].items(),
            sibs["composite_node"].items())


@pytest.fixture
def snapshots(tmp_path):
    """The same ops on a JAX replica and a port replica (epoch 1,000,000),
    each saved with save_node_atomic."""
    out = {}
    for pkg, ckpt in (("j", jckpt), ("t", tckpt)):
        peer, _ = _replica(pkg, 9, 1_000_000)
        peer.add_command({"p": "1"}, ts=3)
        node, sibs = _replica(pkg, 2, 1_000_000)
        _drive(node, sibs, peer.gossip_payload())
        root = tmp_path / pkg
        snap = ckpt.save_node_atomic(str(root), node, **sibs)
        out[pkg] = (node, sibs, root, pathlib.Path(snap))
    return out


def test_snapshot_files_equal_the_jax_package(snapshots):
    jn, js, _, jsnap = snapshots["j"]
    tn, ts, _, tsnap = snapshots["t"]
    assert _state(tn, taudit) == _state(jn, jaudit)
    for name in JSON_FILES:
        assert (tsnap / name).read_bytes() == (jsnap / name).read_bytes(), name
    with np.load(jsnap / "log.npz") as a, np.load(tsnap / "log.npz") as b:
        assert sorted(a.files) == sorted(b.files) == sorted(tckpt.LOG_COLUMNS)
        for name in a.files:
            assert a[name].dtype == b[name].dtype and np.array_equal(a[name], b[name]), name
    jm = json.loads((jsnap / "MANIFEST.json").read_text())["files"]
    tm = json.loads((tsnap / "MANIFEST.json").read_text())["files"]
    assert set(tm) == set(jm)
    assert {k: v for k, v in tm.items() if k != "log.npz"} == \
        {k: v for k, v in jm.items() if k != "log.npz"}
    assert (snapshots["t"][2] / "LATEST").read_text() == (snapshots["j"][2] / "LATEST").read_text()


@pytest.mark.parametrize("src,dst", [("j", "t"), ("t", "j")])
def test_cross_package_restore_at_another_epoch(snapshots, src, dst):
    """A snapshot from one package restores into a fresh node of the
    other, booted at another epoch: the node adopts the snapshot's epoch,
    and state, vv, frontier, summary, commands, seq counter and the audit
    digest equal the writer's; the siblings' views too; the restored
    node's next write continues its writer's seq."""
    node, sibs, root, _ = snapshots[src]
    fresh, fresh_sibs = _replica(dst, 2, 77)
    ckpt = tckpt if dst == "t" else jckpt
    aud = taudit if dst == "t" else jaudit
    assert ckpt.load_latest_node(str(root), fresh, **fresh_sibs)
    want = _state(node, jaudit if src == "j" else taudit)
    assert _state(fresh, aud) == want
    assert _sibling_views(fresh_sibs) == _sibling_views(sibs)
    assert fresh.gossip_payload() == node.gossip_payload()
    assert [e["snap"] for e in fresh.events.find(event="snapshot_restore")] == ["snap-00000000"]
    count = fresh._seq.count
    fresh.add_command({"after": "1"}, ts=500)
    assert fresh._by_writer[2][-1][0] == (500, 2, count)


def test_incarnation_restore_keeps_a_fresh_seq_counter(snapshots):
    """allow_rid_change (the boot-incarnation path): the new rid writes
    from seq 0, the old rid's ops stay a frozen prefix, in both."""
    out = []
    for pkg, ckpt in (("j", jckpt), ("t", tckpt)):
        node, sibs = _replica(pkg, 2 + 64, 5)
        assert ckpt.load_latest_node(str(snapshots[pkg][2]), node, **sibs)
        node.add_command({"new": "1"}, ts=9)
        out.append((node.get_state(), node.version_vector(), node._seq.count))
    assert out[0] == out[1]
    assert out[1][1][66] == 0 and out[1][1][2] == snapshots["t"][0].version_vector()[2]


def test_restore_preserves_seq_identity(tmp_path):
    """tests/test_checkpoint.py's case on the port: a node restored into
    the same rid mints a fresh seq at an already-used timestamp, so both
    ops survive (SeqGen.count persisted)."""
    n = tnode.ReplicaNode(rid=0, capacity=32, clock=tclock.ManualClock(start=5), device="cpu")
    n.add_command({"x": "1"})
    tckpt.save_node(str(tmp_path / "s"), n)
    n2 = tnode.ReplicaNode(rid=0, capacity=32, clock=tclock.ManualClock(start=5), device="cpu")
    tckpt.restore_node(str(tmp_path / "s"), n2)
    assert n2._seq.count == 1
    assert n2.add_command({"x": "1"})
    assert n2.get_state() == {"x": "2"}
    with pytest.raises(AssertionError, match="another replica"):
        tckpt.restore_node(str(tmp_path / "s"),
                           tnode.ReplicaNode(rid=1, capacity=32, device="cpu"))


def test_bump_incarnation_matches(tmp_path):
    for ckpt, d in ((jckpt, tmp_path / "j"), (tckpt, tmp_path / "t")):
        assert [ckpt.bump_incarnation(str(d)) for _ in range(3)] == [0, 1, 2]
    boot = [(tmp_path / pkg / "boot.json").read_bytes() for pkg in ("t", "j")]
    assert boot[0] == boot[1]


def _two_generations(pkg, root):
    node, sibs = _replica(pkg, 4, 1_000)
    ckpt = tckpt if pkg == "t" else jckpt
    node.add_command({"a": "1"}, ts=1)
    ckpt.save_node_atomic(str(root), node, **sibs)
    node.add_command({"b": "2"}, ts=2)
    ckpt.save_node_atomic(str(root), node, **sibs)
    return ckpt


@pytest.mark.parametrize("corrupt", ["log.npz", "meta-digest"])
def test_corrupt_generation_quarantined_in_both(tmp_path, corrupt):
    """Two generations; the newest is corrupted (a flipped byte in
    log.npz: the manifest catches it; or a command's timestamp moved,
    with the manifest rewritten: the restored digest catches it).  Both packages
    quarantine it, restore the older one, and log the same events."""
    out = {}
    for pkg in ("j", "t"):
        root = tmp_path / pkg
        ckpt = _two_generations(pkg, root)
        snap = root / "snap-00000001"
        if corrupt == "log.npz":
            raw = bytearray((snap / "log.npz").read_bytes())
            raw[len(raw) // 2] ^= 0xFF
            (snap / "log.npz").write_bytes(bytes(raw))
        else:
            meta = json.loads((snap / "meta.json").read_text())
            meta["commands"][0]["ts"] += 1  # a winner's timestamp
            (snap / "meta.json").write_text(json.dumps(meta))
            ckpt.write_manifest(str(snap))
        node, sibs = _replica(pkg, 4, 1_000)
        assert ckpt.load_latest_node(str(root), node, **sibs)
        events = [{k: v for k, v in e.items() if k not in ("ts_ms", "v", "node")}
                  for e in node.events.find() if e["event"].startswith("snapshot_")]
        out[pkg] = (node.get_state(), events,
                    sorted(p.name for p in root.iterdir() if p.is_dir()),
                    node.metrics.registry.counter_value("snapshot_quarantines"))
    assert out["t"] == out["j"]
    assert out["t"][0] == {"a": "1"}
    assert out["t"][2] == ["quarantine-snap-00000001", "snap-00000000"]


def test_no_snapshot_is_a_fresh_boot(tmp_path):
    """No snapshot: a fresh boot in both packages, keyspace and leases
    untouched (until the tier was ported the port refused them here)."""
    for pkg, ckpt in (("j", jckpt), ("t", tckpt)):
        node, _ = _replica(pkg, 0, 1)
        ks, leases = _tier(pkg, node, 2)
        assert not ckpt.load_latest_node(str(tmp_path / "none"), node, keyspace=ks,
                                         leases=leases)
        assert ks.n_shards == 2 and ks.epoch == 0 and leases.fences_snapshot() == {}


def _tier(pkg, node, n_shards):
    """A keyspace of ``n_shards`` (host path, its shards on one ManualClock
    at the node's epoch) and a LeaseManager for ``node``."""
    if pkg == "j":
        from crdt_tpu.consistency.leases import LeaseManager
        from crdt_tpu.keyspace import ShardedKeyspace

        clock = jclock.ManualClock()
        ks = ShardedKeyspace(node.rid, n_shards, capacity=32, mesh="off", clock=clock)
    else:
        from crdt_tpu_torch.consistency.leases import LeaseManager
        from crdt_tpu_torch.keyspace import ShardedKeyspace

        clock = tclock.ManualClock()
        ks = ShardedKeyspace(node.rid, n_shards, capacity=32, mesh="off", device="cpu",
                             clock=clock)
    clock.epoch_ms = node.clock.epoch_ms  # every shard's, reborn ones too
    return ks, LeaseManager(node, n_slots=4, duration=5.0, clock=lambda: 0.0)


def _tier_drive(pkg, ks, leases):
    """Tenant writes through the door, a shard-local fold, fences; the
    reshard machine's window opened."""
    door = (__import__("crdt_tpu.keyspace" if pkg == "j" else "crdt_tpu_torch.keyspace",
                       fromlist=["KeyspaceFrontDoor"]).KeyspaceFrontDoor(ks, max_batch=4))
    for i in range(14):
        door.admit_cmd(("t-a", "t-b")[i % 2], {f"k{i % 9}": f"v{i}"}, timeout=5.0)
    door.flush_all()
    ks.compact_shard(1, {ks.rid: 0})
    leases.note_fence(0, 3)
    leases.note_fence(2, 7)
    leases.grant(1, "http://h", 2, 5.0)


def _tier_state(ks, leases):
    return (ks.epoch, ks.n_shards, ks.reshard.ledger(),
            [s.gossip_payload(since=None) for s in ks.shards],
            [s.version_vector() for s in ks.shards], ks.tenant_state("t-a"),
            ks.tenant_state("t-b"), leases.fences_snapshot())


@pytest.mark.parametrize("phase", ["settled", "migrate", "cutover"])
def test_keyspace_and_lease_snapshots_cross_both_ways(tmp_path, phase):
    """ks-shard-*.json, ks-reshard.json and leases.json byte for byte in
    both packages (settled at 2 shards, inside a MIGRATE window toward 3,
    and after the cutover at epoch 1), and each package's snapshot
    restores into the other: the same shard count, epoch, ledger, every
    shard's wire dump and vv, tenant states and fence floors."""
    saved = {}
    for pkg, ckpt in (("j", jckpt), ("t", tckpt)):
        node, sibs = _replica(pkg, 2, 1_000_000)
        ks, leases = _tier(pkg, node, 2)
        _tier_drive(pkg, ks, leases)
        if phase != "settled":
            ks.reshard.start(3)
        if phase == "cutover":
            ks.reshard.cutover()
        snap = pathlib.Path(ckpt.save_node_atomic(str(tmp_path / pkg), node, keyspace=ks,
                                                  leases=leases))
        saved[pkg] = (snap, _tier_state(ks, leases))
    assert saved["t"][1] == saved["j"][1]
    names = sorted(p.name for p in saved["j"][0].iterdir())
    assert sorted(p.name for p in saved["t"][0].iterdir()) == names
    tier_files = [n for n in names if n.startswith(("ks-", "leases"))]
    assert tier_files == sorted(["ks-reshard.json", "leases.json"] +
                                [f"ks-shard-{i}.json" for i in range(saved["t"][1][1])])
    for name in tier_files:
        assert (saved["t"][0] / name).read_bytes() == (saved["j"][0] / name).read_bytes(), name
    for src, dst in (("j", "t"), ("t", "j")):
        ckpt = tckpt if dst == "t" else jckpt
        node, _ = _replica(dst, 2, 5)
        ks, leases = _tier(dst, node, 2)
        assert ckpt.load_latest_node(str(tmp_path / src), node, keyspace=ks, leases=leases)
        got = _tier_state(ks, leases)
        assert got == saved[src][1], (src, dst)
        events = [e for e in node.events.find(event="snapshot_restore")]
        assert events[-1]["ks_shards"] == saved[src][1][1]
        assert ks.reshard.status()["phase"] == ("migrate" if phase == "migrate" else "idle")


def test_swarm_snapshot_round_trips(tmp_path):
    """save_swarm / restore_swarm over the port's tensor trees, and the
    port's swarm.npz read back by the JAX package's restore_swarm (its
    no-orbax layout: leaf_{i} in tree order)."""
    import jax.numpy as jnp

    from crdt_tpu.models import gcounter as jgc
    from crdt_tpu.models import oplog as joplog

    state = gcounter.GCounter(counts=torch.arange(64, dtype=torch.int32).reshape(8, 8))
    tckpt.save_swarm(str(tmp_path / "g"), state)
    back = tckpt.restore_swarm(str(tmp_path / "g"), gcounter.zero(8, batch=(8,), device="cpu"))
    assert torch.equal(back.counts, state.counts)
    jback = jckpt.restore_swarm(str(tmp_path / "g"), jgc.zero(8, batch=(8,)))
    assert np.array_equal(np.asarray(jback.counts), state.counts.numpy())
    log = oplog.empty(16, device="cpu")
    log = oplog.OpLog(**{f: torch.stack([getattr(log, f)] * 3) for f in tckpt.LOG_COLUMNS})
    tckpt.save_swarm(str(tmp_path / "o"), log)
    jlike = joplog.OpLog(**{f: jnp.stack([getattr(joplog.empty(16), f)] * 3)
                            for f in tckpt.LOG_COLUMNS})
    jlog = jckpt.restore_swarm(str(tmp_path / "o"), jlike)
    for f in tckpt.LOG_COLUMNS:
        assert np.array_equal(np.asarray(getattr(jlog, f)), getattr(log, f).numpy()), f
