"""The port's mesh plane (crdt_tpu_torch.parallel.meshplane, device="cpu")
against its own host path and the JAX package's, zero tolerance; follows
tests/test_meshplane.py case by case.

The plane's claim is "same bits, fewer merges": ONE batched step folds
every keyspace shard lane, and each lane's merged log, vv, state, digest
and gossip payload equal what S separate merges give.  The JAX package
runs 8 virtual CPU devices under pytest, where its ``select_engine``
picks ``pjit``; the port's keyspace on the CPU sees one device and picks
``vmap``, so the twins hold the port's ``mesh="on"`` against JAX's plane
pinned to ``engine="vmap"`` and against JAX's host path.  The
``engine=`` cases hold the port's partitioned engine (``pjit`` and
``shard_map``, one engine under two names) on four CPU slots against
JAX's engines on its virtual devices.  Dispatch counters are compared
only where both sides fuse.
"""
from __future__ import annotations

import json
import random
import re
import threading
import urllib.request

import numpy as np
import pytest
import torch

from crdt_tpu import keyspace as jks
from crdt_tpu.api import node as jnode
from crdt_tpu.api.net import NodeHost as JNodeHost
from crdt_tpu.api.net import RemotePeer as JRemotePeer
from crdt_tpu.models import oplog as jlog
from crdt_tpu.parallel import meshplane as jmp
from crdt_tpu.utils.clock import ManualClock as JClock
from crdt_tpu.utils.config import ClusterConfig as JConfig
from crdt_tpu.utils.metrics import Metrics as JMetrics
from crdt_tpu_torch import keyspace as tks
from crdt_tpu_torch.api import node as tnode
from crdt_tpu_torch.api.net import NodeHost as TNodeHost
from crdt_tpu_torch.api.net import RemotePeer as TRemotePeer
from crdt_tpu_torch.models import oplog
from crdt_tpu_torch.parallel import meshplane as tmp
from crdt_tpu_torch.utils.clock import ManualClock as TClock
from crdt_tpu_torch.utils.config import ClusterConfig as TConfig
from crdt_tpu_torch.utils.metrics import Metrics as TMetrics

N_SHARDS = 4
TENANTS = ("t-acme", "t-bravo", "t-noisy")
_COLS = ("ts", "rid", "seq", "key", "val", "payload", "is_num")


def _keyspace(pkg, mesh, clock, n_shards=N_SHARDS):
    if pkg == "j":
        ks = jks.ShardedKeyspace(rid=0, n_shards=n_shards, capacity=64,
                                 metrics=JMetrics(), clock=clock, mesh=mesh)
        if mesh == "on":  # the port's engine; JAX would pick pjit here
            ks._meshplane = jmp.MeshPlane(n_shards, mode="on",
                                          metrics=ks.shards[0].metrics, engine="vmap")
        return ks
    return tks.ShardedKeyspace(rid=0, n_shards=n_shards, capacity=64, metrics=TMetrics(),
                               clock=clock, mesh=mesh, device="cpu")


def _twin_keyspaces(n_shards=N_SHARDS):
    """The port's mesh keyspace and host-path twin, on ONE ManualClock
    (same epoch, so the same rebased ts and bit-comparable logs)."""
    clock = TClock()
    return (_keyspace("t", "off", clock, n_shards), _keyspace("t", "on", clock, n_shards),
            clock)


def _writers(ks, clock, rids=(100, 101)):
    """Per-(shard, rid) writer nodes on the keyspace's clock: the gossip
    sources whose payloads every twin folds."""
    return {(s, r): tnode.ReplicaNode(rid=r, capacity=64, clock=clock, device="cpu")
            for s in range(ks.n_shards) for r in rids}


def _random_round(rng, ks, writers, clock, n_ops=8):
    """One gossip round: random tenant-qualified writes land on the writer
    owning their shard; returns one payload per shard (None for shards
    nothing routed to this round)."""
    rids = sorted({r for (_, r) in writers})
    for _ in range(n_ops):
        tenant = rng.choice(TENANTS)
        key = f"k{rng.randrange(12)}"
        shard = ks.shard_of(tenant, key)
        writers[(shard, rng.choice(rids))].add_commands(
            [{tks.qualify(tenant, key): f"v{rng.randrange(1000)}"}])
        clock.advance(rng.randrange(1, 3))
    payloads = []
    for s in range(ks.n_shards):
        merged = {}
        for r in rids:
            merged.update(writers[(s, r)].gossip_payload() or {})
        payloads.append(merged or None)
    return payloads


def _live(node):
    n = int(oplog.size(node.log)) if isinstance(node, tnode.ReplicaNode) \
        else int(np.asarray(node.log.ts != 2**31 - 1).sum())
    return [np.asarray(getattr(node.log, c))[:n].tolist() for c in _COLS]


def _assert_shards_equal(a, b):
    """state, vv, gossip payload, digest and the live prefix of every raw
    OpLog column, shard by shard (either package on either side)."""
    for i, (x, y) in enumerate(zip(a.shards, b.shards)):
        assert x.get_state() == y.get_state(), f"shard {i} state"
        assert x.version_vector() == y.version_vector(), f"shard {i} vv"
        assert x.gossip_payload() == y.gossip_payload(), f"shard {i} payload"
        assert x.gossip_payload_json({}) == y.gossip_payload_json({}), f"shard {i} bytes"
        assert _live(x) == _live(y), f"shard {i} columns"
        assert x.audit_snapshot()[2] == y.audit_snapshot()[2], f"shard {i} digest"


def _assert_no_lock_leak(ks):
    for i, shard in enumerate(ks.shards):
        assert shard._lock.acquire(blocking=False), f"shard {i} lock leaked"
        shard._lock.release()


def _count(metrics, name):
    return metrics.registry.counter_value(name)


def _dispatches(ks):
    return _count(ks.shards[0].metrics, "merge_dispatches")


# ---- engine selection ----

def test_mesh_divisor():
    for n in range(1, 17):
        for d in range(1, 9):
            assert tmp._mesh_divisor(n, d) == jmp._mesh_divisor(n, d)
    assert tmp._mesh_divisor(6, 4) == 3 and tmp._mesh_divisor(5, 4) == 1


@pytest.mark.parametrize("n_devices", [1, 8])
def test_select_engine_modes(n_devices, monkeypatch):
    """JAX's rules for off/on/auto: the port picks exactly the engine JAX's
    select_engine picks on 8 virtual devices, and JAX's one-device rule
    (auto never fuses, on is vmap) on one."""
    monkeypatch.setattr(tmp, "_device_count", lambda device: n_devices)
    with pytest.raises(ValueError):
        tmp.select_engine(4, "bogus", "cpu")
    for n in (0, 1, 2, 4, 7):
        for mode in tmp.MESH_MODES:
            got = tmp.select_engine(n, mode, "cpu")
            if n_devices == 8:
                want = jmp.select_engine(n, mode)
            else:  # JAX's rule on one device: auto never fuses
                want = None if mode == "off" or n < 1 or mode == "auto" else "vmap"
            assert got == want, (n, mode)
    assert tmp.select_engine(4, "auto", "cpu") == (None if n_devices == 1 else "pjit")


def test_select_engine_counts_devices_of_the_keyspace_type():
    assert tmp.select_engine(4, "auto", "cpu") is None  # one CPU device
    assert tmp.select_engine(4, "on", "cpu") == "vmap"
    assert tks.ShardedKeyspace(0, 4, device="cpu").mesh_active is False


def test_config_knob_validated():
    assert TConfig(keyspace_mesh="on").keyspace_mesh == "on"
    with pytest.raises(ValueError):
        TConfig(keyspace_mesh="bogus")
    for mode in tmp.MESH_MODES:
        TConfig(keyspace_mesh=mode)
        JConfig(keyspace_mesh=mode)


# ---- bit-parity: mesh vs host, the port's and JAX's ----

@pytest.mark.parametrize("engine", [None, "vmap"], ids=["selected", "vmap"])
def test_mesh_parity_randomized_multitenant(engine):
    """A randomized multi-tenant trace: after every fused converge, each
    port mesh shard equals its port host twin, JAX's mesh plane (vmap) and
    JAX's host path: state, vv, payload dicts and bytes, the digest and
    all 7 raw OpLog columns."""
    jclock, tclock = JClock(), TClock()
    kss = {(p, m): _keyspace(p, m, jclock if p == "j" else tclock)
           for p in ("j", "t") for m in ("on", "off")}
    mesh = kss[("t", "on")]
    if engine is not None:
        mesh._meshplane = tmp.MeshPlane(N_SHARDS, mode="on", engine=engine, device="cpu",
                                        metrics=mesh.shards[0].metrics)
    for ks in kss.values():
        ks.enable_audit()
    assert mesh.mesh_active and mesh.mesh_engine == "vmap"
    assert kss[("j", "on")].mesh_engine == "vmap"
    writers = _writers(mesh, tclock)
    rng = random.Random(1234)
    for _ in range(6):
        payloads = _random_round(rng, mesh, writers, tclock)
        for (p, m), ks in kss.items():
            if m == "on":
                results = ks.receive_all(payloads)
                assert all(isinstance(r, int) for r in results)
            else:
                for i, pl in enumerate(payloads):
                    if pl is not None:
                        ks.receive(i, pl)
        for key, ks in kss.items():
            _assert_shards_equal(mesh, ks)
    assert mesh.state() == kss[("j", "off")].state() and mesh.state()
    # both sides fuse: one dispatch a round, as JAX's vmap plane
    assert _dispatches(mesh) == _dispatches(kss[("j", "on")]) == 6


# ---- the partitioned engine: pjit / shard_map on four CPU slots ----

SLOTS = ["cpu"] * 4


@pytest.mark.parametrize("engine", ["pjit", "shard_map"])
def test_partitioned_engine_matches_jax_engines(engine):
    """The port's partitioned engine, its 4 lanes split over four CPU
    slots, against JAX's engine of the same name on its virtual devices
    (4 of 8 divide the lanes) and both host paths: every shard's state,
    vv, payload, digest and raw columns after each fused converge; one
    merge a round on both sides."""
    jclock, tclock = JClock(), TClock()
    kss = {(p, m): _keyspace(p, m, jclock if p == "j" else tclock)
           for p in ("j", "t") for m in ("on", "off")}
    jks_on, mesh = kss[("j", "on")], kss[("t", "on")]
    jks_on._meshplane = jmp.MeshPlane(N_SHARDS, mode="on", engine=engine,
                                      metrics=jks_on.shards[0].metrics)
    mesh._meshplane = tmp.MeshPlane(N_SHARDS, mode="on", engine=engine, device="cpu",
                                    devices=SLOTS, metrics=mesh.shards[0].metrics)
    assert mesh.mesh_engine == jks_on.mesh_engine == engine
    assert mesh._meshplane.n_devices == jks_on._meshplane.n_devices == 4
    for ks in kss.values():
        ks.enable_audit()
    writers = _writers(mesh, tclock)
    rng = random.Random(4321)
    for _ in range(5):
        payloads = _random_round(rng, mesh, writers, tclock)
        for (p, m), ks in kss.items():
            if m == "on":
                assert all(isinstance(r, int) for r in ks.receive_all(payloads))
            else:
                for i, pl in enumerate(payloads):
                    if pl is not None:
                        ks.receive(i, pl)
        for ks in kss.values():
            _assert_shards_equal(mesh, ks)
    assert _dispatches(mesh) == _dispatches(jks_on) == 5
    _assert_no_lock_leak(mesh)


def test_partitioned_engine_groups_and_lock_order():
    """d = the largest slot count dividing the lanes; each group's lanes
    fold on their own device; every device lock is taken once, in
    ascending device order."""
    plane = tmp.MeshPlane(6, mode="on", engine="pjit", device="cpu", devices=SLOTS)
    assert plane.n_devices == 3 and plane.devices == [torch.device("cpu")] * 3
    assert [str(d) for d in plane._lock_devices] == ["cpu"]
    plane = tmp.MeshPlane(4, mode="on", engine="shard_map", device="cpu",
                          devices=["cpu", "meta", "cpu", "meta"])
    assert [str(d) for d in plane._lock_devices] == ["cpu", "meta"]
    assert tmp.MeshPlane(5, mode="on", engine="pjit", device="cpu",
                         devices=SLOTS).n_devices == 1
    with pytest.raises(ValueError, match="unknown mesh engine"):
        tmp.MeshPlane(4, engine="gspmd", device="cpu")


@pytest.mark.parametrize("bad_group", [0, 2])
def test_partitioned_group_failure_lands_every_lane_inline(bad_group):
    """A failure in ANY group's step lands every lane with its own inline
    merge: bits equal to the host path, no lock held, one fallback."""
    host, mesh, clock = _twin_keyspaces()
    mesh._meshplane = tmp.MeshPlane(N_SHARDS, mode="on", engine="pjit", device="cpu",
                                    devices=SLOTS, metrics=mesh.shards[0].metrics)
    plane, fold = mesh._meshplane, mesh._meshplane._fold_group

    def flaky(k, *args):
        if k == bad_group:
            raise RuntimeError("injected group failure")
        return fold(k, *args)

    plane._fold_group = flaky
    writers = _writers(mesh, clock)
    payloads = _random_round(random.Random(8), mesh, writers, clock, n_ops=16)
    for i, p in enumerate(payloads):
        if p is not None:
            host.receive(i, p)
    assert all(isinstance(r, int) for r in mesh.receive_all(payloads))
    _assert_shards_equal(host, mesh)
    _assert_no_lock_leak(mesh)
    assert not tnode.device_lock("cpu").locked()
    assert _count(mesh.shards[0].metrics, "meshplane_fallbacks") == 1
    plane._fold_group = fold
    payloads = _random_round(random.Random(9), mesh, writers, clock)
    for i, p in enumerate(payloads):
        if p is not None:
            host.receive(i, p)
    mesh.receive_all(payloads)
    _assert_shards_equal(host, mesh)


# ---- one dispatch per step + per-shard attribution ----

def test_one_dispatch_per_step_and_shard_labels():
    """A fused converge ticks the label-free merge_dispatches ONCE, where
    the host twin ticks it per shard; the per-shard labeled counters tick
    alike on both paths."""
    host, mesh, clock = _twin_keyspaces()
    writers = _writers(mesh, clock)
    payloads = _random_round(random.Random(7), mesh, writers, clock, n_ops=16)
    n_nonempty = sum(1 for p in payloads if p is not None)
    assert n_nonempty == N_SHARDS
    before_m, before_h = _dispatches(mesh), _dispatches(host)
    mesh.receive_all(payloads)
    for i, p in enumerate(payloads):
        if p is not None:
            host.receive(i, p)
    assert _dispatches(mesh) - before_m == 1, "the mesh step is ONE merge"
    assert _dispatches(host) - before_h == n_nonempty
    for ks in (mesh, host):
        text = ks.shards[0].metrics.registry.render_prometheus()
        for i in range(N_SHARDS):
            assert f'crdt_merge_dispatches_total{{shard="{i}"}} 1' in text
            assert f'crdt_union_path_total{{path="sort",shard="{i}"}} 1' in text


def test_zero_fresh_converge_skips_device():
    """A pure redelivery commits inline: no merge at all."""
    host, mesh, clock = _twin_keyspaces()
    writers = _writers(mesh, clock)
    payloads = _random_round(random.Random(3), mesh, writers, clock)
    mesh.receive_all(payloads)
    before = _dispatches(mesh)
    assert all(r == 0 for r in mesh.receive_all(payloads))
    assert _dispatches(mesh) == before
    assert all(isinstance(r, int) for r in mesh.receive_all([None] * N_SHARDS))
    assert _dispatches(mesh) == before


# ---- corrupt-shard isolation inside the fused step ----

def test_corrupt_shard_isolated_siblings_fold():
    """A payload that fails validation quarantines its OWN lane while the
    siblings converge in the same single step; JAX's vmap plane returns
    the same results."""
    host, mesh, clock = _twin_keyspaces()
    jmesh = _keyspace("j", "on", JClock())
    writers = _writers(mesh, clock)
    payloads = _random_round(random.Random(11), mesh, writers, clock, n_ops=16)
    payloads[1] = {"nemesis:corrupt:key": {"a": "b"}}
    for i, p in enumerate(payloads):
        if i != 1 and p is not None:
            host.receive(i, p)
    before = _dispatches(mesh)
    results = mesh.receive_all(payloads, quarantine=True)
    assert results == jmesh.receive_all(payloads, quarantine=True)
    assert isinstance(results[1], str) and "ValueError" in results[1]
    assert all(isinstance(r, int) and r > 0 for i, r in enumerate(results) if i != 1)
    _assert_shards_equal(host, mesh)
    _assert_shards_equal(jmesh, mesh)
    assert _dispatches(mesh) - before == 1
    with pytest.raises(ValueError):
        mesh.receive_all(payloads, quarantine=False)
    mesh.receive_all([None] * N_SHARDS)
    _assert_no_lock_leak(mesh)


# ---- step failure: inline fallback ----

def test_step_failure_falls_back_to_inline_commits():
    """A step that blows up lands every lane with its own inline merge:
    bits equal to the host path, locks released, meshplane_fallbacks 1."""
    host, mesh, clock = _twin_keyspaces()
    plane = mesh._plane()

    def boom(capacity, batch_cap):
        raise RuntimeError("injected engine failure")

    plane._step_for = boom
    writers = _writers(mesh, clock)
    payloads = _random_round(random.Random(5), mesh, writers, clock)
    for i, p in enumerate(payloads):
        if p is not None:
            host.receive(i, p)
    assert all(isinstance(r, int) for r in mesh.receive_all(payloads))
    _assert_shards_equal(host, mesh)
    _assert_no_lock_leak(mesh)
    assert _count(mesh.shards[0].metrics, "meshplane_fallbacks") == 1
    assert _dispatches(mesh) == sum(1 for p in payloads if p is not None)


def test_lane_count_mismatch_aborts_cleanly():
    host, mesh, clock = _twin_keyspaces()
    with pytest.raises(ValueError):
        mesh.receive_all([None] * (N_SHARDS + 1))
    plane = mesh._plane()
    pendings = [s.merge_begin([]) for s in mesh.shards[:2]]
    with pytest.raises(ValueError):
        plane.converge(pendings)
    _assert_no_lock_leak(mesh)
    writers = _writers(mesh, clock)
    payloads = _random_round(random.Random(2), mesh, writers, clock)
    assert sum(r for r in mesh.receive_all(payloads) if isinstance(r, int)) > 0


# ---- failure paths never leak a lane's node lock ----

def test_adoption_failure_quarantines_lane_without_lock_leak():
    """A payload that passes validation but fails at ADOPTION inside
    merge_begin (a frontier without __summary__): with quarantine it is
    that lane's error string while the siblings fold; without, it raises
    once every held lane landed inline."""
    host, mesh, clock = _twin_keyspaces()
    writers = _writers(mesh, clock)
    payloads = _random_round(random.Random(23), mesh, writers, clock, n_ops=16)
    bad = {"__frontier__": {"7": 5}}
    assert mesh.shards[2].validate_payload(bad) is None
    payloads[2] = bad
    for i, p in enumerate(payloads):
        if i != 2 and p is not None:
            host.receive(i, p)
    results = mesh.receive_all(payloads, quarantine=True)
    assert isinstance(results[2], str) and "__summary__" in results[2]
    assert all(isinstance(r, int) and r > 0 for i, r in enumerate(results)
               if i != 2 and payloads[i] is not None)
    _assert_no_lock_leak(mesh)
    _assert_shards_equal(host, mesh)
    payloads2 = _random_round(random.Random(24), mesh, writers, clock)
    payloads2[2] = dict(bad)
    with pytest.raises(ValueError, match="__summary__"):
        mesh.receive_all(payloads2, quarantine=False)
    _assert_no_lock_leak(mesh)
    assert all(isinstance(r, int) for r in mesh.receive_all([None] * N_SHARDS))


def test_commit_failure_still_commits_sibling_lanes():
    """ONE lane's commit raising still commits every sibling's lane before
    the error surfaces: no lock held, no host index ahead of its log."""
    host, mesh, clock = _twin_keyspaces()
    writers = _writers(mesh, clock)
    payloads = _random_round(random.Random(31), mesh, writers, clock, n_ops=16)
    for i, p in enumerate(payloads):
        if p is not None:
            host.receive(i, p)
    bad = next(i for i, p in enumerate(payloads) if p is not None)

    def boom():
        raise RuntimeError("injected commit failure")

    mesh.shards[bad]._count_lane_fold = boom
    try:
        with pytest.raises(RuntimeError, match="injected commit failure"):
            mesh.receive_all(payloads)
    finally:
        del mesh.shards[bad]._count_lane_fold
    _assert_no_lock_leak(mesh)
    _assert_shards_equal(host, mesh)
    assert all(isinstance(r, int) for r in mesh.receive_all([None] * N_SHARDS))


def _door_groups(ks, n=16):
    groups = {}
    for i in range(n):
        key = f"k{i}"
        groups.setdefault(ks.shard_of("t-acme", key), []).append(
            (None, {tks.qualify("t-acme", key): f"v{i}"}, "t-acme"))
    return groups


def test_fused_flush_converge_failure_fails_claims_and_releases_lanes():
    """flush_all_fused with a commit that raises fails every outstanding
    claim (tickets see the error, none hangs) and releases every drain
    slot and node lock; the door keeps working."""
    mesh = tks.ShardedKeyspace(rid=0, n_shards=N_SHARDS, capacity=64, metrics=TMetrics(),
                               clock=TClock(), mesh="on", device="cpu")
    door = tks.KeyspaceFrontDoor(mesh, max_batch=1024)
    groups = _door_groups(mesh)
    lane_tickets = door._submit_groups(groups, "t-acme")
    bad = next(iter(groups))

    def boom():
        raise RuntimeError("injected commit failure")

    mesh.shards[bad]._count_lane_fold = boom
    try:
        with pytest.raises(RuntimeError, match="injected commit failure"):
            door.flush_all()
    finally:
        del mesh.shards[bad]._count_lane_fold
    for _, ticket in lane_tickets:
        assert ticket.done
        with pytest.raises(RuntimeError, match="injected commit failure"):
            ticket.wait(0)
    _assert_no_lock_leak(mesh)
    for lane in door.lanes:
        assert lane._drain_lock.acquire(blocking=False), f"lane {lane.name} leaked"
        lane._drain_lock.release()
    assert door.admit_kv("t-acme", "fresh-key", "fresh-val", timeout=5.0) is not None
    assert mesh.get("t-acme", "fresh-key") == "fresh-val"


def test_fused_flush_matches_jax_and_the_host_path():
    """The same tenant writes through a door over the port's mesh
    keyspace (flush_all -> flush_all_fused), JAX's vmap plane and both
    host paths: equal idents, shard states, vvs, payloads and digests; the
    fused flushes tick merge_dispatches once each, as JAX's."""
    kss = {}
    for p, m in (("j", "on"), ("j", "off"), ("t", "on"), ("t", "off")):
        ks = _keyspace(p, m, JClock() if p == "j" else TClock())
        ks.enable_audit()
        door = (jks if p == "j" else tks).KeyspaceFrontDoor(ks, max_batch=1024)
        rng = random.Random(3)
        idents = []
        for _ in range(3):
            groups = {}
            for _ in range(24):
                t, k = rng.choice(TENANTS), f"k{rng.randrange(40)}"
                groups.setdefault(ks.shard_of(t, k), []).append(
                    (None, {tks.qualify(t, k): f"v{rng.randrange(99)}"}, t))
            tickets = door._submit_groups(groups, "t-acme")
            assert door.flush_all() == 24
            idents.append([tk.wait(0) for _, tk in tickets])
        kss[(p, m)] = (ks, idents)
    mesh, idents = kss[("t", "on")]
    for ks, other in kss.values():
        assert other == idents
        _assert_shards_equal(mesh, ks)
    assert _dispatches(mesh) == _dispatches(kss[("j", "on")][0]) == 3


def test_commit_digest_checks_the_device_fold():
    """The fused step's device digest sums equal the host's on every lane
    (no audit_mesh_mismatch); a wrong device sum is reported as
    audit_mesh_mismatch, as in the JAX package, and the merge stands."""
    host, mesh, clock = _twin_keyspaces()
    mesh.enable_audit()
    host.enable_audit()
    writers = _writers(mesh, clock)
    payloads = _random_round(random.Random(9), mesh, writers, clock, n_ops=16)
    mesh.receive_all(payloads)
    for i, p in enumerate(payloads):
        if p is not None:
            host.receive(i, p)
    _assert_shards_equal(host, mesh)
    assert _count(mesh.shards[0].metrics, "audit_mesh_mismatch") == 0
    out = {}
    for pkg, mod, kw in (("j", jnode, {}), ("t", tnode, {"device": "cpu"})):
        node = mod.ReplicaNode(rid=0, capacity=8, clock=(JClock if pkg == "j" else TClock)(),
                               **kw)
        node.enable_audit()
        pending = node.merge_begin([writers[(0, 100)].gossip_payload()])
        assert pending.fresh and pending.dig_sum is not None
        log_mod = jlog if pkg == "j" else oplog
        log = node.log
        while pending.rows_held() + pending.fresh > log.capacity:
            log = log_mod.grow(log, log.capacity * 2)
        batch = log_mod.from_ops(pending.fresh, pending.ops, **kw)
        merged, n = log_mod.merge_checked(log, batch)
        wrong = (np.asarray(pending.dig_sum) + np.uint32(1)).astype(np.uint32)
        got = pending.commit(merged, int(n), digest=wrong)
        ev = [{k: v for k, v in e.items() if k in ("event", "host", "device")}
              for e in node.events.find(event="audit_mesh_mismatch")]
        out[pkg] = (got, _count(node.metrics, "audit_mesh_mismatch"), ev,
                    node.get_state())
        assert node._lock.acquire(blocking=False)
        node._lock.release()
    assert out["t"] == out["j"] and out["t"][1] == 1


# ---- _ks_pull_mesh and the served scrape over real sockets ----

def _serve(hosts):
    for h in hosts:
        threading.Thread(target=h._server.serve_forever, daemon=True).start()


def _stop(hosts):
    for h in hosts:
        h._server.shutdown()
        h._server.server_close()


def _post(url, body, tenant):
    req = urllib.request.Request(url + "/data", data=json.dumps(body).encode(), method="POST")
    req.add_header(tks.TENANT_HEADER, tenant)
    return urllib.request.urlopen(req, timeout=5).status


def test_served_scrape_shows_per_shard_counters():
    """A mesh-path ks_pull over real sockets: one fused merge for the whole
    round, and the puller's served /metrics carries the per-shard labeled
    counters beside the label-free one."""
    cfg = TConfig(keyspace_shards=N_SHARDS, keyspace_capacity=64, keyspace_mesh="on")
    a = TNodeHost(rid=0, peers=[], config=cfg, device="cpu")
    b = TNodeHost(rid=1, peers=[], config=cfg, device="cpu")
    assert b.keyspace.mesh_active
    _serve((a, b))
    try:
        before = _count(b.node.metrics, "merge_dispatches")
        body = {f"k{i}": f"v{i}" for i in range(16)}
        assert _post(a.url, body, "t-acme") == 200
        assert b.agent.ks_pull(TRemotePeer(a.url)) == 16
        assert b.keyspace.tenant_state("t-acme") == body
        assert _count(b.node.metrics, "merge_dispatches") - before == 1
        text = TRemotePeer(b.url).metrics_text()
        for i in range(N_SHARDS):
            assert f'crdt_merge_dispatches_total{{shard="{i}"}}' in text
            assert f'crdt_union_path_total{{path="sort",shard="{i}"}}' in text
        assert re.search(r"^crdt_merge_dispatches_total \d", text, re.MULTILINE)
    finally:
        _stop((a, b))


def test_ks_pull_mesh_matches_jax():
    """_ks_pull_mesh in both packages (JAX's plane pinned to vmap): the
    same tenant writes, a pull round, a quarantined corrupt shard body and
    a second round give equal returns, shard states, vvs, payloads,
    events and the one-merge-a-round counter."""
    out = {}
    for p, host_cls, peer_cls, cfg_cls, kw in (
            ("j", JNodeHost, JRemotePeer, JConfig, {}),
            ("t", TNodeHost, TRemotePeer, TConfig, {"device": "cpu"})):
        cfg = cfg_cls(keyspace_shards=N_SHARDS, keyspace_capacity=64, keyspace_mesh="on")
        a = host_cls(rid=0, peers=[], config=cfg, **kw)
        b = host_cls(rid=1, peers=[], config=cfg, **kw)
        for h in (a, b):
            if p == "j":
                ks = h.keyspace
                ks._meshplane = jmp.MeshPlane(N_SHARDS, mode="on", engine="vmap",
                                              metrics=ks.shards[0].metrics)
        _serve((a, b))
        rec = []
        try:
            rec.append(_post(a.url, {f"k{i}": f"v{i}" for i in range(12)}, "t-acme"))
            rec.append(b.agent.ks_pull(peer_cls(a.url)))
            rec.append(_post(a.url, {f"q{i}": str(i) for i in range(6)}, "t-bravo"))
            peer = peer_cls(a.url)
            real = peer.ks_gossip

            def corrupt(shard, since, trace=None, epoch=None, _real=real):
                body = _real(shard, since, trace=trace, epoch=epoch)
                if shard == 1 and body is not None:
                    body = dict(body, payload={"bad:key": {"x": "1"}})
                return body

            peer.ks_gossip = corrupt
            rec.append(b.agent.ks_pull(peer))
            rec.append(b.agent.ks_pull(peer_cls(a.url)))
            # the hosts run on the wall clock: payloads compared without ts
            rec.append([(s.get_state(), s.version_vector(),
                         sorted((k.split(":", 1)[1], v) for k, v in s.gossip_payload().items()))
                        for s in b.keyspace.shards])
            rec.append([{k: v for k, v in e.items() if k in ("event", "shard", "fresh", "error")}
                        for e in b.node.events.find()
                        if e.get("event", "").startswith(("ks_pull", "payload_quar"))])
            rec.append(tuple(_count(b.node.metrics, n) for n in (
                "merge_dispatches", "net_ks_quarantined", "net_ks_pulls",
                "meshplane_fallbacks")))
        finally:
            _stop((a, b))
        out[p] = rec
    assert out["t"] == out["j"]
    assert out["t"][1] == 12 and out["t"][-1][1] == 1 and out["t"][-1][3] == 0
