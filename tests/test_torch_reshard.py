"""The port's online resharding (crdt_tpu_torch.keyspace.reshard) against
the JAX package's, zero tolerance, following tests/test_reshard.py case
by case: the same writes and the same state-machine drive go to a JAX
and a port keyspace (or NodeHost), and the statuses, fold verdicts,
quarantines, fence bodies, ledgers, events and every shard's full wire
dump must be equal.  The keyspaces run ``mesh="off"`` (the port's path)
on a ManualClock each, so wire timestamps are equal across packages."""
from __future__ import annotations

import json
import threading
import urllib.error
import urllib.request

import pytest

from crdt_tpu.api import net as jnet
from crdt_tpu.ingest import PageBuilder as JPageBuilder
from crdt_tpu.keyspace import ShardedKeyspace as JKs
from crdt_tpu.keyspace import qualify
from crdt_tpu.keyspace.reshard import PHASE_IDLE, PHASE_MIGRATE
from crdt_tpu.utils.clock import ManualClock as JClock
from crdt_tpu.utils.config import ClusterConfig as JConfig
from crdt_tpu_torch.api import net as tnet
from crdt_tpu_torch.ingest import PageBuilder as TPageBuilder
from crdt_tpu_torch.keyspace import ShardedKeyspace as TKs
from crdt_tpu_torch.keyspace import reshard as treshard
from crdt_tpu_torch.utils.clock import ManualClock as TClock
from crdt_tpu_torch.utils.config import ClusterConfig as TConfig

KS_EPOCH_HEADER = "X-CRDT-KS-Epoch"
TENANT_HEADER = "X-CRDT-Tenant"
CFG = dict(keyspace_shards=2, keyspace_capacity=256, keyspace_mesh="off")


def make_ks(pkg, rid=0, n=2, capacity=256):
    if pkg == "j":
        return JKs(rid, n, capacity=capacity, mesh="off", clock=JClock())
    return TKs(rid, n, capacity=capacity, mesh="off", clock=TClock(), device="cpu")


def make_host(pkg, rid=0, **kw):
    if pkg == "j":
        return jnet.NodeHost(rid=rid, peers=[], config=JConfig(**CFG), **kw)
    return tnet.NodeHost(rid=rid, peers=[], config=TConfig(**CFG), device="cpu", **kw)


def both(fn):
    out = {p: fn(p) for p in ("j", "t")}
    assert out["t"] == out["j"]
    return out["t"]


def write(ks, tenant, key, value):
    assert ks.shards[ks.shard_of(tenant, key)].add_command({qualify(tenant, key): value})


def dump(ks):
    """epoch, shard count and every shard's full wire dump."""
    return ks.epoch, ks.n_shards, [s.gossip_payload(since=None) for s in ks.shards]


def events(ks, *names):
    return [{k: v for k, v in e.items() if k not in ("ts_ms", "v")}
            for name in names for e in ks.shards[0].events.find(event=name)]


def test_abort_rolls_back_bit_identical():
    def run(p):
        ks = make_ks(p)
        for i in range(24):
            write(ks, "t-acme", f"k{i:03d}", f"v{i}")
        before = dump(ks)
        out = [ks.reshard.start(4)]
        moved = [q for q in sorted(ks.state()) if ks.reshard.moved_to(q) is not None]
        dst = ks.reshard.moved_to(moved[0])
        out.append(ks.reshard.receive_migration(dst, {"1000:9:0": {moved[0]: "peer-value"}}))
        out += [ks.reshard.abort("test"), dump(ks) == before, ks.reshard.abort("again"),
                ks.reshard.start(4), ks.reshard.ledger(), dump(ks)]
        out.append(events(ks, "ks_reshard_phase", "ks_reshard_migrate_fold"))
        return out

    out = both(run)
    assert out[0]["phase"] == PHASE_MIGRATE and out[0]["moved"] > 0
    assert out[1] == {"ok": True, "folded": 1} and out[3] is True
    assert out[2]["phase"] == out[4]["phase"] == PHASE_IDLE


def test_crash_mid_migrate_resumes_and_cuts_over(tmp_path):
    """A host checkpointed inside the window restores into MIGRATE, its
    resumed cutover lands the same tenant state, and the post-cutover
    snapshot restores straight to 4 shards: equal in both packages, and
    the ledgers and reshard sections cross the packages both ways."""
    def run(p, d_write, d_read):
        a = make_host(p, checkpoint_dir=d_write)
        for i in range(20):
            write(a.keyspace, "t-acme", f"k{i:03d}", f"v{i}")
        expect = a.keyspace.tenant_state("t-acme")
        out = [a.admin_ks_reshard({"action": "start", "shards": 4})]
        out.append(a.checkpoint_now().rsplit("/", 1)[1])
        a._server.server_close()
        b = make_host(p, checkpoint_dir=d_read)
        try:
            out += [b.restored, b.keyspace.reshard.status(), b.keyspace.epoch,
                    b.keyspace.n_shards, b.admin_ks_reshard({"action": "cutover"}),
                    b.keyspace.tenant_state("t-acme") == expect]
            out.append(b.checkpoint_now().rsplit("/", 1)[1])
        finally:
            b._server.server_close()
        c = make_host(p, checkpoint_dir=d_read)
        try:
            out += [c.keyspace.n_shards, c.keyspace.epoch, c.keyspace.reshard.status(),
                    c.keyspace.tenant_state("t-acme") == expect,
                    c.keyspace.tenant_state("t-acme")]
        finally:
            c._server.server_close()
        return out

    same = {p: run(p, str(tmp_path / p), str(tmp_path / p)) for p in ("j", "t")}
    assert same["t"] == same["j"]
    # the JAX package's mid-window snapshot resumes in the port, and back
    import shutil

    for src, dst in (("j", "t"), ("t", "j")):
        d = tmp_path / f"{src}-to-{dst}"
        shutil.copytree(tmp_path / src, d)
        for snap in ("snap-00000001", "snap-00000002"):
            shutil.rmtree(d / snap, ignore_errors=True)
        (d / "LATEST").write_text("snap-00000000")
        h = make_host(dst, checkpoint_dir=str(d))
        try:
            st = h.keyspace.reshard.status()
            assert st == {"epoch": 0, "phase": "migrate", "target": 4, "n_shards": 2}
            assert h.admin_ks_reshard({"action": "cutover"})["n_shards"] == 4
            assert h.keyspace.tenant_state("t-acme") == same["t"][-1]
        finally:
            h._server.server_close()
    out = same["t"]
    assert out[2] is True and out[3]["phase"] == PHASE_MIGRATE and out[3]["target"] == 4
    assert out[6]["epoch"] == 1 and out[7] is True
    assert out[9:12] == [4, 1, {"epoch": 1, "phase": PHASE_IDLE, "target": None,
                                "n_shards": 4}] and out[12] is True


def _serve(*hosts):
    for h in hosts:
        threading.Thread(target=h._server.serve_forever, daemon=True).start()


def _shutdown(*hosts):
    for h in hosts:
        h._server.shutdown()
        h._server.server_close()


def _call(url, body=None, headers=None, raw=None):
    data = raw if raw is not None else (None if body is None else json.dumps(body).encode())
    req = urllib.request.Request(url, data=data, headers=headers or {},
                                 method="GET" if data is None else "POST")
    try:
        with urllib.request.urlopen(req, timeout=5) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def test_stale_epoch_409_on_every_fenced_surface():
    def run(p):
        a = make_host(p)
        _serve(a)
        try:
            write(a.keyspace, "t-acme", "k0", "v0")
            a.admin_ks_reshard({"action": "start", "shards": 4})
            out = [a.admin_ks_reshard({"action": "cutover"})]
            fences0 = a.keyspace.reshard.fences
            u = a.url
            out.append(_call(u + "/ks/gossip?shard=0&epoch=0"))
            out.append(_call(u + "/ks/gossip?shard=0"))
            out.append(_call(u + "/ks/gossip?shard=0&epoch=x"))
            out.append(_call(u + "/ks/compact", {"shard": 0, "frontier": {}, "epoch": 0}))
            out.append(_call(u + "/ks/migrate", {"shard": 0, "epoch": 0, "payload": {}}))
            out.append(_call(u + "/ks/migrate", {"shard": 0, "epoch": 1, "payload": {}}))
            pager = (JPageBuilder if p == "j" else TPageBuilder)(origin=7, page_size=1 << 16)
            pager.add("k1", "v1")
            raw = pager.flush()
            out.append(_call(u + "/ingest/page", raw=raw,
                             headers={TENANT_HEADER: "t-acme", KS_EPOCH_HEADER: "0"}))
            out.append(a.keyspace.reshard.fences - fences0)
            out.append(_call(u + "/ks/gossip?shard=0&epoch=1")[0])
            out.append(_call(u + "/ks/compact", {"shard": 0, "frontier": {}, "epoch": 1}))
            out.append(_call(u + "/ingest/page", raw=raw,
                             headers={TENANT_HEADER: "t-acme", KS_EPOCH_HEADER: "1"}))
            out.append([{k: v for k, v in e.items() if k not in ("ts_ms", "v", "peer")}
                        for e in a.node.events.find(event="ks_reshard_fence")])
            out.append(a.node.metrics.registry.counter_value("ks_reshard_fenced"))
        finally:
            _shutdown(a)
        return out

    out = both(run)
    for status, body in out[1:6]:
        got = json.loads(body)
        assert status == 409 and got["fenced"] is True and got["epoch"] == 1
    assert out[8] == 6 and out[9] == 200 and out[10][0] == 200 and out[11][0] == 200


def test_corrupt_migration_slice_quarantined_without_wedging():
    def run(p):
        ks = make_ks(p)
        for i in range(16):
            write(ks, "t-acme", f"k{i:03d}", f"v{i}")
        ks.reshard.start(4)
        moved = [q for q in sorted(ks.state()) if ks.reshard.moved_to(q) is not None]
        kept = next(q for q in sorted(ks.state()) if ks.reshard.moved_to(q) is None)
        dst = ks.reshard.moved_to(moved[0])
        out = [ks.reshard.receive_migration(dst, {"nemesis:corrupt:key": {moved[0]: "x"}}),
               ks.reshard.receive_migration(dst, {"1000:1:0": "not-a-dict"}),
               ks.reshard.receive_migration(dst, {"1000:1:0": {moved[0]: "a", kept: "b"}}),
               ks.reshard.receive_migration(dst, ["not", "a", "dict"]),
               ks.reshard.quarantines,
               ks.reshard.receive_migration(dst, {"4102444800000:9:0": {moved[0]: "peer-wins"}}),
               ks.reshard.migration_slices(), ks.reshard._collect_winners()]
        out.append(ks.reshard.cutover())
        out += [ks.get("t-acme", moved[0].split(":", 1)[1]), dump(ks),
                events(ks, "ks_reshard_quarantine", "ks_reshard_phase")]
        return out

    out = both(run)
    assert all(o["ok"] is False and "quarantined" in o for o in out[:4]) and out[4] == 4
    assert out[5] == {"ok": True, "folded": 1} and out[9] == "peer-wins"


def test_receive_migration_outside_window_refuses():
    def run(p):
        ks = make_ks(p, capacity=64)
        return [ks.reshard.receive_migration(0, {"1:1:0": {"t:k": "v"}}),
                ks.reshard.quarantines, ks.reshard.migration_slices(),
                ks.check_epoch(None, "x"), ks.check_epoch("2", "x", peer="p"),
                ks.check_epoch("junk", "y"), ks.reshard.status(), ks.reshard.phase_gauge()]

    out = both(run)
    assert out[0] == {"ok": False, "reason": "not-migrating", "epoch": 0} and out[1] == 0
    assert out[4] == treshard.fence_body("x", 0, 2)


def _acquirable(lock, timeout=2.0) -> bool:
    got = []

    def probe():
        ok = lock.acquire(timeout=timeout)
        if ok:
            lock.release()
        got.append(ok)

    t = threading.Thread(target=probe)
    t.start()
    t.join(timeout + 1)
    return bool(got and got[0])


def test_failure_paths_release_every_lock():
    def run(p):
        a = make_host(p)
        try:
            ks = a.keyspace
            for i in range(8):
                write(ks, "t-acme", f"k{i}", "v")
            door = ks._door
            out = []
            for fn in (lambda: ks.reshard.start(2), ks.reshard.cutover):
                with pytest.raises(ValueError) as ei:
                    fn()
                out.append(str(ei.value))
            out.append(ks.reshard.start(4))
            with pytest.raises(ValueError) as ei:
                ks.reshard.start(3)
            out.append(str(ei.value))
            out.append(ks.reshard.receive_migration(99, {"1:1:0": {"t:k": "v"}}))
            for lock in [ks.reshard._phase_lock, door._adm] + [s._lock for s in ks.shards]:
                assert _acquirable(lock)
            out.append(ks.reshard.cutover())
            for lock in [ks.reshard._phase_lock, door._adm] + [s._lock for s in ks.shards]:
                assert _acquirable(lock)
            out.append(door.admit_kv("t-acme", "post", "cut") is not None)
            out.append([lane.name for lane in door.lanes])
            for body in ({"action": "nope"}, {"action": "start", "shards": 4}):
                try:
                    out.append(a.admin_ks_reshard(body))
                except ValueError as e:
                    out.append(str(e))
        finally:
            a._server.server_close()
        return out

    out = both(run)
    assert out[5]["epoch"] == 1 and out[6] is True and len(out[7]) == 4


def test_reshard_end_to_end_over_http():
    """Write on A, open the window on both, stream A's slices, cut both
    over: the same answers and tenant states at 4 shards, then fresh
    writes converge at epoch 1; the JAX pair and the port pair alike."""
    def run(p):
        net = jnet if p == "j" else tnet
        a, b = make_host(p, 0), make_host(p, 1)
        _serve(a, b)
        out = []
        try:
            a.agent.peers = [net.RemotePeer(b.url)]
            b.agent.peers = [net.RemotePeer(a.url)]
            for i in range(20):
                write(a.keyspace, "t-acme", f"k{i:03d}", f"v{i}")
            out.append(b.agent.ks_pull(b.agent.peers[0]))
            expect = a.keyspace.tenant_state("t-acme")
            for h in (a, b):
                out.append(_call(h.url + "/admin/ks_reshard", {"action": "start", "shards": 4}))
            out.append(_call(a.url + "/admin/ks_reshard", {"action": "stream"}))
            out.append(a.agent.ks_pull(a.agent.peers[0]))  # both still at epoch 0
            for h in (a, b):
                out.append(_call(h.url + "/admin/ks_reshard", {"action": "cutover"}))
                out.append(h.keyspace.tenant_state("t-acme") == expect)
            write(a.keyspace, "t-acme", "post-cutover", "yes")
            out.append(b.agent.ks_pull(b.agent.peers[0]) > 0)
            out.append(b.keyspace.get("t-acme", "post-cutover"))
            out.append(_call(a.url + "/admin/ks_gc", {}))
            out.append([b.keyspace.version_vector(i) == a.keyspace.version_vector(i)
                        for i in range(4)])
            out.append(a.node.metrics.registry.counter_value("net_ks_fenced"))
        finally:
            _shutdown(a, b)
        return out

    out = both(run)
    assert out[0] == 20 and json.loads(out[3][1])["ok"] == json.loads(out[3][1])["sent"] > 0
    assert out[-5:-3] == [True, "yes"] and out[-1] == 0
