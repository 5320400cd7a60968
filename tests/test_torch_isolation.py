"""The PyTorch port stands alone: no file of crdt_tpu_torch/ (nor
chip_smoke.py, nor tools/) imports jax, flax or crdt_tpu; constructors never quietly
fall back to the CPU; the kernel entry point never reaches its plain twin
for a non-CPU tensor."""
import ast
import re
from pathlib import Path

import pytest
import torch

import crdt_tpu_torch
from crdt_tpu_torch import convert, native, workload
from crdt_tpu_torch.api.cluster import LocalCluster
from crdt_tpu_torch.api.compositenode import CompositeNode
from crdt_tpu_torch.api.mapnode import MapNode
from crdt_tpu_torch.api.net import NodeHost
from crdt_tpu_torch.harness.crashsoak import CrashSoakRunner
from crdt_tpu_torch.harness.nemesis_soak import NemesisSoak, run_soak
from crdt_tpu_torch.api.node import ReplicaNode
from crdt_tpu_torch.api.seqnode import SeqNode
from crdt_tpu_torch.api.setnode import SetNode
from crdt_tpu_torch.consistency import vvclock
from crdt_tpu_torch.harness.gc_soak import MapSoakRunner, SetSoakRunner
from crdt_tpu_torch.harness.seq_soak import SeqSoakRunner
from crdt_tpu_torch.keyspace import ShardedKeyspace, keyspace_from_config
from crdt_tpu_torch.models import compactlog
from crdt_tpu_torch.models import flags, gcounter, gset, lww, mvregister, oplog
from crdt_tpu_torch.models import oplog_columnar, orset, pncounter, rseq
from crdt_tpu_torch.models import ormap, ormap_gc, rseq_columnar, tomb_gc
from crdt_tpu_torch.ops import hopper_union, joins, orset_floor
from crdt_tpu_torch.ops import randstate as rs
from crdt_tpu_torch.analysis.verify import domains, prove
from crdt_tpu_torch.parallel import mesh, meshplane, multihost, swarm
from crdt_tpu_torch.utils import config as tconfig

ROOT = Path(__file__).resolve().parent.parent
PORT_FILES = (sorted((ROOT / "crdt_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
              + sorted((ROOT / "tools").glob("*.py")))
FORBIDDEN = ("jax", "jaxlib", "flax", "crdt_tpu", "benches")


def _imported_modules(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", None)
              == "import_module" and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield node.args[0].value


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_nothing_of_jax_or_crdt_tpu(path):
    assert path.exists(), path
    for mod in _imported_modules(path):
        top = mod.split(".")[0]
        assert top not in FORBIDDEN, f"{path.name} imports {mod}"


def test_scan_sees_the_whole_package():
    names = {p.name for p in PORT_FILES}
    assert {"hopper_union.py", "oplog_columnar.py", "oplog_engine.py",
            "swarm.py", "chip_smoke.py", "pack.py", "union_engine.py",
            "orset.py", "gset.py", "rseq.py", "rseq_columnar.py",
            "rseq_engine.py", "tomb_gc.py", "convert.py", "workload.py",
            "time_lexn_union.py", "orset_floor.py", "gcounter.py", "pncounter.py",
            "lww.py", "flags.py", "mvregister.py", "compactlog.py", "node.py",
            "cluster.py", "replica.py", "clock.py", "config.py", "metrics.py",
            "registry.py", "trace.py", "events.py", "provenance.py", "health.py",
            "devtime.py", "vvclock.py", "joins.py", "randstate.py", "ormap.py",
            "algebra.py", "composite.py", "ormap_gc.py", "setnode.py", "seqnode.py",
            "mapnode.py", "floornode.py", "gc_soak.py", "seq_soak.py",
            "http_shim.py", "session.py", "stability.py", "wire.py", "shed.py",
            "admission.py", "shim.py", "soak.py", "__main__.py", "net.py",
            "compositenode.py", "checkpoint.py", "digest.py", "audit.py", "routing.py",
            "shards.py", "frontdoor.py", "reshard.py", "leases.py", "plane.py",
            "fleet.py", "schedule.py", "transport.py", "disk.py", "assemble.py",
            "crashsoak.py", "nemesis_soak.py", "meshplane.py", "tracing.py",
            "mesh.py", "multihost.py", "pipeline.py", "sarif.py", "baseline.py",
            "domains.py", "prove.py", "ledger.py", "race.py", "astcache.py",
            "ast_checks.py", "concurrency.py", "flow.py", "fx_checks.py",
            "hazards.py"} <= names
    assert ROOT / "crdt_tpu_torch" / "native" / "__init__.py" in PORT_FILES
    assert ROOT / "crdt_tpu_torch" / "obs" / "__main__.py" in PORT_FILES


@pytest.mark.parametrize("make", [
    lambda: oplog.empty(8),
    lambda: oplog.from_ops(8, {f: [] for f in oplog._FIELDS}),
    lambda: oplog_columnar.empty(8, 4),
    lambda: swarm.random_peers(torch.Generator(), 4),
    lambda: convert.oplog_from_numpy(convert.oplog_to_numpy(oplog.empty(4, device="cpu"))),
    lambda: crdt_tpu_torch.default_device(),
    lambda: orset.empty(8),
    lambda: orset.bitmap_empty(64),
    lambda: orset.bucketed_empty(16, 4),
    lambda: gset.g_empty(8),
    lambda: gset.tp_empty(8),
    lambda: convert.orset_from_numpy(convert.orset_to_numpy(orset.empty(4, device="cpu"))),
    lambda: workload.set_swarm(workload.set_pool(0), 2, 8, 0),
    lambda: workload.strided_columns(8, 2, 4, 64, 0),
    lambda: rseq.empty(8),
    lambda: rseq_columnar.empty(8, 2),
    lambda: tomb_gc.wrap(rseq.empty(8, device="cpu"), 4),
    lambda: workload.seq_swarm(workload.seq_pool(0, n_elements=8), 2, 8, 0),
    lambda: convert.rseq_from_numpy(convert.rseq_to_numpy(rseq.empty(4, device="cpu"))),
    lambda: gcounter.zero(8),
    lambda: pncounter.zero(8),
    lambda: lww.zero((4,)),
    lambda: flags.ew_zero(4),
    lambda: flags.dw_zero(4),
    lambda: mvregister.zero(4),
    lambda: convert.mvregister_from_numpy(
        convert.mvregister_to_numpy(mvregister.zero(4, device="cpu"))),
    lambda: compactlog.empty(8, 4, 2),
    lambda: ReplicaNode(rid=0),
    lambda: LocalCluster(),
    lambda: convert.compactlog_from_numpy(
        convert.compactlog_to_numpy(compactlog.empty(4, 4, 2, device="cpu"))),
    lambda: vvclock.zero(8),
    lambda: ormap.empty(4, 2, pncounter.zero(2, device="cpu")),
    lambda: ormap_gc.wrap(ormap.empty(4, 2, pncounter.zero(2, device="cpu"), device="cpu")),
    lambda: SetNode(rid=0),
    lambda: SeqNode(rid=0),
    lambda: MapNode(rid=0),
    lambda: rs.rand_orset(__import__("numpy").random.default_rng(0)),
    lambda: rs.small_gset(),
    lambda: joins.registered_joins()["mapof(pncounter)"].neutral(),
    lambda: convert.vvclock_from_numpy({"seqs": [0, -1]}),
    lambda: SetSoakRunner(),
    lambda: MapSoakRunner(),
    lambda: SeqSoakRunner(),
    lambda: CompositeNode(rid=0),
    lambda: NodeHost(rid=0, peers=[]),
    lambda: ShardedKeyspace(0, 2),
    lambda: keyspace_from_config(0, tconfig.ClusterConfig(keyspace_shards=2)),
    lambda: NodeHost(rid=0, peers=[], config=tconfig.ClusterConfig(keyspace_shards=2)),
    lambda: NemesisSoak(0, nodes=2, steps=10),
    lambda: run_soak(0, 2, 10),
    lambda: CrashSoakRunner(n=2),
    lambda: meshplane.MeshPlane(4, mode="on"),
    lambda: ShardedKeyspace(0, 2, mesh="on"),
    lambda: meshplane.MeshPlane(4, mode="on", engine="pjit"),
    lambda: mesh.make_mesh(),
    lambda: multihost.global_mesh(),
    lambda: prove.prove_spec(joins.registered_joins()["gcounter"]),
    lambda: domains.build_domain(joins.registered_joins()["lww"]),
], ids=["oplog.empty", "from_ops", "columnar.empty", "random_peers",
        "convert", "default_device", "orset.empty", "bitmap_empty",
        "bucketed_empty", "g_empty", "tp_empty", "convert.orset", "set_swarm",
        "strided_columns", "rseq.empty", "rseq_columnar.empty", "tomb_gc.wrap",
        "seq_swarm", "convert.rseq", "gcounter.zero", "pncounter.zero", "lww.zero",
        "ew_zero", "dw_zero", "mvregister.zero", "convert.mvregister",
        "compactlog.empty", "ReplicaNode", "LocalCluster", "convert.compactlog",
        "vvclock.zero", "ormap.empty", "ormap_gc.wrap", "SetNode", "SeqNode", "MapNode",
        "rand_orset", "small_gset", "registry_neutral", "convert.vvclock", "SetSoakRunner",
        "MapSoakRunner", "SeqSoakRunner", "CompositeNode", "NodeHost", "ShardedKeyspace",
        "keyspace_from_config", "NodeHost_keyspace", "NemesisSoak", "run_soak",
        "CrashSoakRunner", "MeshPlane", "ShardedKeyspace_mesh", "MeshPlane_pjit",
        "make_mesh", "global_mesh", "prove_spec", "build_domain"])
def test_constructor_without_device_raises_when_no_card(make, monkeypatch):
    """device=None means the CUDA card; without one it raises rather than
    returning CPU tensors."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make()


def test_native_sources_name_nothing_of_the_jax_package():
    """The native runtime is an own copy: no file under
    crdt_tpu_torch/native/ names a path or module of the JAX package."""
    files = sorted(p for p in (ROOT / "crdt_tpu_torch" / "native").iterdir() if p.is_file())
    assert {p.name for p in files} >= {"__init__.py", "ingest.cpp"}
    for path in files:
        text = path.read_text()
        assert not re.search(r"crdt_tpu(?!_torch)[/.]", text), path.name
        assert "crdt_tpu/" not in text and "Makefile" not in text, path.name


def test_native_library_lands_under_build():
    """The default node builds (or reuses) libcrdt_ingest under the
    repository's git-ignored build/ directory."""
    node = ReplicaNode(rid=0, device="cpu")
    assert node._native and node._wire is not None
    path = native.library_path()
    assert path.exists() and path.is_relative_to(ROOT / "build" / "native")
    assert path.name.startswith("libcrdt_ingest-") and path.suffix == ".so"


def test_failed_native_build_raises_without_fallback(monkeypatch, tmp_path):
    """When g++ fails, the default node raises with the compiler's words
    and does not fall back to the Python path; only use_native=False gets
    the Python path."""
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(native, "CXX", "false")
    with pytest.raises(RuntimeError, match="false failed to build ingest.cpp"):
        ReplicaNode(rid=0, device="cpu")
    monkeypatch.setattr(native, "CXX", str(tmp_path / "no-such-compiler"))
    with pytest.raises(RuntimeError, match="could not run"):
        ReplicaNode(rid=0, use_native=True, device="cpu")
    assert not list(tmp_path.glob("*.so"))
    node = ReplicaNode(rid=0, use_native=False, device="cpu")
    assert not node._native and node._wire is None


@pytest.mark.parametrize("engine", ["pjit", "shard_map"])
def test_multi_device_mesh_engines_raise_naming_item_6b(engine):
    """(Named for the refusal it replaced.)  The multi-device engines are
    ported: on four CPU slots the port's partitioned engine folds the
    same page as JAX's engine of that name on its virtual devices, shard
    for shard, in one merge each."""
    from crdt_tpu import keyspace as jks
    from crdt_tpu.parallel import meshplane as jmp
    from crdt_tpu.utils.clock import ManualClock as JClock
    from crdt_tpu.utils.metrics import Metrics as JMetrics
    from crdt_tpu_torch import keyspace as tks
    from crdt_tpu_torch.utils.clock import ManualClock as TClock
    from crdt_tpu_torch.utils.metrics import Metrics as TMetrics

    j = jks.ShardedKeyspace(rid=0, n_shards=4, capacity=64, metrics=JMetrics(),
                            clock=JClock(), mesh="on")
    j._meshplane = jmp.MeshPlane(4, mode="on", engine=engine, metrics=j.shards[0].metrics)
    t = tks.ShardedKeyspace(rid=0, n_shards=4, capacity=64, metrics=TMetrics(),
                            clock=TClock(), mesh="on", device="cpu")
    t._meshplane = meshplane.MeshPlane(4, mode="on", engine=engine, device="cpu",
                                       devices=["cpu"] * 4, metrics=t.shards[0].metrics)
    assert t.mesh_engine == j.mesh_engine == engine
    assert t._meshplane.n_devices == j._meshplane.n_devices == 4
    clock = t.shards[0].clock
    writers = [ReplicaNode(rid=100 + s, capacity=64, clock=clock, device="cpu")
               for s in range(4)]
    for i in range(24):
        shard = t.shard_of("t-acme", f"k{i}")
        assert shard == j.shard_of("t-acme", f"k{i}")
        writers[shard].add_commands([{tks.qualify("t-acme", f"k{i}"): f"v{i}"}])
        clock.advance(1)
    payloads = [w.gossip_payload() or None for w in writers]
    assert t.receive_all(payloads) == j.receive_all(payloads)
    for x, y in zip(t.shards, j.shards):
        assert x.get_state() == y.get_state() and x.get_state()
        assert x.version_vector() == y.version_vector()
    counts = [ks.shards[0].metrics.registry.counter_value("merge_dispatches")
              for ks in (t, j)]
    assert counts == [1, 1]


def test_enable_audit_attaches_the_digest():
    """The live divergence audit is ported: enable_audit attaches a digest
    seeded from the store, and the gossip header's digest follows it."""
    node = ReplicaNode(rid=0, device="cpu")
    node.add_command({"a": "1"}, ts=1)
    assert node.audit_snapshot()[2] is None
    digest = node.enable_audit()
    assert node.digest is digest and digest.winner == {"a": (1 + node.clock.epoch_ms, 0, 0)}
    node.compact({0: 0})
    assert node.audit_snapshot()[2] == node.audit_digest_at({0: 0}) is not None
    pending = node.merge_begin([])
    pending.commit(node.log, 0)  # no digest: the lock is released
    assert node._lock.acquire(timeout=1)
    node._lock.release()


@pytest.mark.parametrize("knob,barrier", [("set_collect_every", "set_collect"),
                                           ("seq_collect_every", "seq_collect"),
                                           ("map_reset_every", "map_reset")])
def test_sibling_barrier_knobs_are_accepted(knob, barrier):
    """The typed siblings are ported: a non-zero barrier cadence builds a
    cluster whose every tick runs that barrier."""
    c = LocalCluster(tconfig.ClusterConfig(n_replicas=2, **{knob: 1}), device="cpu")
    ran = []
    setattr(c, barrier, lambda: ran.append(barrier))
    c.tick()
    c.tick()
    assert ran == [barrier, barrier]


def test_kernel_entry_has_no_try_fallback():
    """No `try` anywhere in the wrapper module: a failed build or launch
    raises, it cannot fall through to the twin."""
    tree = ast.parse(Path(hopper_union.__file__).read_text())
    assert not any(isinstance(n, ast.Try) for n in ast.walk(tree))


def test_floor_entry_has_no_try_fallback():
    """Nor in the floors' wrapper module."""
    tree = ast.parse(Path(orset_floor.__file__).read_text())
    assert not any(isinstance(n, ast.Try) for n in ast.walk(tree))


def test_non_cpu_planes_never_reach_the_twin(monkeypatch, tmp_path):
    """Planes on a device with no kernel raise; the CUDA launch path with
    no toolkit raises too, and neither counts a launch or calls the twin."""
    def twin_called(*_a, **_k):
        raise AssertionError("the plain twin was reached")

    def no_nvcc():
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(hopper_union, "_lexn_union_plain", twin_called)
    planes = [torch.full((8, 4), 2**31 - 1, dtype=torch.int32, device="meta")] * 4
    before = hopper_union.LAUNCHES["lexn_union"]
    with pytest.raises(ValueError, match="no lexn_union kernel"):
        hopper_union.sorted_union_columnar_fused_lex2(
            planes[:2], planes[2:], planes[:2], planes[2:])
    monkeypatch.setattr(hopper_union._build, "_nvcc", no_nvcc)
    monkeypatch.setattr(hopper_union._build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(hopper_union._build, "_LIBS", {})
    cpu = [torch.full((8, 4), 2**31 - 1, dtype=torch.int32)] * 4
    with pytest.raises(RuntimeError, match="nvcc"):
        hopper_union._lexn_union_cuda(cpu[:2], cpu[2:], cpu[:2], cpu[2:], 8)
    assert hopper_union.LAUNCHES["lexn_union"] == before


@pytest.mark.parametrize("twin, call", [
    ("_lexn_merge_plain", lambda p: hopper_union.lexn_merge_columnar(p[:2], p[2:], p[:2], p[2:])),
    ("_lexn_compact_plain", lambda p: hopper_union.lexn_compact_columnar(p[:2], p[2:], 8)),
    ("_lexn_union_plain", lambda p: hopper_union.sorted_union_columnar_lexn_auto(
        p[:2], p[2:], p[:2], p[2:])),
    ("_lexn_compact_plain", lambda p: hopper_union.sorted_union_columnar_striped_lexn(
        p[:2], p[2:], p[:2], p[2:], stripe=4)),
], ids=["lexn_merge", "lexn_compact", "lexn_auto", "striped"])
def test_lexn_entry_points_never_reach_a_twin_off_the_cpu(twin, call, monkeypatch):
    """The merge, compaction, auto and striped entry points on a device with
    no kernel raise; none reaches its plain twin or counts a launch."""
    def twin_called(*_a, **_k):
        raise AssertionError("the plain twin was reached")

    for name in ("_lexn_merge_plain", "_lexn_compact_plain", "_lexn_union_plain"):
        monkeypatch.setattr(hopper_union, name, twin_called)
    planes = [torch.full((8, 4), 2**31 - 1, dtype=torch.int32, device="meta")] * 4
    before = dict(hopper_union.LAUNCHES)
    with pytest.raises(ValueError, match="no lexn_[a-z]+ kernel"):
        call(planes)
    assert hopper_union.LAUNCHES == before


@pytest.mark.parametrize("name", ["lexn_merge", "lexn_compact"])
def test_lexn_kernels_without_a_toolkit_raise(name, monkeypatch, tmp_path):
    """The CUDA launch path of the merge and the compaction with no nvcc
    raises and counts no launch."""
    def no_nvcc():
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(hopper_union._build, "_nvcc", no_nvcc)
    monkeypatch.setattr(hopper_union._build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(hopper_union._build, "_LIBS", {})
    cpu = tuple(torch.full((8, 4), 2**31 - 1, dtype=torch.int32) for _ in range(2))
    before = dict(hopper_union.LAUNCHES)
    with pytest.raises(RuntimeError, match="nvcc"):
        if name == "lexn_merge":
            hopper_union._lexn_merge_cuda(cpu[:1], cpu[1:], cpu[:1], cpu[1:])
        else:
            hopper_union._lexn_compact_cuda(cpu[:1], cpu[1:], 8)
    assert hopper_union.LAUNCHES == before


@pytest.mark.parametrize("name", ["set_union", "merge", "bucketed_union"])
def test_set_kernels_without_a_toolkit_raise(name, monkeypatch, tmp_path):
    """The CUDA launch path of csrc/set_union.cu with no nvcc raises and
    counts no launch."""
    def no_nvcc():
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(hopper_union._build, "_nvcc", no_nvcc)
    monkeypatch.setattr(hopper_union._build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(hopper_union._build, "_LIBS", {})
    cpu = [torch.full((8, 4), 2**31 - 1, dtype=torch.int32)] * 4
    before = dict(hopper_union.LAUNCHES)
    with pytest.raises(RuntimeError, match="nvcc"):
        hopper_union._set_union_cuda(name, *cpu, 8 if name != "bucketed_union" else 4,
                                     16 if name == "merge" else 4)
    assert hopper_union.LAUNCHES == before
