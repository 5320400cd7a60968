"""The port's tracing hooks (crdt_tpu_torch.utils.tracing on
torch.profiler) write traces, and the swarm path carries the JAX
package's three named regions around its kernel launches: the OpLog and
RSeq converges and the GC barrier, whose results under a trace equal the
JAX package's.  Follows tests/test_tracing.py.

Beyond the JAX package: every range the port opens goes through the one
gate, ``trace_region``, which enters ``record_function`` only while a
profiler records; and the swarm engines' inner spans (the pull round's
gather, union and gate, the barrier's halvings and broadcast, the views'
unstack and scatter, the OR-Set join and member mask) nest in their
parents and leave every result as it was."""
import ast
import contextlib
import json
import math
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crdt_tpu.models import oplog_columnar as joc
from crdt_tpu.models import orset as jos
from crdt_tpu.models import rseq as jrseq
from crdt_tpu.models import tomb_gc as jgc
from crdt_tpu.parallel import swarm as jswarm
from crdt_tpu_torch.models import oplog_columnar as toc
from crdt_tpu_torch.models import orset as tos
from crdt_tpu_torch.models import rseq as trseq
from crdt_tpu_torch.models import rseq_columnar as trc
from crdt_tpu_torch.models import tomb_gc as tgc
from crdt_tpu_torch.obs import devtime
from crdt_tpu_torch.obs import trace as obs_trace
from crdt_tpu_torch.parallel import swarm as tswarm
from crdt_tpu_torch.utils import tracing
from tests.test_torch_oplog_columnar import BITS, _assert_col, _assert_kv, _batch, _op_pool
from tests.test_torch_pack_orset import _assert_columnar, _swarm
from tests.test_torch_rseq_columnar import swarm as rseq_swarm
from tests.test_torch_tomb_gc import CAP, JAD, TAD, assert_gc, edited_swarm, gc_j


def _names(logdir) -> set:
    files = [p for p in pathlib.Path(logdir).rglob("*.json") if p.is_file()]
    assert files, "no trace files written"
    return {e.get("name") for f in files for e in json.loads(f.read_text())["traceEvents"]}


def test_trace_to_captures_profile(tmp_path):
    """trace_to around an OpLog swarm converge writes a Chrome trace
    holding the caller's region and the converge's own; the traced
    converge equals the JAX package's (Pallas in interpret mode)."""
    rng = np.random.default_rng(3)
    j, t = _batch(rng, 4, 16, _op_pool(rng, 24))
    logdir = tmp_path / "trace"
    with tracing.trace_to(str(logdir)):
        with tracing.trace_region("converge"):
            tc, tn = toc.converge_checked(toc.stack(t, BITS))
    assert {"converge", "oplog_columnar.converge"} <= _names(logdir)
    jc, jn = joc.converge_checked(joc.stack(j, BITS), interpret=True)
    _assert_col(jc, tc)
    assert int(jn) == int(tn)


def test_trace_region_is_transparent():
    with tracing.trace_region("noop"):
        x = torch.arange(4).sum()
    assert int(x) == 6
    with pytest.raises(RuntimeError, match="no trace"):
        tracing.stop_trace()


def test_start_trace_twice_refuses(tmp_path):
    tracing.start_trace(str(tmp_path))
    try:
        with pytest.raises(RuntimeError, match="already running"):
            tracing.start_trace(str(tmp_path))
    finally:
        path = tracing.stop_trace()
    assert pathlib.Path(path).parent == tmp_path


def test_rseq_converge_and_gc_barrier_regions_match_jax(tmp_path):
    """The RSeq converge and the GC barrier (its columnar converge inside)
    under one trace: both regions named as in the JAX package, and the
    barrier's result equal to the JAX package's generic barrier."""
    st = rseq_swarm(6, 4, 10)
    g = edited_swarm(2)
    alive = torch.tensor([True, True, False, True])
    with tracing.trace_to(str(tmp_path)):
        got, nu = trc.converge_checked(trc.stack(st))
        out = tgc.gc_round(tswarm.make(g, alive), TAD, trseq.empty(CAP, device="cpu"))
    assert {"rseq_columnar.converge", "tomb_gc.barrier"} <= _names(tmp_path)
    assert int(nu) <= CAP and got.keys.shape[-1] == st.keys.shape[0]
    want = jgc.gc_round(jswarm.make(gc_j(g), jnp.asarray(alive.numpy())), JAD,
                        jrseq.empty(CAP), engine="generic")
    assert_gc(want.state, out.state)


# ---- the gate ------------------------------------------------------------------


def _count_ranges(monkeypatch) -> list:
    """Replace the gate's ``record_function`` by one that counts the
    ranges it opens; returns the list of their names."""
    opened = []
    real = tracing.record_function

    def counted(name):
        opened.append(name)
        return real(name)

    monkeypatch.setattr(tracing, "record_function", counted)
    return opened


def _every_range_opener():
    """Enter each kind of range the port opens once: trace_region,
    obs.trace.span and devtime.dispatch_annotation."""
    with tracing.trace_region("gate.region"):
        pass
    with obs_trace.span("gate.span"):
        with devtime.dispatch_annotation("merge"):
            pass


def test_trace_region_opens_no_range_without_a_profiler(monkeypatch):
    opened = _count_ranges(monkeypatch)
    _every_range_opener()
    assert opened == []
    assert tracing.trace_region("a") is tracing.trace_region("b")


@contextlib.contextmanager
def _user_scope_session():
    """A Kineto session with its record-function callbacks limited to user
    scopes, started as the benchmark's tracer starts one: the profiler's C
    flag reads true, its Python flag stays false."""
    from torch._C._autograd import _disable_profiler, _enable_profiler, _prepare_profiler
    from torch._C._profiler import RecordScope
    from torch.autograd import profiler as autograd_profiler

    session = autograd_profiler.profile(use_kineto=True)
    config, activities = session.config(), session.kineto_activities
    _prepare_profiler(config, activities)
    _enable_profiler(config, activities, {RecordScope.USER_SCOPE})
    try:
        yield
    finally:
        _disable_profiler()


@contextlib.contextmanager
def _profile_session():
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        yield


@pytest.mark.parametrize("session", ["user_scopes", "profile", "trace_to"])
def test_trace_region_opens_its_range_under_a_profiler(monkeypatch, tmp_path, session):
    opened = _count_ranges(monkeypatch)
    start = {"user_scopes": _user_scope_session, "profile": _profile_session,
             "trace_to": lambda: tracing.trace_to(str(tmp_path))}[session]
    with start():
        if session == "user_scopes":
            assert not torch.autograd.profiler._is_profiler_enabled
        _every_range_opener()
    assert opened[:2] == ["gate.region", "gate.span"]
    assert len(opened) == 3 and opened[2].startswith("crdt.join.merge#trace=")
    opened.clear()
    _every_range_opener()
    assert opened == []


def test_span_binds_and_resets_the_trace_id_without_a_profiler(monkeypatch):
    opened = _count_ranges(monkeypatch)
    assert obs_trace.current_trace() is None
    with obs_trace.span("outer", trace_id="t-1") as tid:
        assert tid == "t-1" and obs_trace.current_trace() == "t-1"
        with obs_trace.span("inner") as inner:
            assert inner == "t-1"
        with obs_trace.span("other", trace_id="t-2"):
            assert obs_trace.current_trace() == "t-2"
        assert obs_trace.current_trace() == "t-1"
    assert obs_trace.current_trace() is None
    with pytest.raises(KeyError):
        with obs_trace.span("raises", trace_id="t-3"):
            raise KeyError("x")
    assert obs_trace.current_trace() is None
    assert opened == []


def test_only_the_gate_calls_record_function():
    """No module of the port but utils/tracing.py names record_function
    (a call, an attribute or an import of it)."""
    root = pathlib.Path(tracing.__file__).resolve().parents[1]
    found = []
    for path in sorted(root.rglob("*.py")):
        if path == pathlib.Path(tracing.__file__).resolve():
            continue
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            names = ([a.name for a in node.names] if isinstance(node, ast.ImportFrom)
                     else [getattr(node, "attr", None), getattr(node, "id", None)])
            if "record_function" in names:
                found.append(f"{path.relative_to(root)}:{node.lineno}")
    assert found == []


# ---- the swarm engines' spans ------------------------------------------------

R_SWARM = 6
# span -> its parent (None: opened by the caller's call itself)
SWARM_SPANS = {
    "oplog_columnar.gossip_round": None,
    "oplog_columnar.gossip_round.gather": "oplog_columnar.gossip_round",
    "oplog_columnar.gossip_round.union": "oplog_columnar.gossip_round",
    "oplog_columnar.gossip_round.gate": "oplog_columnar.gossip_round",
    "oplog_columnar.converge": None,
    "oplog_columnar.converge.halving": "oplog_columnar.converge",
    "oplog_columnar.converge.broadcast": "oplog_columnar.converge",
    "oplog_columnar.rebuild": None,
    "oplog_columnar.rebuild.unstack": "oplog_columnar.rebuild",
    "oplog_columnar.rebuild.scatter": "oplog_columnar.rebuild",
    "orset.columnar_join": None,
    "orset.columnar_member_mask": None,
    "orset.columnar_member_mask.decode": "orset.columnar_member_mask",
    "orset.columnar_member_mask.scatter": "orset.columnar_member_mask",
}


def _swarm_calls(t, alive, peers, ta, tb):
    """A pull round, the barrier and the views of an OpLog swarm; an OR-Set
    columnar join and its member mask."""
    col = toc.gossip_round(toc.stack(t, BITS), peers, alive)
    top, nu = toc.converge_checked(col, alive)
    joined = tos.columnar_join(*ta, *tb, out_size=16)
    return {"round": col, "top": top, "nu": nu, "views": toc.rebuild(top, 16),
            "joined": joined, "mask": tos.columnar_member_mask(*joined[:2], 10)}


@pytest.fixture(scope="module")
def swarm_trace(tmp_path_factory):
    """The calls' results traced and untraced, their inputs, and the
    trace's user spans: {name: [(start, end)]}."""
    rng = np.random.default_rng(7)
    j, t = _batch(rng, R_SWARM, 16, _op_pool(rng, 24))
    alive = np.ones(R_SWARM, bool)
    alive[1] = False
    peers = ((np.arange(R_SWARM) + rng.integers(1, R_SWARM, R_SWARM)) % R_SWARM).astype(np.int32)
    js_a, ts_a = _swarm(4, 12)
    js_b, ts_b = _swarm(5, 12)
    ta, tb = tos.stack_to_columnar(ts_a), tos.stack_to_columnar(ts_b)
    args = (t, torch.from_numpy(alive), torch.from_numpy(peers), ta, tb)
    untraced = _swarm_calls(*args)
    logdir = tmp_path_factory.mktemp("swarm-trace")
    with tracing.trace_to(str(logdir)):
        traced = _swarm_calls(*args)
    [path] = list(logdir.glob("*.json"))
    spans = {}
    for e in json.loads(path.read_text())["traceEvents"]:
        if e.get("cat") == "user_annotation" and e.get("ph") == "X":
            spans.setdefault(e["name"], []).append((e["ts"], e["ts"] + e.get("dur", 0)))
    jax_in = (j, jnp.asarray(alive), jnp.asarray(peers), jos.stack_to_columnar(js_a),
              jos.stack_to_columnar(js_b))
    return {"untraced": untraced, "traced": traced, "spans": spans, "jax": jax_in}


@pytest.mark.parametrize("name", list(SWARM_SPANS))
def test_swarm_span_is_written_inside_its_parent(swarm_trace, name):
    spans = swarm_trace["spans"]
    want = math.ceil(math.log2(R_SWARM)) if name.endswith(".halving") else 1
    assert len(spans.get(name, [])) == want, sorted(spans)
    parent = SWARM_SPANS[name]
    if parent is not None:
        for start, end in spans[name]:
            assert any(a <= start and end <= b for a, b in spans[parent]), (name, parent)


def test_swarm_spans_leave_the_results_equal_to_untraced_and_jax(swarm_trace):
    traced, untraced = swarm_trace["traced"], swarm_trace["untraced"]
    for key in ("round", "top"):
        for p in ("hi", "lo", "val", "pay"):
            assert torch.equal(getattr(traced[key], p), getattr(untraced[key], p)), (key, p)
    assert int(traced["nu"]) == int(untraced["nu"])
    for a, b in zip(traced["joined"], untraced["joined"]):
        assert torch.equal(a, b)
    assert torch.equal(traced["mask"], untraced["mask"])
    j, alive, peers, ja, jb = swarm_trace["jax"]
    jcol = joc.gossip_round(joc.stack(j, BITS), peers, alive, interpret=True)
    _assert_col(jcol, traced["round"])
    jtop, jnu = joc.converge_checked(jcol, alive, interpret=True)
    _assert_col(jtop, traced["top"])
    assert int(jnu) == int(traced["nu"])
    _assert_kv(joc.rebuild(jtop, 16), traced["views"])
    want = jos.columnar_join(*ja, *jb, out_size=16, interpret=True)
    _assert_columnar(want, traced["joined"])
    np.testing.assert_array_equal(np.asarray(jos.columnar_member_mask(*want[:2], 10)),
                                  traced["mask"].numpy())
