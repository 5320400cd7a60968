"""The port's crdtflow (crdt_tpu_torch.analysis.flow) against the JAX
package's: every fixture of tests/test_flow.py (the three mesh-plane lock-leak
bugs, their fixed shapes, the CRDT210-213 cases) gives equal findings
from both; the card's ``device_lock``, which only the port has, is seen
in ``with`` items, through ``ExitStack.enter_context`` and through
``.acquire()``, in the declared order node lock before device lock; a
torch host sync under a node lock is CRDT213; the race-detector bridge
maps the same witness alike in both packages; the port's tree is free of
error-severity flow findings."""
import textwrap

import pytest

from crdt_tpu.analysis import Finding as JFinding
from crdt_tpu.analysis import flow as jflow
from crdt_tpu_torch import analysis
from crdt_tpu_torch.analysis import Finding, flow


def _key(findings):
    return sorted((f.rule, f.line, f.scope, f.detail, f.severity) for f in findings)


def _check(mod, tmp_path, source, relpath="fixture.py"):
    p = tmp_path / relpath
    p.parent.mkdir(parents=True, exist_ok=True)
    p.write_text(textwrap.dedent(source))
    return mod.check_files([p], tmp_path)


# ---- tests/test_flow.py's fixtures: name -> (source, sorted rules) ----

FIXTURES = {
    "meshplane_bug1_comprehension_built_lane_list": ("""
        def receive_all(self, payloads):
            pendings = [shard.merge_begin([p])
                        for shard, p in zip(self.shards, payloads)]
            return self.plane.converge(pendings)
    """, ["CRDT212"]),
    "meshplane_bug2_first_failure_commit_sweep": ("""
        def converge(self, a, b):
            a._lock.acquire()
            b._lock.acquire()
            total = a.commit_rows()    # first failure aborts the sweep
            total += b.commit_rows()
            a._lock.release()
            b._lock.release()
            return total
    """, ["CRDT210", "CRDT210"]),
    "meshplane_bug3_unresolved_claims_on_converge_error": ("""
        def flush_fused(self, lane, plane, pendings):
            claim = lane.claim()
            plane.converge(pendings)   # raises -> claim leaks
            return claim.resolve([])
    """, ["CRDT212"]),
    "meshplane_fix1_incremental_build_with_landing": ("""
        def receive_all(self, shards):
            pendings = []
            try:
                for shard in shards:
                    pendings.append(shard.merge_begin([]))
            except BaseException:
                self.land_all_inline(pendings)
                raise
            return self.plane.converge(pendings)
    """, []),
    "meshplane_fix2_per_lane_try_finally_sweep": ("""
        def converge(self, lanes):
            total = 0
            for lane in lanes:
                lane._lock.acquire()
                try:
                    total += lane.commit_rows()
                finally:
                    lane._lock.release()
            return total
    """, []),
    "meshplane_fix3_claim_guarded_by_fail": ("""
        def flush_fused(self, lane, plane, pendings):
            claim = lane.claim()
            if claim is None:
                return 0
            try:
                plane.converge(pendings)
            except BaseException as exc:
                return claim.fail(exc)
            return claim.resolve([])
    """, []),
    "bare_acquire_with_raising_call": ("""
        def poke(self):
            self._lock.acquire()
            self.refresh()
            self._lock.release()
    """, ["CRDT210"]),
    "try_finally_release": ("""
        def poke(self):
            self._lock.acquire()
            try:
                self.refresh()
            finally:
                self._lock.release()
    """, []),
    "with_block": ("""
        def poke(self):
            with self._lock:
                self.refresh()
    """, []),
    "creator_returns_holding": ("""
        def merge_begin(self, batch):
            self._lock.acquire()
            try:
                self._accept(batch)
                pending = PendingMerge(self)
            except BaseException:
                self._lock.release()
                raise
            return pending
    """, []),
    "creator_leaky_raise_edge": ("""
        def merge_begin(self, batch):
            self._lock.acquire()
            self._accept(batch)
            return PendingMerge(self)
    """, ["CRDT210"]),
    "door_lock_via_threading_registry": ("""
        import threading

        class Door:
            def __init__(self):
                self._adm = threading.Lock()

            def submit(self):
                self._adm.acquire()
                self.push()
                self._adm.release()
    """, ["CRDT210"]),
    "locked_callee_convention": ("""
        def update(self):
            with self._lock:
                self._bump_locked()

        def _bump_locked(self):
            self.n += 1
    """, []),
    "declared_order_node_before_drain": ("""
        def backwards(self, lane):
            self._lock.acquire()
            try:
                lane._drain_lock.acquire()
                try:
                    self.fold()
                finally:
                    lane._drain_lock.release()
            finally:
                self._lock.release()
    """, ["CRDT211"]),
    "declared_order_respected": ("""
        def forwards(self, lane):
            lane._drain_lock.acquire()
            try:
                with self._lock:
                    self.fold()
            finally:
                lane._drain_lock.release()
    """, []),
    "order_cycle": ("""
        def one(self):
            with self._alock:
                with self._block:
                    self.a()

        def two(self):
            with self._block:
                with self._alock:
                    self.b()
    """, ["CRDT211", "CRDT211"]),
    "dropped_claim": ("""
        def fire(self, lane):
            lane.claim()
    """, ["CRDT212"]),
    "ticket_normal_path_drop": ("""
        def admit(self, q):
            t = q.submit_many([1])
            if self.closed:
                return None
            return t.wait(1.0)
    """, ["CRDT212"]),
    "ticket_exception_paths_exempt": ("""
        def admit(self, q):
            t = q.submit_many([1])
            self.account()
            return t.wait(5.0)
    """, []),
    "ticket_comprehension": ("""
        def submit_groups(self, groups):
            with self._adm_lock:
                return [q.submit_many(items) for q, items in groups]
    """, []),
    "escape_transfers_obligation": ("""
        def land_all_inline(pendings):
            total = 0
            for p in pendings:
                total += p.commit_inline()
            return total

        def handoff(self, lane):
            claim = lane.claim()
            self.landings.append(claim)
            return self.drain_later()
    """, []),
    "host_sync_under_node_lock": ("""
        import numpy as np

        def snapshot(self):
            with self._lock:
                return np.asarray(self.rows)
    """, ["CRDT213"]),
    "transitive_blocking_under_lock": ("""
        import time

        class Lane:
            def settle(self):
                time.sleep(0.1)

            def drain(self, other):
                other._drain_lock.acquire()
                try:
                    self.settle()
                finally:
                    other._drain_lock.release()
    """, ["CRDT213"]),
    "blocking_outside_sensitive_locks": ("""
        import numpy as np
        import time

        def poll(self):
            time.sleep(0.1)
            return np.asarray(self.rows)

        def account(self):
            with self._gauge_lock:
                self.n += 1
    """, []),
}


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_fixture_findings_equal_jax(tmp_path, name):
    source, want = FIXTURES[name]
    relpath = "leaky.py" if name == "creator_leaky_raise_edge" else "fixture.py"
    got = _check(flow, tmp_path / "t", source, relpath)
    ref = _check(jflow, tmp_path / "j", source, relpath)
    assert sorted(f.rule for f in got) == want
    assert _key(got) == _key(ref)


# ---- the card's device lock (the port's own) ----

DEVICE_FIXTURES = {
    "node_then_device_nested": ("""
        def merge(self):
            with self._lock:
                with device_lock(self.device):
                    self.fold()
    """, []),
    "node_then_device_one_with": ("""
        def get_state(self):
            with self._lock, device_lock(self.device):
                return self.fold()
    """, []),
    "device_then_node": ("""
        def backwards(self):
            with device_lock(self.device):
                with self._lock:
                    self.fold()
    """, ["CRDT211"]),
    "device_then_node_one_with": ("""
        def backwards(self):
            with device_lock(self.device), self._lock:
                return self.fold()
    """, ["CRDT211"]),
    "exit_stack_of_device_locks": ("""
        import contextlib

        def step(self, devices):
            with contextlib.ExitStack() as locks:
                for d in devices:
                    locks.enter_context(device_lock(d))
                self.fold()
            return self.commit()
    """, []),
    "node_lock_under_exit_stack": ("""
        import contextlib

        def step(self, devices):
            with contextlib.ExitStack() as locks:
                for d in devices:
                    locks.enter_context(device_lock(d))
                with self._lock:
                    self.fold()
    """, ["CRDT211"]),
    "bare_device_acquire_with_raising_call": ("""
        def merge(self, d):
            device_lock(d).acquire()
            self.fold()
            device_lock(d).release()
    """, ["CRDT210"]),
    "device_acquire_try_finally": ("""
        def merge(self, d):
            device_lock(d).acquire()
            try:
                self.fold()
            finally:
                device_lock(d).release()
    """, []),
    "torch_sync_under_node_lock": ("""
        def snapshot(self):
            with self._lock:
                return self.rows.cpu()
    """, ["CRDT213"]),
    "int_of_tensor_under_node_lock": ("""
        def count(self):
            with self._lock, device_lock(self.device):
                return int(self.rows.sum())
    """, ["CRDT213"]),
    "torch_sync_under_device_lock_only": ("""
        def snapshot(self, node):
            with device_lock(node.device):
                host = node.rows.cpu()
            return host
    """, []),
}


@pytest.mark.parametrize("name", sorted(DEVICE_FIXTURES))
def test_device_lock_fixtures(tmp_path, name):
    source, want = DEVICE_FIXTURES[name]
    findings = _check(flow, tmp_path, source)
    assert sorted(f.rule for f in findings) == want
    for f in findings:
        if f.rule == "CRDT211":
            assert f.detail == "device_lock->_lock"
            assert "declared" in f.message and f.severity == "error"
        if f.rule == "CRDT210":
            assert f.detail.startswith("device_lock(d)|")


def test_jax_flow_does_not_see_the_device_order(tmp_path):
    """What the port adds: JAX's crdtflow declares no device-lock order,
    so the reverse acquisition passes it silently."""
    source = DEVICE_FIXTURES["device_then_node"][0]
    assert _check(jflow, tmp_path, source) == []
    assert flow.DECLARED_ORDER == jflow.DECLARED_ORDER + (("_lock", "device_lock"),)


def test_exit_stack_locks_are_held_until_the_stack_closes(tmp_path):
    """A node lock taken after the stack's ``with`` closed is clean: the
    stack released its device locks on every exit edge."""
    findings = _check(flow, tmp_path, """
        import contextlib

        def step(self, devices):
            with contextlib.ExitStack() as locks:
                for d in devices:
                    locks.enter_context(device_lock(d))
                self.fold()
            with self._lock:
                self.commit()
    """)
    assert findings == []


# ---- rules and the race-detector bridge ----


def test_flow_rules_are_listed():
    for rule in ("CRDT210", "CRDT211", "CRDT212", "CRDT213"):
        assert rule in analysis.RULES
    assert [analysis.SEVERITY[r] for r in ("CRDT210", "CRDT211", "CRDT212", "CRDT213")] \
        == ["error", "error", "error", "warn"]


def _bridge(mod, finding, pkg):
    f = finding(rule="CRDT210", path=f"{pkg}/ingest/admission.py", line=249,
                scope="AdmissionQueue.claim", message="m",
                detail="self._drain_lock|raise")
    return mod.map_witnesses(
        [f"race on AdmissionQueue._pending:\n"
         f"  writer: {pkg}/ingest/admission.py:251 in claim\n"
         f"  reader: {pkg}/ingest/admission.py:210 in submit_many",
         f"race on Metrics._vals:\n  writer: {pkg}/utils/metrics.py:60 in inc"],
        findings=[f])


def test_bridge_maps_witnesses_like_jax():
    mine = _bridge(flow, Finding, "crdt_tpu_torch")
    theirs = _bridge(jflow, JFinding, "crdt_tpu")
    assert [m["covered"] for m in mine] == [True, False]
    assert "CRDT210" in mine[0]["covered_by"][0]
    assert [{**m, "covered_by": [c.replace("crdt_tpu_torch/", "crdt_tpu/")
                                 for c in m["covered_by"]]} for m in mine] == theirs


def test_bridge_report_shape():
    assert flow.bridge_report([]) == jflow.bridge_report([]) == \
        {"witness_count": 0, "mapped": [], "uncovered_count": 0}


def test_flow_layer_runs_over_package_without_errors():
    """The port's tree is CRDT210/211/212-clean (errors are fixed, not
    baselined), device lock included."""
    findings = flow.check_files(analysis.iter_py_files([analysis.package_root()]),
                                analysis.repo_root())
    errors = [f for f in findings if f.severity == "error"]
    assert errors == [], "\n".join(f.render() for f in errors)
