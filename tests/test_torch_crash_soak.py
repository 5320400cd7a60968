"""The port's crash-recovery soak (crdt_tpu_torch.harness.crashsoak) on
``python -m crdt_tpu_torch --daemon --device cpu`` processes: real
SIGKILLs and checkpoint restores into the live fleet while compaction and
GC barriers run.

* The scripted stale-frontier restore runs on a port fleet and on a JAX
  fleet: the converged states, version vectors and frontiers are equal.
* The other three scenarios of tests/test_crash_soak.py (the post-snapshot
  suffix loss, a random schedule, the stale-floor restore under GC
  barriers) are held by the runner's own oracle folds (I1-I4, S1-S3,
  Q1-Q3, M1-M3, K1 and the black-box provenance checks).
* ``CrashSoakRunner(device=None)`` and the CLI without ``--device`` refuse
  on a machine without a card.
"""
from __future__ import annotations

import json

import pytest
import torch

from crdt_tpu.harness import crashsoak as jcs
from crdt_tpu_torch.harness import crashsoak as tcs
from tests.test_crash_soak import _barrier, _pull_all, _set_add, _set_barrier, _set_pull_all, \
    _set_remove, _write

_http = tcs._http


@pytest.fixture
def fleet():
    r = tcs.CrashSoakRunner(n=3, seed=7, device="cpu")
    yield r
    r.close()


def _stale_frontier_restore(r):
    """tests/test_crash_soak.py's scripted interleaving: restore from a
    PRE-barrier snapshot into a fleet whose barriers keep advancing; returns
    the healed fleet's /data, /vv (vv and frontier) and the report."""
    for slot in range(3):
        _write(r, slot, {"a": str(slot + 1)})
    _pull_all(r)
    code, body = _http(r.daemons[2].url + "/admin/checkpoint", "POST", {})
    assert code == 200, body
    r.ckpt_watermark[r.daemons[2].wire_rid] = r.accepted_per_boot.get(r.daemons[2].wire_rid, 0)
    assert _barrier(r), "fleet was fully converged; barrier must fold"
    _write(r, 0, {"b": "10"})
    _pull_all(r)
    r.daemons[2].sigkill()
    r.daemons[2].spawn()
    stale = json.loads(_http(r.daemons[2].url + "/vv")[1])["frontier"]
    live = json.loads(_http(r.daemons[0].url + "/vv")[1])["frontier"]
    assert stale != live and all(int(stale.get(k, -1)) <= int(v) for k, v in live.items())
    _write(r, 1, {"c": "-4"})
    _barrier(r)
    _pull_all(r)
    _barrier(r)
    report = r.heal_and_check()
    out = [(json.loads(_http(d.url + "/data")[1]), json.loads(_http(d.url + "/vv")[1]))
           for d in r.daemons]
    return out, report


def test_stale_frontier_restore_under_barriers_matches_jax():
    out = {}
    for name, mod, kw in (("j", jcs, {}), ("t", tcs, {"device": "cpu"})):
        r = mod.CrashSoakRunner(n=3, seed=7, **kw)
        try:
            views, report = _stale_frontier_restore(r)
            out[name] = (views, report.ops_lost_to_crashes, report.final_keys,
                         report.event_boots)
        finally:
            r.close()
    assert out["t"] == out["j"]
    views, lost, keys, boots = out["t"]
    assert lost == 0 and keys == 3 and boots == 4
    state, vv = views[2]
    assert state == {"a": "6", "b": "10", "c": "-4"}
    assert all(v == views[0] for v in views)
    assert vv["frontier"], "the barrier folded: the frontier is not empty"


def test_crash_loses_only_post_snapshot_suffix(fleet):
    r = fleet
    _write(r, 1, {"x": "5"})
    _pull_all(r)
    code, _ = _http(r.daemons[1].url + "/admin/checkpoint", "POST", {})
    assert code == 200
    r.ckpt_watermark[r.daemons[1].wire_rid] = r.accepted_per_boot.get(r.daemons[1].wire_rid, 0)
    _write(r, 1, {"y": "7"})
    r.daemons[1].sigkill()
    r.daemons[1].spawn()
    report = r.heal_and_check()
    assert report.ops_lost_to_crashes == 1
    state = json.loads(_http(r.daemons[0].url + "/data")[1])
    assert state.get("x") == "5" and "y" not in state


def test_random_crash_schedule(tmp_path):
    """Seed 3 at 60 steps, the JAX test's schedule: the runner's folds hold
    after SIGKILLs and restores, and the three slots' event logs assemble
    (``python -m crdt_tpu_torch.obs assemble``'s library half) with a
    track for each slot."""
    from crdt_tpu_torch.obs import assemble

    runner = tcs.CrashSoakRunner(n=3, seed=3, device="cpu", workdir=str(tmp_path))
    try:
        for _ in range(60):
            runner.step()
        report = runner.heal_and_check()
        records = assemble.load_node_logs([d.event_log_path for d in runner.daemons])
        trace = assemble.assemble_trace(records)
    finally:
        runner.close()
    assert report.sigkills >= 1 and report.restores >= 1, report
    assert report.checkpoints >= 1 and report.writes_accepted > 0, report
    assert report.set_adds >= 1 and report.seq_inserts >= 1 and report.map_upds >= 1, report
    tracks = {e["args"]["name"] for e in trace["traceEvents"]
              if e.get("ph") == "M" and e["name"] == "thread_name"}
    assert {"node slot 0", "node slot 1", "node slot 2"} <= tracks


def test_stale_floor_restore_under_gc_barriers(fleet):
    r = fleet
    for slot in range(3):
        _set_add(r, slot, f"e{slot}")
    _set_pull_all(r)
    _set_pull_all(r)
    code, body = _http(r.daemons[2].url + "/admin/checkpoint", "POST", {})
    assert code == 200, body
    r.set_ckpt_watermark[r.daemons[2].wire_rid] = r.set_accepted_per_boot.get(
        r.daemons[2].wire_rid, 0)
    _set_remove(r, 0, "e0")
    _set_pull_all(r)
    _set_pull_all(r)
    assert _set_barrier(r), "converged fleet: the GC barrier must fold"
    r.daemons[2].sigkill()
    r.daemons[2].spawn()
    assert "e0" in json.loads(_http(r.daemons[2].url + "/set")[1])["members"]
    _set_barrier(r)
    _set_pull_all(r)
    _set_barrier(r)
    report = r.heal_and_check()
    assert report.set_ops_lost == 0
    members = json.loads(_http(r.daemons[2].url + "/set")[1])["members"]
    assert set(members) == {"e1", "e2"}


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the refusal without a card")
def test_device_none_refuses_without_a_card(tmp_path, capsys):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcs.CrashSoakRunner(n=2, seed=0, workdir=str(tmp_path))
    assert not list(tmp_path.iterdir()), "nothing spawned before the refusal"
    assert tcs.main(["--steps", "1", "--seeds", "1"]) == 2
    assert "no CUDA device" in capsys.readouterr().err
