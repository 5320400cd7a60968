"""Each cell, at a tiny size on the program's CPU twins, comes out
correct; the control comes out not correct; and so does a run whose timed
path is broken underneath, once for each fault the cell can have."""
import time

import pytest
import torch

from crdt_tpu_torch.models import oplog_columnar, orset
from portbench import harness
from portbench.systems import kv_swarm, orset_swarm

CELLS = ("kv-swarm-10k.gossip", "kv-swarm-10k.read", "orset-swarm-1m.join")
SENTINEL = 2**31 - 1


def run(root, cell, seed=2**31 + 11, system=None, trace=False, seconds=0.3):
    return harness.run_cell(root, cell, seed, seconds, trace, "cpu", time.perf_counter(),
                            system=system)["result"]


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("cell", CELLS)
def test_cell_is_correct_on_the_cpu(tiny_root, cell, trace):
    r = run(tiny_root, cell, trace=trace)
    assert r["correct"], r["compared"]
    assert r["attempted"] > 0 and r["failed"] == 0
    assert list(r)[-1] == "compared"
    if not trace:
        reported = {m["name"] for m in harness.Spec(tiny_root).metrics(
            harness.Spec(tiny_root).cells[cell], False)}
        assert set(r["metrics"]) == reported and "setup_s" in reported
        assert all(m["value"] > 0 for m in r["metrics"].values())
    else:
        # no device: the trace's device readers find nothing to read
        assert not any(k.endswith("roofline") or k.startswith("device_idle")
                       for k in r["metrics"])


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(tiny_root, cell):
    module = kv_swarm if cell.startswith("kv") else orset_swarm
    r = run(tiny_root, cell, system=module.Control())
    assert not r["correct"]
    assert sum(c["value"] > c["limit"] for c in r["compared"].values()) >= 1


@pytest.mark.parametrize("cell", CELLS)
def test_a_one_epoch_window_is_checked(tiny_root, cell):
    """However short the window, the check compares what it produced."""
    module = kv_swarm if cell.startswith("kv") else orset_swarm
    r = run(tiny_root, cell, system=module.Control(), seconds=0)
    assert r["attempted"] == 1 and not r["correct"], r["compared"]


def _gossip_unchanged(col, peers, alive=None):
    return col


def _converge_unchanged(col, alive=None):
    return col, torch.zeros((), dtype=torch.int32)


def _merge_half(real):
    def merge_checked(a, b):
        out, nu = real(a, b)
        half = a.lanes // 2
        for p in ("hi", "lo", "val", "pay"):
            getattr(out, p)[:, half:] = getattr(a, p)[:, half:]
        return out, nu
    return merge_checked


def _merge_altered(real):
    def merge_checked(a, b):
        out, nu = real(a, b)
        # lane 0's newest op, which its key's view always shows: the
        # barrier's last merge makes the union every up lane takes
        k = int(nu[0].clamp(max=out.capacity)) - 1
        if k >= 0:
            out.val[k, 0] += 1
            out.pay[k, 0] += 1
        return out, nu
    return merge_checked


def _rebuild_altered(real):
    def rebuild(col, n_keys):
        kv = real(col, n_keys)
        kv.num[0] += 1
        kv.payload[0] += 1
        return kv
    return rebuild


def _converge_keeps_state(real):
    def converge_checked(col, alive=None):
        _, nu = real(col, alive)
        return col, nu
    return converge_checked


def _gossip_ignores_alive(real):
    def gossip_round(col, peers, alive=None):
        return real(col, peers)
    return gossip_round


def _converge_overflows(real):
    def converge_checked(col, alive=None):
        out, nu = real(col, alive)
        return out, nu + col.capacity
    return converge_checked


KV_FAULTS = {
    "gossip returns its state unchanged": ("gossip_round", lambda real: _gossip_unchanged),
    "barrier returns its state unchanged": ("converge_checked",
                                            lambda real: _converge_unchanged),
    "barrier returns its state unchanged with the true unique count": (
        "converge_checked", _converge_keeps_state),
    "half the lanes left out of each merge": ("merge_checked", _merge_half),
    "an op altered where a merge makes it": ("merge_checked", _merge_altered),
    "a view altered where rebuild makes it": ("rebuild", _rebuild_altered),
    "the down replica pulls": ("gossip_round", _gossip_ignores_alive),
    "the barrier's unique count altered": ("converge_checked", _converge_overflows),
}


@pytest.mark.parametrize("fault", sorted(KV_FAULTS))
@pytest.mark.parametrize("cell", CELLS[:2])
def test_kv_fault_is_not_correct(tiny_root, monkeypatch, cell, fault):
    name, broken = KV_FAULTS[fault]
    monkeypatch.setattr(oplog_columnar, name, broken(getattr(oplog_columnar, name)))
    r = run(tiny_root, cell)
    assert not r["correct"], (fault, r["compared"])


def _join_unchanged(real):
    def columnar_join(pa, ra, pb, rb, **kw):
        return pa, ra, (pa != SENTINEL).sum(0, dtype=torch.int32)
    return columnar_join


def _join_half(real):
    def columnar_join(pa, ra, pb, rb, **kw):
        keys, vals, n = real(pa, ra, pb, rb, **kw)
        half = pa.shape[1] // 2
        return (torch.cat([keys[:, :half], pa[:, half:]], 1),
                torch.cat([vals[:, :half], ra[:, half:]], 1), n)
    return columnar_join


def _join_altered(real):
    def columnar_join(pa, ra, pb, rb, **kw):
        keys, vals, n = real(pa, ra, pb, rb, **kw)
        vals = vals.clone()
        vals[0, 0] ^= 1
        return keys, vals, n
    return columnar_join


def _mask_unchanged(real):
    def columnar_member_mask(packed, removed, n_universe):
        return torch.zeros((n_universe, packed.shape[1]), dtype=torch.bool)
    return columnar_member_mask


def _join_count_altered(real):
    def columnar_join(pa, ra, pb, rb, **kw):
        keys, vals, n = real(pa, ra, pb, rb, **kw)
        return keys, vals, n + pa.shape[0]
    return columnar_join


def _join_other_engine(real):
    def columnar_join(pa, ra, pb, rb, **kw):
        return real(pa, ra, pb, rb, **dict(kw, engine="bucket"))
    return columnar_join


ORSET_FAULTS = {
    "join returns its state unchanged": ("columnar_join", _join_unchanged),
    "half the lanes left out of the join": ("columnar_join", _join_half),
    "a tombstone altered where the join makes it": ("columnar_join", _join_altered),
    "membership never computed": ("columnar_member_mask", _mask_unchanged),
    "the unique count altered": ("columnar_join", _join_count_altered),
    "the join off the engine the traffic states": ("columnar_join", _join_other_engine),
}


@pytest.mark.parametrize("fault", sorted(ORSET_FAULTS))
def test_orset_fault_is_not_correct(tiny_root, monkeypatch, fault):
    name, broken = ORSET_FAULTS[fault]
    monkeypatch.setattr(orset, name, broken(getattr(orset, name)))
    r = run(tiny_root, "orset-swarm-1m.join")
    assert not r["correct"], (fault, r["compared"])


def test_orset_cell_checks_lane_blocks_past_the_first(tmp_path):
    """Past 65,536 lanes the draw and the check go block by block."""
    from portbench.tests.conftest import TINY, copy_benchmark

    sizes = dict(TINY, **{"orset-swarm-1m": dict(TINY["orset-swarm-1m"], replicas=65_600,
                                                 capacity=32, elems=32, writers=4)})
    r = run(copy_benchmark(tmp_path, sizes), "orset-swarm-1m.join")
    assert r["correct"], r["compared"]


@pytest.mark.parametrize("fault", [False, True])
def test_epochs_issued_ahead_are_all_counted_and_checked(tiny_root, monkeypatch, fault):
    """In a cell that issues epochs ahead of the one it waits for, the
    window closes on every epoch it issued: each is counted, and each
    epoch's unique count is read back and compared."""
    if fault:
        monkeypatch.setattr(oplog_columnar, "converge_checked",
                            _converge_overflows(oplog_columnar.converge_checked))
    assert harness.Spec(tiny_root).traffic({"traffic": "read"})["epochs_ahead"] > 0
    out = harness.run_cell(tiny_root, "kv-swarm-10k.read", 2**31 + 5, 0.3, False, "cpu",
                           time.perf_counter())
    info, r = out["info"], out["result"]
    assert info["epochs"] == info["totals"]["epochs"] == r["attempted"] > 1
    if fault:
        assert r["compared"]["n_unique_wrong"]["value"] == r["attempted"] == r["failed"]
    else:
        assert r["correct"] and r["failed"] == 0
