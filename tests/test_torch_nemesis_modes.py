"""Every mode of the port's nemesis soak against the JAX package's, zero
tolerance (tests/test_torch_nemesis.py's twin runner): ``--gc`` with its
shadow arm, ``--strong``, ``--crash-coordinator``, ``--multitenant``,
``--reshard``, ``--audit`` with its plant-free arm, ``--composite`` and
``--overload``.  Each arm's seed and size is one at which the JAX
package's own oracles hold (the CLI's defaults are larger); the two runs
give equal fault-log bytes, ledgers, states, vvs, censuses and counters,
and each mode's laws hold."""
import pytest

from tests.test_torch_nemesis import run_twins


def test_gc_mode_with_its_shadow_arm(tmp_path):
    rep, _ = run_twins(tmp_path, 0, 2, 30, gc=True)
    assert rep["gc_mints"] > 0 and rep["gc_retained"] == 0


def test_gc_shadow_comparison_through_run_soak():
    """run_soak's two-arm gate in the port: the GC arm against its GC-off
    shadow (bit-equal state, fewer retained commands)."""
    from crdt_tpu.harness.nemesis_soak import run_soak as jrun
    from crdt_tpu_torch.harness.nemesis_soak import run_soak as trun

    j = jrun(0, 2, 30, gc=True)
    t = trun(0, 2, 30, gc=True, device="cpu")
    assert (t.gc_retained, t.gc_retained_shadow, t.state_json) == \
        (j.gc_retained, j.gc_retained_shadow, j.state_json)
    assert t.gc_retained < t.gc_retained_shadow


def test_strong_mode(tmp_path):
    rep, _ = run_twins(tmp_path, 0, 2, 30, strong=True)
    assert rep["strong_ok"] > 0 and rep["strong_unavailable"] > 0


def test_crash_coordinator_mode(tmp_path):
    rep, _ = run_twins(tmp_path, 1, 3, 40, strong=True, crash_coordinator=True)
    assert rep["coordinator_crashes"] >= 1 and rep["zombie_attempts"] >= 1
    assert rep["cas_commits"] > 0 and rep["fenced_rejects"] > 0


def test_multitenant_mode(tmp_path):
    rep, _ = run_twins(tmp_path, 2, 2, 30, multitenant=True)
    assert rep["mt_sheds"] > 0 and rep["mt_page_quarantines"] > 0 and rep["mt_restores"] >= 1
    assert min(rep["mt_prop_coverage"].values()) >= 0.95
    assert [b["kind"] for b in rep["slo_breaches"]] == ["shed_ratio"]


def test_reshard_mode(tmp_path):
    """The online 2 -> 4 reshard under corrupt and drop windows, a durable
    crash mid-window and the staggered cutover; the restore's replay is
    muted in both packages, so the flight recorder's counts agree."""
    rep, _ = run_twins(tmp_path, 0, 3, 30, reshard=True)
    assert (rep["rs_shards_from"], rep["rs_shards_to"], rep["rs_epoch"]) == (2, 4, 1)
    assert rep["rs_fences"] > 0 and rep["rs_quarantines"] > 0 and rep["rs_streams"] > 0


def test_audit_mode_planted_arm(tmp_path):
    rep, _ = run_twins(tmp_path, 0, 2, 30, audit=True)
    assert rep["audit_planted"] == rep["audit_drifts"] > 0
    assert rep["audit_divergences"] > 0 and rep["audit_postmortems"] > 0


def test_audit_plant_free_arm_and_census_through_run_soak():
    from crdt_tpu.harness.nemesis_soak import run_soak as jrun
    from crdt_tpu_torch.harness.nemesis_soak import run_soak as trun

    j = jrun(0, 2, 30, audit=True)
    t = trun(0, 2, 30, audit=True, device="cpu")
    assert t.wire_census == j.wire_census and t.state_json == j.state_json


@pytest.mark.parametrize("mode", ["composite", "overload"])
def test_composite_and_overload_modes(tmp_path, mode):
    rep, _ = run_twins(tmp_path, 0, 2, 30, **{mode: True})
    if mode == "composite":
        assert rep["composite_ops"] > 0
    else:
        assert rep["sheds"] > 0 and rep["shed_ops"] > 0
