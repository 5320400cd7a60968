"""The port's nemesis soak (crdt_tpu_torch.harness.nemesis_soak,
device="cpu") against the JAX package's, zero tolerance: the same seed
drives both in-process fleets through the same fault schedule, and the
two runs give equal applied-fault log bytes, write ledgers, converged
states and vvs, wire-call censuses and report counters.

Compared: every field of the report but the wall-clock ones (the
``propagation_s_*`` seconds histograms and the ``admit_p99`` SLO breach,
which time the host), each listed in :data:`WALL_CLOCK`.  This file holds
the default arm (with ``--assemble-check``), the replay check, the CLI and
the refusals; tests/test_torch_nemesis_modes.py holds each mode.
"""
import dataclasses
import json
import pathlib
import re

import pytest
import torch

from crdt_tpu.harness import nemesis_soak as jns
from crdt_tpu_torch.harness import nemesis_soak as tns
from crdt_tpu_torch.parallel import meshplane as tmeshplane

# report fields that time the host (seconds, not steps): not compared
WALL_CLOCK = ("propagation_s_count", "propagation_s_p50", "propagation_s_p99")


def _record(soak, rep, log_path):
    d = dataclasses.asdict(rep)
    d["propagation"] = {k: v for k, v in d["propagation"].items() if k not in WALL_CLOCK}
    fleet = soak._fleet_report
    d["slo_breaches"] = None if fleet is None else [
        b for b in fleet.get("slo_breaches", []) if b.get("kind") != "admit_p99"]
    return d, pathlib.Path(log_path).read_bytes()


def run_twins(tmp_path, seed, nodes, steps, **modes):
    """One NemesisSoak per package, each with its fault log; returns the
    port's record after asserting the two equal.  Unless ``ks_mesh`` is
    given (then both sides take it), the JAX side's keyspace runs
    ``ks_mesh="off"``: the host path the port's ``"auto"`` takes on one
    device, where JAX's ``"auto"`` fuses over its 8 virtual devices."""
    out = {}
    pin_off = (modes.get("multitenant") or modes.get("reshard")) and "ks_mesh" not in modes
    for name, mod, kw in (("j", jns, {"ks_mesh": "off"} if pin_off else {}),
                          ("t", tns, {"device": "cpu"})):
        log = tmp_path / f"{name}-{seed}.jsonl"
        soak = mod.NemesisSoak(seed, nodes=nodes, steps=steps, fault_log=str(log), **modes, **kw)
        rep = soak.run()
        out[name] = _record(soak, rep, log)
    (jd, jlog), (td, tlog) = out["j"], out["t"]
    assert tlog == jlog, "applied-fault logs differ"
    for key in ("writes_ledger", "final_vv", "state_json", "wire_census", "fault_counts"):
        assert td[key] == jd[key], key
    assert td == jd
    return td, tlog


def test_default_arm_with_assembly_matches_jax(tmp_path):
    """The README's default arm at test size, with --assemble-check: the
    blame report explains every spike in both packages."""
    rep, log = run_twins(tmp_path, 0, 2, 30, assemble_check=True)
    assert rep["writes"] > 0 and rep["final_keys"] > 0 and rep["crashes"] >= 1
    assert rep["blame_coverage"] >= 0.95 and rep["snapshot_quarantines"] >= 1
    assert b'"fault": "heal"' in log


@pytest.mark.parametrize("seed", [1, 2])
def test_default_arm_more_seeds_match_jax(tmp_path, seed):
    rep, _ = run_twins(tmp_path, seed, 3, 30)
    assert rep["heal_rounds"] >= 1 and rep["writes"] > 0


@pytest.mark.parametrize("seed,modes", [(5, {}), (3, {"composite": True})],
                         ids=["default-5", "composite-3"])
def test_clock_skew_arms_match_jax(tmp_path, seed, modes):
    """Seeds whose schedules skew a node's clock between its writes and
    its serving: each op keeps the wire key it got when it entered, so no
    peer keeps a second, re-timed row of one (rid, seq) and the raw
    commands retained (``gc_retained``) equal the JAX package's."""
    rep, _ = run_twins(tmp_path, seed, 3, 40, **modes)
    assert rep["writes"] > 0


def test_replay_check_cli_and_summary(tmp_path, capsys):
    """``--replay-check`` through each package's CLI: two same-seed runs
    with byte-identical fault logs, and the same printed summary."""
    lines = []
    for mod, extra in ((jns, []), (tns, ["--device", "cpu"])):
        assert mod.main(["--nodes", "2", "--steps", "20", "--replay-check",
                         "--postmortem-dir", str(tmp_path), *extra]) == 0
        out = capsys.readouterr().out
        [line] = [ln for ln in out.splitlines() if "replay-check OK" in ln]
        lines.append(line.split("; propagation")[0])
    assert lines[0] == lines[1]
    assert not list(tmp_path.glob("postmortem-*")), "no failure, no bundle"


def test_race_check_refused_naming_item_8(capsys):
    """(Named for the refusal it replaced.)  ``--race-check`` runs the
    default arm under the witnessed-race detector: 0 witnesses over a
    non-zero count of watched accesses, and the detector uninstalled
    after the run."""
    import threading

    from crdt_tpu_torch.analysis.verify import race

    assert tns.main(["--race-check", "--device", "cpu", "--nodes", "3",
                     "--steps", "60"]) == 0
    out = capsys.readouterr().out
    [line] = [ln for ln in out.splitlines() if "race-check OK" in ln]
    reads, writes = (int(x) for x in re.findall(r"(\d+) (?:reads|writes)", line))
    assert "0 witnesses" in line and reads + writes > 0
    assert threading.Lock is not race._TracedLock and not race._ENABLED


def test_multitenant_mesh_on_matches_jax(tmp_path, monkeypatch):
    """The multitenant arm with ``ks_mesh="on"`` in both packages (the
    port's one-device batched step, JAX's fused mesh step): the same
    fault log, ledger, state, vv and report, corrupt-shard isolation
    inside the fused step included.  The port's shards really fold
    through the plane, and no step falls back inline."""
    fallbacks = []
    converge = tmeshplane.MeshPlane.converge

    def counted(plane, pendings):
        out = converge(plane, pendings)
        fallbacks.append(plane.metrics.registry.counter_value("meshplane_fallbacks"))
        return out

    monkeypatch.setattr(tmeshplane.MeshPlane, "converge", counted)
    rep, _ = run_twins(tmp_path, 0, 3, 40, multitenant=True, ks_mesh="on")
    assert rep["writes"] > 0
    assert len(fallbacks) > 10 and not any(fallbacks)


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the refusal without a card")
def test_device_none_refuses_without_a_card(capsys):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tns.run_soak(0, 2, 10)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tns.NemesisSoak(0, nodes=2, steps=10)
    assert tns.main(["--steps", "5"]) == 2
    assert "no CUDA device" in capsys.readouterr().err


def test_postmortem_bundle_on_failure_matches_jax(tmp_path):
    """A soak whose oracle fails (a subclass's planted failure) writes
    postmortem-<seed>.tar.gz in both packages with the same members (node
    logs, faults.jsonl, trace.json, blame.json, fleet.json), and the same
    faults.jsonl bytes."""
    import tarfile

    names = {}
    for name, mod, kw in (("j", jns, {}), ("t", tns, {"device": "cpu"})):
        out = tmp_path / name

        class Failing(mod.NemesisSoak):
            def _check_idempotence(self):
                raise AssertionError("planted")

        with pytest.raises(AssertionError, match="planted"):
            Failing(0, nodes=2, steps=20, postmortem_dir=str(out), **kw).run()
        with tarfile.open(out / "postmortem-0.tar.gz") as tf:
            names[name] = (sorted(tf.getnames()),
                           tf.extractfile("faults.jsonl").read(),
                           json.loads(tf.extractfile("blame.json").read())["n_faults"])
    assert names["t"] == names["j"]
    assert {"faults.jsonl", "trace.json", "blame.json"} <= set(names["t"][0])
