"""The benchmark is driven by data: every file BENCHMARK.json names is
found by name, and a cell, a mix, a configuration and a metric are added
with new files and new entries only."""
import json
import time

import pytest

from portbench import harness
from portbench.tests.conftest import ROOT

SPEC = harness.Spec(ROOT)


@pytest.mark.parametrize("cell", sorted(SPEC.cells))
def test_every_cell_finds_its_files(cell):
    entry = SPEC.cells[cell]
    config, traffic = SPEC.config(entry), SPEC.traffic(entry)
    assert config["name"] == entry["config"]
    assert (ROOT / "portbench" / "systems" / f"{config['system']}.py").exists()
    assert set(config) >= {"source", "guarantees", "assumed", "reduced"}
    assert traffic["why"]
    for trace in (False, True):
        for m in SPEC.metrics(entry, trace):
            assert callable(SPEC.reader(m["name"]))
    reported = {m["name"] for m in SPEC.metrics(entry, False)}
    assert "setup_s" in reported and len(reported) >= 2
    assert SPEC.metrics(entry, True)


def test_every_metric_has_a_reader_and_moves_a_reported_metric():
    e2e = {m["name"] for m in SPEC.data["end_to_end"]}
    for m in SPEC.data["end_to_end"] + SPEC.data["per_layer"]:
        assert callable(SPEC.reader(m["name"]))
    for m in SPEC.data["per_layer"]:
        assert m["moves"] in e2e
        for cell in m["workloads"]:
            assert m["moves"] in {x["name"] for x in SPEC.metrics(SPEC.cells[cell], False)}


def test_a_new_cell_needs_only_new_files_and_entries(tiny_root):
    """A throwaway configuration, mix and metric, added beside the
    existing files, are found and run without an edit to any of them."""
    before = {p: p.read_bytes() for p in (tiny_root / "portbench").rglob("*") if p.is_file()}
    (tiny_root / "portbench" / "configs" / "kv-tiny.json").write_text(json.dumps({
        "name": "kv-tiny", "system": "kv_swarm", "source": "a test", "replicas": 24,
        "capacity": 32, "delta_min": -20, "delta_max": -11, "non_numeric": 0.5,
        "writes_per_ms": 3, "burst_writes": 20, "hold_fraction": 0.5, "down_per_burst": 2,
        "guarantees": [], "assumed": {}, "reduced": []}))
    (tiny_root / "portbench" / "traffic" / "two-rounds.json").write_text(json.dumps({
        "why": "a test", "snapshots": 2, "peer_bank": 3, "rounds": 2,
        "rebuild_every_round": True}))
    (tiny_root / "portbench" / "metrics" / "epochs_in_window.py").write_text(
        "def read(run):\n    return run.totals['epochs']\n")
    spec = json.loads((tiny_root / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "kv-tiny", "source": "a test",
                            "file": "portbench/configs/kv-tiny.json", "reduced": [],
                            "why": "a test"})
    spec["workloads"].append({"name": "kv-tiny.two-rounds", "config": "kv-tiny",
                              "traffic": "two-rounds", "chips": 1, "why": "a test"})
    spec["per_layer"].append({"name": "epochs_in_window", "unit": "epochs",
                              "better": "higher", "source": "program_counter",
                              "layer": "swarm engine", "moves": "views_per_s",
                              "workloads": ["kv-tiny.two-rounds"]})
    for m in spec["end_to_end"]:
        if m["name"] == "views_per_s":
            m["workloads"].append("kv-tiny.two-rounds")
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(spec))

    out = harness.run_cell(tiny_root, "kv-tiny.two-rounds", 2**31 + 7, 0.3, True, "cpu",
                           time.perf_counter())
    r = out["result"]
    assert r["correct"], r["compared"]
    assert r["metrics"]["epochs_in_window"]["value"] == r["attempted"] > 0
    after = {p: p.read_bytes() for p in before}
    assert after == before
