"""The port's trace assembler (crdt_tpu_torch.obs.assemble) against the
JAX package's, zero tolerance: tests/test_provenance.py's assembler cases
(the two-node round trip, blame attribution, the CLI with its coverage
gate and the postmortem bundle, the obs CLI dispatch, the lease track) on
the same logs through both packages give byte-equal trace and blame JSON
and bundles with the same members and member bytes (``mtime`` aside); and
the event logs of a port nemesis run, assembled by both packages, give
equal traces and blame reports."""
import json
import tarfile

import pytest

from crdt_tpu.obs import assemble as jasm
from crdt_tpu_torch.obs import assemble as tasm
from tests.test_provenance import _synthetic_logs, _write_jsonl

FAULTS = [{"step": 10, "fault": "drop", "src": "1", "dst": "0", "op": "gossip"}]


def _dump(obj):
    return json.dumps(obj, sort_keys=True)


def both(fn):
    out = {"j": fn(jasm), "t": fn(tasm)}
    assert out["t"] == out["j"]
    return out["t"]


def test_assembler_round_trip_two_nodes(tmp_path):
    paths = _synthetic_logs(tmp_path)

    def run(asm):
        records = asm.load_node_logs(list(paths))
        return _dump(records), _dump(asm.assemble_trace(records)), _dump(asm.blame_report(records))

    records, trace, blame = both(run)
    assert json.loads(records)[0]["node"] == "0"
    evs = json.loads(trace)["traceEvents"]
    names = {e.get("args", {}).get("name") for e in evs if e["ph"] == "M"}
    assert {"node slot 0", "node slot 1", "nemesis (applied faults)"} <= names
    [x] = [e for e in evs if e["ph"] == "X"]
    assert x["name"] == "pull_merge" and x["args"]["trace"] == "tr-1"
    assert len({e["id"] for e in evs if e["ph"] in ("s", "f")}) == 1
    blame = json.loads(blame)
    assert blame["n_visible"] == 1 and blame["n_spikes"] == 0


@pytest.mark.parametrize("faults", [None, FAULTS, [{"step": 10, "fault": "drop", "src": "2",
                                                   "dst": "3"}]])
def test_blame_attributes_spike_to_fault_window(tmp_path, faults):
    paths = _synthetic_logs(tmp_path, with_fault_window=True)

    def run(asm):
        records = asm.load_node_logs(list(paths))
        return (_dump(asm.blame_report(records, faults)),
                _dump(asm.assemble_trace(records, faults)))

    blame = json.loads(both(run)[0])
    assert blame["n_spikes"] == 1
    cause = blame["spikes"][0]["cause"]
    if faults == FAULTS:
        assert cause["kind"] == "drop" and blame["coverage"] == 1.0
    else:
        assert cause == "unexplained" and blame["coverage"] == 0.0


def test_assemble_cli_and_postmortem(tmp_path, capsys):
    p0, p1 = _synthetic_logs(tmp_path, with_fault_window=True)
    faults = _write_jsonl(tmp_path / "faults.jsonl", FAULTS)

    def run(asm):
        tag = asm.__name__.split(".")[0]
        out, blame = tmp_path / f"{tag}-trace.json", tmp_path / f"{tag}-blame.json"
        rc = asm.main([p0, p1, "--fault-log", faults, "--out", str(out), "--blame", str(blame),
                       "--min-coverage", "0.95"])
        printed = json.loads(capsys.readouterr().out)
        printed.pop("out")
        rc2 = asm.main([p0, p1, "--out", str(out), "--min-coverage", "0.95"])
        gate = capsys.readouterr().out.splitlines()[-1]
        rc3 = asm.main([p0, p1, "--fault-log", faults, "--out", str(out)])
        capsys.readouterr()
        bundle = asm.write_postmortem(str(tmp_path / tag / "postmortem-0.tar.gz"), [p0, p1],
                                      fault_records=FAULTS, extra={"fleet.json": {"a": 1}})
        with tarfile.open(bundle) as tf:
            members = [(m.name, m.size, tf.extractfile(m).read()) for m in tf.getmembers()]
        return [rc, printed, blame.read_bytes(), rc2, gate, rc3, out.read_bytes(), members]

    out = both(run)
    assert out[0] == 0 and out[1]["coverage"] == 1.0 and out[3] == 1 and out[5] == 0
    assert out[4].startswith("FAIL: blame coverage")
    assert any(e["tid"] == 0 and e["ph"] == "i"
               for e in json.loads(out[6])["traceEvents"])
    assert [m[0] for m in out[7]] == ["node0.jsonl", "node1.jsonl", "faults.jsonl",
                                      "trace.json", "blame.json", "fleet.json"]


def test_postmortem_qualifies_repeated_basenames(tmp_path):
    """Harness logs share one basename (node<i>/events.jsonl): every
    archive name is qualified by its parent dir, in both packages."""
    paths = []
    for i, p in enumerate(_synthetic_logs(tmp_path)):
        d = tmp_path / f"node{i}"
        d.mkdir()
        target = d / "events.jsonl"
        target.write_bytes(open(p, "rb").read())
        paths.append(str(target))

    def run(asm):
        tag = asm.__name__.split(".")[0]
        with tarfile.open(asm.write_postmortem(str(tmp_path / f"{tag}.tar.gz"), paths)) as tf:
            return tf.getnames()

    assert both(run) == ["node0-events.jsonl", "node1-events.jsonl", "trace.json", "blame.json"]


def test_obs_main_dispatches_assemble(tmp_path, capsys):
    from crdt_tpu.obs.__main__ import main as jmain
    from crdt_tpu_torch.obs.__main__ import main as tmain

    p0, p1 = _synthetic_logs(tmp_path)
    got = []
    for name, main in (("j", jmain), ("t", tmain)):
        out = tmp_path / f"{name}.json"
        assert main(["assemble", p0, p1, "--out", str(out)]) == 0
        assert main(["no-such-cmd"]) == 2
        printed = capsys.readouterr().out.splitlines()
        got.append((out.read_bytes(), printed[-1]))
    assert got[0] == got[1] and json.loads(got[1][0])["traceEvents"]


def test_assembler_lease_track_round_trip(tmp_path):
    t = 1_000_000
    n0 = [
        {"v": 2, "ts_ms": t, "node": "0", "event": "boot", "step": 0},
        {"v": 2, "ts_ms": t + 5, "node": "0", "event": "lease_grant", "slot": 0, "fence": 1,
         "holder": "http://a", "trace": "tr-l1", "step": 1},
        {"v": 2, "ts_ms": t + 8, "node": "0", "event": "lease_renew", "slot": 0, "fence": 1,
         "holder": "http://a", "step": 2},
        {"v": 2, "ts_ms": t + 20, "node": "0", "event": "lease_expire", "slot": 0, "fence": 1,
         "step": 4},
        {"v": 2, "ts_ms": t + 40, "node": "0", "event": "cas_commit", "elapsed_ms": 120.0,
         "keys": ["r"], "step": 8},
        {"v": 2, "ts_ms": t + 41, "node": "0", "event": "consistency_unavailable",
         "reason": "lease_unavailable", "step": 8},
    ]
    n1 = [
        {"v": 2, "ts_ms": t + 1, "node": "1", "event": "boot", "step": 0},
        {"v": 2, "ts_ms": t + 30, "node": "1", "event": "lease_grant", "slot": 0, "fence": 2,
         "holder": "http://b", "trace": "tr-l2", "step": 6},
        {"v": 2, "ts_ms": t + 35, "node": "1", "event": "cas_fenced_reject", "slot": 0,
         "fence": 1, "known": 2, "trace": "tr-z", "step": 7},
        *[{"v": 2, "ts_ms": t + 36 + k, "node": "1", "event": "cas_commit", "elapsed_ms": 2.0,
           "keys": ["r"], "step": 7} for k in range(3)],
    ]
    p0 = _write_jsonl(tmp_path / "node0.jsonl", n0)
    p1 = _write_jsonl(tmp_path / "node1.jsonl", n1)

    def run(asm):
        records = asm.load_node_logs([p0, p1])
        return _dump(asm.assemble_trace(records)), _dump(asm.blame_report(records))

    trace, blame = both(run)
    evs = json.loads(trace)["traceEvents"]
    fences = [e["args"]["fence"] for e in evs if e["ph"] == "C" and e["name"] == "lease fence s0"]
    assert fences == sorted(fences) and fences[-1] == 2
    flows = [e for e in evs if e["ph"] in ("s", "f") and e["name"] == "lease_handoff"]
    assert {e["ph"] for e in flows} == {"s", "f"}
    blame = json.loads(blame)
    assert blame["n_cas_commits"] == 4 and blame["n_cas_spikes"] == 1
    assert blame["cas_spikes"][0]["cause"]["kind"] == "lease_churn"
    assert blame["n_unavailable"] == 1 and blame["burst_coverage"] == 1.0


def test_port_nemesis_logs_assemble_alike(tmp_path):
    """A port nemesis run's event logs and applied-fault log, assembled by
    both packages: equal traces and blame reports, with a gossip span and
    a track for each slot."""
    from crdt_tpu_torch.harness.nemesis_soak import NemesisSoak

    soak = NemesisSoak(0, nodes=3, steps=30, device="cpu")
    try:
        for i in range(soak.steps):
            soak.step(i)
        soak.heal_and_check()
        paths = [s.event_log_path for s in soak.slots]
        faults = list(soak.plane.log)

        def run(asm):
            records = asm.load_node_logs(paths)
            return (_dump(asm.assemble_trace(records, faults)),
                    _dump(asm.blame_report(records, faults)))

        trace, blame = both(run)
    finally:
        soak.close()
    evs = json.loads(trace)["traceEvents"]
    assert any(e["ph"] == "X" for e in evs)
    assert {f"node slot {i}" for i in range(3)} <= {
        e["args"]["name"] for e in evs if e["ph"] == "M"}
    assert json.loads(blame)["n_visible"] > 0
