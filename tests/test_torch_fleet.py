"""The port's fleet SLO rollup (crdt_tpu_torch.obs.fleet) and its CLI
(``python -m crdt_tpu_torch.obs``) against the JAX package's, zero
tolerance, following tests/test_fleet.py case by case: the same
registry content, rendered by either package's registry, parses and
folds to the same report in both; breaches, events, reconciliations,
lease timelines, the CLI's exit codes and files, and a live ``GET
/fleet`` of a JAX pair and a port pair are equal."""
from __future__ import annotations

import json
import os
import subprocess
import sys
import threading
import urllib.error
import urllib.request
from pathlib import Path

import pytest

from crdt_tpu.api import net as jnet
from crdt_tpu.obs import fleet as jfleet
from crdt_tpu.obs.events import EventLog as JEventLog
from crdt_tpu.obs.registry import MetricsRegistry as JRegistry
from crdt_tpu.utils.config import ClusterConfig as JConfig
from crdt_tpu_torch.api import net as tnet
from crdt_tpu_torch.obs import fleet as tfleet
from crdt_tpu_torch.obs.events import EventLog as TEventLog
from crdt_tpu_torch.obs.registry import MetricsRegistry as TRegistry
from crdt_tpu_torch.utils.config import ClusterConfig as TConfig

ROOT = Path(__file__).resolve().parent.parent
PKG = {"j": (jfleet, JRegistry, JEventLog), "t": (tfleet, TRegistry, TEventLog)}


def both(fn):
    out = {p: fn(p) for p in ("j", "t")}
    assert out["t"] == out["j"]
    return out["t"]


def snapshot_tables(snap):
    hists = {k: (h.buckets, h.count, h.sum) for k, h in snap.hists.items()}
    return snap.counters, snap.gauges, hists


def fill_round_trip(reg):
    reg.inc("ingest_shed", 3.0, lane="tenant", node="0", tenant="t-a")
    reg.inc("keyspace_tenant_ops", 7.0, tenant="t-a", node="0")
    reg.set_gauge("keyspace_shard_ops", 42.0, shard="1", node="0")
    reg.set_gauge("keyspace_tenant_depth", 2.0, tenant='t-"q\\uo\nte"', node="0")
    for v in (0.001, 0.004, 0.25, 3.0, 3.0):
        reg.observe("ks_admit_latency", v, tenant="t-a", node="0")
    for lag in (0.0, 1.0, 2.0, 2.0, 40.0):
        reg.observe("op_propagation_steps", lag, origin="1", node="0", tenant="t-a", shard="0")
    return reg


def test_parse_prometheus_round_trip():
    """Each package's exposition parses to the same tables in both, and a
    parsed histogram equals the one that rendered it."""
    texts = {p: fill_round_trip(PKG[p][1]()).render_prometheus() for p in ("j", "t")}
    assert texts["t"] == texts["j"]
    for text in texts.values():
        tables = both(lambda p: snapshot_tables(PKG[p][0].parse_prometheus(text)))
        assert tables[0][("ingest_shed", (("lane", "tenant"), ("node", "0"),
                                          ("tenant", "t-a")))] == 3.0
    snap = tfleet.parse_prometheus(texts["t"])
    src = fill_round_trip(TRegistry()).histogram("ks_admit_latency", tenant="t-a", node="0")
    [(lbl, h)] = snap.hists_named("ks_admit_latency")
    assert lbl == {"tenant": "t-a", "node": "0"} and h.buckets == src.buckets
    assert h.quantile(0.5) == src.quantile(0.5)
    [(lbl, _)] = snap.gauges_named("keyspace_tenant_depth")
    assert lbl["tenant"] == 't-"q\\uo\nte"'


def two_member_texts(Registry, *, observed=4):
    r0 = Registry()
    r0.inc("keyspace_tenant_ops", 4.0, tenant="t-a", node="0")
    r0.inc("ingest_shed", 2.0, lane="tenant", node="0", tenant="t-noisy")
    r0.inc("ingest_shed_ops", 6.0, lane="tenant", node="0", tenant="t-noisy")
    r0.set_gauge("keyspace_tenant_quota", 8.0, tenant="t-noisy", node="0")
    r0.set_gauge("keyspace_shard_ops", 3.0, shard="0", node="0")
    r0.set_gauge("keyspace_shard_ops", 1.0, shard="1", node="0")
    r0.set_gauge("lease_state", 1.0, slot="0", node="0")
    r0.set_gauge("lease_fence_epoch", 3.0, slot="0", node="0")
    for v in (0.001, 0.002, 0.004, 0.008):
        r0.observe("ks_admit_latency", v, tenant="t-a", node="0")
    r1 = Registry()
    for _ in range(observed):
        r1.observe("op_propagation_steps", 2.0, origin="0", node="1", tenant="t-a", shard="0")
    r1.set_gauge("lease_state", 0.0, slot="0", node="1")
    r1.set_gauge("lease_fence_epoch", 3.0, slot="0", node="1")
    r1.set_gauge("lease_state", 2.0, slot="1", node="1")
    r1.set_gauge("lease_fence_epoch", 2.0, slot="1", node="1")
    return {"0": r0.render_prometheus(), "1": r1.render_prometheus()}


@pytest.mark.parametrize("observed", [4, 3])
def test_fleet_summary_tenant_shard_slot_rows(observed):
    def run(p):
        fleet, Registry, _ = PKG[p]
        return fleet.fleet_from_texts(two_member_texts(Registry, observed=observed))

    report = both(run)
    ta = report["tenants"]["t-a"]
    assert ta["ops"] == 4 and ta["prop_coverage"] == observed / 4
    assert report["tenants"]["t-noisy"]["shed_ratio"] == 1.0
    assert report["shard_balance"] == pytest.approx(1.5)
    assert report["slots"]["0"]["holder"] == "0" and report["slots"]["1"]["expired"] == ["1"]


def test_fleet_audit_rollup_worst_state_and_per_plane_rows():
    def run(p):
        fleet, Registry, _ = PKG[p]
        r0, r1 = Registry(), Registry()
        r0.set_gauge("audit_state", 1.0)
        r0.set_gauge("audit_agreement", 1.0, plane="host")
        r1.set_gauge("audit_state", 2.0)
        r1.set_gauge("audit_agreement", 0.0, plane="host")
        r1.set_gauge("audit_agreement", 1.0, plane="ks-0")
        r1.inc("audit_divergences", 3.0)
        r1.inc("audit_scrub_drifts", 1.0)
        return [fleet.fleet_from_texts({"0": r0.render_prometheus(),
                                        "1": r1.render_prometheus()})["audit"],
                fleet.fleet_from_texts({"0": Registry().render_prometheus()})["audit"]]

    a, clean = both(run)
    assert a["state"] == 2 and a["planes"]["host"] == {"agree": ["0"], "disagree": ["1"]}
    assert clean["state"] == 0


def test_evaluate_slo_emits_events_and_reconciles():
    def run(p):
        fleet, Registry, EventLog = PKG[p]
        ev = EventLog(node="0")
        report = fleet.fleet_from_texts(two_member_texts(Registry),
                                        slo={"shed_ratio": 0.5, "admit_p99_ms": 0.001},
                                        events=ev)
        sheds = [{"event": "ingest_shed", "tenant": "t-noisy"}] * 2
        return [report["slo_breaches"],
                [{k: v for k, v in e.items() if k not in ("ts_ms", "v")}
                 for e in ev.find(event="slo_breach")],
                fleet.reconcile_sheds(report["slo_breaches"], sheds),
                fleet.reconcile_sheds(report["slo_breaches"], sheds[:1]),
                fleet.evaluate_slo(report, slo=None), fleet.DEFAULT_SLO, fleet.LEASE_EVENTS]

    out = both(run)
    assert any(b["kind"] == "shed_ratio" and b["n_sheds"] == 2 for b in out[0])
    assert out[2]["ok"] and not out[3]["ok"]


def test_lease_timeline_orders_and_filters():
    records = [
        {"event": "lease_renew", "slot": 0, "fence": 1, "node": "0", "ts_ms": 30},
        {"event": "pull_merge", "node": "1", "ts_ms": 5},
        {"event": "lease_grant", "slot": 0, "fence": 1, "node": "0", "ts_ms": 10,
         "holder": "http://a"},
        {"event": "cas_fenced_reject", "slot": 0, "fence": 1, "known": 2, "node": "1",
         "ts_ms": 40, "trace": "tr-9"},
        {"event": "lease_grant", "slot": 1, "fence": 5, "node": "1", "ts_ms": 20, "step": 3},
    ]
    tl = both(lambda p: PKG[p][0].lease_timeline(records))
    assert [r["event"] for r in tl["0"]] == ["lease_grant", "lease_renew", "cas_fenced_reject"]


def test_fleet_cli_files_logs_and_coverage_gate(tmp_path, capsys):
    texts = two_member_texts(TRegistry)
    paths = []
    for name, text in texts.items():
        path = tmp_path / f"member{name}.prom"
        path.write_text(text)
        paths.append(str(path))
    log = tmp_path / "events.jsonl"
    with open(log, "w") as fh:
        for _ in range(2):
            fh.write(json.dumps({"event": "ingest_shed", "tenant": "t-noisy", "node": "0"}) + "\n")
        fh.write(json.dumps({"event": "lease_grant", "slot": 0, "fence": 3, "node": "0",
                             "ts_ms": 1}) + "\n")

    def run(p):
        out = tmp_path / f"fleet-{p}.json"
        rc = PKG[p][0].main(paths + ["--logs", str(log), "--min-coverage", "95",
                                     "--out", str(out)])
        stdout = capsys.readouterr().out
        short = two_member_texts(TRegistry, observed=3)
        (tmp_path / "m0.prom").write_text(short["0"])
        (tmp_path / "m1.prom").write_text(short["1"])
        rc2 = PKG[p][0].main([str(tmp_path / "m0.prom"), str(tmp_path / "m1.prom"),
                              "--min-coverage", "95"])
        err = capsys.readouterr().err
        rc3 = PKG[p][0].main([str(tmp_path / "missing.prom")])
        err3 = capsys.readouterr().err
        return [rc, json.loads(out.read_text()), stdout, rc2, err, rc3, err3]

    out = both(run)
    assert out[0] == 0 and out[1]["shed_reconciliation"]["ok"] and out[3] == 1 and out[5] == 2


def test_obs_cli_runs_without_jax(tmp_path):
    """``python -m crdt_tpu_torch.obs fleet`` as a process that cannot
    import JAX (a meta-path hook refuses it): exit 0 with the JAX CLI's
    report; ``assemble`` over the same node logs and fault log exits 0 in
    both packages with equal summaries and byte-equal trace and blame
    files; the usage and unknown-subcommand exits match the JAX CLI's."""
    texts = two_member_texts(TRegistry)
    paths = []
    for name, text in texts.items():
        path = tmp_path / f"m{name}.prom"
        path.write_text(text)
        paths.append(str(path))
    block = ("import sys\n"
             "class NoJax:\n"
             "    def find_spec(self, name, path=None, target=None):\n"
             "        if name.split('.')[0] in ('jax', 'jaxlib', 'crdt_tpu'):\n"
             "            raise ImportError('blocked: ' + name)\n"
             "sys.meta_path.insert(0, NoJax())\n"
             "import runpy\n"
             "sys.argv = ['x'] + sys.argv[1:]\n"
             "runpy.run_module('crdt_tpu_torch.obs', run_name='__main__')\n")
    env = dict(os.environ, JAX_PLATFORMS="cpu")

    def cli(*args, module=None):
        cmd = [sys.executable, "-c", block, *args] if module is None else \
            [sys.executable, "-m", module, *args]
        return subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, env=env,
                              timeout=120)

    out = cli("fleet", *paths, "--out", str(tmp_path / "t.json"))
    assert out.returncode == 0, out.stderr
    jout = cli("fleet", *paths, "--out", str(tmp_path / "j.json"), module="crdt_tpu.obs")
    assert jout.returncode == 0 and out.stdout == jout.stdout
    assert (tmp_path / "t.json").read_text() == (tmp_path / "j.json").read_text()
    logs = []
    for node in ("0", "1"):
        recs = [{"ts_ms": 1000 + i, "node": node, "event": ev, "v": 2, "step": i, **extra}
                for i, (ev, extra) in enumerate((
                    ("boot", {}),
                    ("op_birth", {"origin": int(node), "seq": 0}),
                    ("gossip_serve", {"trace": f"t{node}"}),
                    ("pull_merge", {"trace": f"t{1 - int(node)}", "peer": "p"}),
                    ("op_visible", {"origin": 1 - int(node), "seq_lo": 0, "seq_hi": 0,
                                    "lag_steps": 20 + int(node)}),
                    *[("op_visible", {"origin": 1 - int(node), "seq_lo": q, "seq_hi": q,
                                      "lag_steps": 1}) for q in (1, 2, 3)]))]
        log = tmp_path / f"node{node}.jsonl"
        log.write_text("".join(json.dumps(r) + "\n" for r in recs) + '{"torn')
        logs.append(str(log))
    faults = tmp_path / "faults.jsonl"
    faults.write_text(json.dumps({"step": 2, "fault": "drop", "src": "0", "dst": "1"}) + "\n")
    summaries = []
    for tag, module in (("t", None), ("j", "crdt_tpu.obs")):
        asm = cli("assemble", *logs, "--fault-log", str(faults),
                  "--out", str(tmp_path / f"{tag}-trace.json"),
                  "--blame", str(tmp_path / f"{tag}-blame.json"), module=module)
        assert asm.returncode == 0, asm.stderr
        summaries.append({k: v for k, v in json.loads(asm.stdout).items() if k != "out"})
    assert summaries[0] == summaries[1]
    assert summaries[0]["n_spikes"] == summaries[0]["n_explained"] == 2
    for name in ("trace", "blame"):
        assert (tmp_path / f"t-{name}.json").read_bytes() == \
            (tmp_path / f"j-{name}.json").read_bytes()
    assert cli().returncode == 2 and cli("--help").returncode == 0
    assert cli("nope").stdout == "unknown subcommand 'nope' (only: assemble, fleet, audit)\n"


def test_fleet_http_route_end_to_end():
    """Two live NodeHosts with the keyspace tier in each package: tenant
    writes and a forced quota shed on host a, then ``GET /fleet`` on a
    folds both members and records slo_breach in a's event log; the
    reports and the 400 equal across the packages (member URLs
    normalized)."""
    def run(p):
        net, Config = (jnet, JConfig) if p == "j" else (tnet, TConfig)
        cfg = dict(keyspace_shards=2, keyspace_capacity=64, keyspace_mesh="off",
                   keyspace_tenant_quota={"t-noisy": 2})
        kw = {} if p == "j" else {"device": "cpu"}
        a = net.NodeHost(rid=0, peers=[], config=Config(**cfg), **kw)
        b = net.NodeHost(rid=1, peers=[], config=Config(**cfg), **kw)
        a.agent.peers = [net.RemotePeer(b.url)]
        for h in (a, b):
            threading.Thread(target=h._server.serve_forever, daemon=True).start()

        def call(path, body=None, tenant=None):
            req = urllib.request.Request(a.url + path, method="GET" if body is None else "POST",
                                         data=None if body is None else json.dumps(body).encode())
            if tenant:
                req.add_header("X-CRDT-Tenant", tenant)
            try:
                with urllib.request.urlopen(req, timeout=5) as r:
                    return r.status, r.read()
            except urllib.error.HTTPError as e:
                return e.code, e.read()

        try:
            out = [call("/data", {"k1": "v1", "k2": "v2"}, "t-acme")[0],
                   call("/data", {f"k{i}": "v" for i in range(3)}, "t-noisy")]
            status, body = call("/fleet?shed_ratio=0.001")
            report = json.loads(body.decode().replace(b.url, "URL-b"))
            for row in report["tenants"].values():
                for k in ("admit_p50_ms", "admit_p99_ms"):
                    row[k] = row[k] is not None  # wall-clock latencies
            out += [status, report, call("/fleet?shed_ratio=nope"),
                    [e["tenant"] for e in a.node.events.find(event="slo_breach")]]
        finally:
            for h in (a, b):
                h._server.shutdown()
                h._server.server_close()
        return out

    out = both(run)
    assert out[1][0] == 429 and out[2] == 200 and out[3]["n_members"] == 2
    assert out[3]["tenants"]["t-acme"]["ops"] == 2 and out[4][0] == 400
    assert "t-noisy" in out[5]
