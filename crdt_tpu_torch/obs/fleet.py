"""Fleet SLO rollup: scrape every member, fold to ONE summary (own copy of
``crdt_tpu.obs.fleet``).

``python -m crdt_tpu_torch.obs fleet <url-or-file ...>`` (and the nodes' own
``GET /fleet`` route) collapses N Prometheus expositions into a single
machine-readable view:

* **per-tenant SLO row** — admitted ops, admit p50/p99 (the
  ``ks_admit_latency{tenant=}`` histogram the keyspace lanes record at
  drain), propagation p50/p99 in steps AND seconds (the tenant-labeled
  ``op_propagation*`` series the shard flight recorders derive), shed
  ratio vs the tenant's quota slice;
* **per-shard balance** — op-log rows / keys / pending depth per shard
  per node, plus the fleet imbalance ratio (hottest shard over mean);
* **per-slot lease state** — holder, highest fence, and any node still
  in the expired-unhandedoff zombie window.

Everything folds the same way the registry itself merges: counters add,
gauges concatenate per node, histograms ``Histogram.merge`` — so the
rollup is exact, not an estimate over estimates.  The input is the text
exposition (scraped over HTTP or rendered in-process), parsed back
through the ``# TYPE`` lines; one code path serves the CLI, the tests,
and the ``/fleet`` route.

Threshold crossings are first-class: ``evaluate_slo`` emits one
``slo_breach`` event per (tenant, metric) crossing, carrying the
measured value, the threshold, and — for quota sheds — the shed-event
count, so a soak can reconcile SLO accounting 1:1 against the
``ingest_shed`` provenance records (``reconcile_sheds``).
"""
from __future__ import annotations

import argparse
import json
import math
import re
import sys
import urllib.request
from typing import Any, Dict, List, Optional, Sequence, Tuple

from crdt_tpu_torch.obs.registry import LOG2_LO, N_BUCKETS, Histogram

# sample line: name{labels} value   (timestamps are never emitted here)
_SAMPLE = re.compile(
    r"^([a-zA-Z_:][a-zA-Z0-9_:]*)(\{[^}]*\})?\s+(\S+)\s*$")
_LABEL = re.compile(r'([a-zA-Z0-9_]+)="((?:[^"\\]|\\.)*)"')

# default SLO thresholds: generous enough that a healthy soak is green,
# tight enough that a forced fault trips them (the soak overrides these)
DEFAULT_SLO = {
    "admit_p99_ms": 1000.0,   # keyspace admit latency, per tenant
    "prop_p99_steps": 256.0,  # propagation lag in soak steps
    "shed_ratio": 0.01,       # shed ops / offered ops, per tenant
}

# events that make up a slot's lease timeline (obs/assemble renders the
# same set as the per-slot track)
LEASE_EVENTS = ("lease_grant", "lease_renew", "lease_expire",
                "cas_fenced_reject")


def _unescape(s: str) -> str:
    out: List[str] = []
    i = 0
    while i < len(s):
        c = s[i]
        if c == "\\" and i + 1 < len(s):
            n = s[i + 1]
            out.append("\n" if n == "n" else n)
            i += 2
        else:
            out.append(c)
            i += 1
    return "".join(out)


def _label_key(labels: Dict[str, str]) -> Tuple[Tuple[str, str], ...]:
    return tuple(sorted(labels.items()))


class Snapshot:
    """One member's parsed exposition: counters / gauges / histograms
    keyed ``(name, sorted-label-tuple)`` with registry-internal names
    (namespace prefix and ``_total`` / ``_seconds`` unit suffixes
    stripped, so ``snap`` reads like the registry that produced it)."""

    def __init__(self):
        self.counters: Dict[Tuple[str, tuple], float] = {}
        self.gauges: Dict[Tuple[str, tuple], float] = {}
        self.hists: Dict[Tuple[str, tuple], Histogram] = {}

    def _named(self, table, name):
        return [(dict(k[1]), v) for k, v in table.items() if k[0] == name]

    def counters_named(self, name: str) -> List[Tuple[Dict[str, str], float]]:
        return self._named(self.counters, name)

    def gauges_named(self, name: str) -> List[Tuple[Dict[str, str], float]]:
        return self._named(self.gauges, name)

    def hists_named(self, name: str) -> List[Tuple[Dict[str, str], Histogram]]:
        return [(dict(k[1]), h) for k, h in self.hists.items()
                if k[0] == name]


def _bucket_slot(le: str) -> int:
    if le == "+Inf":
        return N_BUCKETS - 1
    return min(max(int(round(math.log2(float(le)))) - LOG2_LO, 0),
               N_BUCKETS - 2)


def parse_prometheus(text: str, namespace: str = "crdt") -> Snapshot:
    """Parse a registry's text exposition back into a :class:`Snapshot`.

    Kinds come from the ``# TYPE`` lines (the renderer always emits
    them); histogram series are rebuilt from the cumulative ``_bucket``
    lines by de-cumulating in ``le`` order — exact, because the
    registry's buckets ARE the exposition's buckets."""
    ns = namespace + "_"
    kinds: Dict[str, str] = {}
    snap = Snapshot()
    # (base-full-name, labelkey-without-le) -> {"cum": [(slot, cum)...]}
    raw_h: Dict[Tuple[str, tuple], Dict[str, Any]] = {}
    for line in text.splitlines():
        line = line.strip()
        if not line:
            continue
        if line.startswith("#"):
            parts = line.split()
            if len(parts) >= 4 and parts[1] == "TYPE":
                kinds[parts[2]] = parts[3]
            continue
        m = _SAMPLE.match(line)
        if not m:
            continue
        full, lblstr, val = m.groups()
        labels = {k: _unescape(v) for k, v in _LABEL.findall(lblstr or "")}
        try:
            value = float(val)
        except ValueError:
            continue
        kind = kinds.get(full)
        if kind == "counter":
            name = full[len(ns):] if full.startswith(ns) else full
            if name.endswith("_total"):
                name = name[:-len("_total")]
            snap.counters[(name, _label_key(labels))] = value
        elif kind == "gauge":
            name = full[len(ns):] if full.startswith(ns) else full
            snap.gauges[(name, _label_key(labels))] = value
        else:
            # histogram part: TYPE names the base; samples append
            # _bucket/_sum/_count
            for suffix in ("_bucket", "_sum", "_count"):
                if full.endswith(suffix):
                    base = full[:-len(suffix)]
                    if kinds.get(base) != "histogram":
                        continue
                    lb = dict(labels)
                    le = lb.pop("le", None)
                    rec = raw_h.setdefault((base, _label_key(lb)), {
                        "cum": [], "sum": 0.0, "count": 0})
                    if suffix == "_bucket" and le is not None:
                        rec["cum"].append((_bucket_slot(le), value))
                    elif suffix == "_sum":
                        rec["sum"] = value
                    else:
                        rec["count"] = int(value)
                    break
    for (base, lkey), rec in raw_h.items():
        name = base[len(ns):] if base.startswith(ns) else base
        if name.endswith("_seconds"):
            name = name[:-len("_seconds")]
        h = Histogram()
        prev = 0.0
        for slot, cum in sorted(rec["cum"]):
            h.buckets[slot] = int(cum - prev)
            prev = cum
        h.sum = rec["sum"]
        h.count = rec["count"]
        snap.hists[(name, lkey)] = h
    return snap


def _q_ms(h: Optional[Histogram], q: float) -> Optional[float]:
    if h is None or h.count == 0:
        return None
    v = h.quantile(q)
    return None if math.isnan(v) else round(v * 1e3, 3)


def _q(h: Optional[Histogram], q: float) -> Optional[float]:
    if h is None or h.count == 0:
        return None
    v = h.quantile(q)
    return None if math.isnan(v) else round(v, 6)


def fleet_summary(members: Dict[str, Snapshot]) -> Dict[str, Any]:
    """Fold member snapshots into the fleet view (see module doc).

    ``members`` maps a display name (node label or URL) to its parsed
    snapshot.  Counters add across members, per-tenant histograms
    ``Histogram.merge``; propagation coverage compares the tenant's
    observed step-lag count against ``ops x (n_members - 1)`` — the
    exactly-once bound every admitted op owes the flight recorders."""
    tenants: Dict[str, Dict[str, Any]] = {}

    def trow(name: str) -> Dict[str, Any]:
        return tenants.setdefault(name, {
            "ops": 0, "sheds": 0, "shed_ops": 0, "depth": 0.0,
            "quota": None, "_admit": None, "_steps": None, "_secs": None,
        })

    hist_sinks = {"ks_admit_latency": "_admit",
                  "op_propagation_steps": "_steps",
                  "op_propagation": "_secs"}
    for snap in members.values():
        for labels, v in snap.counters_named("keyspace_tenant_ops"):
            trow(labels["tenant"])["ops"] += int(v)
        for labels, v in snap.counters_named("ingest_shed"):
            if labels.get("tenant"):
                trow(labels["tenant"])["sheds"] += int(v)
        for labels, v in snap.counters_named("ingest_shed_ops"):
            if labels.get("tenant"):
                trow(labels["tenant"])["shed_ops"] += int(v)
        for labels, v in snap.gauges_named("keyspace_tenant_depth"):
            trow(labels["tenant"])["depth"] += v
        for labels, v in snap.gauges_named("keyspace_tenant_quota"):
            row = trow(labels["tenant"])
            row["quota"] = v if row["quota"] is None \
                else max(row["quota"], v)
        for name, sink in hist_sinks.items():
            for labels, h in snap.hists_named(name):
                if not labels.get("tenant"):
                    continue
                row = trow(labels["tenant"])
                row[sink] = h if row[sink] is None else row[sink].merge(h)

    n = len(members)
    for tenant, row in tenants.items():
        admit, steps, secs = row.pop("_admit"), row.pop("_steps"), \
            row.pop("_secs")
        row["admit_p50_ms"] = _q_ms(admit, 0.5)
        row["admit_p99_ms"] = _q_ms(admit, 0.99)
        row["prop_p50_steps"] = _q(steps, 0.5)
        row["prop_p99_steps"] = _q(steps, 0.99)
        row["prop_p50_s"] = _q(secs, 0.5)
        row["prop_p99_s"] = _q(secs, 0.99)
        offered = row["ops"] + row["shed_ops"]
        row["shed_ratio"] = round(row["shed_ops"] / offered, 6) \
            if offered else 0.0
        expected = row["ops"] * max(n - 1, 0)
        observed = steps.count if steps is not None else \
            (secs.count if secs is not None else 0)
        row["prop_expected"] = expected
        row["prop_observed"] = observed
        row["prop_coverage"] = round(observed / expected, 4) \
            if expected else None

    shards: Dict[str, Dict[str, Any]] = {}
    for member, snap in members.items():
        for gname, field in (("keyspace_shard_ops", "ops"),
                             ("keyspace_shard_keys", "keys"),
                             ("keyspace_shard_depth", "depth")):
            for labels, v in snap.gauges_named(gname):
                node = labels.get("node", member)
                srow = shards.setdefault(labels["shard"], {"nodes": {}})
                srow["nodes"].setdefault(node, {})[field] = v
    balance = None
    if shards:
        per_shard = [sum(nd.get("ops", 0.0) for nd in s["nodes"].values())
                     for s in shards.values()]
        mean = sum(per_shard) / len(per_shard)
        balance = round(max(per_shard) / mean, 4) if mean else None
        for srow, total in zip(shards.values(), per_shard):
            srow["ops_total"] = total

    # divergence-audit rollup (crdt_tpu_torch.obs.audit): per-plane agreement
    # as seen by every member's watchdog, plus the fleet-total divergence
    # and scrub-drift counts.  ``state`` is the worst member state (0 no
    # data / 1 ok / 2 divergence latched) — the one-number fleet verdict.
    audit: Dict[str, Any] = {"states": {}, "planes": {},
                             "divergences": 0, "scrub_drifts": 0}
    for member, snap in members.items():
        for labels, v in snap.gauges_named("audit_state"):
            audit["states"][member] = max(
                int(v), audit["states"].get(member, 0))
        for labels, v in snap.gauges_named("audit_agreement"):
            plane = labels.get("plane", "host")
            prow = audit["planes"].setdefault(
                plane, {"agree": [], "disagree": []})
            prow["agree" if v >= 1.0 else "disagree"].append(member)
        for _, v in snap.counters_named("audit_divergences"):
            audit["divergences"] += int(v)
        for _, v in snap.counters_named("audit_scrub_drifts"):
            audit["scrub_drifts"] += int(v)
    audit["state"] = max(audit["states"].values(), default=0)
    audit["planes"] = {p: audit["planes"][p]
                       for p in sorted(audit["planes"])}

    slots: Dict[str, Dict[str, Any]] = {}
    for member, snap in members.items():
        states = {tuple(sorted(l.items())): v
                  for l, v in snap.gauges_named("lease_state")}
        for labels, fence in snap.gauges_named("lease_fence_epoch"):
            node = labels.get("node", member)
            slot = labels["slot"]
            srow = slots.setdefault(slot, {
                "holder": None, "fence": 0, "expired": []})
            srow["fence"] = max(srow["fence"], int(fence))
            state = states.get(tuple(sorted(labels.items())))
            if state == 1:
                srow["holder"] = node
            elif state == 2:
                srow["expired"].append(node)

    return {
        "n_members": n,
        "members": sorted(members),
        "tenants": {t: tenants[t] for t in sorted(tenants)},
        "shards": {s: shards[s] for s in sorted(shards, key=int)},
        "shard_balance": balance,
        "slots": {s: slots[s] for s in sorted(slots, key=int)},
        "audit": audit,
    }


def evaluate_slo(summary: Dict[str, Any],
                 slo: Optional[Dict[str, float]] = None,
                 events=None) -> List[Dict[str, Any]]:
    """Check every tenant row against the SLO thresholds; return the
    breaches and (when ``events`` is an EventLog) record each as a
    first-class ``slo_breach`` event.  A quota-shed breach carries the
    fleet shed-event count (``n_sheds``) so the soak's reconciliation
    can hold it against the ``ingest_shed`` provenance 1:1."""
    cfg = dict(DEFAULT_SLO)
    if slo:
        cfg.update({k: v for k, v in slo.items() if v is not None})
    breaches: List[Dict[str, Any]] = []
    for tenant, row in summary.get("tenants", {}).items():
        checks = [
            ("admit_p99", row.get("admit_p99_ms"), cfg["admit_p99_ms"]),
            ("propagation_p99", row.get("prop_p99_steps"),
             cfg["prop_p99_steps"]),
            ("shed_ratio", row.get("shed_ratio"), cfg["shed_ratio"]),
        ]
        for kind, value, threshold in checks:
            if value is None or threshold is None or value <= threshold:
                continue
            b = {"kind": kind, "tenant": tenant, "value": value,
                 "threshold": threshold}
            if kind == "shed_ratio":
                b["n_sheds"] = row.get("sheds", 0)
                b["shed_ops"] = row.get("shed_ops", 0)
                if row.get("quota") is not None:
                    b["quota"] = row["quota"]
            breaches.append(b)
            if events is not None:
                events.emit("slo_breach", **b)
    return breaches


def reconcile_sheds(breaches: Sequence[Dict[str, Any]],
                    records: Sequence[Dict[str, Any]]) -> Dict[str, Any]:
    """Hold the ``slo_breach`` shed accounting against the ``ingest_shed``
    provenance: for every tenant either side names, the breach's
    ``n_sheds`` must equal the count of that tenant's ``ingest_shed``
    events across the fleet's logs (each shed incremented the counter
    once AND emitted one event — same source, two sinks, so any drift
    is a lost record).  Returns ``{tenant: {slo, provenance, ok}}``
    plus ``{"ok": all-match}``."""
    by_tenant: Dict[str, int] = {}
    for b in breaches:
        if b.get("kind") == "shed_ratio" and b.get("tenant"):
            by_tenant[b["tenant"]] = int(b.get("n_sheds", 0))
    seen: Dict[str, int] = {}
    for e in records:
        if e.get("event") == "ingest_shed" and e.get("tenant"):
            seen[e["tenant"]] = seen.get(e["tenant"], 0) + 1
    out: Dict[str, Any] = {"tenants": {}, "ok": True}
    for tenant in sorted(set(by_tenant) | set(seen)):
        a, b = by_tenant.get(tenant, 0), seen.get(tenant, 0)
        ok = a == b
        out["tenants"][tenant] = {"slo": a, "provenance": b, "ok": ok}
        out["ok"] = out["ok"] and ok
    return out


def lease_timeline(records: Sequence[Dict[str, Any]]) -> Dict[str, list]:
    """Per-slot lease timeline from merged event logs: every grant /
    renew / expire / fenced-reject in time order, with node, fence, and
    trace — the raw material of the assembler's per-slot track and the
    fleet report's ``slots[*].timeline``."""
    slots: Dict[str, list] = {}
    for e in sorted(records, key=lambda e: (e.get("ts_ms", 0),
                                            e.get("step", 0) or 0)):
        if e.get("event") not in LEASE_EVENTS or "slot" not in e:
            continue
        row = {"event": e["event"], "node": e.get("node"),
               "fence": e.get("fence"), "ts_ms": e.get("ts_ms")}
        for opt in ("step", "trace", "holder", "known"):
            if e.get(opt) is not None:
                row[opt] = e[opt]
        slots.setdefault(str(e["slot"]), []).append(row)
    return slots


def fleet_from_texts(texts: Dict[str, str],
                     slo: Optional[Dict[str, float]] = None,
                     events=None) -> Dict[str, Any]:
    """Parse one exposition per member and build the full fleet report
    (summary + SLO breaches).  The ``GET /fleet`` route and the CLI both
    land here; ``events`` receives the ``slo_breach`` records."""
    members = {name: parse_prometheus(text)
               for name, text in texts.items()}
    summary = fleet_summary(members)
    summary["slo_breaches"] = evaluate_slo(summary, slo=slo, events=events)
    return summary


def _fetch(target: str, timeout: float = 5.0) -> str:
    if target.startswith(("http://", "https://")):
        url = target if target.endswith("/metrics") \
            else target.rstrip("/") + "/metrics"
        with urllib.request.urlopen(url, timeout=timeout) as resp:
            return resp.read().decode("utf-8", "replace")
    with open(target, "r", encoding="utf-8") as fh:
        return fh.read()


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m crdt_tpu_torch.obs fleet",
        description="Scrape every member (URL or saved exposition file) "
                    "and print one fleet SLO rollup as JSON.")
    ap.add_argument("targets", nargs="+",
                    help="member base URLs (…/metrics is appended) or "
                         "paths to saved Prometheus text files")
    ap.add_argument("--logs", nargs="*", default=[],
                    help="node JSONL event logs: adds per-slot lease "
                         "timelines and the shed reconciliation")
    ap.add_argument("--slo-admit-p99-ms", type=float, default=None)
    ap.add_argument("--slo-prop-p99-steps", type=float, default=None)
    ap.add_argument("--slo-shed-ratio", type=float, default=None)
    ap.add_argument("--min-coverage", type=float, default=None,
                    help="fail unless every tenant's propagation "
                         "coverage reaches this (0.95 or 95 both mean "
                         "95%%)")
    ap.add_argument("--out", default=None, help="also write the report "
                                                "to this JSON file")
    ap.add_argument("--timeout", type=float, default=5.0)
    args = ap.parse_args(argv)

    texts: Dict[str, str] = {}
    for t in args.targets:
        try:
            texts[t] = _fetch(t, timeout=args.timeout)
        except Exception as exc:  # a dead member is a finding, not a crash
            print(f"fleet: scrape failed for {t}: {exc}", file=sys.stderr)
    if not texts:
        print("fleet: no member reachable", file=sys.stderr)
        return 2

    slo = {"admit_p99_ms": args.slo_admit_p99_ms,
           "prop_p99_steps": args.slo_prop_p99_steps,
           "shed_ratio": args.slo_shed_ratio}
    report = fleet_from_texts(texts, slo=slo)

    if args.logs:
        from crdt_tpu_torch.obs.events import read_jsonl

        records: List[Dict[str, Any]] = []
        for path in args.logs:
            records.extend(read_jsonl(path))
        report["lease_timelines"] = lease_timeline(records)
        report["shed_reconciliation"] = reconcile_sheds(
            report["slo_breaches"], records)

    body = json.dumps(report, indent=2, sort_keys=True)
    print(body)
    if args.out:
        with open(args.out, "w", encoding="utf-8") as fh:
            fh.write(body + "\n")

    rc = 0
    if args.min_coverage is not None:
        floor = args.min_coverage / 100.0 if args.min_coverage > 1 \
            else args.min_coverage
        for tenant, row in report["tenants"].items():
            cov = row.get("prop_coverage")
            if cov is not None and cov < floor:
                print(f"fleet: tenant {tenant!r} propagation coverage "
                      f"{cov:.2%} < floor {floor:.2%}", file=sys.stderr)
                rc = 1
    if report.get("shed_reconciliation", {}).get("ok") is False:
        print("fleet: slo_breach shed accounting does not reconcile "
              "with ingest_shed provenance", file=sys.stderr)
        rc = 1
    return rc


if __name__ == "__main__":
    sys.exit(main())
