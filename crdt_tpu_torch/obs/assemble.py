"""Offline flight-recorder assembler (own copy of
``crdt_tpu.obs.assemble``): N per-node JSONL event logs (plus the fault
plane's applied-fault log) joined into ONE cluster timeline.  Host
Python over the records; the same logs give the same trace and blame
bytes in both packages.

Two artifacts come out of :func:`assemble_trace` / :func:`blame_report`:

* a Perfetto/Chrome ``trace_event`` JSON — one track per replica SLOT
  (incarnations of a rebooted node share a track), gossip rounds as
  complete spans on the puller's track linked to the serving node by flow
  events (the join key is the round's trace ID), births / visibilities /
  boots / quarantines as instant events, and the fault plane's applied
  faults overlaid as instants on a dedicated "nemesis" track (fault
  records are step-indexed and wall-time-free by design, so they are
  placed via a step→ts anchor map built from the step-stamped node
  events);
* a blame report — every convergence-lag spike (an ``op_visible`` whose
  step lag exceeds ``max(floor, multiplier × median)``) attributed to the
  partition / drop / delay / breaker-open / reboot window that explains
  it, with a consistency check: every spike is
  either covered by such a window or explicitly flagged ``unexplained``.

CLI:  python -m crdt_tpu_torch.obs assemble node0.jsonl node1.jsonl ... \\
          [--fault-log faults.jsonl] [--out trace.json] [--blame blame.json] \\
          [--min-coverage 0.95]
"""
from __future__ import annotations

import io
import json
import pathlib
import statistics
import tarfile
import time
from typing import Any, Dict, List, Optional, Tuple

from crdt_tpu_torch.obs.events import read_jsonl

# node labels are wire rids; incarnation-bumped reboots stride the rid by
# this much (crdt_tpu_torch.harness.crashsoak.RID_STRIDE), so rid % stride is
# the stable replica SLOT a track represents
RID_STRIDE = 64

# spike threshold: lag > max(SPIKE_FLOOR, SPIKE_MULTIPLIER * median lag).
# The floor keeps a quiet fleet (median ~1 step) from flagging ordinary
# random-schedule propagation as spikes; the multiplier keeps the bar
# relative once real traffic sets a baseline.
SPIKE_FLOOR = 12
SPIKE_MULTIPLIER = 4.0

# puller-side events that terminate a gossip-round span, by severity.
# The keyspace tier's rounds (ks_pull_*) are the same shape as the host
# plane's — one trace ID per round, a serve event on the far side — so
# they fold into the same span machinery.
_ROUND_EVENTS = ("pull_merge", "pull_merge_fused", "ks_pull_merge",
                 "pull_noop", "ks_pull_noop", "payload_quarantine",
                 "pull_skip", "ks_pull_skip")

# serve-side events a round's flow arrow can anchor on
_SERVE_EVENTS = ("gossip_serve", "ks_gossip_serve")

# the per-slot lease track renders these (fence epoch as a counter,
# grants/expiries/rejects as instants, handoffs as flow arrows)
_LEASE_EVENTS = ("lease_grant", "lease_renew", "lease_expire",
                 "cas_fenced_reject")

# CAS latency spikes: elapsed_ms > max(floor, multiplier * median); the
# floor keeps an idle plane (sub-ms commits) from flagging noise
CAS_SPIKE_FLOOR_MS = 50.0

# consistency_unavailable events closer than this (steps when stamped,
# else wall ms) coalesce into one burst for attribution
BURST_GAP_STEPS = 2
BURST_GAP_MS = 1000

# lease grant/expire churn within this many steps (or ms) of a strong-path
# event counts as overlapping churn for the blame rules
CHURN_WINDOW_STEPS = 2
CHURN_WINDOW_MS = 1000


def load_node_logs(paths: List[str]) -> List[Dict[str, Any]]:
    """Flat, ts-sorted record list across every per-node JSONL file.
    Each record already carries its ``node`` label, so files may hold one
    node, several, or several incarnations of one slot."""
    records: List[Dict[str, Any]] = []
    for p in paths:
        records.extend(read_jsonl(str(p)))
    records.sort(key=lambda r: (r.get("ts_ms", 0), r.get("node", "")))
    return records


def _slot(label: Any, stride: int = RID_STRIDE) -> str:
    try:
        return str(int(label) % stride)
    except (TypeError, ValueError):
        return str(label)


def _step_anchors(records: List[Dict[str, Any]]) -> List[Tuple[int, int]]:
    """Sorted (step, earliest ts_ms) pairs from step-stamped node events —
    the bridge that places wall-time-free fault records on the wall-clock
    timeline."""
    anchors: Dict[int, int] = {}
    for r in records:
        step, ts = r.get("step"), r.get("ts_ms")
        if step is None or ts is None:
            continue
        if step not in anchors or ts < anchors[step]:
            anchors[step] = ts
    return sorted(anchors.items())


def _ts_for_step(anchors: List[Tuple[int, int]], step: int) -> Optional[int]:
    """ts_ms for a fault step: the nearest anchored step at or before it
    (faults are applied DURING that step), else the first anchor after."""
    best = None
    for s, ts in anchors:
        if s <= step:
            best = ts
        elif best is None:
            return ts
        else:
            break
    return best


def assemble_trace(records: List[Dict[str, Any]],
                   fault_records: Optional[List[Dict[str, Any]]] = None,
                   stride: int = RID_STRIDE) -> Dict[str, Any]:
    """Join per-node records (+ the applied-fault log) into a Chrome/
    Perfetto ``trace_event`` JSON object (``{"traceEvents": [...]}``)."""
    events: List[Dict[str, Any]] = []
    pid = 1
    slots = sorted(
        {_slot(r.get("node", "?"), stride) for r in records},
        key=lambda s: (len(s), s),
    )
    # tid 0 is the nemesis overlay track; node slots start at 1, then one
    # track per lease slot (the strong path's per-slot timeline)
    tids = {slot: i + 1 for i, slot in enumerate(slots)}
    events.append({"ph": "M", "name": "thread_name", "pid": pid, "tid": 0,
                   "args": {"name": "nemesis (applied faults)"}})
    for slot, tid in tids.items():
        events.append({"ph": "M", "name": "thread_name", "pid": pid,
                       "tid": tid, "args": {"name": f"node slot {slot}"}})
    lease_slots = sorted(
        {str(r["slot"]) for r in records
         if r.get("event") in _LEASE_EVENTS and r.get("slot") is not None},
        key=lambda s: (len(s), s),
    )
    lease_tids = {s: len(tids) + 1 + i for i, s in enumerate(lease_slots)}
    for slot, tid in lease_tids.items():
        events.append({"ph": "M", "name": "thread_name", "pid": pid,
                       "tid": tid, "args": {"name": f"lease slot {slot}"}})

    by_trace: Dict[str, List[Dict[str, Any]]] = {}
    for r in records:
        tid_r = r.get("trace")
        if tid_r is not None:
            by_trace.setdefault(tid_r, []).append(r)

    def args_of(rec: Dict[str, Any]) -> Dict[str, Any]:
        return {k: v for k, v in rec.items()
                if k not in ("ts_ms", "node", "event", "v")}

    # gossip rounds: one complete ("X") span on the puller's track per
    # trace ID, flow-linked ("s"/"f") to the serving node's gossip_serve
    flow = 0
    spanned_ids = set()
    for trace_id, group in by_trace.items():
        group.sort(key=lambda r: r.get("ts_ms", 0))
        outcome = next(
            (r for ev in _ROUND_EVENTS for r in group if r["event"] == ev),
            None,
        )
        if outcome is None:
            continue
        spanned_ids.add(id(outcome))
        tid = tids[_slot(outcome.get("node", "?"), stride)]
        t0 = group[0].get("ts_ms", 0)
        t1 = max(r.get("ts_ms", t0) for r in group)
        events.append({
            "ph": "X", "name": outcome["event"], "pid": pid, "tid": tid,
            "ts": t0 * 1000, "dur": max((t1 - t0) * 1000, 1),
            "args": dict(args_of(outcome), trace=trace_id),
        })
        serve = next((r for r in group if r["event"] in _SERVE_EVENTS),
                     None)
        if serve is not None:
            flow += 1
            spanned_ids.add(id(serve))
            serve_tid = tids[_slot(serve.get("node", "?"), stride)]
            events.append({"ph": "s", "name": "gossip", "cat": "gossip",
                           "id": flow, "pid": pid, "tid": serve_tid,
                           "ts": serve.get("ts_ms", t0) * 1000})
            events.append({"ph": "f", "bp": "e", "name": "gossip",
                           "cat": "gossip", "id": flow, "pid": pid,
                           "tid": tid, "ts": t1 * 1000 + 1})

    # per-slot lease track: the fence epoch as a counter series (a step
    # function that must be monotone — any dip on the rendered track IS
    # a fencing bug), grants/renewals/expiries/rejects as instants, and
    # every handoff (consecutive grants of one slot by different nodes)
    # as a flow arrow between the two holders' node tracks
    last_grant: Dict[str, Dict[str, Any]] = {}
    for r in sorted((r for r in records
                     if r.get("event") in _LEASE_EVENTS
                     and r.get("slot") is not None and "ts_ms" in r),
                    key=lambda r: r.get("ts_ms", 0)):
        slot = str(r["slot"])
        tid = lease_tids[slot]
        ts = r["ts_ms"] * 1000
        fence = r.get("fence")
        # the counter tracks the slot's highest KNOWN fence: a fenced
        # reject carries the zombie's stale stamp in `fence` and the
        # rejecting node's current epoch in `known` — plotting the stale
        # one would saw-tooth a monotone quantity
        if r.get("known") is not None:
            fence = max(int(fence or 0), int(r["known"]))
        if fence is not None:
            events.append({"ph": "C", "name": f"lease fence s{slot}",
                           "pid": pid, "tid": tid, "ts": ts,
                           "args": {"fence": int(fence)}})
        events.append({"ph": "i", "s": "t", "name": r["event"],
                       "pid": pid, "tid": tid, "ts": ts,
                       "args": args_of(r)})
        if r["event"] == "lease_grant":
            prev = last_grant.get(slot)
            if prev is not None and prev.get("node") != r.get("node"):
                flow += 1
                events.append({
                    "ph": "s", "name": "lease_handoff", "cat": "lease",
                    "id": flow, "pid": pid,
                    "tid": tids[_slot(prev.get("node", "?"), stride)],
                    "ts": prev.get("ts_ms", r["ts_ms"]) * 1000})
                events.append({
                    "ph": "f", "bp": "e", "name": "lease_handoff",
                    "cat": "lease", "id": flow, "pid": pid,
                    "tid": tids[_slot(r.get("node", "?"), stride)],
                    "ts": ts + 1})
            last_grant[slot] = r

    # everything not folded into a span: instant events on the node track
    for r in records:
        if id(r) in spanned_ids or "ts_ms" not in r:
            continue
        ev = r.get("event", "?")
        if ev in _ROUND_EVENTS and r.get("trace") in by_trace:
            continue  # round outcome already drawn as its span
        events.append({
            "ph": "i", "s": "t", "name": ev, "pid": pid,
            "tid": tids[_slot(r.get("node", "?"), stride)],
            "ts": r["ts_ms"] * 1000, "args": args_of(r),
        })

    # fault overlay: step-indexed applied faults placed via the anchors
    anchors = _step_anchors(records)
    for f in fault_records or []:
        step = f.get("step")
        ts = _ts_for_step(anchors, step) if step is not None else None
        if ts is None:
            continue
        events.append({
            "ph": "i", "s": "g", "name": f.get("fault", "?"), "pid": pid,
            "tid": 0, "ts": ts * 1000,
            "args": {k: v for k, v in f.items() if k != "fault"},
        })

    events.sort(key=lambda e: (e.get("ts", 0), e.get("ph") != "M"))
    return {"traceEvents": events, "displayTimeUnit": "ms"}


# ---- blame report ----

def _visible_lag(rec: Dict[str, Any],
                 births: Dict[Tuple[Any, Any, Any], int]) -> Optional[int]:
    """Step lag of one op_visible record: the recorder's own max
    (``lag_steps``), else derived from the oldest seq in the range (the
    op that waited longest) against the op_birth records.  Births are
    keyed (origin, seq, shard-or-None): the keyspace shards reuse the
    host plane's rid + seq-from-0 space, so the shard label is the
    disambiguator that keeps a shard birth from answering for a host op
    (and vice versa)."""
    lag = rec.get("lag_steps")
    if lag is not None:
        return int(lag)
    step = rec.get("step")
    if step is None:
        return None
    born = births.get(
        (rec.get("origin"), rec.get("seq_lo"), rec.get("shard")))
    if born is None:
        return None
    return max(0, int(step) - born)


def _explain(window: Tuple[int, int], origin_slot: str, observer_slot: str,
             fault_records: List[Dict[str, Any]],
             records: List[Dict[str, Any]],
             stride: int) -> Optional[Dict[str, Any]]:
    """The first fault-plane window / degradation event overlapping
    ``window`` (the op's birth→visible step interval) that involves either
    endpoint of the propagation edge."""
    lo, hi = window
    slots = {str(origin_slot), str(observer_slot)}

    def involved(rec: Dict[str, Any]) -> bool:
        src, dst = rec.get("src"), rec.get("dst")
        node = rec.get("node")
        named = {str(x) for x in (src, dst, node) if x is not None}
        if not named:
            return True  # edge-less fault (e.g. heal-adjacent global)
        return bool(named & slots) or "*" in named

    for f in fault_records:
        step, kind = f.get("step"), f.get("fault")
        if step is None or kind in (None, "heal"):
            continue
        if lo <= step <= hi and involved(f):
            return {"kind": kind, "step": step,
                    **{k: f[k] for k in ("src", "dst", "node", "op")
                       if k in f}}
    # event-log evidence: the endpoint was down (rebooted inside the
    # window), breaker-open (backoff skip), or quarantining payloads
    for r in records:
        step, ev = r.get("step"), r.get("event")
        if step is None or not (lo <= step <= hi):
            continue
        slot = _slot(r.get("node", "?"), stride)
        if ev == "boot" and slot in slots:
            return {"kind": "reboot", "step": step, "node": slot}
        if ev == "peer_backoff_skip" and slot in slots:
            return {"kind": "breaker_open", "step": step, "node": slot}
        if ev == "pull_skip" and slot in slots \
                and r.get("reason") in ("down", "peer_unreachable"):
            return {"kind": f"pull_skip_{r['reason']}", "step": step,
                    "node": slot}
        if ev == "payload_quarantine" and slot in slots:
            return {"kind": "payload_quarantine", "step": step, "node": slot}
    return None


def _near(rec: Dict[str, Any], other: Dict[str, Any],
          steps: int, ms: int) -> bool:
    """True when two records are close enough to interact: within
    ``steps`` driver steps when both are step-stamped (the deterministic
    soak case), else within ``ms`` wall ms."""
    s0, s1 = rec.get("step"), other.get("step")
    if s0 is not None and s1 is not None:
        return abs(int(s0) - int(s1)) <= steps
    t0, t1 = rec.get("ts_ms"), other.get("ts_ms")
    if t0 is not None and t1 is not None:
        return abs(int(t0) - int(t1)) <= ms
    return False


def _explain_strong(rec: Dict[str, Any],
                    fault_records: List[Dict[str, Any]],
                    records: List[Dict[str, Any]],
                    stride: int) -> Optional[Dict[str, Any]]:
    """Attribution rules for a strong-path anomaly (CAS latency spike or
    consistency_unavailable burst), in evidence order: an applied fault
    window over the event's step, overlapping lease churn (a grant /
    expiry racing the request — handoff storms serialize CAS behind
    quorum re-grants), or an open breaker (peer_backoff_skip — the
    quorum was short a voter)."""
    step = rec.get("step")
    if step is not None:
        for f in fault_records:
            fstep, kind = f.get("step"), f.get("fault")
            if fstep is None or kind in (None, "heal"):
                continue
            if int(step) - CHURN_WINDOW_STEPS <= fstep <= int(step):
                return {"kind": kind, "step": fstep,
                        **{k: f[k] for k in ("src", "dst", "node", "op")
                           if k in f}}
    for r in records:
        ev = r.get("event")
        if ev in ("lease_grant", "lease_expire") \
                and _near(rec, r, CHURN_WINDOW_STEPS, CHURN_WINDOW_MS):
            return {"kind": "lease_churn", "event": ev,
                    "slot": r.get("slot"), "fence": r.get("fence"),
                    "node": _slot(r.get("node", "?"), stride)}
    for r in records:
        if r.get("event") == "peer_backoff_skip" \
                and _near(rec, r, CHURN_WINDOW_STEPS, CHURN_WINDOW_MS):
            return {"kind": "breaker_open",
                    "node": _slot(r.get("node", "?"), stride),
                    "peer": r.get("peer")}
    return None


def _strong_path_report(records: List[Dict[str, Any]],
                        fault_records: List[Dict[str, Any]],
                        stride: int,
                        spike_multiplier: float) -> Dict[str, Any]:
    """CAS latency spikes and consistency_unavailable bursts, each
    attributed through :func:`_explain_strong` — same contract as the
    propagation spikes: everything above threshold is listed, explained
    or flagged, and the per-section coverage is an honest rate."""
    commits = [r for r in records
               if r.get("event") == "cas_commit"
               and r.get("elapsed_ms") is not None]
    out: Dict[str, Any] = {
        "n_cas_commits": len(commits),
        "cas_spikes": [],
        "cas_coverage": 1.0,
    }
    if commits:
        median = statistics.median(float(r["elapsed_ms"]) for r in commits)
        threshold = max(CAS_SPIKE_FLOOR_MS,
                        spike_multiplier * max(median, 1.0))
        out["cas_median_ms"] = median
        out["cas_threshold_ms"] = threshold
        for r in commits:
            if float(r["elapsed_ms"]) <= threshold:
                continue
            cause = _explain_strong(r, fault_records, records, stride)
            out["cas_spikes"].append({
                "node": _slot(r.get("node", "?"), stride),
                "keys": r.get("keys"),
                "elapsed_ms": float(r["elapsed_ms"]),
                "trace": r.get("trace"),
                "cause": cause if cause is not None else "unexplained",
            })
    out["n_cas_spikes"] = len(out["cas_spikes"])
    explained = sum(1 for s in out["cas_spikes"]
                    if s["cause"] != "unexplained")
    out["cas_coverage"] = (explained / out["n_cas_spikes"]
                           if out["cas_spikes"] else 1.0)

    unavail = sorted(
        (r for r in records if r.get("event") == "consistency_unavailable"),
        key=lambda r: (r.get("ts_ms", 0), r.get("step", 0) or 0))
    bursts: List[List[Dict[str, Any]]] = []
    for r in unavail:
        if bursts and _near(bursts[-1][-1], r,
                            BURST_GAP_STEPS, BURST_GAP_MS):
            bursts[-1].append(r)
        else:
            bursts.append([r])
    out["n_unavailable"] = len(unavail)
    out["unavailable_bursts"] = []
    for burst in bursts:
        head = burst[0]
        cause = _explain_strong(head, fault_records, records, stride)
        out["unavailable_bursts"].append({
            "n": len(burst),
            "t0_ms": head.get("ts_ms"),
            "t1_ms": burst[-1].get("ts_ms"),
            "reasons": sorted({str(r.get("reason")) for r in burst}),
            "nodes": sorted({_slot(r.get("node", "?"), stride)
                             for r in burst}),
            "cause": cause if cause is not None else "unexplained",
        })
    nb = len(out["unavailable_bursts"])
    out["burst_coverage"] = (
        sum(1 for b in out["unavailable_bursts"]
            if b["cause"] != "unexplained") / nb if nb else 1.0)
    return out


def blame_report(records: List[Dict[str, Any]],
                 fault_records: Optional[List[Dict[str, Any]]] = None,
                 stride: int = RID_STRIDE,
                 spike_floor: int = SPIKE_FLOOR,
                 spike_multiplier: float = SPIKE_MULTIPLIER) -> Dict[str, Any]:
    """Attribute every convergence-lag spike to the fault window that
    explains it.  The consistency contract: ``spikes`` lists EVERY lag
    above the threshold, each either carrying a ``cause`` or flagged
    ``"cause": "unexplained"`` — nothing is silently dropped, so
    ``coverage`` (explained/total) is an honest attribution rate."""
    fault_records = fault_records or []
    births: Dict[Tuple[Any, Any, Any], int] = {}
    for r in records:
        if r.get("event") == "op_birth" and r.get("step") is not None:
            births[(r.get("origin"), r.get("seq"),
                    r.get("shard"))] = int(r["step"])

    lags: List[Tuple[int, Dict[str, Any]]] = []
    for r in records:
        if r.get("event") != "op_visible":
            continue
        lag = _visible_lag(r, births)
        if lag is not None:
            lags.append((lag, r))

    report: Dict[str, Any] = {
        "n_visible": len(lags),
        "n_faults": len([f for f in fault_records
                         if f.get("fault") != "heal"]),
        "spikes": [],
        "n_spikes": 0,
        "n_explained": 0,
        "coverage": 1.0,
    }
    # strong-path sections (CAS spikes / unavailability bursts) stand on
    # their own evidence — they report even when no op ever propagated
    report.update(_strong_path_report(records, fault_records, stride,
                                      spike_multiplier))
    if not lags:
        report["median_lag_steps"] = None
        report["threshold_steps"] = None
        return report

    median = statistics.median(l for l, _ in lags)
    threshold = max(float(spike_floor), spike_multiplier * max(median, 1.0))
    report["median_lag_steps"] = median
    report["threshold_steps"] = threshold

    for lag, r in lags:
        if lag <= threshold:
            continue
        step = r.get("step")
        window = (max(0, int(step) - lag) if step is not None else 0,
                  int(step) if step is not None else lag)
        origin_slot = _slot(r.get("origin"), stride)
        observer_slot = _slot(r.get("node", "?"), stride)
        cause = _explain(window, origin_slot, observer_slot,
                         fault_records, records, stride)
        report["spikes"].append({
            "origin": r.get("origin"),
            "observer": r.get("node"),
            "seq_lo": r.get("seq_lo"),
            "seq_hi": r.get("seq_hi"),
            "lag_steps": lag,
            "window_steps": list(window),
            "cause": cause if cause is not None else "unexplained",
        })
    report["n_spikes"] = len(report["spikes"])
    report["n_explained"] = sum(
        1 for s in report["spikes"] if s["cause"] != "unexplained"
    )
    report["coverage"] = (
        report["n_explained"] / report["n_spikes"]
        if report["n_spikes"] else 1.0
    )
    return report


# ---- postmortem bundling ----

def write_postmortem(out_path: str, node_log_paths: List[str],
                     fault_records: Optional[List[Dict[str, Any]]] = None,
                     stride: int = RID_STRIDE,
                     extra: Optional[Dict[str, Any]] = None) -> str:
    """Bundle the whole forensic record of a failed run into one tar.gz:
    every per-node JSONL log, the applied-fault log, the assembled
    Perfetto trace, and the blame report.  ``extra`` adds caller
    artifacts by archive name (str / bytes / JSON-able object — the
    nemesis soak drops its fleet SLO rollup in as ``fleet.json``).
    Returns the bundle path."""
    records = load_node_logs(node_log_paths)
    trace = assemble_trace(records, fault_records, stride=stride)
    blame = blame_report(records, fault_records, stride=stride)
    out = pathlib.Path(out_path)
    out.parent.mkdir(parents=True, exist_ok=True)
    mtime = int(time.time())

    def add_bytes(tf: tarfile.TarFile, name: str, data: bytes) -> None:
        info = tarfile.TarInfo(name)
        info.size = len(data)
        info.mtime = mtime
        tf.addfile(info, io.BytesIO(data))

    paths = [pathlib.Path(p) for p in node_log_paths
             if pathlib.Path(p).exists()]
    # harness logs often share one basename (node<i>/events.jsonl): if any
    # basename repeats, qualify EVERY arcname by its parent dir so the
    # bundle stays uniform rather than renaming only the collisions
    qualify = len({p.name for p in paths}) != len(paths)
    with tarfile.open(out, "w:gz") as tf:
        seen = set()
        for p in paths:
            arcname = f"{p.parent.name}-{p.name}" if qualify else p.name
            if arcname in seen:
                continue
            seen.add(arcname)
            tf.add(str(p), arcname=arcname)
        if fault_records is not None:
            add_bytes(tf, "faults.jsonl", "".join(
                json.dumps(f, sort_keys=True) + "\n" for f in fault_records
            ).encode())
        add_bytes(tf, "trace.json",
                  json.dumps(trace, sort_keys=True).encode())
        add_bytes(tf, "blame.json",
                  json.dumps(blame, indent=2, sort_keys=True).encode())
        for name, payload in (extra or {}).items():
            if isinstance(payload, bytes):
                data = payload
            elif isinstance(payload, str):
                data = payload.encode()
            else:
                data = json.dumps(payload, indent=2,
                                  sort_keys=True).encode()
            add_bytes(tf, name, data)
    return str(out)


# ---- CLI ----

def main(argv: Optional[List[str]] = None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        prog="python -m crdt_tpu_torch.obs assemble",
        description="assemble per-node flight-recorder logs into one "
                    "Perfetto timeline + blame report",
    )
    ap.add_argument("logs", nargs="+", help="per-node JSONL event logs")
    ap.add_argument("--fault-log", default=None,
                    help="the nemesis applied-fault JSONL")
    ap.add_argument("--out", default="trace.json",
                    help="Perfetto trace_event JSON output path")
    ap.add_argument("--blame", default=None,
                    help="blame report JSON output path")
    ap.add_argument("--stride", type=int, default=RID_STRIDE,
                    help="rid incarnation stride (node slot = rid %% stride)")
    ap.add_argument("--min-coverage", type=float, default=None,
                    help="exit 1 unless spike attribution coverage >= X")
    args = ap.parse_args(argv)

    records = load_node_logs(args.logs)
    fault_records = read_jsonl(args.fault_log) if args.fault_log else None
    trace = assemble_trace(records, fault_records, stride=args.stride)
    pathlib.Path(args.out).write_text(json.dumps(trace, sort_keys=True))
    blame = blame_report(records, fault_records, stride=args.stride)
    if args.blame:
        pathlib.Path(args.blame).write_text(
            json.dumps(blame, indent=2, sort_keys=True))
    print(json.dumps({
        "records": len(records),
        "trace_events": len(trace["traceEvents"]),
        "out": args.out,
        "n_visible": blame["n_visible"],
        "n_spikes": blame["n_spikes"],
        "n_explained": blame["n_explained"],
        "coverage": round(blame["coverage"], 4),
    }, sort_keys=True))
    if args.min_coverage is not None and blame["coverage"] < args.min_coverage:
        print(f"FAIL: blame coverage {blame['coverage']:.2%} < "
              f"{args.min_coverage:.2%} "
              f"({blame['n_spikes'] - blame['n_explained']} unexplained "
              "spikes)")
        return 1
    return 0
