"""Live divergence audit plane: frontier-anchored digests and the
watchdog (own copy of the host half of ``crdt_tpu.obs.audit``).

A replica that silently diverges (bit-rot, a merge-path bug) is
invisible until the next offline soak.  This module watches for it
online:

* :class:`PlaneDigest`: an incremental, order-independent 128-bit digest
  of one replication plane's canonical ``(key, winner-ts, rid, seq)``
  rows (:mod:`crdt_tpu_torch.ops.digest`), maintained O(delta) per merge
  by add/subtract-on-supersede and *clamped to a compaction/stability
  frontier* on demand: below a gossiped frontier all correct replicas
  hold bit-identical state by construction, so ``digest_at(F)`` is
  comparable across replicas regardless of in-flight ops.  The digest is
  host Python over the node's host stores (``_summary`` and
  ``_commands``); it never reads the card.

* :class:`AuditWatchdog`: consumes the digests that piggyback on every
  ``/gossip`` response's stability header (zero extra round trips),
  compares each against the locally recomputed digest at the SAME
  frontier, and raises a ``divergence_detected`` event, which latches the
  ``crdt_audit_state`` gauge at 2 and writes a
  ``postmortem-<seed>.tar.gz`` bundle through
  :func:`crdt_tpu_torch.obs.assemble.write_postmortem` (the node's event
  logs, the assembled trace, the blame report and the two digest
  witnesses).  Its ``evaluate()`` tick also runs the continuous
  evaluators: store scrub (recompute the digest FROM the store so silent
  bit-rot enters the served digest), frontier stall and convergence-lag
  EWMA breach.

Not ported: the device-mesh digest fold (ROADMAP Queue 1 item 6).

False-positive immunity comes from the frontier clamp, not from luck:
``digest_at(F)`` is computed only when this node's own compaction
frontier <= F <= its version vector (pointwise), and in that window the
below-F winner set is immutable — duplicate or reordered deliveries
cannot move it, so two correct replicas NEVER disagree at a shared
frontier.

``plant_divergence`` is the fault-plane hook: it silently flips one
committed row's winner timestamp post-merge, the corruption class the
digest exists to catch, without telling the digest, so only the scrub
and the peer comparison can find it.

    python -m crdt_tpu_torch.obs.audit http://127.0.0.1:8080 http://127.0.0.1:8081

folds every member's ``GET /audit`` report into one fleet verdict.
"""
from __future__ import annotations

import json
import threading
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from crdt_tpu_torch.ops import digest as digops

# crdt_audit_state gauge values
AUDIT_NO_DATA = 0   # no peer digest compared yet
AUDIT_OK = 1        # comparisons happened, all agreed so far
AUDIT_DIVERGED = 2  # latched on the first divergence_detected

# per-plane frontier-keyed digest records retained for cross-peer
# comparison (older frontiers age out — they were compared when live)
_SEEN_FRONTIERS_MAX = 8
# clamped-digest memo entries per plane (invalidated on every resync)
_CLAMP_CACHE_MAX = 8


def _fkey(frontier: Dict[int, int]) -> Tuple[Tuple[int, int], ...]:
    return tuple(sorted((int(r), int(s)) for r, s in frontier.items()))


class PlaneDigest:
    """One replication plane's incremental winner-row digest.

    Owned by a :class:`~crdt_tpu_torch.api.node.ReplicaNode` and mutated ONLY
    under that node's lock (the observe/resync hooks all sit inside
    ``_locked`` methods), so it carries no lock of its own.  State:

    * ``winner[key]`` — the current LWW winner ident ``(ts_abs, rid,
      seq)`` (absolute-ms timestamps: relative ts are node-epoch-local
      and would make digests incomparable across replicas);
    * ``acc`` — 4 uint32 lanes: the running sum of every winner row's
      hash (the *unclamped* digest);
    * ``rows[key]`` — every candidate ident observed for the key, so the
      frontier clamp can re-derive the winner *at* F when the live
      winner is above F.  Rebuilt (and thereby pruned) on every resync.

    Enablement is ``registry.enabled`` AND an explicit ``enable_audit()``:
    a bare node pays one ``is not None`` check on the ingest hot path.
    """

    def __init__(self, node, plane: str = "host"):
        self.node = node
        self.plane = plane
        # lanes live as 4-int tuples on the host hot path (the pure-int
        # row-hash mirror in ops.digest) and re-enter numpy only at
        # dig_column / digest_hex
        self.acc: Tuple[int, int, int, int] = digops.ZERO_INTS
        self.winner: Dict[str, Tuple[int, int, int]] = {}
        self.rows: Dict[str, set] = {}
        self._klanes: Dict[str, Tuple[int, int, int, int]] = {}
        # clamped-digest memo: frontier key -> lanes.  A clamped digest
        # is invariant under new observes (a fresh op is never <= an
        # already-satisfied frontier — _accept_locked drops folded rows)
        # so only resync() invalidates.
        self._clamp_cache: Dict[Tuple[Tuple[int, int], ...],
                                Tuple[int, int, int, int]] = {}

    @property
    def enabled(self) -> bool:
        return self.node.metrics.registry.enabled

    # ---- incremental maintenance (node lock held) ----

    def _kl(self, key: str) -> Tuple[int, int, int, int]:
        kl = self._klanes.get(key)
        if kl is None:
            kl = self._klanes[key] = digops.key_lanes_ints(key)
        return kl

    def row(self, key: str, ts_abs: int, rid: int, seq: int
            ) -> Tuple[int, int, int, int]:
        return digops.row_lanes_ints(self._kl(key), ts_abs, rid, seq)

    def observe(self, key: str, ts_abs: int, rid: int, seq: int) -> None:
        """One accepted (key, ident) row: track the candidate and, on
        supersede, subtract the old winner / add the new — O(1)."""
        ident = (ts_abs, rid, seq)
        cands = self.rows.get(key)
        if cands is None:
            cands = self.rows[key] = set()
        if ident in cands:
            return
        cands.add(ident)
        old = self.winner.get(key)
        if old is None:
            self.winner[key] = ident
            self.acc = digops.add_lanes_ints(self.acc,
                                             self.row(key, *ident))
        elif ident > old:
            self.winner[key] = ident
            self.acc = digops.add_lanes_ints(
                digops.sub_lanes_ints(self.acc, self.row(key, *old)),
                self.row(key, *ident))

    def observe_rows(self, rows: Sequence[Tuple[int, int, int, Dict]],
                     epoch: int) -> None:
        """Ingest-path hook: ``rows`` are accepted ``(ts_rel, rid, seq,
        cmd)`` tuples; ``epoch`` rebases onto absolute ms."""
        for ts, rid, seq, cmd in rows:
            ts_abs = ts + epoch
            for key in cmd:
                self.observe(key, ts_abs, rid, seq)

    def dig_column(self, rows: Sequence[Tuple[int, int, int, Dict]],
                   epoch: int) -> np.ndarray:
        """Per-(key, ident) row-hash lanes of a packed ingest batch, an
        ``(n, 4)`` uint32 column (order does not matter: only the lane SUM
        is compared, and addition commutes)."""
        out: List[np.ndarray] = []
        for ts, rid, seq, cmd in rows:
            ts_abs = ts + epoch
            for key in cmd:
                out.append(self.row(key, ts_abs, rid, seq))
        if not out:
            return np.zeros((0, digops.LANES), np.uint32)
        return np.array(out, dtype=np.uint32)

    # ---- full recompute (folds / adoption / restore / scrub) ----

    def compute_from_store(self):
        """From-scratch (winner, rows, acc) off the node's OWN stores
        (``_summary`` and ``_commands``): the ground truth the scrub holds
        the incremental accumulator against."""
        node = self.node
        epoch = node.clock.epoch_ms
        winner: Dict[str, Tuple[int, int, int]] = {}
        rows: Dict[str, set] = {}
        for key, e in node._summary.items():
            ident = (int(e["ts"]), int(e["rid"]), int(e["seq"]))
            rows.setdefault(key, set()).add(ident)
            if winner.get(key) is None or ident > winner[key]:
                winner[key] = ident
        for (ts, rid, seq), cmd in node._commands.items():
            ident = (ts + epoch, rid, seq)
            for key in cmd:
                rows.setdefault(key, set()).add(ident)
                old = winner.get(key)
                if old is None or ident > old:
                    winner[key] = ident
        acc = digops.ZERO_INTS
        for key, ident in winner.items():
            acc = digops.add_lanes_ints(acc, self.row(key, *ident))
        return winner, rows, acc

    def resync(self) -> None:
        """Rebuild from the store (compact/adopt/restore paths: the fold
        rewrote the store wholesale, so the O(state) recompute happens
        exactly where an O(state) store rewrite already did)."""
        self.winner, self.rows, self.acc = self.compute_from_store()
        self._clamp_cache.clear()

    def scrub(self) -> bool:
        """Recompute from the store and ADOPT the result; True when the
        incremental accumulator disagreed — i.e. the store changed
        underneath the digest (silent bit-rot / an unhooked mutation).
        Adopting is the point: the corruption must enter the *served*
        digest so peers at the same frontier can see it."""
        before = self.acc
        self.resync()
        return before != self.acc

    # ---- frontier clamp ----

    def digest_at(self, frontier: Dict[int, int]
                  ) -> Tuple[int, int, int, int]:
        """The digest of state at-or-under ``frontier``: start from the
        live accumulator and, for each key whose winner is above F,
        substitute the best candidate <= F (or nothing).  rid<0
        (foreign/Go-format) rows carry no watermark and count as above
        every frontier.  Caller guarantees comparability (own compaction
        frontier <= F <= own vv, ``ReplicaNode.audit_digest_at``)."""
        key = _fkey(frontier)
        memo = self._clamp_cache.get(key)
        if memo is not None:
            return memo
        acc = self.acc
        for k, w in self.winner.items():
            if w[1] >= 0 and w[2] <= frontier.get(w[1], -1):
                continue  # winner itself is under F: acc term already right
            acc = digops.sub_lanes_ints(acc, self.row(k, *w))
            best = None
            for c in self.rows.get(k, ()):
                if c[1] >= 0 and c[2] <= frontier.get(c[1], -1):
                    if best is None or c > best:
                        best = c
            if best is not None:
                acc = digops.add_lanes_ints(acc, self.row(k, *best))
        if len(self._clamp_cache) >= _CLAMP_CACHE_MAX:
            self._clamp_cache.pop(next(iter(self._clamp_cache)))
        self._clamp_cache[key] = acc
        return acc

    def digest_hex_at(self, frontier: Dict[int, int]) -> str:
        return digops.digest_hex(self.digest_at(frontier))


class AuditWatchdog:
    """Per-node anomaly watchdog over the piggybacked digest stream.

    Fed by the NetworkAgent: ``note_host`` / ``note_shard`` on every
    gossip response carrying a stability summary (the digest rides the
    same header or body: no new round trips), ``evaluate()`` once per
    pull round.  All public entry points are thread-safe; node-state
    reads go through the node's own locked accessors.
    """

    def __init__(self, node, *, keyspace=None, stability=None,
                 ks_trackers: Optional[List] = None, leases=None,
                 scrub_every: int = 16, stall_rounds: int = 3,
                 lag_threshold: float = 512.0):
        self.node = node
        self.keyspace = keyspace
        self.stability = stability
        self.ks_trackers = ks_trackers
        self.leases = leases
        self.scrub_every = max(int(scrub_every), 0)
        self.stall_rounds = max(int(stall_rounds), 1)
        self.lag_threshold = float(lag_threshold)
        self.registry = node.metrics.registry
        self.events = node.events
        self._lock = threading.Lock()
        # (plane, fkey) -> {source: digest_hex}; insertion-ordered so old
        # frontiers age out
        self._seen: Dict[Tuple[str, tuple], Dict[str, str]] = {}
        self._flagged: set = set()
        self.divergences: List[Dict[str, Any]] = []
        self.state = AUDIT_NO_DATA
        self.evals = 0
        self.scrub_drifts: List[Dict[str, Any]] = []
        self._stall_streak = 0
        self._stalled = False
        self._lag_breached = False
        self._zombie = False
        # auto-postmortem wiring (NodeHost / the soak driver configures)
        self._pm_dir: Optional[str] = None
        self._pm_seed: Optional[int] = None
        self._pm_logs: List[str] = []
        self._pm_fleet: Optional[Callable[[], str]] = None
        self.postmortem_path: Optional[str] = None
        self.registry.set_gauge("audit_state", self.state)

    # ---- plane enumeration (reshard-safe: resolved per call) ----

    def planes(self) -> List[Tuple[str, Any]]:
        out: List[Tuple[str, Any]] = [("host", self.node)]
        if self.keyspace is not None:
            out.extend((f"ks-{i}", s)
                       for i, s in enumerate(self.keyspace.shards))
        return out

    def _plane_node(self, plane: str):
        if plane == "host":
            return self.node
        if self.keyspace is not None and plane.startswith("ks-"):
            i = int(plane[3:])
            if 0 <= i < len(self.keyspace.shards):
                return self.keyspace.shards[i]
        return None

    # ---- digest intake (the piggyback consumer) ----

    def note_host(self, peer: str, frontier: Dict[int, int],
                  digest_hex: Optional[str]) -> None:
        self._note("host", peer, frontier, digest_hex)

    def note_shard(self, peer: str, shard: int, frontier: Dict[int, int],
                   digest_hex: Optional[str]) -> None:
        self._note(f"ks-{int(shard)}", peer, frontier, digest_hex)

    def _note(self, plane: str, peer: str, frontier: Dict[int, int],
              digest_hex: Optional[str]) -> None:
        if digops.parse_digest_hex(digest_hex) is None:
            return  # absent or garbled (faulted transport): no digest
        frontier = {int(r): int(s) for r, s in frontier.items()}
        fk = _fkey(frontier)
        if not fk:
            return  # empty frontier: every clamp is vacuously zero
        node = self._plane_node(plane)
        local = node.audit_digest_at(frontier) if node is not None else None
        with self._lock:
            rec = self._seen.get((plane, fk))
            if rec is None:
                rec = self._seen[(plane, fk)] = {}
                # age out old frontier records for this plane
                mine = [k for k in self._seen if k[0] == plane]
                while len(mine) > _SEEN_FRONTIERS_MAX:
                    self._seen.pop(mine.pop(0))
            rec[peer] = digest_hex
            if local is not None:
                rec["local"] = local
            agree = True
            sources = sorted(rec)
            for i, a in enumerate(sources):
                for b in sources[i + 1:]:
                    if rec[a] != rec[b]:
                        agree = False
                        self._flag_locked(plane, frontier, fk,
                                          a, rec[a], b, rec[b])
            compared = len(sources) >= 2
            if self.state != AUDIT_DIVERGED and compared:
                self.state = AUDIT_OK
        self.registry.set_gauge("audit_state", self.state)
        if compared:  # absent gauge == no comparison yet for the plane
            self.registry.set_gauge("audit_agreement",
                                    1.0 if agree else 0.0, plane=plane)

    def _flag_locked(self, plane: str, frontier: Dict[int, int], fk: tuple,
                     a: str, dig_a: str, b: str, dig_b: str) -> None:
        sig = (plane, fk, a, b)
        if sig in self._flagged:
            return
        self._flagged.add(sig)
        rec = {
            "plane": plane,
            "frontier": {str(r): s for r, s in sorted(frontier.items())},
            "a": a, "digest_a": dig_a,
            "b": b, "digest_b": dig_b,
        }
        self.divergences.append(rec)
        self.state = AUDIT_DIVERGED
        self.registry.inc("audit_divergences")
        self.events.emit("divergence_detected", **rec)
        self._auto_postmortem_locked(rec)

    # ---- continuous evaluators ----

    def evaluate(self) -> None:
        """One watchdog tick: scrub (cadenced), frontier stall,
        convergence-lag EWMA breach, lease zombie window.  Drive once per
        gossip or soak round."""
        with self._lock:
            self.evals += 1
            do_scrub = bool(self.scrub_every
                            and self.evals % self.scrub_every == 0)
        if do_scrub:
            self.scrub()
        self._eval_frontier_stall()
        self._eval_lag()
        self._eval_leases()
        self.registry.set_gauge("audit_state", self.state)

    def scrub(self) -> List[Dict[str, Any]]:
        """Recompute every plane's digest FROM its store; a drift means
        the store changed underneath the incremental digest: the silent
        bit-rot signal, and the channel by which planted corruption
        enters the served digest so peers can convict it."""
        drifted = []
        for plane, node in self.planes():
            if not node.audit_scrub():
                continue
            rec = {"plane": plane, "node": str(node.rid)}
            drifted.append(rec)
            with self._lock:
                self.scrub_drifts.append(rec)
            self.registry.inc("audit_scrub_drifts")
            self.events.emit("audit_scrub_drift", **rec)
        return drifted

    def _trackers(self) -> List[Any]:
        out = [t for t in (self.stability,) if t is not None]
        out.extend(self.ks_trackers or ())
        return out

    def _eval_frontier_stall(self) -> None:
        stale: List[str] = []
        for t in self._trackers():
            stale.extend(t.stale_members())
        with self._lock:
            if stale:
                self._stall_streak += 1
            else:
                self._stall_streak = 0
                self._stalled = False
            fire = (self._stall_streak >= self.stall_rounds
                    and not self._stalled)
            if fire:
                self._stalled = True  # edge-triggered; re-arms on recovery
            rounds = self._stall_streak
        if fire:
            self.registry.inc("audit_frontier_stalls")
            self.events.emit("audit_frontier_stall",
                             stale=sorted(set(stale)), rounds=rounds)

    def _eval_lag(self) -> None:
        from crdt_tpu_torch.obs import health

        lag = health.max_convergence_lag(self.registry)
        with self._lock:
            if lag is None or lag <= self.lag_threshold:
                self._lag_breached = False
                return
            fire = not self._lag_breached
            self._lag_breached = True
        if fire:
            self.registry.inc("audit_lag_breaches")
            self.events.emit("audit_lag_breach", lag_ops=lag,
                             threshold=self.lag_threshold)

    def _eval_leases(self) -> None:
        if self.leases is None:
            return
        zombies = [slot for slot, st in self.leases.slot_states().items()
                   if int(st.get("state", 0)) == 2]
        with self._lock:
            if not zombies:
                self._zombie = False
                return
            fire = not self._zombie
            self._zombie = True
        if fire:
            self.registry.inc("audit_lease_zombies")
            self.events.emit("audit_lease_zombie",
                             slots=[str(s) for s in sorted(zombies)])

    # ---- auto-postmortem ----

    def configure_postmortem(self, out_dir: str, seed: int,
                             log_paths: Sequence[str],
                             fleet_text: Optional[Callable[[], str]] = None
                             ) -> None:
        self._pm_dir = out_dir
        self._pm_seed = int(seed)
        self._pm_logs = list(log_paths)
        self._pm_fleet = fleet_text

    def _auto_postmortem_locked(self, div: Dict[str, Any]) -> None:
        if self._pm_dir is None or self.postmortem_path is not None:
            return
        import os

        from crdt_tpu_torch.obs import assemble

        out = os.path.join(self._pm_dir,
                           f"postmortem-{self._pm_seed}.tar.gz")
        extra: Dict[str, Any] = {"audit_witnesses.json": {
            "divergence": div,
            "planes": self._plane_digests(),
        }}
        if self._pm_fleet is not None:
            try:
                extra["fleet_rollup.txt"] = self._pm_fleet()
            except Exception as e:  # the bundle must land regardless
                extra["fleet_rollup.txt"] = f"<unavailable: {e}>"
        try:
            self.postmortem_path = assemble.write_postmortem(
                out, self._pm_logs, extra=extra)
            self.events.emit("audit_postmortem", path=self.postmortem_path)
        except Exception as e:
            self.events.emit("audit_postmortem_error",
                             error=f"{type(e).__name__}: {e}"[:200])

    # ---- reporting (GET /audit, the obs CLI) ----

    def _plane_digests(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {}
        for plane, node in self.planes():
            snap = node.audit_snapshot()
            if snap is not None:
                vv, frontier, dig = snap
                out[plane] = {
                    "digest": dig,
                    "frontier": {str(r): s for r, s in sorted(
                        frontier.items())},
                    "vv": {str(r): s for r, s in sorted(vv.items())},
                }
        return out

    def report(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "node": str(self.node.rid),
                "state": self.state,
                "evals": self.evals,
                "planes": self._plane_digests(),
                "divergences": list(self.divergences),
                "scrub_drifts": list(self.scrub_drifts),
                "postmortem": self.postmortem_path,
            }

    def report_json(self) -> bytes:
        return json.dumps(self.report()).encode()


def store_digest_hex(node) -> str:
    """From-scratch digest of a plane's CURRENT store — no enablement or
    attached :class:`PlaneDigest` required.  The checkpoint layer's
    corruption signal: saved into the snapshot at save time, recomputed
    over the restored store and compared at load (utils/checkpoint); a
    mismatch means the stores did not survive the round trip bit-exact,
    and the generation is quarantined like any torn section.  Absolute-ts
    hashing makes the value robust to an epoch rebase."""
    pd = node.digest if node.digest is not None else PlaneDigest(node)
    _winner, _rows, acc = pd.compute_from_store()
    return digops.digest_hex(acc)


def cross_check(reports: Dict[str, Dict[str, Any]]) -> List[Dict[str, Any]]:
    """Fold several nodes' ``GET /audit`` reports into per-(plane,
    frontier) agreement rows — the offline analogue of the in-process
    watchdog comparison.  Only digests snapshotted at the SAME frontier
    are comparable (the clamp invariant), so each row groups by the
    exact frontier; ``n == 1`` rows carry no verdict."""
    cells: Dict[Tuple[str, tuple], Dict[str, str]] = {}
    for name, rep in reports.items():
        for plane, rec in (rep.get("planes") or {}).items():
            dig = rec.get("digest")
            fk = tuple(sorted((rec.get("frontier") or {}).items()))
            if dig is None or not fk:
                continue
            cells.setdefault((plane, fk), {})[name] = dig
    rows = []
    for (plane, fk), digs in sorted(cells.items()):
        rows.append({
            "plane": plane,
            "frontier": dict(fk),
            "digests": digs,
            "n": len(digs),
            "agree": len(set(digs.values())) <= 1,
        })
    return rows


def _fetch_report(target: str, timeout: float = 5.0) -> Dict[str, Any]:
    if target.startswith(("http://", "https://")):
        import urllib.request
        url = target if target.endswith("/audit") \
            else target.rstrip("/") + "/audit"
        with urllib.request.urlopen(url, timeout=timeout) as resp:
            return json.loads(resp.read().decode("utf-8", "replace"))
    with open(target, "r", encoding="utf-8") as fh:
        return json.load(fh)


def main(argv: Optional[Sequence[str]] = None) -> int:
    """``python -m crdt_tpu_torch.obs.audit <url-or-file ...>``: scrape every
    member's ``GET /audit`` report (or read saved report JSON), print
    the fleet divergence verdict, exit 1 on any latched divergence or
    cross-node digest disagreement at a shared frontier."""
    import argparse
    import sys

    ap = argparse.ArgumentParser(
        prog="python -m crdt_tpu_torch.obs.audit",
        description="Aggregate per-node divergence-audit reports into "
                    "one fleet verdict (cross-node digest agreement at "
                    "matching frontiers).")
    ap.add_argument("targets", nargs="+",
                    help="member base URLs (…/audit is appended) or "
                         "paths to saved audit-report JSON files")
    ap.add_argument("--out", default=None,
                    help="also write the fleet audit report to this "
                         "JSON file")
    ap.add_argument("--timeout", type=float, default=5.0)
    args = ap.parse_args(argv)

    reports: Dict[str, Dict[str, Any]] = {}
    for t in args.targets:
        try:
            reports[t] = _fetch_report(t, timeout=args.timeout)
        except Exception as exc:  # a dead member is a finding, not a crash
            print(f"audit: scrape failed for {t}: {exc}", file=sys.stderr)
    if not reports:
        print("audit: no member reachable", file=sys.stderr)
        return 2

    rows = cross_check(reports)
    out = {
        "nodes": {name: {
            "node": rep.get("node"),
            "state": rep.get("state"),
            "divergences": rep.get("divergences") or [],
            "scrub_drifts": rep.get("scrub_drifts") or [],
            "postmortem": rep.get("postmortem"),
        } for name, rep in reports.items()},
        "cross": rows,
    }
    diverged = [n for n, r in out["nodes"].items()
                if r["state"] == AUDIT_DIVERGED or r["divergences"]]
    disagreed = [r for r in rows if r["n"] >= 2 and not r["agree"]]
    out["verdict"] = "diverged" if (diverged or disagreed) else (
        "ok" if any(r["n"] >= 2 for r in rows)
        or any(r["state"] == AUDIT_OK for r in out["nodes"].values())
        else "no_data")
    body = json.dumps(out, indent=2, sort_keys=True)
    print(body)
    if args.out:
        with open(args.out, "w", encoding="utf-8") as fh:
            fh.write(body + "\n")
    if diverged or disagreed:
        for n in diverged:
            print(f"audit: {n} reports divergence", file=sys.stderr)
        for r in disagreed:
            print(f"audit: plane {r['plane']} digests disagree at "
                  f"frontier {r['frontier']}", file=sys.stderr)
        return 1
    return 0


def plant_divergence(node) -> Optional[Dict[str, Any]]:
    """The fault plane's silent-corruption hook: flip one committed row's
    winner timestamp post-merge WITHOUT telling the digest.  The node
    keeps serving, the incremental digest still vouches for the old row,
    and only the watchdog's scrub and frontier-anchored peer comparison
    can convict it.  Targets the folded summary (rows below the stable
    frontier are exactly the ones peers compare at matching frontiers);
    returns a witness record, or None when the node holds no folded
    state to corrupt yet (the soak retries next round).

    The bump is RID-KEYED, not a constant: every replica folds the same
    rows, so a fixed ``+1`` planted on two different nodes manufactures
    the same corrupt row on both — consistently-wrong replicas AGREE at
    every frontier and the divergence is undetectable by construction.
    A per-rid offset keeps any two planted nodes (and every clean node)
    pairwise distinguishable."""
    with node._lock:
        if not node._summary:
            return None
        key = min(node._summary)
        e = node._summary[key]
        before = int(e["ts"])
        after = before + 1 + int(node.rid) % 1024
        e["ts"] = after
        node._summary_cache = None  # the device view must see the flip
    return {"node": str(node.rid), "key": key,
            "ts_before": before, "ts_after": after}


if __name__ == "__main__":
    import sys

    sys.exit(main())
