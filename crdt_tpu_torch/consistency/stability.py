"""Stability frontier: gossip-piggybacked vv summaries toward coordinated
GC (own copy of ``crdt_tpu.consistency.stability``).

An op ``(rid, seq)`` is STABLE once every member's version vector
dominates it: no delta payload can need it again.  The frontier is
computed from summaries that ride traffic the fleet already exchanges:
every ``GET /gossip`` response carries an ``X-CRDT-Stability`` header with
the serving node's ``{rid, vv, frontier}`` snapshot (``api.http_shim``),
and a puller hands the captured summaries to its ``StabilityTracker``.

The rule is pessimistic: a member with no summary, or one older than
``max_staleness``, stalls the frontier (``{}`` and a ``stability_stalled``
event); a stale but real summary is safe (vvs are monotone, so it can only
under-collect); the candidate must satisfy the chain rule against every
member's fold (``stable_frontier_host``).  Every minted frontier is kept in
``ledger`` with the summaries it came from.
"""
from __future__ import annotations

import json
import threading
import time
from typing import Any, Callable, Dict, List, Optional

# response header carrying the serving node's stability summary
STABILITY_HEADER = "X-CRDT-Stability"


def encode_summary(rid: int, vv: Dict[int, int],
                   frontier: Dict[int, int],
                   digest: Optional[str] = None) -> str:
    """Header value for one node's summary (compact JSON, keys as strings
    like the /vv body).  ``digest`` is the serving node's audit digest
    clamped at ``frontier``, when it has one."""
    d: Dict[str, Any] = {
        "rid": int(rid),
        "vv": {str(r): int(s) for r, s in vv.items()},
        "frontier": {str(r): int(s) for r, s in frontier.items()},
    }
    if digest is not None:
        d["digest"] = str(digest)
    return json.dumps(d, separators=(",", ":"))


def decode_summary(raw: Optional[str]) -> Optional[Dict[str, Any]]:
    """Parse a header value; garbage (a truncated or corrupt header) is
    None, and the round contributes no summary.  ``digest`` passes through
    untyped."""
    if not raw:
        return None
    try:
        d = json.loads(raw)
        out = {
            "rid": int(d["rid"]),
            "vv": {int(r): int(s) for r, s in (d.get("vv") or {}).items()},
            "frontier": {int(r): int(s)
                         for r, s in (d.get("frontier") or {}).items()},
        }
        dig = d.get("digest")
        if dig is not None:
            out["digest"] = dig
        return out
    except (ValueError, TypeError, KeyError):
        return None


class StabilityTracker:
    """Fleet-wide stable-frontier bookkeeping for ONE node's view.

    ``members`` are the peer identities this node must hear from; the
    local node is the implicit extra member, read fresh at mint time.
    Thread-safe (summaries arrive on gossip threads)."""

    def __init__(self, node, members: List[str], *,
                 max_staleness: float = 30.0,
                 clock: Optional[Callable[[], float]] = None,
                 events=None):
        self.node = node
        self.members = list(members)
        self.max_staleness = float(max_staleness)
        self.clock = clock or time.monotonic
        self.events = events
        self._lock = threading.Lock()
        # member -> {"vv": {rid: seq}, "frontier": {rid: seq}, "at": t}
        self._observed: Dict[str, Dict[str, Any]] = {}
        # last successfully minted frontier ({} before the first mint)
        self.last_frontier: Dict[int, int] = {}
        # audit trail: one record per mint, with the summaries used
        self.ledger: List[Dict[str, Any]] = []

    def note(self, member: str, vv: Dict[int, int],
             frontier: Dict[int, int]) -> None:
        """Record a member's summary.  Watermarks are monotone, so a
        delayed or reordered summary merges pointwise instead of replacing
        a newer one."""
        now = self.clock()
        with self._lock:
            prev = self._observed.get(member)
            if prev is not None:
                vv = {r: max(s, prev["vv"].get(r, -1)) for r, s in vv.items()
                      } | {r: s for r, s in prev["vv"].items() if r not in vv}
                frontier = {
                    r: max(s, prev["frontier"].get(r, -1))
                    for r, s in frontier.items()
                } | {r: s for r, s in prev["frontier"].items()
                     if r not in frontier}
            self._observed[member] = {"vv": vv, "frontier": frontier,
                                      "at": now}

    def observed(self) -> Dict[str, Dict[str, Any]]:
        with self._lock:
            return {m: {"vv": dict(o["vv"]), "frontier": dict(o["frontier"]),
                        "at": o["at"]} for m, o in self._observed.items()}

    def stale_members(self, now: Optional[float] = None) -> List[str]:
        """Members whose summary is missing or older than max_staleness
        (nonempty: the frontier is stalled)."""
        now = self.clock() if now is None else now
        with self._lock:
            out = []
            for m in self.members:
                o = self._observed.get(m)
                if o is None or (now - o["at"]) > self.max_staleness:
                    out.append(m)
            return out

    def frontier(self) -> Dict[int, int]:
        """The fleet-stable frontier, or {} when it cannot be proven: the
        pointwise min over the local vv and every member's fresh vv, under
        the chain rule (``stable_frontier_host``).  Stalls loudly when a
        member is silent or stale."""
        # late import: api.node imports the obs modules this one sits beside
        from crdt_tpu_torch.api.node import stable_frontier_host

        stale = self.stale_members()
        if stale:
            if self.events is not None:
                self.events.emit("stability_stalled",
                                 stale=sorted(stale),
                                 members=len(self.members))
            return {}
        own_vv, own_frontier = self.node.vv_snapshot()
        with self._lock:
            vvs = [own_vv] + [dict(self._observed[m]["vv"])
                              for m in self.members]
            frontiers = [own_frontier] + [dict(self._observed[m]["frontier"])
                                          for m in self.members]
        return stable_frontier_host(vvs, frontiers)

    def mint(self, step: Optional[int] = None) -> Dict[int, int]:
        """frontier() plus its ledger record; empty mints are not
        recorded."""
        frontier = self.frontier()
        if not frontier:
            return {}
        with self._lock:
            self.last_frontier = dict(frontier)
            self.ledger.append({
                "t": self.clock(),
                "step": step,
                "frontier": dict(frontier),
                "summaries": {m: dict(o["vv"])
                              for m, o in self._observed.items()},
            })
        return frontier

    def lag_ops(self) -> int:
        """Local vv ops minus last-minted-frontier ops: the op-log debt
        carried above the stable line."""
        own_vv, _ = self.node.vv_snapshot()
        with self._lock:
            f = self.last_frontier
            return (sum(s + 1 for s in own_vv.values())
                    - sum(s + 1 for s in f.values()))
