"""Tunable consistency: eventual | session | linearizable reads, plus CAS
(own copy of ``crdt_tpu.consistency.plane``, pure host code over the
node's locked accessors).

"Linearizable State Machine Replication of State-Based CRDTs without
Logs" (PAPERS.md) layers strong operations on an unmodified lattice by
using the version-vector frontier as the progress measure: a read is
linearizable once the serving replica provably dominates a quorum's
watermarks at some point after the request began.  This module is that
layer for the KV surface:

* ``eventual``      — the plain local read (unchanged fast path);
* ``session``       — local read gated on dominance of the caller's
                      session token ([[session]]): read-your-writes and
                      monotonic reads, waiting-or-proxying until the
                      local vv catches up;
* ``linearizable``  — a quorum round over RemotePeers: collect vv
                      watermarks from a majority (breaker-aware — an OPEN
                      circuit counts as a missing ack instead of a paid
                      timeout), pull until the local vv dominates their
                      pointwise max, then serve locally;
* ``cas``           — linearizable read + expected-value check + local
                      mint + synchronous delta push to a write quorum.

Failure posture: strong operations NEVER silently degrade.  Quorum loss,
catch-up timeout, or a dead local node raise ``ConsistencyUnavailable``
(HTTP 503) and emit a ``consistency_unavailable`` event — a soak can
audit the 1:1 correspondence and that no stale value is
ever served in place of an error.  A CAS that minted its write but could
not reach a write quorum raises with ``indeterminate=True``: the op
exists and will propagate via anti-entropy; the caller must treat the
outcome as unknown (retry with the ACTUAL value it reads next).

Concurrency: CAS decisions serialize through a COORDINATOR LEASE
([[leases]]) when a ``LeaseManager`` is attached — every key routes
(rendezvous over the live member list) to one coordinator per routing
slot, non-coordinators FORWARD the request (``cas_forwarded``, bounded
hop budget), and the coordinator decides under a quorum-granted lease,
stamping its fence epoch on the synchronous push so replicas reject a
zombie coordinator's late decision (``cas_fenced_reject``).  Without a
LeaseManager (direct construction, unit tests) the plane keeps the
lease-less posture: one plane-wide lock, correct only for same-node
routing.

The same machinery carries multi-key CAS batches (``cas_multi``: every
key routed, every slot's lease held, every expectation checked under
one linearizable view, all pairs minted as ONE command — all-or-
nothing) and bounded-staleness reads (``level="bounded"``: served
locally when the summed per-writer op lag behind the quorum max is
within Δ).
"""
from __future__ import annotations

import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

from crdt_tpu_torch.consistency.session import (
    mint_token,
    vv_dominates,
    wait_for_dominance,
)
from crdt_tpu_torch.obs.trace import current_trace, mint_trace_id, span

LEVELS = ("eventual", "session", "bounded", "linearizable")


class ConsistencyUnavailable(Exception):
    """Strong guarantee cannot be met right now — HTTP 503, never a
    silently stale value.  ``indeterminate`` marks a CAS whose write was
    minted locally but not quorum-acked (outcome unknown to the caller).
    ``retry_after_s`` is the advisory backoff the 503 response carries
    in its Retry-After header (like the ingest door's 429s).
    ``token`` names the minted-but-unacked op identity ({rid: seq})
    when the decider got as far as minting — the op may still land via
    anti-entropy, and naming it lets a caller (or a soak's oracle)
    account for exactly which write is outstanding."""

    def __init__(self, reason: str, *, level: str = "linearizable",
                 op: str = "read", acks: int = 0, quorum: int = 0,
                 indeterminate: bool = False,
                 retry_after_s: float = 0.05,
                 token: Optional[Dict[int, int]] = None):
        self.reason = reason
        self.level = level
        self.op = op
        self.acks = acks
        self.quorum = quorum
        self.indeterminate = indeterminate
        self.retry_after_s = float(retry_after_s)
        self.token = token
        super().__init__(
            f"{level} {op} unavailable: {reason} "
            f"(acks={acks} quorum={quorum})"
        )


class CasConflict(Exception):
    """CAS expectation failed — HTTP 409 carrying the actual value so the
    caller can re-derive and retry.  ``coordinator``/``fence`` name the
    node that DECIDED the conflict and the lease epoch it held, so a
    client can re-route its retry straight to the deciding coordinator
    (None on the legacy lease-less path)."""

    def __init__(self, key: str, expect: Optional[str],
                 actual: Optional[str],
                 coordinator: Optional[str] = None,
                 fence: Optional[int] = None):
        self.key = key
        self.expect = expect
        self.actual = actual
        self.coordinator = coordinator
        self.fence = fence
        super().__init__(f"cas conflict on {key!r}: "
                         f"expected {expect!r}, found {actual!r}")


class ConsistencyPlane:
    """Per-node strong-read/CAS coordinator over the agent's RemotePeers.

    ``peers`` defaults to reading ``agent.peers`` live (a fault harness
    swaps that list for FaultyTransports after boot; reading it per-operation
    keeps the plane inside the fault schedule).  ``clock``/``sleep`` are
    injectable so tests drive the wait loops on a fake clock."""

    def __init__(self, node, *, agent=None,
                 peers: Optional[Callable[[], List]] = None,
                 quorum: int = 0, strong_timeout: float = 5.0,
                 session_timeout: float = 5.0, poll: float = 0.02,
                 events=None, metrics=None,
                 clock: Optional[Callable[[], float]] = None,
                 sleep: Optional[Callable[[float], None]] = None,
                 leases=None, forward_hops: int = 2,
                 bounded_staleness: int = 64,
                 retry_after_s: float = 0.05):
        self.node = node
        self.agent = agent
        self._peers_fn = peers
        self.quorum = int(quorum)  # 0 = majority of (peers + self)
        self.strong_timeout = float(strong_timeout)
        self.session_timeout = float(session_timeout)
        self.poll = float(poll)
        self.events = events if events is not None else node.events
        self.metrics = metrics if metrics is not None else node.metrics
        self.clock = clock or time.monotonic
        self.sleep = sleep or time.sleep
        # None = the lease-less plane (plane-wide lock, same-node
        # routing caveat) — the path every directly-constructed test
        # plane still takes.  NodeHost attaches a LeaseManager.
        self.leases = leases
        self.forward_hops = int(forward_hops)
        self.bounded_staleness = int(bounded_staleness)
        self.retry_after_s = float(retry_after_s)
        self._cas_lock = threading.Lock()

    # ---- membership ----

    def _peers(self) -> List:
        if self._peers_fn is not None:
            return list(self._peers_fn())
        if self.agent is not None:
            return list(self.agent.peers)
        return []

    def _quorum_of(self, n_members: int) -> int:
        return self.quorum if self.quorum > 0 else n_members // 2 + 1

    # ---- failure bookkeeping ----

    def _unavailable(self, reason: str, *, level: str, op: str,
                     acks: int = 0, quorum: int = 0,
                     indeterminate: bool = False,
                     token: Optional[Dict[int, int]] = None,
                     ) -> ConsistencyUnavailable:
        self.metrics.inc("consistency_unavailable")
        # trace-joined when raised inside a CAS span (current_trace is
        # bound there): the blame report can tie an unavailability burst
        # to the lease churn / breaker state of the SAME request
        self.events.emit("consistency_unavailable", trace=current_trace(),
                         reason=reason,
                         level=level, op=op, acks=acks, quorum=quorum,
                         indeterminate=indeterminate,
                         **({"token": {str(r): s for r, s in token.items()}}
                            if token else {}))
        return ConsistencyUnavailable(
            reason, level=level, op=op, acks=acks, quorum=quorum,
            indeterminate=indeterminate,
            retry_after_s=self.retry_after_s, token=token)

    # ---- proxy pulls (shared by session waits and quorum catch-up) ----

    def _guarded_receive(self, payload, peer: Optional[str] = None) -> None:
        """Merge a proxied payload; malformed content is skipped (the
        quarantine posture of the pull loop), never fatal to the wait —
        and logged as the same ``payload_quarantine`` event the pull loop
        emits, so corruption accounting stays 1:1 whichever path fetched
        the payload."""
        try:
            self.node.receive(payload)
        except (ValueError, KeyError, TypeError) as e:
            self.metrics.inc("consistency_proxy_quarantine")
            self.events.emit("payload_quarantine", peer=peer,
                             surface="consistency_proxy",
                             error=f"{type(e).__name__}: {e}"[:200])

    def _proxy_pull(self, peers: Optional[List] = None) -> None:
        """One proxy round: fetch each responsive peer's delta since our
        vv and merge it — fills session/quorum gaps without waiting for
        the background gossip cadence."""
        vv, _ = self.node.vv_snapshot()
        for p in (self._peers() if peers is None else peers):
            if p.backed_off():
                continue
            payload = p.gossip_payload(since=vv)
            if payload:
                self._guarded_receive(payload, peer=p.url)

    # ---- quorum machinery ----

    def _collect_quorum(self, *, level: str, op: str) -> List[Tuple]:
        """Collect (peer, vv) watermarks from enough members to prove a
        quorum view.  Sequential, in peer-list order — deterministic under
        a fault schedule — with OPEN breakers skipped (a partitioned
        peer costs a missing ack, not a paid timeout).  Raises ConsistencyUnavailable when acks < quorum."""
        peers = self._peers()
        q = self._quorum_of(len(peers) + 1)
        if not self.node.alive:
            raise self._unavailable("node_down", level=level, op=op,
                                    quorum=q)
        responding: List[Tuple] = []
        for p in peers:
            if p.backed_off():
                continue
            got = p.version_vector()
            if got is None:
                continue
            responding.append((p, got[0]))
        acks = 1 + len(responding)  # self always acks while alive
        if acks < q:
            raise self._unavailable("quorum_lost", level=level, op=op,
                                    acks=acks, quorum=q)
        return responding

    def _catch_up(self, responding: List[Tuple], deadline: float, *,
                  level: str, op: str) -> None:
        """Pull from the quorum until the local vv dominates the pointwise
        max of every collected watermark (the linearization point: we now
        hold everything any quorum member had acknowledged)."""
        target: Dict[int, int] = {}
        for _, vv in responding:
            for r, s in vv.items():
                if s > target.get(r, -1):
                    target[r] = s
        while True:
            vv, _ = self.node.vv_snapshot()
            if vv_dominates(vv, target):
                return
            if self.clock() >= deadline:
                q = self._quorum_of(len(self._peers()) + 1)
                raise self._unavailable("catchup_timeout", level=level,
                                        op=op, acks=1 + len(responding),
                                        quorum=q)
            self._proxy_pull([p for p, _ in responding])
            vv, _ = self.node.vv_snapshot()
            if vv_dominates(vv, target):
                return
            self.sleep(self.poll)

    # ---- public API ----

    def read(self, key: str, level: str = "eventual",
             token: Optional[Dict[int, int]] = None,
             timeout: Optional[float] = None,
             staleness: Optional[int] = None) -> Optional[str]:
        """Read ``key`` at the requested consistency level.  Returns the
        value (None = key absent — a valid answer); raises
        ConsistencyUnavailable when the level's guarantee cannot be met
        and ValueError on caller mistakes (bad level, session without a
        token).  ``staleness`` overrides the configured Δ op budget for
        ``level="bounded"`` (ignored at other levels)."""
        if level not in LEVELS:
            raise ValueError(f"unknown consistency level {level!r} "
                             f"(one of {LEVELS})")
        if level == "eventual":
            state = self.node.get_state()
            if state is None:
                raise self._unavailable("node_down", level=level, op="read")
            self.metrics.inc("reads_eventual")
            return state.get(key)
        if level == "session":
            if token is None:
                raise ValueError("session read requires a session token")
            ok = wait_for_dominance(
                self.node, token,
                timeout=self.session_timeout if timeout is None else timeout,
                poll=self.poll, clock=self.clock, sleep=self.sleep,
                proxy=self._proxy_pull)
            if not ok:
                raise self._unavailable("token_timeout", level=level,
                                        op="read")
            state = self.node.get_state()
            if state is None:
                raise self._unavailable("node_down", level=level, op="read")
            self.metrics.inc("reads_session")
            return state.get(key)
        if level == "bounded":
            return self._read_bounded(key, timeout=timeout,
                                      staleness=staleness)
        # linearizable
        t0 = self.clock()
        deadline = t0 + (self.strong_timeout if timeout is None else timeout)
        responding = self._collect_quorum(level=level, op="read")
        self._catch_up(responding, deadline, level=level, op="read")
        state = self.node.get_state()
        if state is None:
            raise self._unavailable("node_down", level=level, op="read")
        self.metrics.observe("strong_read_quorum_seconds",
                             self.clock() - t0)
        self.metrics.inc("reads_linearizable")
        return state.get(key)

    def _read_bounded(self, key: str, *, timeout: Optional[float],
                      staleness: Optional[int]) -> Optional[str]:
        """Bounded-staleness read: serve locally once the summed
        per-writer op lag behind the QUORUM MAX watermark is within Δ.
        Same quorum round as linearizable (staleness is measured against
        a majority view, so a partitioned minority cannot self-certify
        freshness), but the catch-up stops at Δ instead of zero — the
        cheap middle ground between session and linearizable."""
        delta = self.bounded_staleness if staleness is None else int(staleness)
        if delta < 0:
            raise ValueError(f"bounded staleness Δ={delta} is negative")
        t0 = self.clock()
        deadline = t0 + (self.strong_timeout if timeout is None else timeout)
        responding = self._collect_quorum(level="bounded", op="read")
        target: Dict[int, int] = {}
        for _, vv in responding:
            for r, s in vv.items():
                if s > target.get(r, -1):
                    target[r] = s

        def lag() -> int:
            vv, _ = self.node.vv_snapshot()
            return sum(max(0, s - vv.get(r, -1))
                       for r, s in target.items())

        while lag() > delta:
            if self.clock() >= deadline:
                q = self._quorum_of(len(self._peers()) + 1)
                raise self._unavailable("catchup_timeout", level="bounded",
                                        op="read", acks=1 + len(responding),
                                        quorum=q)
            self._proxy_pull([p for p, _ in responding])
            if lag() <= delta:
                break
            self.sleep(self.poll)
        state = self.node.get_state()
        if state is None:
            raise self._unavailable("node_down", level="bounded", op="read")
        self.metrics.observe("strong_read_quorum_seconds",
                             self.clock() - t0)
        self.metrics.inc("reads_bounded")
        return state.get(key)

    def cas(self, key: str, expect: Optional[str], update: str,
            timeout: Optional[float] = None,
            hops: int = 0, trace: Optional[str] = None) -> Dict[int, int]:
        """Compare-and-set: atomically replace ``key``'s value with
        ``update`` iff its linearizable-read value equals ``expect``
        (``expect=None`` = key must be absent).  Returns the session
        token covering the write (the caller's read-your-writes handle).

        With a LeaseManager attached the request routes to the key's
        slot coordinator (forwarding when this node isn't it — ``hops``
        counts forwards already taken, bounded by ``forward_hops``) and
        the decision happens under a quorum-granted, fenced lease.

        Raises CasConflict (409) on expectation failure and
        ConsistencyUnavailable (503) on quorum loss — with
        ``indeterminate=True`` when the write was already minted locally
        but fewer than a quorum acked the synchronous push (the op WILL
        still propagate via anti-entropy)."""
        return self.cas_multi({key: (expect, update)}, timeout=timeout,
                              hops=hops, trace=trace)

    def cas_multi(self, ops: Dict[str, Tuple[Optional[str], str]],
                  timeout: Optional[float] = None,
                  hops: int = 0,
                  trace: Optional[str] = None) -> Dict[int, int]:
        """Multi-key CAS batch: every ``key -> (expect, update)`` pair
        checked under ONE linearizable view and applied all-or-nothing
        (all pairs minted as a single command, so one op identity covers
        the batch — replicas merge it atomically or not at all).  Every
        involved routing slot's lease must be held by the deciding
        coordinator; cross-slot batches may 503 ``lease_unavailable``
        while another coordinator's unexpired lease covers a slot (the
        documented availability cost of strict all-or-nothing batches
        without a 2PC)."""
        if not ops:
            raise ValueError("cas_multi requires at least one key")
        # one trace id threads the whole request — minted here at the
        # origin unless the HTTP surface already propagated one
        # (X-CRDT-Trace across forwarding hops).  The span binds it as
        # current_trace, so every lease event (grant/renew/expire) and
        # unavailability raised underneath joins the same trace.
        tid = trace or current_trace() or mint_trace_id(self.node.rid)
        with span("crdt.cas", tid):
            if self.leases is None:
                return self._cas_decide(ops, fences=None, timeout=timeout,
                                        trace=tid)
            slots = sorted({self.leases.slot_of(k) for k in ops})
            # the batch coordinator is the FIRST sorted slot's
            # coordinator — deterministic, so concurrent batches over the
            # same slot set route to the same decider
            coord = self.leases.coordinator_of(slots[0])
            if coord != self.leases.own_url:
                return self._cas_forward(coord, ops, timeout=timeout,
                                         hops=hops, trace=tid)
            fences: Dict[int, int] = {}
            for slot in slots:
                fence = self.leases.ensure(slot)
                if fence is None:
                    peers = self._peers()
                    raise self._unavailable(
                        "lease_unavailable", level="linearizable",
                        op="cas",
                        quorum=self._quorum_of(len(peers) + 1))
                fences[slot] = fence
            return self._cas_decide(ops, fences=fences, timeout=timeout,
                                    trace=tid)

    def _cas_forward(self, coord: str,
                     ops: Dict[str, Tuple[Optional[str], str]],
                     *, timeout: Optional[float],
                     hops: int,
                     trace: Optional[str] = None) -> Dict[int, int]:
        """Relay the batch to the routed coordinator.  The coordinator's
        verdict is re-raised HERE without re-emitting events/metrics —
        the deciding node already counted it, and refusals are audited
        1:1 against events (a relay that double-
        counted would break it).  Only a transport failure is OURS to
        report, and it is ``indeterminate``: the coordinator may have
        committed before the connection died."""
        if hops >= self.forward_hops:
            raise self._unavailable("forward_hops_exhausted",
                                    level="linearizable", op="cas")
        peer = next((p for p in self._peers()
                     if p.url == coord.rstrip("/")), None)
        if peer is None or peer.backed_off():
            # never sent: a routing view naming an unreachable
            # coordinator is plain unavailability, not indeterminacy
            raise self._unavailable("forward_unreachable",
                                    level="linearizable", op="cas")
        self.metrics.inc("cas_forwarded")
        self.events.emit("cas_forward", trace=trace, coordinator=coord,
                         hops=int(hops) + 1, keys=sorted(ops))
        body = {
            "ops": {k: {"expect": e, "update": u}
                    for k, (e, u) in ops.items()},
            "hops": int(hops) + 1,
        }
        if trace:
            # the causal thread crosses the hop: the coordinator's /cas
            # handler re-binds this id, so its lease events and commit
            # join the ORIGIN's trace in the assembled timeline
            body["trace"] = trace
        if timeout is not None:
            body["timeout"] = float(timeout)
        got = peer.cas_forward(body)
        if got is None:
            raise self._unavailable("forward_unreachable",
                                    level="linearizable", op="cas",
                                    indeterminate=True)
        status, rbody = got["status"], got["body"] or {}
        if status == 200 and "token" in rbody:
            return {int(r): int(s)
                    for r, s in (rbody["token"] or {}).items()}
        if status == 409 and rbody.get("conflict"):
            raise CasConflict(
                rbody.get("key"), rbody.get("expect"),
                rbody.get("actual"),
                coordinator=rbody.get("coordinator") or coord,
                fence=rbody.get("fence"))
        if status == 503 and rbody.get("reason"):
            raise ConsistencyUnavailable(
                rbody["reason"], level=rbody.get("level", "linearizable"),
                op=rbody.get("op", "cas"),
                acks=int(rbody.get("acks", 0)),
                quorum=int(rbody.get("quorum", 0)),
                indeterminate=bool(rbody.get("indeterminate", False)),
                retry_after_s=float(
                    rbody.get("retry_after_s", self.retry_after_s)),
                token={int(r): int(s)
                       for r, s in (rbody.get("token") or {}).items()}
                or None)
        # a coordinator answering garbage is as unknown as one that died
        raise self._unavailable("forward_unreachable",
                                level="linearizable", op="cas",
                                indeterminate=True)

    def _cas_decide(self, ops: Dict[str, Tuple[Optional[str], str]],
                    *, fences: Optional[Dict[int, int]],
                    timeout: Optional[float],
                    trace: Optional[str] = None) -> Dict[int, int]:
        """Decide the batch locally: linearizable view, expectation
        checks, one-command mint, fence-stamped synchronous write
        quorum.  ``fences=None`` is the legacy lease-less path (plain
        pushes, no stamps)."""
        t0 = self.clock()
        deadline = t0 + (self.strong_timeout if timeout is None else timeout)
        coordinator = self.leases.own_url if self.leases is not None else None
        with self._cas_lock:
            responding = self._collect_quorum(level="linearizable", op="cas")
            self._catch_up(responding, deadline, level="linearizable",
                           op="cas")
            state = self.node.get_state()
            if state is None:
                raise self._unavailable("node_down", level="linearizable",
                                        op="cas")
            for key, (expect, _) in sorted(ops.items()):
                actual = state.get(key)
                if actual != expect:
                    self.metrics.inc("cas_conflicts")
                    fence = None
                    if fences is not None and self.leases is not None:
                        fence = fences.get(self.leases.slot_of(key))
                    raise CasConflict(key, expect, actual,
                                      coordinator=coordinator, fence=fence)
            # ONE command dict = one op identity: replicas adopt the
            # whole batch atomically or not at all
            idents = self.node.add_commands(
                [{k: u for k, (_, u) in ops.items()}])
            if idents is None:
                raise self._unavailable("node_down", level="linearizable",
                                        op="cas")
            token = mint_token(idents)
            # synchronous write quorum: push the delta each reader is
            # missing; a 200 means the peer merged it before answering
            # (http_shim /push), so its vv now dominates the token.
            # With fences, the stamp rides the push and a stale-fence
            # refusal is a FAILED ack that also teaches us the higher
            # fence (we were zombied; the raise below is indeterminate
            # because the op still propagates via unfenced anti-entropy)
            q = self._quorum_of(len(self._peers()) + 1)
            acks = 1  # self
            for p, peer_vv in responding:
                if acks >= q:
                    break
                payload = self.node.gossip_payload(since=peer_vv)
                if not payload:
                    continue
                if fences is None:
                    if p.push_payload(payload):
                        acks += 1
                    continue
                verdict = p.push_fenced(payload, fences, trace=trace)
                if verdict.get("ok"):
                    acks += 1
                elif verdict.get("fenced") and self.leases is not None:
                    self.leases.note_fence(int(verdict.get("slot", -1)),
                                           int(verdict.get("fence", 0)))
            if acks < q:
                raise self._unavailable(
                    "write_quorum_lost", level="linearizable", op="cas",
                    acks=acks, quorum=q, indeterminate=True, token=token)
            if fences is not None:
                # decision provenance for the coordinator-crash oracle:
                # a commit names its fence epochs, so the black boxes can
                # prove no two nodes ever committed under the same
                # (slot, fence) — the claim the whole lease design makes.
                # elapsed_ms feeds the blame report's CAS-latency-spike
                # rule; the trace joins the commit to the origin's
                # request across any forwarding hops it took.
                self.events.emit(
                    "cas_commit", trace=trace, keys=sorted(ops),
                    fences={str(s): f for s, f in sorted(fences.items())},
                    acks=acks,
                    elapsed_ms=round((self.clock() - t0) * 1e3, 3))
            self.metrics.observe("strong_read_quorum_seconds",
                                 self.clock() - t0)
            self.metrics.inc("cas_applied")
            return token
