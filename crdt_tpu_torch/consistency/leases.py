"""Coordinator leases with fencing tokens — log-free linearizable CAS
that survives coordinator crashes (own copy of
``crdt_tpu.consistency.leases``, pure host code).

A lease-less CAS serializes through one plane-wide lock, which decides
conflicting CAS correctly only when both requests land on the SAME node.
This module closes that gap on exactly the machinery the fleet already
gossips ("Linearizable State Machine Replication of State-Based CRDTs
without Logs", PAPERS.md — no op-log consensus):

* **Routing** — every key hashes to one of ``n_slots`` routing slots;
  each slot's preferred coordinator is the top-ranked member of a
  rendezvous hash over the LIVE member list (own URL + peers whose
  circuit breakers are closed), via the same
  ``keyspace.routing.ranked_members`` seam the keyspace tier uses.
  Routing is a per-node VIEW and may transiently disagree across a
  partition — safety never depends on it (the fences below arbitrate);
  it only decides where CAS requests forward.

* **Leases** — before deciding, a coordinator must hold a
  QUORUM-GRANTED lease on the slot: it proposes ``fence = highest
  known + 1`` to every member; a member refuses while it has granted an
  unexpired lease on that slot to a DIFFERENT holder, or knows an equal
  or higher fence held elsewhere (loud refusal — the grant response
  names the blocking holder + fence so the proposer adopts it).  Self
  plus remote grants must reach the write quorum.  Renewal keeps the
  same fence and re-extends expiry through the same quorum.  Expiry
  runs on the plane's injectable clock.

* **Fencing** — the granted fence is a monotone epoch per slot.  The
  coordinator stamps ``{slot: fence}`` on every synchronous CAS delta
  push; every replica REJECTS pushes carrying a fence below its highest
  known for that slot (``cas_fenced_reject`` event + counter) and
  adopts higher ones.  A zombie coordinator — partitioned away while a
  successor acquired fence+1 from the quorum — can therefore never
  reach a write quorum with a late decision: at least a quorum of
  replicas already refuse its stale fence.  Fences are persisted
  fail-stop with checkpoints (utils/checkpoint.py ``leases.json``),
  like quorum-acked writes, so a crash-restored replica keeps refusing
  what it refused before.

The JAX package hammers this end to end with its nemesis soak; the
port's fake-clock tests (tests/test_torch_leases.py) hold every grant,
fence and refusal equal to the JAX package's under the same schedule.
"""
from __future__ import annotations

import hashlib
import threading
import time
from typing import Callable, Dict, List, Optional

from crdt_tpu_torch.keyspace.routing import ranked_members
from crdt_tpu_torch.obs.trace import current_trace

# gauge encoding for lease_state{slot} (obs/health.sample_leases):
# ordered by degradation so alert rules can threshold
LEASE_STATE = {"follower": 0, "held": 1, "expired": 2}


def slot_of_key(key: str, n_slots: int) -> int:
    """Deterministic key -> routing slot (blake2b, like the rendezvous
    score: never Python's per-process-salted hash())."""
    h = hashlib.blake2b(key.encode("utf-8"), digest_size=8)
    return int.from_bytes(h.digest(), "big") % n_slots


class LeaseManager:
    """Per-node lease + fence bookkeeping for every routing slot.

    One per NodeHost, shared by the consistency plane (coordinator side:
    ``ensure``/``coordinator_of``) and the HTTP surface (voter side:
    ``grant``; replica side: ``check_push_fences``).  ``clock`` is
    injectable: a soak drives it with the same fake plane time as the
    consistency plane, and the fake-clock tests with a manual one.  Wiring that needs the bound server (``own_url``) and
    the live peer list arrives after construction via :meth:`attach`.
    """

    def __init__(self, node, *, n_slots: int, duration: float,
                 clock: Optional[Callable[[], float]] = None,
                 events=None, metrics=None):
        self.node = node
        self.n_slots = int(n_slots)
        self.duration = float(duration)
        self.clock = clock or time.monotonic
        self.events = events if events is not None else node.events
        self.metrics = metrics if metrics is not None else node.metrics
        self.own_url: str = ""
        self._peers_fn: Optional[Callable[[], List]] = None
        # optional url -> stable-name mapping the rendezvous ranks over
        # (harnesses with OS-assigned ports pin routing determinism here)
        self.member_key: Optional[Callable[[str], str]] = None
        self._lock = threading.Lock()
        # highest fence epoch known per slot (from grants given, leases
        # acquired, fenced-reject responses, checkpoint restore) — the
        # monotone fact every safety argument leans on
        self._fences: Dict[int, int] = {}
        # voter side: slot -> {"holder": url, "fence": int, "expires": t}
        # for the lease this node has GRANTED (in-memory only: a crash
        # wipes grants but keeps fences, which is safe — a restored
        # voter may re-grant early, but never below the persisted fence)
        self._granted: Dict[int, Dict] = {}
        # coordinator side: slot -> {"fence": int, "expires": t} for
        # leases THIS node holds
        self._held: Dict[int, Dict] = {}

    def attach(self, own_url: str,
               peers_fn: Callable[[], List]) -> None:
        """Late wiring: the bound server URL and a live-peer-list
        closure (RemotePeer-likes with .url/.backed_off()/.lease_grant).
        """
        self.own_url = own_url
        self._peers_fn = peers_fn

    # ---- routing ----

    def _peers(self) -> List:
        return list(self._peers_fn()) if self._peers_fn is not None else []

    def slot_of(self, key: str) -> int:
        return slot_of_key(key, self.n_slots)

    def live_members(self) -> List[str]:
        """The member URLs routing ranks over: self plus every peer
        whose circuit breaker is not currently forbidding traffic.
        Sorted so the rendezvous input is order-independent; a per-node
        view (partitions make views diverge — fences, not routing,
        arbitrate).  The breaker check must be the PASSIVE peek:
        ``backed_off()`` would consume the half-open probe slot without
        ever probing, wedging the breaker open (routing is a read, not a
        send)."""
        urls = {self.own_url}
        for p in self._peers():
            peek = getattr(p, "backoff_peek", p.backed_off)
            if not peek():
                urls.add(p.url)
        return sorted(urls)

    def coordinator_of(self, slot: int) -> str:
        """This node's view of the slot's preferred coordinator URL.
        Ranks over ``member_key(url)`` when set — harnesses with
        OS-assigned ports map URLs to stable member names there, so
        routing (and therefore the whole wire-call schedule) replays
        byte-identically across same-seed runs."""
        return ranked_members(self.live_members(), f"lease-slot-{slot}",
                              ident=self.member_key)[0]

    # ---- fence facts ----

    def fence_of(self, slot: int) -> int:
        with self._lock:
            return self._fences.get(slot, 0)

    def note_fence(self, slot: int, fence: int) -> None:
        """Adopt a higher observed fence (grant refusals, fenced-reject
        bodies, restored checkpoints).  Monotone: never lowers."""
        with self._lock:
            if fence > self._fences.get(slot, 0):
                self._fences[slot] = int(fence)
                held = self._held.get(slot)
                if held is not None and held["fence"] < fence:
                    # a successor holds a higher fence: our lease is
                    # dead regardless of its clock expiry
                    del self._held[slot]

    def fences_snapshot(self) -> Dict[int, int]:
        """Checkpoint section: {slot: highest known fence}."""
        with self._lock:
            return dict(self._fences)

    def restore_fences(self, fences: Dict[int, int]) -> None:
        for slot, fence in fences.items():
            self.note_fence(int(slot), int(fence))

    # ---- voter side (POST /lease/grant lands here) ----

    def grant(self, slot: int, holder: str, fence: int,
              ttl: float) -> Dict:
        """Decide one grant request.  Returns the wire verdict:
        ``{"granted": bool, "fence": highest known, "holder": ...}`` —
        a refusal is LOUD, naming the blocking fence/holder so the
        proposer adopts it instead of retrying blind."""
        slot, fence = int(slot), int(fence)
        now = self.clock()
        with self._lock:
            known = self._fences.get(slot, 0)
            cur = self._granted.get(slot)
            if cur is not None and cur["expires"] <= now:
                cur = None  # expired grant no longer blocks anyone
                self._granted.pop(slot, None)
            if fence < known or (fence == known and
                                 (cur is None or cur["holder"] != holder)):
                # a fence this high is already known held (or burned)
                # elsewhere: granting would allow two holders per epoch
                return {"granted": False, "fence": known,
                        "holder": cur["holder"] if cur else None}
            if cur is not None and cur["holder"] != holder:
                # unexpired lease granted to someone else: the proposer
                # must wait it out (no handoff without expiry)
                return {"granted": False, "fence": known,
                        "holder": cur["holder"]}
            self._granted[slot] = {"holder": holder, "fence": fence,
                                   "expires": now + float(ttl)}
            self._fences[slot] = max(known, fence)
            return {"granted": True, "fence": self._fences[slot],
                    "holder": holder}

    # ---- coordinator side ----

    def held_fence(self, slot: int) -> Optional[int]:
        """The fence of an unexpired lease this node holds, else None
        (emitting ``lease_expire`` the first time expiry is observed)."""
        now = self.clock()
        with self._lock:
            held = self._held.get(slot)
            if held is None:
                return None
            if held["expires"] <= now:
                del self._held[slot]
                # trace-joined (current_trace is bound inside a CAS
                # span): an expiry observed mid-request lands in that
                # request's assembled trace, not as an orphan instant
                self.events.emit("lease_expire", trace=current_trace(),
                                 slot=slot, fence=held["fence"])
                return None
            return held["fence"]

    def ensure(self, slot: int) -> Optional[int]:
        """Hold a valid lease on ``slot``: fast-path an unexpired one
        (renewing through the quorum once past half-life), else acquire
        ``highest known fence + 1`` from a quorum.  Returns the fence,
        or None when no quorum would grant (the caller 503s loudly —
        this method emits no unavailability event so the plane's 1:1
        event audit stays intact)."""
        now = self.clock()
        fence = self.held_fence(slot)
        if fence is not None:
            with self._lock:
                expires = self._held[slot]["expires"]
            if now < expires - self.duration / 2:
                return fence
            # past half-life: renew (same fence) through the quorum;
            # a failed renewal keeps the current lease until expiry
            if self._quorum_round(slot, fence, renewal=True):
                # the quorum re-extended its grants to now+ttl: extend
                # the held lease to match, else it would lapse at the
                # ORIGINAL ttl and burn a fence epoch per duration
                with self._lock:
                    held = self._held.get(slot)
                    if held is not None and held["fence"] == fence:
                        held["expires"] = self.clock() + self.duration
                self.events.emit("lease_renew", trace=current_trace(),
                                 slot=slot, fence=fence,
                                 holder=self.own_url)
                self.metrics.inc("lease_renewals")
            return fence
        proposed = self.fence_of(slot) + 1
        if not self._quorum_round(slot, proposed, renewal=False):
            # refusals teach (note_fence above): if a voter named a
            # higher fence, retry ONCE immediately above it — a fresh
            # coordinator behind on fence gossip recovers in one round.
            # A second refusal means a live competing holder, which only
            # expiry can clear: refuse loudly instead of spinning.
            taught = self.fence_of(slot) + 1
            if taught <= proposed:
                return None
            proposed = taught
            if not self._quorum_round(slot, proposed, renewal=False):
                return None
        with self._lock:
            self._held[slot] = {"fence": proposed,
                                "expires": self.clock() + self.duration}
            self._fences[slot] = max(self._fences.get(slot, 0), proposed)
        self.events.emit("lease_grant", trace=current_trace(), slot=slot,
                         fence=proposed, holder=self.own_url)
        self.metrics.inc("lease_grants")
        return proposed

    def _quorum_round(self, slot: int, fence: int, *,
                      renewal: bool) -> bool:
        """One grant/renewal round: self-vote + sequential peer votes in
        peer-list order (deterministic under a fault schedule, like the
        plane's quorum collection).  Adopts any higher fence a
        refusal names.  True when votes reach the majority quorum."""
        peers = self._peers()
        q = len(peers) // 2 + 1  # majority of (peers + self)
        own = self.grant(slot, self.own_url, fence, self.duration)
        if not own["granted"]:
            self.note_fence(slot, own["fence"])
            return False
        acks = 1
        for p in peers:
            if acks >= q:
                break
            if p.backed_off():
                continue
            got = p.lease_grant(slot=slot, holder=self.own_url,
                                fence=fence, ttl=self.duration)
            if got is None:
                continue  # transport failure: a missing vote
            if got.get("granted"):
                acks += 1
            else:
                self.note_fence(slot, int(got.get("fence") or 0))
        if acks < q:
            if renewal:
                self.metrics.inc("lease_renew_failures")
            return False
        return True

    # ---- replica side (POST /push fence check) ----

    def check_push_fences(self, fences: Dict[int, int],
                          trace: Optional[str] = None) -> Optional[Dict]:
        """Validate a push's fence stamps BEFORE merging.  Returns None
        when every stamp is current (higher stamps are adopted), else
        ``{"slot": s, "fence": known}`` for the first stale stamp — the
        handler refuses the whole push with that body, emits
        ``cas_fenced_reject``, and merges nothing (zombie-coordinator
        firewall).  ``trace`` is the pushing coordinator's CAS trace id
        (rode the /push body), so the reject joins that request's
        assembled trace across the process boundary."""
        for slot, fence in sorted(fences.items()):
            slot, fence = int(slot), int(fence)
            known = self.fence_of(slot)
            if fence < known:
                self.metrics.inc("cas_fenced_rejects")
                self.events.emit("cas_fenced_reject", trace=trace,
                                 slot=slot, fence=fence, known=known)
                return {"slot": slot, "fence": known}
            self.note_fence(slot, fence)
        return None

    # ---- gauges (obs/health.sample_leases) ----

    def slot_states(self) -> Dict[int, Dict[str, int]]:
        """Scrape-fresh per-slot view: {slot: {"state": LEASE_STATE
        value, "fence": highest known}}.  "expired" marks a lease this
        node held that lapsed without handoff (zombie risk window)."""
        now = self.clock()
        out: Dict[int, Dict[str, int]] = {}
        with self._lock:
            for slot in range(self.n_slots):
                held = self._held.get(slot)
                if held is None:
                    state = LEASE_STATE["follower"]
                elif held["expires"] <= now:
                    state = LEASE_STATE["expired"]
                else:
                    state = LEASE_STATE["held"]
                out[slot] = {"state": state,
                             "fence": self._fences.get(slot, 0)}
        return out
