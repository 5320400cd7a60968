"""Cross-process networking: the host-level distributed runtime (own copy
of ``crdt_tpu.api.net``), each replica's log on the CUDA card.

The reference "distributes" by running every replica in one OS process and
gossiping over loopback HTTP (its main.go:226-267, 316-323).  This module
runs replicas in different processes (or hosts) gossiping over the same
wire surface:

* ``RemotePeer``: the HTTP client of a peer's surface (a port or JAX
  ``NodeHost``, or the original Go server: the wire format is the
  reference's JSON op-log dump, main.go:159), with a per-peer circuit
  breaker;
* ``NetworkAgent``: the anti-entropy pull loop of one local ReplicaNode
  and its siblings over a list of peer URLs (the goroutine at
  main.go:226-261, with delta gossip, quarantine of malformed payloads,
  the compaction, stability and sibling barriers, and the audit
  watchdog);
* ``NodeHost``: one replica, its siblings, its HTTP endpoint, its agent
  and its checkpoints: the standalone deployment unit
  (``python -m crdt_tpu_torch --daemon``).

Gossip payloads carry raw strings and absolute-ms wire keys
(:mod:`crdt_tpu_torch.api.node`), so peers never share an interner or an
epoch, and a port daemon and a JAX daemon gossip with each other.
Writer-id ranges must be disjoint across processes.

Each daemon is its own process with its own CUDA context and its own
``device_lock``: the card time-slices between the processes' contexts,
and nothing serializes merges across processes (as nothing does in the
JAX package).

Not ported: the keyspace, lease and CAS legs of ``RemotePeer`` and the
keyspace pulls, GC and resharding of ``NetworkAgent`` (ROADMAP Queue 1
item 3); they raise, and ``ks_pull`` is a no-op as in the JAX package
without a keyspace.
"""
from __future__ import annotations

import json
import os
import random
import sys
import threading
import time
import urllib.error
import urllib.parse
import urllib.request
from concurrent.futures import ThreadPoolExecutor
from http.server import ThreadingHTTPServer
from typing import Any, Dict, List, Optional, Tuple

import torch

from crdt_tpu_torch import default_device
from crdt_tpu_torch.api.node import (
    ReplicaNode,
    fused_pull_round,
    pull_round,
    stable_frontier_host,
)
from crdt_tpu_torch.consistency.stability import (
    STABILITY_HEADER,
    StabilityTracker,
    decode_summary,
)
from crdt_tpu_torch.obs.audit import AuditWatchdog
from crdt_tpu_torch.obs.events import EventLog
from crdt_tpu_torch.obs.trace import TRACE_HEADER, mint_trace_id
from crdt_tpu_torch.utils.config import ClusterConfig
from crdt_tpu_torch.utils.metrics import Metrics

TIER_NOT_PORTED = "the keyspace and lease tier is not ported (ROADMAP Queue 1 item 3)"

# RemotePeer circuit-breaker states (exposed as the
# net_peer_circuit_state gauge: 0 / 1 / 2 in this order)
CIRCUIT_CLOSED = "closed"
CIRCUIT_HALF_OPEN = "half_open"
CIRCUIT_OPEN = "open"


class RemotePeer:
    """Client for one peer's reference-surface HTTP endpoint."""

    def __init__(self, url: str, timeout: float = 5.0,
                 backoff_base_s: float = 0.5, backoff_cap_s: float = 30.0,
                 failure_threshold: int = 1,
                 rng: Optional[random.Random] = None,
                 clock=None):
        self.url = url.rstrip("/")
        self.timeout = timeout
        # None = unknown, False = peer 404'd /set/gossip (an original
        # reference peer: main.go serves no /set surface), True = seen
        # serving it.  Mixed fleets stop re-probing Go peers every round
        # and the outage metrics stay truthful.
        self.serves_set: Optional[bool] = None
        self.serves_seq: Optional[bool] = None  # same, for /seq/gossip
        self.serves_map: Optional[bool] = None  # same, for /map/gossip
        self.serves_composite: Optional[bool] = None  # /composite/gossip
        # per-peer circuit breaker over TRANSPORT failures (connection
        # refused, socket timeout: the peer's process or network is gone):
        # after ``failure_threshold`` consecutive failures the breaker
        # OPENS and the peer is skipped, so one unreachable peer cannot
        # stall every round at full timeout.  The skip window uses
        # DECORRELATED JITTER, min(cap, U(base, 3*prev)), so a fleet's
        # agents do not re-probe a revived peer in lockstep.  An expired
        # window admits exactly one HALF-OPEN probe: success closes the
        # breaker, failure re-opens it with a fresh window.  A peer that
        # answers with ANY HTTP status, the dead-node 502 included,
        # closes the breaker at once: it costs the round almost nothing
        # and may revive at any moment.
        self.backoff_base_s = backoff_base_s
        self.backoff_cap_s = backoff_cap_s
        self.failure_threshold = max(1, failure_threshold)
        self.failures = 0
        self.retry_at = 0.0  # time.monotonic() deadline; 0 = available
        # injectable randomness and clock: agents seed the rng per
        # (seed, url) so pinned soaks replay their jitter; tests pin the
        # half-open transition with a manual clock
        self._rng = rng if rng is not None else random.Random()
        self._now = clock if clock is not None else time.monotonic
        self._delay = 0.0  # previous jittered window (decorrelation state)
        self._state = CIRCUIT_CLOSED
        # breaker state is written from the fused-pull and barrier
        # executor threads AND read by the agent loop: a torn
        # failures/retry_at pair would mint a bogus backoff window
        self._backoff_lock = threading.Lock()
        # last X-CRDT-Stability response header captured by _get (raw
        # string, decoded lazily by take_stability)
        self._stability_lock = threading.Lock()
        self._stability_raw: Optional[str] = None
        # last HTTP error status and body captured by _get (the GET path
        # discards non-200 statuses); pop semantics via take_http_error,
        # like the stability slot
        self._http_err_lock = threading.Lock()
        self._http_err: Optional[Tuple[int, Optional[dict]]] = None

    def _note_reachable(self) -> None:
        with self._backoff_lock:
            self.failures = 0
            self.retry_at = 0.0
            self._delay = 0.0
            self._state = CIRCUIT_CLOSED

    def _note_transport_failure(self) -> None:
        with self._backoff_lock:
            self.failures += 1
            if (self._state == CIRCUIT_HALF_OPEN
                    or self.failures >= self.failure_threshold):
                prev = self._delay if self._delay > 0 else self.backoff_base_s
                self._delay = min(
                    self.backoff_cap_s,
                    self._rng.uniform(self.backoff_base_s, prev * 3.0),
                )
                self.retry_at = self._now() + self._delay
                self._state = CIRCUIT_OPEN

    def backed_off(self) -> bool:
        """True while the breaker forbids traffic this round.  An OPEN
        breaker past its jittered deadline transitions to HALF-OPEN here
        and admits the observing caller as its single probe; every other
        caller keeps getting True until the probe resolves through
        _note_reachable (close) or _note_transport_failure (re-open)."""
        with self._backoff_lock:
            if self._state == CIRCUIT_CLOSED:
                return False
            if self._state == CIRCUIT_OPEN:
                if self._now() < self.retry_at:
                    return True
                self._state = CIRCUIT_HALF_OPEN
                return False  # this caller IS the half-open probe
            return True  # HALF_OPEN: a probe is already in flight

    def backoff_peek(self) -> bool:
        """``backed_off()`` without the probe side effect: True while the
        breaker currently forbids traffic, with NO state transition.
        Passive observers (gauges) must use this: ``backed_off()`` admits
        the observing caller as the single half-open probe, and a caller
        that checks without then sending wedges the breaker in HALF_OPEN
        forever."""
        with self._backoff_lock:
            if self._state == CIRCUIT_CLOSED:
                return False
            if self._state == CIRCUIT_OPEN:
                return self._now() < self.retry_at
            return True  # HALF_OPEN: the probe is still in flight

    def circuit_state(self) -> str:
        """The breaker's current state name (obs gauge + tests)."""
        with self._backoff_lock:
            return self._state

    def failure_count(self) -> int:
        """Transport-failure count, read under the backoff lock (writers
        run on gossip/fetch threads; observers must not read it bare)."""
        with self._backoff_lock:
            return self.failures

    def take_stability(self) -> Optional[Dict[str, Any]]:
        """Pop the last captured stability summary ({rid, vv, frontier}
        with int keys), or None when no response since the previous take
        carried one.  Pop semantics keep a redelivered/stalled round from
        double-counting an old capture; garbage headers decode to None
        (same skip posture as _parse)."""
        with self._stability_lock:
            raw, self._stability_raw = self._stability_raw, None
        return decode_summary(raw)

    def take_http_error(self) -> Optional[Tuple[int, Optional[dict]]]:
        """Pop the (status, parsed-body) of the last HTTP error a _get
        observed, or None."""
        with self._http_err_lock:
            got, self._http_err = self._http_err, None
        return got

    def _get(self, path: str,
             headers: Optional[Dict[str, str]] = None) -> Optional[bytes]:
        req = urllib.request.Request(self.url + path, headers=headers or {})
        try:
            with urllib.request.urlopen(req, timeout=self.timeout) as res:
                body = res.read() if res.status == 200 else None
                stab = res.headers.get(STABILITY_HEADER)
                if stab is not None:
                    with self._stability_lock:
                        self._stability_raw = stab
        except urllib.error.HTTPError as e:
            self._note_reachable()  # served an error status: peer is UP
            try:
                parsed = json.loads(e.read())
            except (ValueError, OSError):
                parsed = None
            with self._http_err_lock:
                self._http_err = (
                    e.code, parsed if isinstance(parsed, dict) else None)
            return None
        except (urllib.error.URLError, OSError):
            self._note_transport_failure()
            return None  # unreachable peer: caller skips (main.go:235-239)
        self._note_reachable()
        return body

    def _post(self, path: str, body: dict) -> bool:
        req = urllib.request.Request(
            self.url + path,
            data=json.dumps(body).encode(),
            headers={"Content-Type": "application/json"},
            method="POST",
        )
        try:
            with urllib.request.urlopen(req, timeout=self.timeout) as res:
                ok = res.status == 200
        except urllib.error.HTTPError:
            self._note_reachable()
            return False
        except (urllib.error.URLError, OSError):
            self._note_transport_failure()
            return False
        self._note_reachable()
        return ok

    def ping(self) -> bool:
        """GET /ping (main.go:115-127)."""
        return self._get("/ping") is not None

    def metrics_text(self) -> Optional[str]:
        """GET /metrics as raw Prometheus text; rides the breaker like
        every other call, so a partitioned member is skipped, not hung
        on."""
        body = self._get("/metrics")
        return None if body is None else body.decode("utf-8", "replace")

    @staticmethod
    def _parse(body: Optional[bytes]):
        """Decode a peer response; a peer serving corrupt bytes is treated
        like an unreachable one (skip this round, try again later): one
        bad peer must not kill the pull loop, as one killed the
        reference's.  Malformed *content* inside valid JSON (bad wire
        keys) is the pull round's to quarantine."""
        if body is None:
            return None
        try:
            parsed = json.loads(body)
        except ValueError:
            return None
        # every endpoint consumed returns a JSON OBJECT; a 200 carrying
        # '"Service Unavailable"', 'null', '[]' (a proxy in front of a
        # dead peer) is structurally corrupt and takes the same skip path
        return parsed if isinstance(parsed, dict) else None

    def get_state(self) -> Optional[Dict[str, str]]:
        """GET /data (main.go:129-139); None when down/unreachable."""
        return self._parse(self._get("/data"))

    def gossip_payload(
        self, since: Optional[Dict[int, int]] = None,
        trace: Optional[str] = None,
    ) -> Optional[Dict[str, Any]]:
        """GET /gossip (main.go:154-171); ``since`` = our version vector for
        delta gossip (?vv=...), None requests the full-log dump.  ``trace``
        rides the X-CRDT-Trace header so the serving node's event log
        records the round under the puller's trace ID."""
        path = "/gossip"
        if since is not None:
            vv = json.dumps({str(r): s for r, s in since.items()})
            path += "?vv=" + urllib.parse.quote(vv)
        headers = {TRACE_HEADER: trace} if trace else None
        return self._parse(self._get(path, headers=headers))

    def add_command(self, cmd: Dict[str, str]) -> bool:
        """POST /data (main.go:173-215)."""
        return self._post("/data", cmd)

    def post_page(self, raw: bytes) -> Dict[str, Any]:
        """POST /ingest/page: one packed columnar op page
        (:mod:`crdt_tpu_torch.ingest.wire`).  Returns the admission
        verdict:

          {"ok": True, "admitted": n, "dup": bool}: admitted
          {"ok": False, "shed": True, "retry_after": s}: 429, back off
              retry_after seconds and RESEND THE SAME PAGE (the
              per-origin page_seq watermark makes the retry idempotent)
          {"ok": False, "quarantined": True}: 400, a malformed page
          {"ok": False}: transport failure or node down
        """
        req = urllib.request.Request(
            self.url + "/ingest/page", data=raw,
            headers={"Content-Type": "application/octet-stream"},
            method="POST",
        )
        try:
            with urllib.request.urlopen(req, timeout=self.timeout) as res:
                body = res.read()
        except urllib.error.HTTPError as e:
            self._note_reachable()  # served an error status: peer is UP
            if e.code == 429:
                retry = e.headers.get("Retry-After")
                return {"ok": False, "shed": True,
                        "retry_after": float(retry) if retry else 0.05}
            return {"ok": False, "quarantined": e.code == 400}
        except (urllib.error.URLError, OSError):
            self._note_transport_failure()
            return {"ok": False}
        self._note_reachable()
        try:
            out = json.loads(body)
        except ValueError:
            return {"ok": False}
        return {"ok": True, "admitted": int(out.get("admitted", 0)),
                "dup": bool(out.get("dup", False))}

    def set_alive(self, alive: bool) -> bool:
        """GET /condition/<bool> (main.go:141-152, with the route fixed)."""
        return self._get(f"/condition/{str(bool(alive)).lower()}") is not None

    def version_vector(self):
        """GET /vv → ({rid: seq} received watermark, {rid: seq} folded
        frontier), or None when down/unreachable."""
        d = self._parse(self._get("/vv"))
        if d is None:
            return None
        return (
            {int(r): int(s) for r, s in (d.get("vv") or {}).items()},
            {int(r): int(s) for r, s in (d.get("frontier") or {}).items()},
        )

    def compact(self, frontier: Dict[int, int]) -> bool:
        """POST /compact: fold everything at or under ``frontier``."""
        return self._post(
            "/compact",
            {"frontier": {str(r): s for r, s in frontier.items()}},
        )

    # ---- the keyspace, lease and CAS legs: not ported ----

    def ks_gossip(self, *args, **kwargs):
        raise NotImplementedError(f"RemotePeer.ks_gossip: {TIER_NOT_PORTED}")

    def ks_compact(self, *args, **kwargs):
        raise NotImplementedError(f"RemotePeer.ks_compact: {TIER_NOT_PORTED}")

    def ks_migrate(self, *args, **kwargs):
        raise NotImplementedError(f"RemotePeer.ks_migrate: {TIER_NOT_PORTED}")

    def ks_reshard_admin(self, *args, **kwargs):
        raise NotImplementedError(f"RemotePeer.ks_reshard_admin: {TIER_NOT_PORTED}")

    def lease_grant(self, *args, **kwargs):
        raise NotImplementedError(f"RemotePeer.lease_grant: {TIER_NOT_PORTED}")

    def push_fenced(self, *args, **kwargs):
        raise NotImplementedError(f"RemotePeer.push_fenced: {TIER_NOT_PORTED}")

    def cas_forward(self, *args, **kwargs):
        raise NotImplementedError(f"RemotePeer.cas_forward: {TIER_NOT_PORTED}")
    def push_payload(self, payload: Dict[str, Any]) -> bool:
        """POST /push: hand the peer a gossip payload to merge NOW.  A
        200 means the peer merged it before answering, so its vv
        dominates every op the payload carried; built on _post, so it
        crosses the circuit breaker like every other leg."""
        return self._post("/push", {"payload": payload})

    # ---- extension-surface probe (shared by the sibling clients) ----

    def _probe_get(self, path: str, flag_attr: str):
        """_get plus surface detection: a 404 permanently marks the peer
        as lacking this surface (an original Go peer: main.go serves none
        of the siblings), a parsed 200 marks it as serving."""
        if getattr(self, flag_attr) is False:
            return None
        try:
            with urllib.request.urlopen(
                self.url + path, timeout=self.timeout
            ) as res:
                body = res.read() if res.status == 200 else None
        except urllib.error.HTTPError as e:
            self._note_reachable()  # served an error status: peer is UP
            if e.code == 404:
                setattr(self, flag_attr, False)
            return None
        except (urllib.error.URLError, OSError):
            self._note_transport_failure()
            return None
        self._note_reachable()
        out = self._parse(body)
        if out is not None:
            setattr(self, flag_attr, True)
        return out

    @staticmethod
    def _vv_query(path: str, since: Optional[Dict[int, int]]) -> str:
        if since is None:
            return path
        vv = json.dumps({str(r): s for r, s in since.items()})
        return path + "?vv=" + urllib.parse.quote(vv)

    # ---- set-lattice surface (crdt_tpu_torch.api.setnode) ----

    def set_gossip_payload(
        self, since: Optional[Dict[int, int]] = None
    ) -> Optional[Dict[str, Any]]:
        """GET /set/gossip (floor-carrying delta; full fallback)."""
        return self._probe_get(
            self._vv_query("/set/gossip", since), "serves_set"
        )

    def set_vv(self):
        """GET /set/vv → (vv, floor) or None when down/unreachable."""
        d = self._parse(self._get("/set/vv"))
        if d is None:
            return None
        return (
            {int(r): int(s) for r, s in (d.get("vv") or {}).items()},
            {int(r): int(s) for r, s in (d.get("floor") or {}).items()},
        )

    def set_collect(self, floor: Dict[int, int]) -> bool:
        """POST /set/collect: advance the GC floor (barrier fold)."""
        return self._post(
            "/set/collect",
            {"floor": {str(r): s for r, s in floor.items()}},
        )

    # ---- sequence-lattice surface (crdt_tpu_torch.api.seqnode) ----

    def seq_gossip_payload(
        self, since: Optional[Dict[int, int]] = None
    ) -> Optional[Dict[str, Any]]:
        """GET /seq/gossip (floor-carrying delta; full fallback)."""
        return self._probe_get(
            self._vv_query("/seq/gossip", since), "serves_seq"
        )

    def seq_vv(self):
        """GET /seq/vv → (vv, floor) or None when down/unreachable."""
        d = self._parse(self._get("/seq/vv"))
        if d is None:
            return None
        return (
            {int(r): int(s) for r, s in (d.get("vv") or {}).items()},
            {int(r): int(s) for r, s in (d.get("floor") or {}).items()},
        )

    def seq_collect(self, floor: Dict[int, int]) -> bool:
        """POST /seq/collect: advance the GC floor (barrier fold)."""
        return self._post(
            "/seq/collect",
            {"floor": {str(r): s for r, s in floor.items()}},
        )

    # ---- map-lattice surface (crdt_tpu_torch.api.mapnode) ----

    def map_gossip_payload(
        self, since: Optional[Dict[int, int]] = None
    ) -> Optional[Dict[str, Any]]:
        """GET /map/gossip (epoch-carrying delta; always valid)."""
        return self._probe_get(
            self._vv_query("/map/gossip", since), "serves_map"
        )

    def map_vv(self):
        """GET /map/vv → (vv, epochs) or None when down/unreachable."""
        d = self._parse(self._get("/map/vv"))
        if d is None:
            return None
        return (
            {int(r): int(s) for r, s in (d.get("vv") or {}).items()},
            {str(k): int(e) for k, e in (d.get("epochs") or {}).items()},
        )

    def map_reset(self, epochs: Dict[str, int]) -> bool:
        """POST /map/reset: adopt barrier-minted epochs."""
        return self._post(
            "/map/reset",
            {"epochs": {str(k): int(e) for k, e in epochs.items()}},
        )

    # ---- composite surface (crdt_tpu_torch.api.compositenode) ----

    def composite_gossip_payload(self) -> Optional[Dict[str, Any]]:
        """GET /composite/gossip: the full state dump.  State-based, so
        there is no ``since``/vv to carry (idempotent and monotone joins
        make duplicate and stale delivery no-ops)."""
        return self._probe_get("/composite/gossip", "serves_composite")


def network_compact(node: ReplicaNode, peers: List[RemotePeer]) -> Dict[int, int]:
    """One cross-daemon compaction barrier (the network analogue of
    LocalCluster.compact): agree on the swarm-stable frontier and tell every
    member to fold it.

    The frontier is the per-writer min over ALL members' version vectors:
    every member provably holds everything under it.  If ANY peer is
    unreachable the barrier is skipped (returns {}): an unseen member might
    lack ops under the candidate frontier, and (chain rule) its existing
    fold must stay dominated.  Run from ONE coordinator only: two
    concurrent coordinators could mint incomparable frontiers.

    A member that misses the /compact POST (a crash between the vv
    collection and the fold) catches up by adopting the frontier and
    summary sections from any folded peer's gossip payload
    (ReplicaNode._adopt_frontier_locked).
    """
    own_vv, own_frontier = node.vv_snapshot()
    vvs, frontiers = [own_vv], [own_frontier]
    with ThreadPoolExecutor(max_workers=max(len(peers), 1)) as pool:
        # per-peer calls are independent: collect concurrently so one slow
        # member costs one timeout, not N.  Drain ALL fetches before
        # judging: bailing out of map() mid-iteration would cancel the
        # not-yet-started ones and make the wire-call count a race
        collected = list(pool.map(lambda p: p.version_vector(), peers))
        if any(got is None for got in collected):
            return {}  # unreachable member: cannot prove stability
        for got in collected:
            vvs.append(got[0])
            frontiers.append(got[1])
        frontier = stable_frontier_host(vvs, frontiers)
        if not frontier:
            return {}
        node.compact(frontier)
        # a missed POST self-heals via gossip frontier adoption
        list(pool.map(lambda p: p.compact(frontier), peers))
    return frontier



class NetworkAgent:
    """Anti-entropy pull loop for one local node over peer URLs.

    ``gossip_once`` = one pull round (random peer, delta payload, merge);
    ``start``/``stop`` run it every ``gossip_period_ms`` in a daemon thread.
    Failures of individual pulls are skipped (the reference's 502 path);
    failures of the *loop* are recorded and re-raised by ``stop()`` (the
    reference's loop died silently forever on one bad payload).  The
    keyspace tier's pulls and GC are not ported: ``keyspace`` must be
    None, and ``ks_pull`` is then a no-op, as in the JAX package.
    """

    def __init__(
        self,
        node: ReplicaNode,
        peer_urls: List[str],
        config: Optional[ClusterConfig] = None,
        metrics: Optional[Metrics] = None,
        seed: Optional[int] = None,
        coordinator: bool = False,
        set_node=None,
        seq_node=None,
        map_node=None,
        composite_node=None,
        keyspace=None,
    ):
        if keyspace is not None:
            raise NotImplementedError(f"NetworkAgent(keyspace=): {TIER_NOT_PORTED}")
        self.node = node
        self.set_node = set_node  # optional SetNode sibling: pulled together
        self.seq_node = seq_node  # optional SeqNode sibling: pulled together
        self.map_node = map_node  # optional MapNode sibling: pulled together
        # optional algebra-derived composite sibling (compositenode.py):
        # pulled together, but state-based; fused rounds fold its k peer
        # payloads in ONE extra merge (_composite_pull_fused)
        self.composite_node = composite_node
        self.config = config or ClusterConfig()
        self.peers = [
            RemotePeer(
                u,
                timeout=self.config.peer_timeout_s,
                backoff_base_s=self.config.peer_backoff_base_s,
                backoff_cap_s=self.config.peer_backoff_cap_s,
                failure_threshold=self.config.peer_failure_threshold,
                # per-(seed, url) jitter rng: decorrelated across the
                # fleet's agents, replayable under a pinned seed
                rng=random.Random(f"{self.config.seed}:{u}"),
            )
            for u in peer_urls
        ]
        self.metrics = metrics or node.metrics
        # compaction-barrier scheduler: exactly ONE agent in the fleet may
        # coordinate (see network_compact's single-scheduler rule)
        self.coordinator = coordinator
        # stability bookkeeping (consistency.stability): fed from the
        # X-CRDT-Stability headers the pull paths capture; only the
        # coordinator mints and pushes frontiers, but every node tracks
        # (the lag gauges are fleet-wide facts)
        self.stability = StabilityTracker(
            node, [p.url for p in self.peers],
            max_staleness=self.config.stability_max_staleness_s,
            events=node.events,
        )
        # the live divergence audit (obs.audit): a gossiping agent IS the
        # deployment, so it digests the plane it serves and watches the
        # digests peers piggyback back
        node.enable_audit()
        self.watchdog = AuditWatchdog(node, stability=self.stability)
        self._rng = random.Random(self.config.seed if seed is None else seed)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # gossip-loop failures: appended from the loop thread, read by
        # stop() on the caller's thread — lock both sides
        self._err_lock = threading.Lock()
        self.errors: List[Exception] = []

    def gossip_once(self) -> bool:
        """One pull round from a random peer: the KV log and (when both
        ends serve them) the sibling lattices.  Returns whether the KV
        pull merged anything; the siblings report through their own
        *_gossip_* metrics (/admin/pull's {"pulled"} and the soak's pulls
        counter are KV facts).  With ``config.fuse_pull_k > 1`` the round
        instead pulls k distinct peers concurrently and merges them in
        one device merge (_gossip_once_fused); peers inside a
        transport-failure backoff window are skipped either way."""
        if not self.peers:
            self.metrics.inc("net_gossip_skipped")
            return False
        avail = self._available_peers()
        if not avail:
            self.metrics.inc("net_gossip_skipped")
            return False
        if min(self.config.fuse_pull_k, len(avail)) > 1:
            return self._gossip_once_fused(avail)
        peer = self._rng.choice(avail)
        merged = self.pull_from(peer)
        self.set_pull(peer)
        self.seq_pull(peer)
        self.map_pull(peer)
        self.composite_pull(peer)
        self.ks_pull(peer)
        return merged

    def pull_from(self, peer: RemotePeer) -> bool:
        """One KV pull round from a SPECIFIC peer client.  Malformed
        payloads are QUARANTINED (event and metric, round skipped, nothing
        merged) instead of killing the gossip loop: one corrupt peer must
        degrade, not destroy, this node's anti-entropy."""
        tid = mint_trace_id(self.node.rid)

        def fetch(since):
            # timed apart from the merge: the fetch half of a round is
            # network wall time
            with self.metrics.timer("net_fetch"):
                return peer.gossip_payload(since, trace=tid)

        merged = pull_round(
            self.node,
            fetch,
            self.metrics,
            delta=self.config.delta_gossip,
            prefix="net_gossip",
            peer=peer.url,
            trace=tid,
            quarantine=True,
        )
        self._note_stability(peer)
        return merged

    def _note_stability(self, peer: RemotePeer) -> None:
        """Feed the tracker (and the watchdog, the digest) any stability
        summary the round's responses piggybacked (no summary: no-op; the
        tracker's staleness rule handles silent peers).  Duck-typed: a
        peer shim that captures no headers never feeds the tracker."""
        take = getattr(peer, "take_stability", None)
        s = take() if take is not None else None
        if s is not None:
            self.stability.note(peer.url, s["vv"], s["frontier"])
            dig = s.get("digest")
            if dig is not None:
                self.watchdog.note_host(peer.url, s["frontier"], dig)

    def _available_peers(self) -> List[RemotePeer]:
        """Peers not inside a transport-failure backoff window.  Skips are
        LOUD: each backed-off peer counts one ``net_peer_backoff_skips``
        a round and an event (the reference instead repaid the connect
        timeout of every unreachable friend every 1500 ms,
        main.go:235-239)."""
        avail = []
        for p in self.peers:
            if p.backed_off():
                self.metrics.inc("net_peer_backoff_skips")
                self.node.events.emit("peer_backoff_skip", peer=p.url,
                                      failures=p.failure_count(),
                                      circuit=p.circuit_state())
            else:
                avail.append(p)
        return avail

    def _gossip_once_fused(self, avail: List[RemotePeer]) -> bool:
        """One k-way fused pull round (config.fuse_pull_k > 1): fetch up to
        k distinct peers' delta payloads CONCURRENTLY against one pre-round
        version vector, then merge every response in one device merge
        (fused_pull_round → ReplicaNode.receive_many).  The set, seq and
        map siblings pull per responding peer afterwards; the composite
        folds its k payloads in one merge."""
        if not self.node.alive:
            # match pull_round's dead-self accounting without fetching
            return fused_pull_round(self.node, [], self.metrics,
                                    delta=self.config.delta_gossip,
                                    prefix="net_gossip")
        k = min(self.config.fuse_pull_k, len(avail))
        peers = self._rng.sample(avail, k)
        tid = mint_trace_id(self.node.rid)
        since = self.node.version_vector() if self.config.delta_gossip else None
        with ThreadPoolExecutor(max_workers=k) as pool:
            payloads = list(pool.map(
                lambda p: p.gossip_payload(since, trace=tid), peers))
        merged = fused_pull_round(
            self.node,
            [(p.url, body) for p, body in zip(peers, payloads)],
            self.metrics,
            delta=self.config.delta_gossip,
            prefix="net_gossip",
            trace=tid,
            quarantine=True,
        )
        responding = [p for p, body in zip(peers, payloads) if body is not None]
        for peer in peers:
            # fused rounds feed the tracker too: the headers rode the
            # same concurrent fetches
            self._note_stability(peer)
        for peer in responding:
            # unreachable-this-round peers are skipped: the timeout is not
            # paid twice
            self.set_pull(peer)
            self.seq_pull(peer)
            self.map_pull(peer)
            self.ks_pull(peer)
        # the composite's k payloads fold in one merge, keeping the fused
        # round at one merge per lattice
        self._composite_pull_fused(responding)
        return merged

    def set_pull(self, peer: RemotePeer) -> bool:
        """One set-lattice pull from ``peer`` (no-op without a set node).
        Always delta-requested: the sender itself decides when a full
        payload is needed (the floor-validity rule, setnode.gossip_payload).
        Peers known to lack the /set surface (original Go peers, 404) are
        counted under set_gossip_unsupported, not as outages."""
        sn = self.set_node
        if sn is None or not sn.alive:
            return False
        payload = peer.set_gossip_payload(since=sn.version_vector())
        if payload is None:
            self.metrics.inc(
                "set_gossip_unsupported" if peer.serves_set is False
                else "set_gossip_skipped"
            )
            return False
        fresh = self._receive_quarantined(sn, payload, "set_gossip", peer)
        self.metrics.inc("set_gossip_rounds" if fresh else "set_gossip_noop")
        return fresh > 0

    def _receive_quarantined(self, lattice, payload, prefix: str,
                             peer: RemotePeer) -> int:
        """Merge one sibling-lattice payload, quarantining a malformed
        body: the round is skipped loudly (``{prefix}_quarantined`` and a
        ``payload_quarantine`` event) and the loop lives on."""
        try:
            return lattice.receive(payload)
        except (ValueError, KeyError, TypeError, AttributeError) as e:
            self.metrics.inc(f"{prefix}_quarantined")
            self.node.events.emit(
                "payload_quarantine", surface=prefix, peer=peer.url,
                error=f"{type(e).__name__}: {e}"[:200],
            )
            return 0

    def seq_pull(self, peer: RemotePeer) -> bool:
        """One sequence-lattice pull from ``peer`` (no-op without a seq
        node) — the seq sibling of set_pull, same delta-request and
        404-skip rules."""
        qn = self.seq_node
        if qn is None or not qn.alive:
            return False
        payload = peer.seq_gossip_payload(since=qn.version_vector())
        if payload is None:
            self.metrics.inc(
                "seq_gossip_unsupported" if peer.serves_seq is False
                else "seq_gossip_skipped"
            )
            return False
        fresh = self._receive_quarantined(qn, payload, "seq_gossip", peer)
        self.metrics.inc("seq_gossip_rounds" if fresh else "seq_gossip_noop")
        return fresh > 0

    def ks_pull(self, peer: RemotePeer) -> int:
        """The keyspace pull round: a no-op returning 0 fresh ops, as in
        the JAX package while ``keyspace`` is None (the tier is not
        ported)."""
        return 0

    def start(self) -> None:
        self._stop.clear()
        with self._err_lock:
            self.errors.clear()  # a restart begins a fresh failure record
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
        with self._err_lock:
            first = self.errors[0] if self.errors else None
        if first is not None:
            raise RuntimeError("network gossip loop died") from first

    def compact_once(self) -> dict:
        """Run one cross-daemon compaction barrier from this agent (must be
        the fleet's single coordinator).  A dead coordinator schedules
        nothing (GET /vv and POST /compact 502 when dead)."""
        if not self.node.alive:
            self.metrics.inc("net_compact_skipped")
            return {}
        frontier = network_compact(self.node, self.peers)
        self.metrics.inc(
            "net_compactions" if frontier else "net_compact_skipped"
        )
        return frontier

    def stability_gc_once(self, step: Optional[int] = None) -> dict:
        """One fleet-coordinated GC round from the piggybacked stability
        frontier (coordinator only, network_compact's single-scheduler
        rule).

        Unlike compact_once this costs NO vv-collection round trips: the
        frontier is minted from summaries that rode earlier gossip
        responses.  A stalled tracker (a missing or stale member) skips
        the round loudly; a successful mint folds locally, then pushes
        POST /compact to every peer in peer-list order, and a peer that
        misses the POST heals by adopting the frontier from any folded
        peer's gossip payload."""
        if not self.node.alive:
            self.metrics.inc("stability_gc_skipped")
            return {}
        frontier = self.stability.mint(step=step)
        if not frontier:
            self.metrics.inc("stability_gc_skipped")
            return {}
        self.node.compact(frontier)
        for p in self.peers:
            if not p.backed_off():
                p.compact(frontier)
        self.metrics.inc("stability_gc_rounds")
        self.node.events.emit(
            "stability_gc",
            frontier={str(r): s for r, s in frontier.items()},
            members=len(self.peers) + 1,
        )
        return frontier

    def set_collect_once(self) -> dict:
        """One cross-daemon set GC barrier (coordinator only): agree on the
        stable floor over every member's set vv (chain-ruled against every
        existing floor) and tell everyone to collect it.  Skipped (returns
        {}) when any member is unreachable (stability cannot be proven
        without it, network_compact's rule).  A member that misses the
        POST catches up by adopting the floor from any collected peer's
        payload."""
        from crdt_tpu_torch.api import setnode as setnode_mod

        sn = self.set_node
        if sn is None or not sn.alive:
            self.metrics.inc("set_collect_skipped")
            return {}
        with ThreadPoolExecutor(max_workers=max(len(self.peers), 1)) as pool:
            got = list(pool.map(lambda p: p.set_vv(), self.peers))
            floor = setnode_mod.set_barrier(sn, got)
            if not floor:
                self.metrics.inc("set_collect_skipped")
                return {}
            sn.collect(floor)
            list(pool.map(lambda p: p.set_collect(floor), self.peers))
        self.metrics.inc("set_collections_scheduled")
        return floor

    def seq_collect_once(self) -> dict:
        """One swarm-wide sequence GC barrier (coordinator only): agree on
        the stable floor over every member's /seq/vv and tell everyone to
        collect it (the seq sibling of set_collect_once, the same
        skip-on-unreachable rule)."""
        from crdt_tpu_torch.api import seqnode as seqnode_mod

        qn = self.seq_node
        if qn is None or not qn.alive:
            self.metrics.inc("seq_collect_skipped")
            return {}
        with ThreadPoolExecutor(max_workers=max(len(self.peers), 1)) as pool:
            got = list(pool.map(lambda p: p.seq_vv(), self.peers))
            floor = seqnode_mod.seq_barrier(qn, got)
            if not floor:
                self.metrics.inc("seq_collect_skipped")
                return {}
            qn.collect(floor)
            list(pool.map(lambda p: p.seq_collect(floor), self.peers))
        self.metrics.inc("seq_collections_scheduled")
        return floor

    def map_pull(self, peer: RemotePeer) -> bool:
        """One map-lattice pull from ``peer`` (no-op without a map node):
        the map sibling of set_pull; epoch-carrying deltas are always
        valid, so there is no full-payload mode to negotiate."""
        mn = self.map_node
        if mn is None or not mn.alive:
            return False
        payload = peer.map_gossip_payload(since=mn.version_vector())
        if payload is None:
            self.metrics.inc(
                "map_gossip_unsupported" if peer.serves_map is False
                else "map_gossip_skipped"
            )
            return False
        fresh = self._receive_quarantined(mn, payload, "map_gossip", peer)
        self.metrics.inc("map_gossip_rounds" if fresh else "map_gossip_noop")
        return fresh > 0

    def composite_pull(self, peer: RemotePeer) -> bool:
        """One composite-lattice pull from ``peer`` (no-op without a
        composite node): the algebra sibling of map_pull, minus the vv;
        the payload is the peer's full state and the merge is the
        REGISTERED ``mapof(pncounter)`` join."""
        cn = self.composite_node
        if cn is None or not cn.alive:
            return False
        payload = peer.composite_gossip_payload()
        if payload is None:
            self.metrics.inc(
                "composite_gossip_unsupported"
                if peer.serves_composite is False
                else "composite_gossip_skipped"
            )
            return False
        fresh = self._receive_quarantined(cn, payload, "composite_gossip",
                                          peer)
        self.metrics.inc(
            "composite_gossip_rounds" if fresh else "composite_gossip_noop")
        if fresh:
            # composite merges land in the node's event stream
            self.node.events.emit(
                "composite_merge", peer=peer.url, n_payloads=1,
                keys=len(cn.keys),
            )
        return fresh > 0

    def _composite_pull_fused(self, peers: List[RemotePeer]) -> bool:
        """The composite leg of a k-way fused round: fetch every responding
        peer's state concurrently, decode each (per-peer quarantine), then
        fold ALL of them into the local state in ONE merge
        (CompositeNode.merge_decoded)."""
        cn = self.composite_node
        if cn is None or not cn.alive or not peers:
            return False
        with ThreadPoolExecutor(max_workers=len(peers)) as pool:
            payloads = list(pool.map(
                lambda p: p.composite_gossip_payload(), peers))
        decoded = []
        for peer, payload in zip(peers, payloads):
            if payload is None:
                self.metrics.inc(
                    "composite_gossip_unsupported"
                    if peer.serves_composite is False
                    else "composite_gossip_skipped"
                )
                continue
            try:
                decoded.append(cn.decode(payload))
            except (ValueError, KeyError, TypeError, AttributeError) as e:
                self.metrics.inc("composite_gossip_quarantined")
                self.node.events.emit(
                    "payload_quarantine", surface="composite_gossip",
                    peer=peer.url, error=f"{type(e).__name__}: {e}"[:200],
                )
        if not decoded:
            return False
        fresh = cn.merge_decoded(decoded)
        self.metrics.inc(
            "composite_gossip_rounds" if fresh else "composite_gossip_noop")
        if fresh:
            self.node.events.emit(
                "composite_merge", peer="fused", n_payloads=len(decoded),
                keys=len(cn.keys),
            )
        return fresh > 0

    def map_reset_once(self):
        """One cross-daemon map RESET barrier (coordinator only): the
        full-fleet rule of ormap_gc.reset_barrier over the network.  (1)
        every member must be reachable, else skip; (2) pull every member's
        contributions into the coordinator's node; (3) verify the
        coordinator's vv dominates every member's; (4) mint the reset
        locally and push the new epochs (a member that misses the push
        adopts them from any peer's next payload).

        Returns ``(epochs, status)``; status is "reset" (epochs minted),
        "noop" (fleet converged, nothing stably removed) or "skipped"
        (the full-fleet rule blocked)."""
        from crdt_tpu_torch.api import mapnode as mapnode_mod

        mn = self.map_node
        if mn is None or not mn.alive:
            self.metrics.inc("map_reset_skipped")
            return {}, "skipped"
        with ThreadPoolExecutor(max_workers=max(len(self.peers), 1)) as pool:
            # full-fleet reachability + fold everyone's contributions
            for peer, got in zip(self.peers,
                                 pool.map(lambda p: p.map_vv(), self.peers)):
                if got is None:
                    self.metrics.inc("map_reset_skipped")
                    return {}, "skipped"
                self.map_pull(peer)
            vvs = list(pool.map(lambda p: p.map_vv(), self.peers))
            if not mapnode_mod.map_barrier_ready(
                mn, [None if v is None else v[0] for v in vvs]
            ):
                # a member died or minted mid-barrier: try next round
                self.metrics.inc("map_reset_skipped")
                return {}, "skipped"
            epochs = mn.mint_reset()
            if not epochs:
                self.metrics.inc("map_reset_noop")
                return {}, "noop"
            list(pool.map(lambda p: p.map_reset(epochs), self.peers))
        self.metrics.inc("map_resets_scheduled")
        return epochs, "reset"

    def _loop(self) -> None:
        period = self.config.gossip_period_ms / 1000.0
        rounds = 0
        while not self._stop.wait(period):
            try:
                self.gossip_once()
                rounds += 1
                every = self.config.compact_every  # re-read: live reconfig
                if self.coordinator and every and rounds % every == 0:
                    self.compact_once()
                # set GC runs on its OWN cadence: KV compaction may be
                # forbidden (go-compat fleets) while set tables still need
                # their tombstones reclaimed
                sce = self.config.set_collect_every
                if self.coordinator and sce and rounds % sce == 0:
                    self.set_collect_once()
                qce = self.config.seq_collect_every
                if self.coordinator and qce and rounds % qce == 0:
                    self.seq_collect_once()
                mre = self.config.map_reset_every
                if self.coordinator and mre and rounds % mre == 0:
                    self.map_reset_once()
                sge = self.config.stability_gc_every
                if self.coordinator and sge and rounds % sge == 0:
                    self.stability_gc_once()
                # watchdog evaluators tick on EVERY node (divergence and
                # stall detection must not die with the coordinator)
                aee = self.config.audit_eval_every
                if aee and rounds % aee == 0:
                    self.watchdog.evaluate()
            except Exception as e:  # noqa: BLE001 — surfaced by stop()
                self.metrics.inc("net_gossip_loop_errors")
                with self._err_lock:
                    self.errors.append(e)
                raise



class _Server(ThreadingHTTPServer):
    """The daemon's HTTP server: a request handler that raised is recorded
    (a client that hung up is not a fault of the daemon) and re-raised by
    :meth:`NodeHost.stop`, so a device error inside a merge served on a
    handler thread cannot vanish with that thread."""


    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.errors: List[BaseException] = []
        self._errors_lock = threading.Lock()

    def handle_error(self, request, client_address) -> None:
        exc = sys.exc_info()[1]
        if isinstance(exc, ConnectionError):
            return
        with self._errors_lock:
            self.errors.append(exc)
        super().handle_error(request, client_address)


class NodeHost:
    """One replica, served and gossiping: the multi-process deployment unit.

    Boot one per process (or several per process; they share only code):

        host = NodeHost(rid=3, peers=["http://other:8080"], port=8083)
        host.start()
        ...
        host.stop()

    The HTTP surface is the reference's five endpoints and the extensions
    (:mod:`crdt_tpu_torch.api.http_shim`); the agent pulls a random peer
    every gossip_period_ms.  ``device=None`` means the CUDA card, and
    raises without one.

    The JAX package's host also runs the keyspace tier, a LeaseManager and
    a ConsistencyPlane; here ``keyspace``, ``ks_door``, ``leases`` and
    ``consistency`` are None (ROADMAP Queue 1 item 3), so ``/read``,
    ``/cas`` and ``/lease/grant`` answer 404 naming that item, and a
    config with ``keyspace_shards`` above 0 raises.
    """

    def __init__(
        self,
        rid: int,
        peers: List[str],
        port: int = 0,
        host: str = "127.0.0.1",
        config: Optional[ClusterConfig] = None,
        capacity: Optional[int] = None,
        coordinator: bool = False,
        checkpoint_dir: Optional[str] = None,
        checkpoint_every_s: float = 0,
        event_log: Optional[str] = None,
        step_clock=None,
        birth_ledger=None,
        device=None,
    ):
        from crdt_tpu_torch.api.compositenode import CompositeNode
        from crdt_tpu_torch.api.http_shim import _make_handler
        from crdt_tpu_torch.api.mapnode import MapNode
        from crdt_tpu_torch.api.seqnode import SeqNode
        from crdt_tpu_torch.api.setnode import SetNode
        from crdt_tpu_torch.ingest import front_door_from_config

        self.config = config or ClusterConfig()
        if self.config.keyspace_shards:
            raise NotImplementedError(
                f"keyspace_shards={self.config.keyspace_shards}: the sharded keyspace "
                "tier is not ported (ROADMAP Queue 1 item 3)")
        if self.config.go_compat_gossip and self.config.compact_every:
            raise ValueError(
                "go_compat_gossip forbids compaction (summary sections are "
                "not Go-parseable); set compact_every=0"
            )
        if self.config.go_compat_gossip and not self.config.delta_gossip:
            raise ValueError(
                "go_compat_gossip requires delta_gossip=True for crdt_tpu "
                "peers: a full pull would receive the lossy bare-ms dump "
                "(rid-less foreign ops) meant for Go peers only"
            )
        device = default_device(device)
        # event_log: the JSONL sink, one line per gossip round, barrier and
        # fault transition (the daemon's black box)
        self.node = ReplicaNode(
            rid=rid, capacity=capacity or self.config.log_capacity,
            go_compat_gossip=self.config.go_compat_gossip,
            events=EventLog(node=str(rid), path=event_log,
                            step_clock=step_clock),
            device=device,
        )
        # flight recorder (obs.provenance): a soak harness passes its
        # shared BirthLedger and step clock; installed BEFORE the boot
        # event below so even boot carries a step stamp
        if step_clock is not None or birth_ledger is not None:
            self.install_flight_recorder(ledger=birth_ledger,
                                         step_clock=step_clock)
        # the typed siblings: the same wire rid (their namespaces are
        # disjoint from the KV vv/frontier), gossiped and checkpointed
        # beside the KV node; the composite shares the node's metrics
        self.set_node = SetNode(rid=rid, device=device)
        self.seq_node = SeqNode(rid=rid, device=device)
        self.map_node = MapNode(rid=rid, device=device)
        self.composite_node = CompositeNode(rid=rid, metrics=self.node.metrics,
                                            device=device)
        self.keyspace = None
        self.ks_door = None
        self.leases = None
        self.consistency = None
        # crash recovery: restore the newest complete snapshot (if any)
        # BEFORE serving.  The caller mints rid through
        # checkpoint.bump_incarnation when restores can land in a live
        # fleet (utils/checkpoint.py's module docstring)
        self.checkpoint_dir = checkpoint_dir
        self.checkpoint_every_s = checkpoint_every_s
        self.restored = False
        if checkpoint_dir:
            from crdt_tpu_torch.utils import checkpoint as ckpt

            self.restored = ckpt.load_latest_node(
                checkpoint_dir, self.node, set_node=self.set_node,
                seq_node=self.seq_node, map_node=self.map_node,
                composite_node=self.composite_node,
            )
        # the ingest front door: every HTTP write rides this host's
        # admission lanes and lands in one device merge a drain
        self.ingest = front_door_from_config(
            self.node, map_node=self.map_node,
            composite_node=self.composite_node, config=self.config,
            events=self.node.events,
        )
        self.nodes = [self.node]  # duck-types as a cluster for the handler
        self.agent = NetworkAgent(
            self.node, peers, self.config, coordinator=coordinator,
            set_node=self.set_node, seq_node=self.seq_node,
            map_node=self.map_node, composite_node=self.composite_node,
        )
        # the auto-postmortem lands beside the durable artifact the host
        # already writes: the checkpoint dir or the event log's dir
        pm_dir = checkpoint_dir
        if pm_dir is None and event_log:
            pm_dir = os.path.dirname(os.path.abspath(event_log))
        if pm_dir:
            self.agent.watchdog.configure_postmortem(
                pm_dir, self.config.seed, [event_log] if event_log else [])
        self._server = _Server((host, port), _make_handler(self, 0, admin=self))
        self.port: int = self._server.server_address[1]
        self.url = f"http://{host}:{self.port}"
        self.node.events.emit(
            "boot", port=self.port, restored=self.restored,
            coordinator=coordinator,
        )
        self._server_thread: Optional[threading.Thread] = None
        self._ckpt_stop = threading.Event()
        self._ckpt_thread: Optional[threading.Thread] = None
        # checkpoint-loop failures: appended from the ckpt thread, read by
        # stop() on the caller's thread; lock both sides
        self._ckpt_err_lock = threading.Lock()
        self._ckpt_errors: List[Exception] = []

    def install_flight_recorder(self, ledger=None, step_clock=None) -> None:
        """Attach a shared BirthLedger and step clock to this host's flight
        recorder (obs.provenance) and stamp subsequent events with the
        driver step.  Idempotent; soak harnesses call this (or pass the
        constructor arguments) so propagation-steps lag uses their
        deterministic time base."""
        self.node.recorder.install(ledger=ledger, step_clock=step_clock)
        if step_clock is not None:
            self.node.events.step_clock = step_clock

    def start_server(self) -> None:
        """Serve the HTTP surface only (no background gossip): for drivers
        that pull deterministically (tests, the network soak)."""
        self._server_thread = threading.Thread(
            target=self._server.serve_forever, daemon=True
        )
        self._server_thread.start()

    def stop_server(self) -> None:
        self._server.shutdown()
        self._server.server_close()
        if self._server_thread is not None:
            self._server_thread.join(timeout=5)
            self._server_thread = None

    def start(self) -> None:
        self.start_server()
        self.agent.start()
        if self.checkpoint_dir and self.checkpoint_every_s > 0:
            self._ckpt_stop.clear()
            self._ckpt_thread = threading.Thread(
                target=self._ckpt_loop, daemon=True
            )
            self._ckpt_thread.start()

    def stop(self) -> None:
        """Stop the checkpoint loop, the agent and the server.  The gossip
        loop's, the checkpoint loop's and the request handlers' failures
        are raised here, and so is a device error of a merge still in
        flight when the server stopped (the device is synchronized after
        the server's threads are done)."""
        self.node.events.emit("stop")
        try:
            self._ckpt_stop.set()
            if self._ckpt_thread is not None:
                self._ckpt_thread.join(timeout=5)
                self._ckpt_thread = None
            self.agent.stop()
            with self._ckpt_err_lock:
                n_failed = len(self._ckpt_errors)
                first = self._ckpt_errors[0] if self._ckpt_errors else None
            if first is not None:
                raise RuntimeError(
                    f"{n_failed} periodic checkpoint(s) failed"
                ) from first
        finally:
            self.stop_server()
            if self.node.device.type == "cuda":
                torch.cuda.synchronize(self.node.device)
        with self._server._errors_lock:
            errors = list(self._server.errors)
        if errors:
            raise RuntimeError(f"{len(errors)} request handler(s) failed") from errors[0]

    def _ckpt_loop(self) -> None:
        # a transient failure (disk full, EIO) must not silently end
        # periodic checkpointing: record, retry next period, and surface
        # the failures through stop() like the gossip loop's errors
        while not self._ckpt_stop.wait(self.checkpoint_every_s):
            try:
                self.checkpoint_now()
            except Exception as e:  # noqa: BLE001 — surfaced by stop()
                self.agent.metrics.inc("checkpoint_errors")
                with self._ckpt_err_lock:
                    self._ckpt_errors.append(e)

    # ---- admin drive surface (POST /admin/*) ----

    def checkpoint_now(self) -> Optional[str]:
        """Crash-safe snapshot (an atomic versioned dir and a LATEST
        repoint)."""
        if not self.checkpoint_dir:
            return None
        from crdt_tpu_torch.utils import checkpoint as ckpt

        return ckpt.save_node_atomic(
            self.checkpoint_dir, self.node, set_node=self.set_node,
            seq_node=self.seq_node, map_node=self.map_node,
            composite_node=self.composite_node,
        )

    def admin_pull(self, peer_url: Optional[str] = None) -> bool:
        """One anti-entropy pull, now, from ``peer_url`` (or a random
        configured peer): a deterministic external gossip drive."""
        if peer_url is None:
            return self.agent.gossip_once()
        return self.agent.pull_from(RemotePeer(peer_url))

    def admin_barrier(self) -> dict:
        """One compaction barrier, now (this host must be the fleet's
        single coordinator)."""
        return self.agent.compact_once()

    def admin_stability_gc(self) -> dict:
        """One stability-frontier GC round, now (coordinator only): mint
        the fleet frontier from piggybacked summaries and fold it
        everywhere, the zero-round-trip alternative to admin_barrier."""
        return self.agent.stability_gc_once()

    def _admin_peer(self, peer_url: Optional[str]) -> Optional[RemotePeer]:
        if peer_url is not None:
            return RemotePeer(peer_url)
        if not self.agent.peers:
            return None
        # the agent's seeded RNG, not the global module: pinned-seed
        # drivers replay their peer-selection schedules
        return self.agent._rng.choice(self.agent.peers)

    def admin_set_pull(self, peer_url: Optional[str] = None) -> bool:
        """One set-lattice pull, now, from ``peer_url`` (or a random
        configured peer)."""
        peer = self._admin_peer(peer_url)
        return False if peer is None else self.agent.set_pull(peer)

    def admin_set_barrier(self) -> dict:
        """One set GC barrier, now (coordinator only)."""
        return self.agent.set_collect_once()

    def admin_seq_pull(self, peer_url: Optional[str] = None) -> bool:
        """One sequence-lattice pull, now."""
        peer = self._admin_peer(peer_url)
        return False if peer is None else self.agent.seq_pull(peer)

    def admin_seq_barrier(self) -> dict:
        """One sequence GC barrier, now (coordinator only)."""
        return self.agent.seq_collect_once()

    def admin_map_pull(self, peer_url: Optional[str] = None) -> bool:
        """One map-lattice pull, now."""
        peer = self._admin_peer(peer_url)
        return False if peer is None else self.agent.map_pull(peer)

    def admin_composite_pull(self, peer_url: Optional[str] = None) -> bool:
        """One composite-lattice pull, now."""
        peer = self._admin_peer(peer_url)
        return False if peer is None else self.agent.composite_pull(peer)

    def admin_map_barrier(self) -> dict:
        """One map reset barrier, now (coordinator only); returns
        {"epochs": ..., "status": "reset"|"noop"|"skipped"}."""
        epochs, status = self.agent.map_reset_once()
        return {"epochs": epochs, "status": status}
