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
* ``NodeHost``: one replica, its siblings, its sharded keyspace (when
  ``keyspace_shards`` > 0), its coordinator leases and consistency plane,
  its HTTP endpoint, its agent and its checkpoints: the standalone
  deployment unit (``python -m crdt_tpu_torch --daemon``).

Gossip payloads carry raw strings and absolute-ms wire keys
(:mod:`crdt_tpu_torch.api.node`), so peers never share an interner or an
epoch, and a port daemon and a JAX daemon gossip with each other.
Writer-id ranges must be disjoint across processes.

Each daemon is its own process with its own CUDA context and its own
``device_lock``: the card time-slices between the processes' contexts,
and nothing serializes merges across processes (as nothing does in the
JAX package).

A keyspace pull round folds its shard planes one merge per shard and
payload on the host path, or all of them in one step of the mesh plane
(``_ks_pull_mesh``) when the keyspace's plane is active.
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
from crdt_tpu_torch.consistency.plane import ConsistencyPlane
from crdt_tpu_torch.consistency.stability import (
    STABILITY_HEADER,
    StabilityTracker,
    decode_summary,
)
from crdt_tpu_torch.obs.audit import AuditWatchdog
from crdt_tpu_torch.obs.events import EventLog
from crdt_tpu_torch.obs.trace import TRACE_HEADER, mint_trace_id, span
from crdt_tpu_torch.utils.config import ClusterConfig
from crdt_tpu_torch.utils.metrics import Metrics

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

    def _clear_http_error(self) -> None:
        with self._http_err_lock:
            self._http_err = None

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

    # ---- sharded keyspace surface (crdt_tpu_torch.keyspace) ----

    def ks_gossip(self, shard: int,
                  since: Optional[Dict[int, int]] = None,
                  trace: Optional[str] = None,
                  epoch: Optional[int] = None,
                  ) -> Optional[Dict[str, Any]]:
        """GET /ks/gossip?shard=i[&vv=...][&epoch=e]: one SHARD's delta
        payload plus its stability summary in the response BODY
        ({"payload", "vv", "frontier"}).  Body, not header: a round
        pulls several shards and the header slot (take_stability) holds
        only one summary.  Built on _get, so the circuit breaker sees it
        like any other pull.  ``trace`` rides the X-CRDT-Trace header so
        the serve event joins the puller's round, exactly like /gossip.

        ``epoch`` is the puller's reshard epoch; a peer at a different
        one answers 409 and this returns its fence body ``{"fenced":
        True, "epoch": theirs, ...}`` instead of a payload — callers
        must check ``"fenced"`` before folding."""
        path = f"/ks/gossip?shard={int(shard)}"
        if since is not None:
            vv = json.dumps({str(r): s for r, s in since.items()})
            path += "&vv=" + urllib.parse.quote(vv)
        if epoch is not None:
            path += f"&epoch={int(epoch)}"
        headers = {TRACE_HEADER: trace} if trace else None
        self._clear_http_error()
        out = self._parse(self._get(path, headers=headers))
        if out is not None:
            return out
        err = self.take_http_error()
        if err is not None and err[0] == 409 \
                and err[1] is not None and err[1].get("fenced"):
            return err[1]
        return None

    def ks_compact(self, shard: int, frontier: Dict[int, int],
                   epoch: Optional[int] = None) -> Dict[str, Any]:
        """POST /ks/compact: fold ONE shard at/under ``frontier`` —
        stability GC gone shard-local.  Returns ``{"ok": True}``,
        ``{"ok": False, "fenced": True, "epoch": theirs}`` when the
        peer's reshard epoch differs, or ``{"ok": False}`` on transport
        failure / node down."""
        body: Dict[str, Any] = {
            "shard": int(shard),
            "frontier": {str(r): s for r, s in frontier.items()},
        }
        if epoch is not None:
            body["epoch"] = int(epoch)
        got = self._post_json("/ks/compact", body)
        if got is None:
            return {"ok": False}
        if got["status"] == 200:
            return {"ok": True}
        rb = got["body"] or {}
        if got["status"] == 409 and rb.get("fenced"):
            return {"ok": False, "fenced": True,
                    "epoch": int(rb.get("epoch", -1))}
        return {"ok": False}

    def ks_migrate(self, shard: int, payload: Dict[str, Any], epoch: int,
                   trace: Optional[str] = None) -> Dict[str, Any]:
        """POST /ks/migrate: one reshard migration slice for destination
        ``shard``, as an ordinary wire payload the receiver folds into
        its migration buffer.  Returns ``{"ok": True, "folded": n}``;
        ``{"ok": False, "fenced": True, "epoch": theirs}`` when the
        peer is not migrating at our epoch (retry next round — it may
        not have been told yet); ``{"ok": False, "quarantined": err}``
        when the peer rejected the payload as corrupt (do NOT blind-
        retry the same bytes); ``{"ok": False}`` on transport failure —
        the breaker/backoff machinery paces the retry."""
        body: Dict[str, Any] = {
            "shard": int(shard), "epoch": int(epoch), "payload": payload,
        }
        if trace:
            body["trace"] = trace
        got = self._post_json("/ks/migrate", body)
        if got is None:
            return {"ok": False}
        rb = got["body"] or {}
        if got["status"] == 200:
            return {"ok": True, "folded": int(rb.get("folded", 0))}
        if got["status"] == 409 and rb.get("fenced"):
            return {"ok": False, "fenced": True,
                    "epoch": int(rb.get("epoch", -1))}
        if got["status"] == 400:
            return {"ok": False,
                    "quarantined": str(rb.get("quarantined", "rejected"))}
        return {"ok": False}

    def ks_reshard_admin(self, action: str, shards: Optional[int] = None
                         ) -> Optional[Dict[str, Any]]:
        """POST /admin/ks_reshard: drive one node's reshard state
        machine (action = start|cutover|abort|status).  Returns the
        node's status dict, or None on transport failure / refusal."""
        body: Dict[str, Any] = {"action": str(action)}
        if shards is not None:
            body["shards"] = int(shards)
        got = self._post_json("/admin/ks_reshard", body)
        if got is None or got["status"] != 200:
            return None
        return got["body"]

    def push_payload(self, payload: Dict[str, Any]) -> bool:
        """POST /push: hand the peer a gossip payload to merge NOW —
        the synchronous write-quorum leg of CAS (crdt_tpu_torch.consistency
        .plane).  A 200 means the peer merged it before answering, so
        its vv dominates every op the payload carried; built on _post,
        so it crosses the circuit breaker like every other leg."""
        return self._post("/push", {"payload": payload})

    # ---- coordinator-lease surface (consistency.leases) ----

    def _post_json(self, path: str, body: dict) -> Optional[Dict[str, Any]]:
        """POST returning ``{"status": int, "body": parsed-or-None}``, or
        None on transport failure.  The lease/CAS surfaces need the
        RESPONSE BODY of non-200 statuses (a grant refusal names the
        blocking fence; a 409 names the deciding coordinator; a 503
        carries the coordinator's refusal the origin must re-raise), so
        _post's bool is not enough.  Same breaker accounting as _post."""
        req = urllib.request.Request(
            self.url + path,
            data=json.dumps(body).encode(),
            headers={"Content-Type": "application/json"},
            method="POST",
        )
        try:
            with urllib.request.urlopen(req, timeout=self.timeout) as res:
                status, raw = res.status, res.read()
        except urllib.error.HTTPError as e:
            self._note_reachable()  # served an error status: peer is UP
            status, raw = e.code, e.read()
        except (urllib.error.URLError, OSError):
            self._note_transport_failure()
            return None
        self._note_reachable()
        try:
            parsed = json.loads(raw)
        except ValueError:
            parsed = None
        return {"status": status,
                "body": parsed if isinstance(parsed, dict) else None}

    def lease_grant(self, *, slot: int, holder: str, fence: int,
                    ttl: float) -> Optional[Dict[str, Any]]:
        """POST /lease/grant: ask this peer to vote one coordinator
        lease.  Returns the voter's verdict dict ({"granted", "fence",
        "holder"}), or None on transport failure (a missing vote, not a
        refusal — the proposer learns nothing from it)."""
        got = self._post_json("/lease/grant", {
            "slot": int(slot), "holder": holder,
            "fence": int(fence), "ttl": float(ttl),
        })
        if got is None or got["body"] is None:
            return None
        return got["body"]

    def push_fenced(self, payload: Dict[str, Any],
                    fences: Dict[int, int],
                    trace: Optional[str] = None) -> Dict[str, Any]:
        """POST /push with ``{slot: fence}`` stamps.  Returns
        ``{"ok": True}`` when the peer checked every stamp and merged;
        ``{"ok": False, "fenced": True, "slot", "fence"}`` when the peer
        refused a stale fence (naming its known one, so a zombie
        coordinator learns it was superseded); ``{"ok": False}`` on
        transport failure / node down.  ``trace`` travels in the body so
        a fence refusal's cas_fenced_reject event joins the CAS trace."""
        body: Dict[str, Any] = {
            "payload": payload,
            "fences": {str(s): int(f) for s, f in fences.items()},
        }
        if trace:
            body["trace"] = trace
        got = self._post_json("/push", body)
        if got is None:
            return {"ok": False}
        if got["status"] == 200:
            return {"ok": True}
        body = got["body"] or {}
        if got["status"] == 409 and body.get("fenced"):
            return {"ok": False, "fenced": True,
                    "slot": int(body.get("slot", -1)),
                    "fence": int(body.get("fence", 0))}
        return {"ok": False}

    def cas_forward(self, body: Dict[str, Any]) -> Optional[Dict[str, Any]]:
        """POST /cas at the routed coordinator (the forwarding leg).
        Returns {"status", "body"} for the plane to interpret — 200
        token, 409 conflict, 503 refusal — or None on transport failure
        (indeterminate: the coordinator may have committed)."""
        return self._post_json("/cas", body)

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
    reference's loop died silently forever on one bad payload).  With a
    ``keyspace`` the round also pulls every shard (``ks_pull``, one
    GET /ks/gossip a shard), and the coordinator drives the shard-local
    GC (``ks_gc_once``) and the reshard streaming (``ks_reshard_stream``).
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
        # the sharded keyspace: one stability tracker PER SHARD, fed from
        # the summaries riding /ks/gossip response bodies
        self.keyspace = keyspace
        self.ks_trackers = self._build_ks_trackers()
        # the live divergence audit (obs.audit): a gossiping agent IS the
        # deployment, so it digests every plane it serves and watches the
        # digests peers piggyback back
        node.enable_audit()
        if keyspace is not None:
            keyspace.enable_audit()
        self.watchdog = AuditWatchdog(node, keyspace=keyspace,
                                      stability=self.stability,
                                      ks_trackers=self.ks_trackers)
        self._rng = random.Random(self.config.seed if seed is None else seed)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # gossip-loop failures: appended from the loop thread, read by
        # stop() on the caller's thread — lock both sides
        self._err_lock = threading.Lock()
        self.errors: List[Exception] = []

    def _build_ks_trackers(self) -> List[StabilityTracker]:
        """One stability tracker per keyspace shard, over the CURRENT
        plane set: at construction and again after a reshard cutover
        swaps the planes (refresh_ks_trackers)."""
        if self.keyspace is None:
            return []
        return [
            StabilityTracker(
                shard, [p.url for p in self.peers],
                max_staleness=self.config.stability_max_staleness_s,
                events=self.node.events,
            )
            for shard in self.keyspace.shards
        ]

    def refresh_ks_trackers(self) -> None:
        """Reshard-cutover reshape hook: every per-shard tracker re-binds
        to the new planes with empty peer summaries (stale pre-cutover
        summaries must not mint a frontier against reborn seq spaces)."""
        self.ks_trackers = self._build_ks_trackers()
        # the watchdog's per-shard stall evaluator reads these trackers
        self.watchdog.ks_trackers = self.ks_trackers

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
        """One keyspace pull round from ``peer``: every shard's delta,
        shard-scoped (shard i's payload merges into shard i and nothing
        else — (rid, seq) spaces collide ACROSS shards by design and
        must never mix).  Malformed shard payloads are quarantined like
        KV gossip: that shard's round is skipped loudly, the siblings
        still pull.  Returns total fresh ops merged."""
        ks = self.keyspace
        if ks is None:
            return 0
        # one trace id covers the whole multi-shard round: it rides the
        # X-CRDT-Trace header of every shard's GET (the server's
        # ks_gossip_serve events join it) and stamps the puller-side
        # round events below — shard gossip shows up in assembled traces
        # exactly like the host plane's pulls
        tid = mint_trace_id(self.node.rid)
        # the round is pinned to ONE reshard epoch: it rides every GET
        # (?epoch=e — a peer at another epoch 409s instead of handing us
        # a payload whose (rid, seq) identities belong to a different
        # plane generation) and gates the merge below (a cutover racing
        # this round flips ks.epoch; folding a pre-cutover payload into
        # a reborn plane would mix generations)
        e0 = ks.epoch
        if ks.mesh_active:
            return self._ks_pull_mesh(ks, peer, tid, e0)
        fresh_total = 0
        trackers = self.ks_trackers  # pinned: a cutover rebuilds the list
        for i, shard in enumerate(ks.shards):
            since = shard.version_vector() \
                if self.config.delta_gossip else None
            body = peer.ks_gossip(i, since, trace=tid, epoch=e0)
            if body is None:
                self.metrics.inc("net_ks_pull_skips")
                self.node.events.emit("ks_pull_skip", trace=tid,
                                      peer=peer.url, shard=i)
                continue
            if body.get("fenced"):
                # the peer is at another epoch: every shard of this
                # round would fence identically, so ONE loud client-
                # side fence record covers the round (1:1 with the
                # count a fault schedule predicts)
                self.metrics.inc("net_ks_fenced")
                self.node.events.emit(
                    "ks_reshard_fence", role="client",
                    surface="ks_gossip", trace=tid, peer=peer.url,
                    epoch=e0, got=int(body.get("epoch", -1)))
                break
            if ks.epoch != e0:
                break  # cutover landed mid-round: drop the stale rest
            try:
                payload = body.get("payload")
                with span("crdt.ks_pull", tid):
                    fresh = 0 if payload is None else shard.receive(payload)
            except (ValueError, KeyError, TypeError) as e:
                self.metrics.inc("net_ks_quarantined")
                self.node.events.emit(
                    "payload_quarantine", surface="ks_gossip",
                    trace=tid, peer=peer.url, shard=i,
                    error=f"{type(e).__name__}: {e}")
                continue
            fresh_total += fresh
            self.node.events.emit(
                "ks_pull_merge" if fresh else "ks_pull_noop",
                trace=tid, peer=peer.url, shard=i, fresh=fresh)
            try:
                vv = {int(r): int(s)
                      for r, s in (body.get("vv") or {}).items()}
                frontier = {int(r): int(s)
                            for r, s in (body.get("frontier") or {}).items()}
            except (ValueError, TypeError):
                continue  # summary malformed: merge stood, tracker skips
            trackers[i].note(peer.url, vv, frontier)
            dig = body.get("digest")
            if dig is not None:
                self.watchdog.note_shard(peer.url, i, frontier, dig)
        self.metrics.inc("net_ks_pulls")
        if fresh_total:
            self.metrics.inc("net_ks_fresh", fresh_total)
        return fresh_total

    def _ks_pull_mesh(self, ks, peer: RemotePeer, tid: str,
                      e0: int) -> int:
        """The fused pull round: fetch every shard's delta first (the S
        HTTP GETs are unchanged), then fold ALL shards in ONE mesh-plane
        step (`ShardedKeyspace.receive_all` -> `MeshPlane.converge`).
        Same quarantine semantics as the host loop — a corrupt shard
        payload isolates that shard's lane inside the fused step while
        the siblings still fold.  Epoch-pinned like the host loop: a
        fenced response ends the round with one client fence record, and
        a cutover racing the fetches drops the whole fold."""
        payloads: List[Optional[Dict[str, Any]]] = [None] * ks.n_shards
        bodies: List[Optional[dict]] = [None] * ks.n_shards
        trackers = self.ks_trackers  # pinned: a cutover rebuilds the list
        for i, shard in enumerate(ks.shards):
            since = shard.version_vector() \
                if self.config.delta_gossip else None
            body = peer.ks_gossip(i, since, trace=tid, epoch=e0)
            if body is None:
                self.metrics.inc("net_ks_pull_skips")
                self.node.events.emit("ks_pull_skip", trace=tid,
                                      peer=peer.url, shard=i)
                continue
            if body.get("fenced"):
                self.metrics.inc("net_ks_fenced")
                self.node.events.emit(
                    "ks_reshard_fence", role="client",
                    surface="ks_gossip", trace=tid, peer=peer.url,
                    epoch=e0, got=int(body.get("epoch", -1)))
                return 0
            bodies[i] = body
            payloads[i] = body.get("payload")
        if ks.epoch != e0:
            return 0  # cutover landed mid-round: drop the stale fold
        with span("crdt.ks_pull_mesh", tid):
            results = ks.receive_all(payloads, quarantine=True)
        fresh_total = 0
        for i, (body, res) in enumerate(zip(bodies, results)):
            if body is None:
                continue
            if isinstance(res, str):  # quarantined lane: siblings folded
                self.metrics.inc("net_ks_quarantined")
                self.node.events.emit(
                    "payload_quarantine", surface="ks_gossip",
                    trace=tid, peer=peer.url, shard=i, error=res)
                continue
            fresh_total += res
            self.node.events.emit(
                "ks_pull_merge" if res else "ks_pull_noop",
                trace=tid, peer=peer.url, shard=i, fresh=res)
            try:
                vv = {int(r): int(s)
                      for r, s in (body.get("vv") or {}).items()}
                frontier = {int(r): int(s)
                            for r, s in (body.get("frontier") or {}).items()}
            except (ValueError, TypeError):
                continue  # summary malformed: merge stood, tracker skips
            trackers[i].note(peer.url, vv, frontier)
            dig = body.get("digest")
            if dig is not None:
                self.watchdog.note_shard(peer.url, i, frontier, dig)
        self.metrics.inc("net_ks_pulls")
        if fresh_total:
            self.metrics.inc("net_ks_fresh", fresh_total)
        return fresh_total

    def ks_reshard_stream(self) -> Dict[str, int]:
        """One MIGRATE-window streaming round: every moved key's current
        evidence, sliced per destination shard, POSTed to every
        reachable peer (``/ks/migrate``).  The receiver's fold is a
        max-(ts, rid, seq) per key, so re-sending a slice is idempotent
        — this round simply re-streams everything still moved, and the
        window converges as long as one round lands after the last
        pre-cutover write.  Peers inside a backoff window are skipped
        (the breaker paces the retry); fenced peers (not migrating yet,
        or already cut over) are counted and retried next round; a
        quarantine verdict is counted loudly and NOT blind-retried this
        round.  Returns {sent, ok, fenced, quarantined, failed}."""
        ks = self.keyspace
        stats = {"sent": 0, "ok": 0, "fenced": 0, "quarantined": 0,
                 "failed": 0}
        if ks is None or not self.node.alive:
            return stats
        slices = ks.reshard.migration_slices()
        if not slices:
            return stats
        e0 = ks.epoch
        tid = mint_trace_id(self.node.rid)
        for peer in self.peers:
            if peer.backed_off():
                continue
            for dst, payload in slices:
                stats["sent"] += 1
                out = peer.ks_migrate(dst, payload, e0, trace=tid)
                if out.get("ok"):
                    stats["ok"] += 1
                elif out.get("fenced"):
                    stats["fenced"] += 1
                    self.metrics.inc("net_ks_fenced")
                    self.node.events.emit(
                        "ks_reshard_fence", role="client",
                        surface="ks_migrate", trace=tid, peer=peer.url,
                        epoch=e0, got=int(out.get("epoch", -1)))
                elif "quarantined" in out:
                    stats["quarantined"] += 1
                else:
                    stats["failed"] += 1
        self.node.events.emit("ks_reshard_stream", trace=tid, **stats)
        return stats

    def ks_gc_once(self, step: Optional[int] = None) -> Dict[int, dict]:
        """One SHARD-LOCAL stability-GC round (coordinator only): each
        shard's tracker mints its own frontier from the summaries that
        rode /ks/gossip bodies; shards whose frontier is provable fold
        locally and push POST /ks/compact to every peer — a stalled
        shard freezes ALONE, its siblings keep collecting.  Returns
        {shard: frontier} for the shards that folded."""
        ks = self.keyspace
        if ks is None or not self.node.alive:
            return {}
        # trace-stamped like ks_pull: the GC round (and any vv movement
        # its folds cause) shows up as one joined group in assembled
        # traces instead of anonymous leftovers
        tid = mint_trace_id(self.node.rid)
        e0 = ks.epoch
        out: Dict[int, dict] = {}
        for i, tracker in enumerate(list(self.ks_trackers)):
            frontier = tracker.mint(step=step)
            if not frontier:
                self.metrics.inc("ks_gc_skipped")
                continue
            if ks.epoch != e0:
                break  # cutover landed mid-round: stale frontiers die
            with span("crdt.ks_gc", tid):
                ks.compact_shard(i, frontier)
            for p in self.peers:
                if p.backed_off():
                    continue
                got = p.ks_compact(i, frontier, epoch=e0)
                if got.get("fenced"):
                    self.metrics.inc("net_ks_fenced")
                    self.node.events.emit(
                        "ks_reshard_fence", role="client",
                        surface="ks_compact", trace=tid, peer=p.url,
                        epoch=e0, got=int(got.get("epoch", -1)))
            out[i] = frontier
        if out:
            self.metrics.inc("ks_gc_rounds")
            self.node.events.emit(
                "ks_gc", trace=tid,
                shards={str(i): {str(r): s for r, s in f.items()}
                        for i, f in out.items()},
            )
        return out

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

    As in the JAX package, every host runs a LeaseManager and a
    ConsistencyPlane (``/read``, ``/cas``, ``/lease/grant`` and the fence
    check of ``/push``), and ``keyspace_shards`` > 0 adds the sharded
    keyspace (S ``ReplicaNode`` planes on the same device) with its
    tenant front door, reshard machine and ``/ks/*`` routes.
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
        ks_birth_ledgers=None,
        device=None,
    ):
        from crdt_tpu_torch.api.compositenode import CompositeNode
        from crdt_tpu_torch.api.http_shim import _make_handler
        from crdt_tpu_torch.api.mapnode import MapNode
        from crdt_tpu_torch.api.seqnode import SeqNode
        from crdt_tpu_torch.api.setnode import SetNode
        from crdt_tpu_torch.consistency.leases import LeaseManager
        from crdt_tpu_torch.ingest import front_door_from_config
        from crdt_tpu_torch.keyspace import (keyspace_from_config,
                                             keyspace_front_door_from_config)

        self.config = config or ClusterConfig()
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
        # event below so even boot carries a step stamp.  The keyspace
        # does not exist yet: install_flight_recorder runs again once it
        # is built, so the shard recorders get their per-shard ledgers
        # (shards share the host's rid and seq space, so the host ledger
        # cannot serve them)
        self._ks_birth_ledgers = \
            list(ks_birth_ledgers) if ks_birth_ledgers else None
        self._step_clock = step_clock
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
        # crash recovery: restore the newest complete snapshot (if any)
        # BEFORE serving.  The caller mints rid through
        # checkpoint.bump_incarnation when restores can land in a live
        # fleet (utils/checkpoint.py's module docstring)
        self.checkpoint_dir = checkpoint_dir
        self.checkpoint_every_s = checkpoint_every_s
        self.restored = False
        # the sharded keyspace (keyspace_shards > 0, else None): S plane
        # shards on this host's device, sharing the node's metrics and
        # events so GET /metrics and the black box stay one-stop.  Built
        # BEFORE the restore so shard snapshots land in the live planes
        self.keyspace = keyspace_from_config(
            rid, self.config, metrics=self.node.metrics,
            events=self.node.events, device=device,
        )
        if self.keyspace is not None and (
                step_clock is not None or self._ks_birth_ledgers):
            # second pass now that the shards exist
            self.install_flight_recorder(step_clock=step_clock)
        # coordinator leases: built before the restore so persisted fence
        # floors land back in it (a rebooted replica keeps refusing the
        # stale fences it refused before); attach() wires the bound URL
        # and the live peer list once the server exists
        self.leases = LeaseManager(
            self.node, n_slots=self.config.lease_slots,
            duration=self.config.lease_duration_s,
        )
        if checkpoint_dir:
            from crdt_tpu_torch.utils import checkpoint as ckpt

            self.restored = ckpt.load_latest_node(
                checkpoint_dir, self.node, set_node=self.set_node,
                seq_node=self.seq_node, map_node=self.map_node,
                composite_node=self.composite_node,
                keyspace=self.keyspace, leases=self.leases,
            )
        # the ingest front door: every HTTP write rides this host's
        # admission lanes and lands in one device merge a drain
        self.ingest = front_door_from_config(
            self.node, map_node=self.map_node,
            composite_node=self.composite_node, config=self.config,
            events=self.node.events,
        )
        self.ks_door = None if self.keyspace is None else \
            keyspace_front_door_from_config(
                self.keyspace, inner=self.ingest, config=self.config,
                events=self.node.events, node=str(rid),
            )
        self.nodes = [self.node]  # duck-types as a cluster for the handler
        self.agent = NetworkAgent(
            self.node, peers, self.config, coordinator=coordinator,
            set_node=self.set_node, seq_node=self.seq_node,
            map_node=self.map_node, composite_node=self.composite_node,
            keyspace=self.keyspace,
        )
        if self.keyspace is not None:
            # a reshard cutover swaps the plane set: everything host-side
            # that cached it re-binds
            self.keyspace.on_reshape(self._on_ks_reshape)
        # the watchdog's lease-zombie evaluator reads this host's leases;
        # the auto-postmortem lands beside the durable artifact the host
        # already writes: the checkpoint dir or the event log's dir
        self.agent.watchdog.leases = self.leases
        pm_dir = checkpoint_dir
        if pm_dir is None and event_log:
            pm_dir = os.path.dirname(os.path.abspath(event_log))
        if pm_dir:
            self.agent.watchdog.configure_postmortem(
                pm_dir, self.config.seed, [event_log] if event_log else [])
        # strong reads and CAS: reads agent.peers live, so a harness that
        # swaps the peer list after boot keeps the plane on it
        self.consistency = ConsistencyPlane(
            self.node, agent=self.agent,
            quorum=self.config.strong_quorum,
            strong_timeout=self.config.strong_timeout_s,
            session_timeout=self.config.session_wait_s,
            poll=self.config.session_poll_s,
            leases=self.leases,
            forward_hops=self.config.cas_forward_hops,
            bounded_staleness=self.config.bounded_staleness_ops,
            retry_after_s=self.config.consistency_retry_after_s,
        )
        self._server = _Server((host, port), _make_handler(self, 0, admin=self))
        self.port: int = self._server.server_address[1]
        self.url = f"http://{host}:{self.port}"
        # late lease wiring: routing needs the bound URL and reads
        # agent.peers live
        self.leases.attach(self.url, lambda: self.agent.peers)
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

    def install_flight_recorder(self, ledger=None, step_clock=None,
                                ks_ledgers=None) -> None:
        """Attach a shared BirthLedger and step clock to this host's flight
        recorder (obs.provenance) and stamp subsequent events with the
        driver step.  Idempotent; soak harnesses call this (or pass the
        constructor arguments) so propagation-steps lag uses their
        deterministic time base.  ``ks_ledgers`` is the keyspace's ledger
        list, ONE fleet-wide BirthLedger per shard index."""
        self.node.recorder.install(ledger=ledger, step_clock=step_clock)
        if step_clock is not None:
            self.node.events.step_clock = step_clock
        if ks_ledgers is not None:
            self._ks_birth_ledgers = list(ks_ledgers)
        if getattr(self, "keyspace", None) is not None:
            self._install_ks_recorders(step_clock)

    def _install_ks_recorders(self, step_clock) -> None:
        """Wire the per-shard ledgers and the step clock into the CURRENT
        shard set's flight recorders (a reshard cutover reruns exactly
        this: reborn shards carry unbound recorders)."""
        ledgers = self._ks_birth_ledgers
        for i, shard in enumerate(self.keyspace.shards):
            shard.recorder.install(
                ledger=ledgers[i]
                if ledgers and i < len(ledgers) else None,
                step_clock=step_clock)

    def _on_ks_reshape(self) -> None:
        """Reshard-cutover reshape hook (the door's admission lock held,
        right after the plane swap): the per-shard stability trackers and
        the shard flight recorders re-bind.  The door rebuilt its own
        lanes already."""
        self.agent.refresh_ks_trackers()
        self._install_ks_recorders(self._step_clock)

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
            keyspace=self.keyspace, leases=self.leases,
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

    def admin_ks_pull(self, peer_url: Optional[str] = None) -> int:
        """One keyspace pull round (all shards), now, from ``peer_url``
        (or a random configured peer); 0 when the tier is disabled."""
        if self.keyspace is None:
            return 0
        peer = self._admin_peer(peer_url)
        return 0 if peer is None else self.agent.ks_pull(peer)

    def admin_ks_gc(self) -> dict:
        """One shard-local stability-GC round, now (coordinator only):
        {shard: frontier} for the shards whose frontier was provable."""
        return self.agent.ks_gc_once()

    def admin_ks_reshard(self, body: dict) -> dict:
        """Drive this node's reshard state machine (POST
        /admin/ks_reshard).  Actions:

          {"action": "start", "shards": S'}  — PREPARE + open the
              MIGRATE window toward S' shards (idempotent for the same
              target; a node already AT S' with an idle machine answers
              its status instead of failing, so a resumed caller can
              re-send)
          {"action": "stream"}   — one migration streaming round to
              every reachable peer (returns the round's stats)
          {"action": "cutover"}  — epoch bump + plane rebirth at S'
          {"action": "abort"}    — roll back to the old epoch
          {"action": "status"}   — the machine's current state

        Raises ValueError on an invalid action/transition (the HTTP
        shim answers 400 with the message)."""
        if self.keyspace is None:
            raise ValueError("no keyspace tier on this node")
        action = str(body.get("action", "status"))
        if action == "start":
            target = int(body.get("shards", 0))
            if self.keyspace.n_shards == target \
                    and self.keyspace.reshard.phase == "idle":
                return self.keyspace.reshard.status()  # already there
            return self.keyspace.reshard.start(target)
        if action == "stream":
            return dict(self.agent.ks_reshard_stream())
        if action == "cutover":
            return self.keyspace.reshard.cutover()
        if action == "abort":
            return self.keyspace.reshard.abort(
                str(body.get("reason", "admin")))
        if action == "status":
            return self.keyspace.reshard.status()
        raise ValueError(f"unknown ks_reshard action {action!r}")
