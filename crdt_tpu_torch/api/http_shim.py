"""HTTP shim: the reference's REST surface over the port's replicas (own
copy of ``crdt_tpu.api.http_shim``: the same routes, status codes,
bodies, headers and content types), in demo mode over a LocalCluster and
in daemon mode over a network daemon's ``NodeHost``.

The reference's five routes (its main.go:262-266):
  GET  /gossip                  the op log as JSON         (main.go:154-171)
  GET  /ping                    200 "Pong" / 502           (main.go:115-127)
  GET  /data                    materialized state JSON    (main.go:129-139)
  POST /data                    append command, "Inserted" (main.go:173-215)
  GET  /condition/<bool>        set alive                  (main.go:141-152)

Extensions, as in the JAX package:
  GET  /gossip?vv=<json>        delta gossip: only the ops the caller lacks;
                                every GET /gossip answer carries the node's
                                stability summary in ``X-CRDT-Stability``,
                                and an ``X-CRDT-Trace`` request header is
                                recorded as a ``gossip_serve`` event and
                                echoed back
  GET  /vv                      {"vv": {rid: seq}, "frontier": {rid: seq}}
  POST /compact                 {"frontier": {rid: seq}} -> fold + prune
  POST /push                    {"payload": <gossip payload>} -> merge now,
                                {"fresh": n}
  POST /ingest/page             a columnar op page (crdt_tpu_torch.ingest):
                                200 {"admitted", "dup", "page_seq"}, 400 on
                                a malformed page (quarantined whole), 429 +
                                Retry-After past the lane's high-water mark
  GET  /metrics                 Prometheus text exposition (the node's
                                registry and the health gauges, sampled at
                                scrape time)
  /set/*, /seq/*, /map/*        the typed siblings of the replica (GET
                                view, gossip[?vv=], vv; POST add / remove /
                                collect, insert / remove / collect, upd /
                                rem / reset)
  GET  /composite               the composite sibling's {"items"} (daemon
                                mode), /composite/gossip its full state dump
  POST /composite/upd           {"key", "delta"} -> {"value"}; /composite/rem
                                {"key"} -> {"removed"}

``POST /data`` goes through the replica's ingest front door: concurrent
posters fuse into one ``add_commands`` (one device merge) a drain, and the
answer carries the write's ``X-CRDT-Session-Token`` (its vv watermark).
The body stays the reference's ``Inserted``; an unparseable body is the
reference's 500.

Daemon mode (the handler built with ``admin=``, a NodeHost) adds the
consistency plane and the coordinator leases:

  GET  /read?key=k&level=l      l in eventual|session|bounded|linearizable
                                (session: the X-CRDT-Session-Token header;
                                bounded: &staleness=<ops>); 200
                                {"key","value","level"}, 503 + Retry-After
                                when the level cannot be met
  POST /cas                     {"key","expect","update"} or {"ops": {key:
                                {"expect","update"}}} -> 200 {"token"}, 409
                                {"conflict", ..., "coordinator","fence"},
                                503 as /read; routed to the key's slot
                                coordinator under a fenced lease
  POST /push                    with {"fences": {slot: fence}}: a stale
                                stamp is refused whole, 409 {"fenced",
                                "slot","fence"}
  POST /lease/grant             {"slot","holder","fence","ttl"} -> one vote

the sharded keyspace when its config has ``keyspace_shards`` > 0 (writes
naming their tenant in ``X-CRDT-Tenant`` on /data, /ingest/page and
/map/upd route through the tenant door; ``X-CRDT-KS-Epoch`` on a page
409s when stale):

  GET  /ks/gossip?shard=i[&vv=][&epoch=e]  one shard's delta payload and
                                its stability summary in the body
  GET  /ks/data[?tenant=t]      a tenant's state, or the per-shard stats
  POST /ks/compact              {"shard","frontier","epoch"?}: fold one
                                shard
  POST /ks/migrate              {"shard","epoch","payload"}: one reshard
                                migration slice
  POST /admin/ks_pull, /admin/ks_gc, /admin/ks_reshard  the keyspace's
                                pull, shard-local GC and reshard machine

and the drive routes:

  POST /admin/pull              {"peer": url?} -> one gossip pull now
  POST /admin/barrier           one compaction barrier now (coordinator)
  POST /admin/stability_gc      one stability-frontier GC round now
  POST /admin/checkpoint        a crash-safe snapshot now
  POST /admin/{set,seq,map,composite}_pull, /admin/{set,seq,map}_barrier
                                the siblings' pulls and barriers
  GET  /audit                   the audit watchdog's report (obs.audit)

and every GET /gossip answer's stability header carries the node's
audit digest, clamped at the summary's frontier.

``GET /fleet`` folds this node's ``/metrics`` and every reachable peer's
into one SLO rollup (:mod:`crdt_tpu_torch.obs.fleet`).  As in the JAX
package's demo mode, ``/read``, ``/cas``, ``/lease/grant``, ``/ks/*``,
``/composite/*``, ``/admin/*`` and ``/audit`` answer 404 in demo mode.

The /condition route takes the flag as a path segment (or
``?alive_status=``); the reference registered it without its parameter,
so every call there answered 500.
"""
from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import List, Optional
from urllib.parse import parse_qs, urlparse

from crdt_tpu_torch.consistency.plane import CasConflict, ConsistencyUnavailable
from crdt_tpu_torch.consistency.session import (
    SESSION_TOKEN_HEADER,
    decode_token,
    encode_token,
)
from crdt_tpu_torch.consistency.stability import STABILITY_HEADER, encode_summary
from crdt_tpu_torch.ingest import PageFormatError, ShedError
from crdt_tpu_torch.keyspace import TENANT_HEADER
from crdt_tpu_torch.obs import health
from crdt_tpu_torch.obs.trace import TRACE_HEADER, span

PROM_CTYPE = "text/plain; version=0.0.4; charset=utf-8"
JSON = "application/json"

# optional reshard-epoch stamp on tenant-scoped page admits: a stamped
# page 409s when the writer's epoch is stale (keyspace/reshard.py); an
# un-stamped page routes by the live shard map
KS_EPOCH_HEADER = "X-CRDT-KS-Epoch"


def _ranks(d) -> dict:
    """A {rid: seq} map with string keys (the JSON bodies' convention)."""
    return {str(r): s for r, s in d.items()}


def _int_map(d) -> dict:
    """A request body's {rid: seq} map (absent: {}); raises on a bad one."""
    return {int(r): int(s) for r, s in (d or {}).items()}


def _make_handler(cluster, idx: int, admin=None):
    """The request handler of replica ``idx`` of ``cluster``; ``admin``
    (a NodeHost, which also serves as the one-node ``cluster``) adds the
    daemon's routes and siblings."""
    agent = getattr(admin, "agent", None)

    def sibling(kind: str):
        if admin is not None:
            return getattr(admin, f"{kind}_node", None)
        nodes = getattr(cluster, f"{kind}_nodes", None)
        return nodes[idx] if nodes else None

    class Handler(BaseHTTPRequestHandler):
        # resolve at request time: a node may be replaced in the cluster
        @property
        def node(self):
            return cluster.nodes[idx]

        @property
        def ingest(self):
            """The replica's ingest front door, or None (the routes then
            write directly)."""
            if admin is not None:
                return getattr(admin, "ingest", None)
            doors = getattr(cluster, "ingests", None)
            return doors[idx] if doors else None

        # a daemon's tier (None in demo mode): the sharded keyspace and
        # its tenant door, the consistency plane and the leases
        @property
        def keyspace(self):
            return getattr(admin, "keyspace", None)

        @property
        def ks_door(self):
            return getattr(admin, "ks_door", None)

        @property
        def consistency(self):
            return getattr(admin, "consistency", None)

        @property
        def leases(self):
            return getattr(admin, "leases", None)

        def log_message(self, *args):  # quiet
            pass

        def _send(self, code: int, body: str, ctype: str = "text/plain"):
            self._send_bytes(code, body.encode(), ctype)

        def _send_json(self, code: int, obj) -> None:
            self._send(code, json.dumps(obj), JSON)

        def _send_bytes(self, code: int, data: bytes, ctype: str, extra_headers=None):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(data)))
            for k, v in (extra_headers or {}).items():
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(data)

        def _send_unavailable(self, exc: ConsistencyUnavailable):
            """503 + Retry-After: a strong operation that cannot meet its
            guarantee, never a silently stale value.  The body carries every
            field a forwarding origin needs to re-raise the refusal."""
            body = {
                "error": "consistency_unavailable",
                "reason": exc.reason, "level": exc.level,
                "op": exc.op, "acks": exc.acks, "quorum": exc.quorum,
                "indeterminate": exc.indeterminate,
                "retry_after_s": exc.retry_after_s,
            }
            if exc.token:
                # the minted-but-unacked op identity
                body["token"] = {str(r): s for r, s in exc.token.items()}
            self._send_bytes(503, json.dumps(body).encode(), JSON,
                             extra_headers={"Retry-After": f"{exc.retry_after_s:.3f}"})

        def _send_shed(self, exc: ShedError):
            """429 Too Many Requests + Retry-After: the loud face of the
            shed policy (never a silent drop)."""
            body = {"shed": True, "lane": exc.lane, "n_ops": exc.n_ops,
                    "retry_after": exc.retry_after_s}
            if exc.tenant is not None:
                body["tenant"] = exc.tenant
            self._send_bytes(429, json.dumps(body).encode(), JSON,
                             extra_headers={"Retry-After": f"{exc.retry_after_s:.3f}"})

        def _parse_vv_query(self, url):
            """?vv=<json {rid: seq}> -> dict, None (absent), or "bad"."""
            q = parse_qs(url.query)
            if "vv" not in q:
                return None
            try:
                return {int(r): int(s) for r, s in json.loads(q["vv"][0]).items()}
            except (ValueError, TypeError, AttributeError):
                return "bad"

        def _body(self):
            n = int(self.headers.get("Content-Length", 0))
            return self.rfile.read(n)

        # ---- the typed siblings ----

        def _sibling_get(self, kind: str, sib, url) -> None:
            if url.path == f"/{kind}":
                view = sib.members() if kind == "set" else sib.items()
                if view is None:
                    self._send(502, "Unreachable")
                else:
                    self._send_json(200, {"members" if kind == "set" else "items": view})
            elif url.path == f"/{kind}/gossip":
                since = self._parse_vv_query(url)
                if since == "bad":
                    self._send(400, "invalid vv")
                    return
                payload = sib.gossip_payload(since=since)
                if payload is None:
                    self._send(502, "Unreachable")
                else:
                    self._send_json(200, payload)
            elif url.path == f"/{kind}/vv":
                if not sib.alive:
                    self._send(502, "Unreachable")
                    return
                vv, second = sib.vv_snapshot()
                if kind == "map":
                    self._send_json(200, {"vv": _ranks(vv), "epochs": second,
                                          "records": sib.n_records()})
                else:
                    self._send_json(200, {"vv": _ranks(vv), "floor": _ranks(second)})
            else:
                self._send(404, "not found")

        def _sibling_post(self, kind: str, sib, path: str) -> None:
            try:
                body = json.loads(self._body() or b"{}")
                assert isinstance(body, dict)
            except Exception:
                self._send(400, "invalid body")
                return
            verb = path[len(kind) + 2:]
            if (kind, verb) in (("set", "remove"), ("seq", "remove"), ("set", "collect"),
                                ("seq", "collect"), ("map", "rem"), ("map", "reset")) \
                    and not sib.alive:
                self._send(502, "Unreachable")
                return
            if verb == "collect" and kind != "map":
                try:
                    floor = _int_map(body.get("floor"))
                except Exception:
                    self._send(400, "invalid floor")
                    return
                sib.collect(floor)
                self._send(200, "OK")
            elif (kind, verb) == ("set", "add"):
                self._send_ident(sib.add(str(body.get("elem", ""))))
            elif (kind, verb) == ("set", "remove"):
                ident = sib.remove(str(body.get("elem", "")))
                self._send_removed(sib, ident, "tags", lambda op: op.get("tags", []))
            elif (kind, verb) == ("seq", "insert"):
                at = body.get("index")
                try:
                    at = None if at is None else int(at)
                except (TypeError, ValueError):
                    self._send(400, "invalid index")
                    return
                self._send_ident(sib.insert_at(at, str(body.get("elem", ""))))
            elif (kind, verb) == ("seq", "remove"):
                try:
                    at = int(body.get("index"))
                except (TypeError, ValueError):
                    self._send(400, "invalid index")
                    return
                ident = sib.remove_at(at)
                self._send_removed(sib, ident, "target", lambda op: op.get("del"))
            elif (kind, verb) == ("map", "upd"):
                self._map_upd(sib, body)
            elif (kind, verb) == ("map", "rem"):
                ident = sib.rem(str(body.get("key", "")))
                op = (sib.op_record(ident) if ident else None) or {}
                self._send_json(200, {
                    "removed": ident is not None,
                    "rid": ident[0] if ident else None,
                    "seq": ident[1] if ident else None,
                    "obs": op.get("obs", {}), "e": int(op.get("e", 0))})
            elif (kind, verb) == ("map", "reset"):
                try:
                    epochs = {str(k): int(e) for k, e in (body.get("epochs") or {}).items()}
                except Exception:
                    self._send(400, "invalid epochs")
                    return
                sib.adopt_epochs(epochs)
                self._send(200, "OK")
            else:
                self._send(404, "not found")

        def _send_ident(self, ident) -> None:
            if ident is None:
                self._send(502, "Unreachable")
            else:
                self._send_json(200, {"rid": ident[0], "seq": ident[1]})

        def _send_removed(self, sib, ident, field: str, pick) -> None:
            op = (sib.op_record(ident) if ident else None) or {}
            self._send_json(200, {"removed": ident is not None,
                                  "rid": ident[0] if ident else None,
                                  "seq": ident[1] if ident else None,
                                  field: pick(op)})

        def _map_upd(self, mn, body) -> None:
            try:
                delta = int(body.get("delta"))
            except (TypeError, ValueError):
                self._send(400, "invalid delta")
                return
            front = self.ingest
            key = str(body.get("key", ""))
            tenant = self.headers.get(TENANT_HEADER)
            if tenant is not None and self.ks_door is not None:
                # books against the tenant's quota slice, the key lands
                # qualified
                try:
                    ident = self.ks_door.admit_map_upd(tenant, key, delta)
                except ShedError as e:
                    self._send_shed(e)
                    return
                except ValueError as e:  # a bad tenant name
                    self._send(400, str(e))
                    return
            elif front is not None and front.map is not None:
                # singleton map writes share the page path's admission
                # queue: one drain = one batched mint
                try:
                    ident = front.admit_map_upd(key, delta)
                except ShedError as e:
                    self._send_shed(e)
                    return
            else:
                ident = mn.upd(key, delta)
            if ident is None:
                self._send(502, "Unreachable")
            else:
                op = mn.op_record(ident) or {}
                self._send_json(200, {"rid": ident[0], "seq": ident[1],
                                      "e": int(op.get("e", 0))})

        # ---- GET ----

        def do_GET(self):
            url = urlparse(self.path)
            parts = [p for p in url.path.split("/") if p]
            if parts and parts[0] in ("set", "seq", "map"):
                sib = sibling(parts[0])
                if sib is not None:
                    self._sibling_get(parts[0], sib, url)
                    return
            if parts and parts[0] == "composite" and sibling("composite") is not None:
                self._composite_get(sibling("composite"), url.path)
                return
            if parts and parts[0] == "ks" and self.keyspace is not None:
                self._ks_get(self.keyspace, url)
                return
            if url.path == "/metrics":
                self._send(200, self._metrics_text(), PROM_CTYPE)
            elif url.path == "/fleet":
                self._fleet(url)
            elif url.path == "/audit":
                wd = getattr(agent, "watchdog", None)
                if wd is None:
                    self._send(404, "no audit watchdog on this node")
                else:
                    self._send_bytes(200, wd.report_json(), JSON)
            elif url.path == "/ping":
                if self.node.ping():
                    self._send(200, "Pong")
                else:
                    self._send(502, "Unreachable")
            elif url.path == "/data":
                tenant = self.headers.get(TENANT_HEADER)
                if tenant is not None and self.keyspace is not None:
                    # the tenant's slice of the keyspace, un-qualified
                    if not self.node.alive:
                        self._send(502, "Unreachable")
                    else:
                        self._send_json(200, self.keyspace.tenant_state(tenant))
                    return
                state = self.node.get_state()
                if state is None:
                    self._send(502, "Unreachable")
                else:
                    self._send_json(200, state)
            elif url.path == "/gossip":
                self._gossip(url)
            elif url.path == "/read":
                self._read(url)
            elif url.path == "/vv":
                if not self.node.alive:
                    self._send(502, "Unreachable")
                    return
                vv, frontier = self.node.vv_snapshot()  # one lock: a consistent pair
                self._send_json(200, {"vv": _ranks(vv), "frontier": _ranks(frontier)})
            elif parts and parts[0] == "condition":
                flag = parts[1] if len(parts) > 1 else \
                    parse_qs(url.query).get("alive_status", [None])[0]
                if flag is None or flag.lower() not in ("true", "false", "1", "0"):
                    self._send(500, "invalid alive_status")
                    return
                self.node.set_alive(flag.lower() in ("true", "1"))
                self._send(200, "OK")
            else:
                self._send(404, "not found")

        def _metrics_text(self) -> str:
            """The Prometheus exposition: the node's registry and the health
            gauges of every plane this handler serves, sampled now."""
            return health.render_node_metrics(
                self.node, set_node=sibling("set"), seq_node=sibling("seq"),
                map_node=sibling("map"), composite_node=sibling("composite"),
                agent=agent, ingest=self.ingest,
                stability=getattr(agent, "stability", None),
                keyspace=self.keyspace, ks_door=self.ks_door, leases=self.leases,
                watchdog=getattr(agent, "watchdog", None))

        def _fleet(self, url) -> None:
            """GET /fleet: this node's exposition and every reachable peer's
            /metrics, folded by obs.fleet (the CLI's code path); slo_breach
            events land in this node's event log."""
            from crdt_tpu_torch.obs import fleet as fleet_lib

            texts = {str(self.node.rid): self._metrics_text()}
            if agent is not None:
                for p in agent.peers:
                    if p.backed_off():
                        continue
                    text = p.metrics_text()
                    if text is not None:
                        texts[p.url] = text
            q = parse_qs(url.query)
            slo = {}
            for key in ("admit_p99_ms", "prop_p99_steps", "shed_ratio"):
                if key in q:
                    try:
                        slo[key] = float(q[key][0])
                    except ValueError:
                        self._send(400, f"invalid {key}")
                        return
            report = fleet_lib.fleet_from_texts(
                texts, slo=slo or None, events=self.node.events)
            self._send_json(200, report)

        def _ks_get(self, ks, url) -> None:
            """GET /ks/gossip (one shard's delta and its stability summary,
            epoch-fenced) and GET /ks/data (a tenant's state, or the
            per-shard stats)."""
            if url.path == "/ks/gossip":
                if not self.node.alive:
                    self._send(502, "Unreachable")
                    return
                q = parse_qs(url.query)
                try:
                    shard = int(q.get("shard", [None])[0])
                    assert 0 <= shard < ks.n_shards
                except (TypeError, ValueError, AssertionError):
                    self._send(400, "invalid shard")
                    return
                # a puller at another reshard epoch gets a 409 naming ours
                # (no ?epoch= means epoch 0)
                fence = ks.check_epoch(q.get("epoch", [None])[0], "ks_gossip",
                                       peer=self.client_address[0])
                if fence is not None:
                    self._send_json(409, fence)
                    return
                since = self._parse_vv_query(url)
                if since == "bad":
                    self._send(400, "invalid vv")
                    return
                trace = self.headers.get(TRACE_HEADER)
                payload = ks.gossip_payload(shard, since=since)
                if trace:
                    self.node.events.emit(
                        "ks_gossip_serve", trace=trace, shard=shard,
                        peer=self.client_address[0], delta=since is not None)
                # the shard's stability summary and audit digest ride the
                # BODY: a round pulls several shards
                vv, frontier, dig = ks.audit_snapshot(shard)
                body = {"payload": payload, "vv": _ranks(vv),
                        "frontier": _ranks(frontier)}
                if dig is not None:
                    body["digest"] = dig
                self._send_bytes(200, json.dumps(body).encode(), JSON,
                                 extra_headers={TRACE_HEADER: trace} if trace else None)
            elif url.path == "/ks/data":
                if not self.node.alive:
                    self._send(502, "Unreachable")
                    return
                tenant = parse_qs(url.query).get("tenant", [None])[0]
                if tenant is not None:
                    self._send_json(200, {"tenant": tenant,
                                          "state": ks.tenant_state(tenant)})
                else:
                    self._send_json(200, {"shards": ks.shard_stats()})
            else:
                self._send(404, "not found")

        def _read(self, url) -> None:
            """GET /read?key=&level=[&staleness=]: one read at a consistency
            level, through the consistency plane."""
            plane = self.consistency
            if plane is None:
                self._send(404, "no consistency plane on this node")
                return
            q = parse_qs(url.query)
            key = q.get("key", [None])[0]
            if key is None:
                self._send(400, "missing key")
                return
            level = q.get("level", ["eventual"])[0]
            token = decode_token(self.headers.get(SESSION_TOKEN_HEADER))
            if level == "session" and token is None:
                self._send(400, "session read requires a valid "
                                f"{SESSION_TOKEN_HEADER} header")
                return
            staleness = None
            if "staleness" in q:
                try:
                    staleness = int(q["staleness"][0])
                except ValueError:
                    self._send(400, "staleness must be an integer op budget")
                    return
            try:
                value = plane.read(key, level=level, token=token,
                                   staleness=staleness)
            except ValueError as e:
                self._send(400, str(e))
                return
            except ConsistencyUnavailable as e:
                self._send_unavailable(e)
                return
            self._send_json(200, {"key": key, "value": value, "level": level})

        def _composite_get(self, cn, path: str) -> None:
            if path == "/composite":
                items = cn.items()
                if items is None:
                    self._send(502, "Unreachable")
                else:
                    self._send_json(200, {"items": items})
            elif path == "/composite/gossip":
                # state-based: the full trimmed dump, no vv query
                payload = cn.gossip_payload()
                if payload is None:
                    self._send(502, "Unreachable")
                else:
                    self._send_json(200, payload)
            else:
                self._send(404, "not found")

        def _gossip(self, url) -> None:
            """GET /gossip[?vv=]: the full log (the reference's dump, as long
            as the node never compacted) or the delta the caller lacks."""
            since = None
            q = parse_qs(url.query)
            if "vv" in q:
                try:
                    since = {int(r): int(s) for r, s in json.loads(q["vv"][0]).items()}
                except Exception:
                    self._send(400, "invalid vv")
                    return
            trace = self.headers.get(TRACE_HEADER)
            body = self.node.gossip_payload_json(since=since)
            if body is None:
                self._send(502, "Unreachable")
                return
            if trace:
                # the serve side of the round: the puller's trace ID
                self.node.events.emit("gossip_serve", trace=trace,
                                      peer=self.client_address[0],
                                      delta=since is not None, bytes=len(body))
            # every gossip answer piggybacks this node's stability summary
            vv, frontier, dig = self.node.audit_snapshot()
            extra = {STABILITY_HEADER: encode_summary(self.node.rid, vv, frontier, digest=dig)}
            if trace:
                extra[TRACE_HEADER] = trace
            self._send_bytes(200, body, JSON, extra_headers=extra)

        # ---- POST ----

        def do_POST(self):
            path = urlparse(self.path).path
            if path == "/ingest/page":
                self._ingest_page()
                return
            if path.startswith("/admin/") and admin is not None:
                self._admin(path)
                return
            kind = path.split("/")[1] if path.count("/") > 1 else ""
            if kind in ("set", "seq", "map"):
                sib = sibling(kind)
                if sib is not None:
                    self._sibling_post(kind, sib, path)
                    return
            if kind == "composite" and sibling("composite") is not None:
                self._composite_post(sibling("composite"), path)
                return
            if path in ("/ks/compact", "/ks/migrate"):
                self._ks_post(path)
            elif path == "/compact":
                self._compact()
            elif path == "/push":
                self._push()
            elif path == "/lease/grant":
                self._lease_grant()
            elif path == "/cas":
                self._cas()
            elif path != "/data":
                self._send(404, "not found")
            else:
                self._post_data()

        def _admin(self, path: str) -> None:
            """POST /admin/*: drive the daemon's pulls, barriers and
            checkpoints (a failure answers 500 naming it, never a silent
            skip)."""
            try:
                body = json.loads(self._body() or b"{}")
            except ValueError:
                self._send(400, "invalid body")
                return
            pulls = {"/admin/pull": admin.admin_pull, "/admin/set_pull": admin.admin_set_pull,
                     "/admin/seq_pull": admin.admin_seq_pull,
                     "/admin/map_pull": admin.admin_map_pull,
                     "/admin/composite_pull": admin.admin_composite_pull}
            try:
                if path in pulls:
                    self._send_json(200, {"pulled": bool(pulls[path](body.get("peer")))})
                elif path in ("/admin/barrier", "/admin/stability_gc"):
                    frontier = (admin.admin_barrier() if path == "/admin/barrier"
                                else admin.admin_stability_gc())
                    self._send_json(200, {"frontier": _ranks(frontier)})
                elif path == "/admin/checkpoint":
                    snap = admin.checkpoint_now()
                    if snap is None:
                        self._send(400, "no checkpoint dir configured")
                    else:
                        self._send_json(200, {"snapshot": snap})
                elif path in ("/admin/set_barrier", "/admin/seq_barrier"):
                    floor = (admin.admin_set_barrier() if path == "/admin/set_barrier"
                             else admin.admin_seq_barrier())
                    self._send_json(200, {"floor": _ranks(floor)})
                elif path == "/admin/map_barrier":
                    out = admin.admin_map_barrier()
                    self._send_json(200, {"epochs": {str(k): int(e)
                                                     for k, e in out["epochs"].items()},
                                          "status": out["status"]})
                elif path == "/admin/ks_pull":
                    self._send_json(200, {"fresh": int(admin.admin_ks_pull(body.get("peer")))})
                elif path == "/admin/ks_reshard":
                    try:
                        out = admin.admin_ks_reshard(body)
                    except ValueError as e:
                        self._send(400, str(e))
                    else:
                        self._send_json(200, out)
                elif path == "/admin/ks_gc":
                    folded = admin.admin_ks_gc()
                    self._send_json(200, {"shards": {str(i): _ranks(f)
                                                     for i, f in folded.items()}})
                else:
                    self._send(404, "not found")
            except Exception as e:  # noqa: BLE001 — answered, never a silent skip
                self._send(500, f"{type(e).__name__}: {e}")

        def _composite_post(self, cn, path: str) -> None:
            try:
                body = json.loads(self._body() or b"{}")
                assert isinstance(body, dict)
            except Exception:
                self._send(400, "invalid body")
                return
            if path == "/composite/upd":
                try:
                    delta = int(body.get("delta"))
                except (TypeError, ValueError):
                    self._send(400, "invalid delta")
                    return
                front = self.ingest
                key = str(body.get("key", ""))
                if front is not None and front.composite is not None:
                    try:
                        value = front.admit_composite_upd(key, delta)
                    except ShedError as e:
                        self._send_shed(e)
                        return
                else:
                    value = cn.upd(key, delta)
                if value is None:
                    self._send(502, "Unreachable")
                else:
                    self._send_json(200, {"value": value})
            elif path == "/composite/rem":
                removed = cn.rem(str(body.get("key", "")))
                if removed is None:
                    self._send(502, "Unreachable")
                else:
                    self._send_json(200, {"removed": removed})
            else:
                self._send(404, "not found")

        def _ingest_page(self) -> None:
            front = self.ingest
            if front is None:
                self._send(404, "no ingest front door on this node")
                return
            raw = self._body()
            if not self.node.alive:
                self._send(502, "Unreachable")
                return
            tenant = self.headers.get(TENANT_HEADER)
            try:
                if tenant is not None and self.ks_door is not None:
                    # a writer that stamps its reshard epoch gets a 409
                    # naming ours when stale
                    eh = self.headers.get(KS_EPOCH_HEADER)
                    if eh is not None:
                        fence = self.keyspace.check_epoch(
                            eh, "ingest_page", peer=self.client_address[0])
                        if fence is not None:
                            self._send_json(409, fence)
                            return
                    # rendezvous fan-out across the shard lanes, the
                    # tenant's quota slice, whole-page shed
                    out = self.ks_door.admit_page(raw, tenant)
                else:
                    out = front.admit_page(raw, tenant=tenant)
            except PageFormatError as e:
                # decoded and validated whole before any op is admitted: a
                # truncated page is "no page", never "some ops"
                self._send(400, f"page quarantined: {e}")
                return
            except ValueError as e:  # a bad tenant name
                self._send(400, str(e))
                return
            except ShedError as e:
                self._send_shed(e)
                return
            self._send_json(200, out)

        def _compact(self) -> None:
            try:
                body = json.loads(self._body() or b"{}")
                frontier = _int_map(body.get("frontier"))
            except Exception:
                self._send(400, "invalid frontier")
                return
            if not self.node.alive:
                self._send(502, "Unreachable")
                return
            self.node.compact(frontier)
            self._send(200, "OK")

        def _push(self) -> None:
            """Merge the pushed payload BEFORE answering, so a 200 proves this
            node's vv dominates every op it carried."""
            try:
                body = json.loads(self._body() or b"{}")
                payload = body.get("payload")
                assert isinstance(payload, dict)
                fences = _int_map(body.get("fences"))
                trace = body.get("trace")
                trace = None if trace is None else str(trace)
            except Exception:
                self._send(400, "invalid payload")
                return
            if not self.node.alive:
                self._send(502, "Unreachable")
                return
            if fences and self.leases is not None:
                # the fence firewall BEFORE the merge: a push stamped with a
                # superseded lease epoch is refused whole
                stale = self.leases.check_push_fences(fences, trace=trace)
                if stale is not None:
                    self._send_json(409, {"fenced": True, "slot": stale["slot"],
                                          "fence": stale["fence"]})
                    return
            try:
                if trace:
                    with span("crdt.push", trace):
                        fresh = self.node.receive(payload)
                else:
                    fresh = self.node.receive(payload)
            except (ValueError, KeyError, TypeError) as e:
                self._send(400, f"malformed payload: {type(e).__name__}: {e}")
                return
            self._send_json(200, {"fresh": fresh})

        def _ks_post(self, path: str) -> None:
            """POST /ks/compact (fold one shard) and /ks/migrate (one
            reshard migration slice), both epoch-fenced."""
            ks = self.keyspace
            if ks is None:
                self._send(404, "no keyspace tier on this node")
                return
            try:
                body = json.loads(self._body() or b"{}")
                shard = int(body.get("shard"))
                if path == "/ks/compact":
                    assert 0 <= shard < ks.n_shards
                    frontier = _int_map(body.get("frontier"))
                else:
                    payload = body.get("payload")
                    assert isinstance(payload, dict)
            except Exception:
                self._send(400, "invalid shard/frontier" if path == "/ks/compact"
                           else "invalid shard/payload")
                return
            if not self.node.alive:
                self._send(502, "Unreachable")
                return
            # a frontier or slice minted against another plane generation
            # must never touch this one (absent epoch = epoch 0)
            fence = ks.check_epoch(body.get("epoch"), path[1:].replace("/", "_"),
                                   peer=self.client_address[0])
            if fence is not None:
                self._send_json(409, fence)
                return
            if path == "/ks/compact":
                ks.compact_shard(shard, frontier)
                self._send(200, "OK")
                return
            out = ks.reshard.receive_migration(shard, payload,
                                               peer=self.client_address[0])
            if out.get("ok"):
                self._send_json(200, out)
            elif "quarantined" in out:
                self._send_json(400, out)
            else:
                # not in a MIGRATE window at this epoch: the fence's 409
                # grammar, so the sender retries later
                out["fenced"] = True
                out["epoch"] = ks.epoch
                self._send_json(409, out)

        def _lease_grant(self) -> None:
            """POST /lease/grant: one coordinator-lease vote."""
            leases = self.leases
            if leases is None:
                self._send(404, "no lease manager on this node")
                return
            try:
                body = json.loads(self._body() or b"{}")
                slot = int(body["slot"])
                holder = str(body["holder"])
                fence = int(body["fence"])
                ttl = float(body["ttl"])
                assert 0 <= slot < leases.n_slots and fence > 0 and ttl > 0
            except Exception:
                self._send(400, "invalid grant request: need slot/holder/fence/ttl")
                return
            if not self.node.alive:
                self._send(502, "Unreachable")
                return
            self._send_json(200, leases.grant(slot, holder, fence, ttl))

        def _cas(self) -> None:
            """POST /cas: one CAS or an all-or-nothing multi-key batch,
            routed to the slot coordinator by the consistency plane."""
            plane = self.consistency
            if plane is None:
                self._send(404, "no consistency plane on this node")
                return
            try:
                body = json.loads(self._body() or b"{}")
                assert isinstance(body, dict)
                if "ops" in body:
                    assert isinstance(body["ops"], dict) and body["ops"]
                    ops = {}
                    for k, ou in body["ops"].items():
                        e = ou.get("expect")
                        ops[str(k)] = (None if e is None else str(e), str(ou["update"]))
                else:
                    expect = body.get("expect")
                    ops = {str(body["key"]): (None if expect is None else str(expect),
                                              str(body["update"]))}
                hops = int(body.get("hops", 0))
                timeout = body.get("timeout")
                timeout = None if timeout is None else float(timeout)
                assert hops >= 0
            except Exception:
                self._send(400, "invalid body: need key/update or "
                                "ops={key:{expect,update}} "
                                "(expect null = key must be absent)")
                return
            # the request's trace: the header from external clients, the
            # body field across coordinator forwarding hops
            trace = self.headers.get(TRACE_HEADER) or body.get("trace")
            trace = None if trace is None else str(trace)
            try:
                token = plane.cas_multi(ops, timeout=timeout, hops=hops, trace=trace)
            except CasConflict as e:
                self._send_json(409, {"conflict": True, "key": e.key,
                                      "expect": e.expect, "actual": e.actual,
                                      "coordinator": e.coordinator, "fence": e.fence})
                return
            except ConsistencyUnavailable as e:
                self._send_unavailable(e)
                return
            self._send_bytes(200, json.dumps({"token": _ranks(token)}).encode(), JSON,
                             extra_headers={SESSION_TOKEN_HEADER: encode_token(token)})

        def _post_data(self) -> None:
            try:
                cmd = json.loads(self._body() or b"{}")
                assert isinstance(cmd, dict)
                cmd = {str(k): str(v) for k, v in cmd.items()}
            except Exception:
                self._send(500, "Request body is invalid")  # main.go:179-186
                return
            tenant = self.headers.get(TENANT_HEADER)
            if tenant is not None and self.ks_door is not None:
                # every pair routes to its owning shard's lane (all or
                # nothing); the LAST pair's ident mints the session token
                try:
                    idents = self.ks_door.admit_cmd(tenant, cmd)
                except ShedError as e:
                    self._send_shed(e)
                    return
                except ValueError as e:  # a bad tenant name
                    self._send(400, str(e))
                    return
                if idents and all(i is not None for i in idents):
                    ident = idents[-1]
                    self._send_bytes(200, b"Inserted", "text/plain", extra_headers={
                        SESSION_TOKEN_HEADER: encode_token({ident[0]: ident[1]})})
                else:
                    self._send(502, "Unreachable")
                return
            front = self.ingest
            if front is None:
                if self.node.add_command(cmd):
                    self._send(200, "Inserted")  # main.go:208
                else:
                    self._send(502, "Unreachable")
                return
            # the single-op route rides the same admission lane as op pages
            try:
                ident = front.admit_kv(cmd, tenant=tenant)
            except ShedError as e:
                self._send_shed(e)
                return
            if ident is None:
                self._send(502, "Unreachable")
                return
            # the ticket ident IS the session token, in a header so the
            # body stays the reference's
            self._send_bytes(200, b"Inserted", "text/plain", extra_headers={
                SESSION_TOKEN_HEADER: encode_token({ident[0]: ident[1]})})

    return Handler


class HttpCluster:
    """Serve every node of a LocalCluster on its own port."""

    def __init__(self, cluster, host: str = "127.0.0.1"):
        self.cluster = cluster
        self.host = host
        self.servers: List[ThreadingHTTPServer] = []
        self.ports: List[int] = []
        self._threads: List[threading.Thread] = []

    def start(self, ports: Optional[List[int]] = None) -> List[int]:
        ports = ports or [0] * len(self.cluster.nodes)  # 0 = ephemeral
        for idx, port in enumerate(ports[: len(self.cluster.nodes)]):
            srv = ThreadingHTTPServer((self.host, port), _make_handler(self.cluster, idx))
            self.servers.append(srv)
            self.ports.append(srv.server_address[1])
            t = threading.Thread(target=srv.serve_forever, daemon=True)
            t.start()
            self._threads.append(t)
        return self.ports

    @property
    def urls(self) -> List[str]:
        return [f"http://{self.host}:{p}" for p in self.ports]

    def stop(self) -> None:
        # each serve_forever polls its shutdown flag every 0.5 s: signal
        # every server at once rather than one after the other
        signals = [threading.Thread(target=srv.shutdown) for srv in self.servers]
        for t in signals:
            t.start()
        for t in signals:
            t.join()
        for srv in self.servers:
            srv.server_close()
        for t in self._threads:
            t.join(timeout=5)
        self.servers.clear()
        self._threads.clear()
