"""Quirk-compat HTTP surface: the reference's observable behaviour over its
five routes, bit for bit, backed by the quirks-ON oracle (own copy of
``crdt_tpu.oracle.shim``).

Black-box parity runs against THIS server in place of the Go original: it
serves over real HTTP exactly what ``go run main.go`` serves, bugs
included: ts-only log keys, the broken ``/condition`` route (always 500),
the multi-key early return, local-op exclusion after a merge and the
two-pointer tail drop.  The fixed surface is ``api.http_shim``.

Wire format: the reference's ``Gossip`` marshals its treemap as
{"<unix-ms>": {key: value}, ...} (main.go:159); with the ts_only_keys quirk
the oracle's log keys are 1-tuples, serialized as the bare millisecond
string, byte-compatible with the Go server's JSON.
"""
from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import List, Optional

from crdt_tpu_torch.oracle.replica import HandlerResult, OracleReplica, Quirks
from crdt_tpu_torch.utils.clock import HostClock


def _go_json_str(s: str) -> str:
    """One string, escaped exactly as Go's encoding/json encodeString
    does (with the default HTML escaping gin uses): only \\, \", \\n, \\r,
    \\t get short escapes; other control chars become \\u00xx (so \\b is
    \\u0008, NOT Python's \\b); <, >, & become \\u003c/e/26; everything
    else — including non-ASCII — is raw UTF-8."""
    out = ['"']
    for ch in s:
        if ch in ('"', "\\"):
            out.append("\\" + ch)
        elif ch == "\n":
            out.append("\\n")
        elif ch == "\r":
            out.append("\\r")
        elif ch == "\t":
            out.append("\\t")
        elif ch < "\x20":
            out.append(f"\\u{ord(ch):04x}")
        elif ch in "<>&":
            out.append(f"\\u{ord(ch):04x}")
        elif ch in ("\u2028", "\u2029"):  # encoding/json escapes these too
            out.append(f"\\u{ord(ch):04x}")
        else:
            out.append(ch)
    out.append('"')
    return "".join(out)


def go_json_dumps(obj) -> str:
    """encoding/json-compatible marshal of (possibly nested) string maps:
    keys sorted lexicographically (Go sorts map keys in Marshal; the
    treemap's ToJSON at main.go:159 goes through map[string]interface{},
    so gossip key order is STRING order — equal to numeric order for the
    13-digit same-epoch ms keys, but not in general), no whitespace, raw
    UTF-8, and encodeString's exact escaping (see _go_json_str).  Handles
    the shim's value shapes: str, None (a nil *Command marshals as null),
    and nested string maps."""
    if obj is None:
        return "null"
    if isinstance(obj, str):
        return _go_json_str(obj)
    if isinstance(obj, dict):
        return "{" + ",".join(
            f"{_go_json_str(str(k))}:{go_json_dumps(v)}"
            for k, v in sorted(obj.items(), key=lambda kv: str(kv[0]))
        ) + "}"
    raise TypeError(f"go_json_dumps: unsupported type {type(obj)!r}")


class OracleNode:
    """One quirks-ON oracle replica + the host plumbing the shim needs."""

    def __init__(self, rid: int, clock: Optional[HostClock] = None):
        self.oracle = OracleReplica(rid=rid, quirks=Quirks.reference())
        self.clock = clock or HostClock()
        self._lock = threading.Lock()  # the reference's Server.Lock

    @property
    def alive(self) -> bool:
        return self.oracle.alive

    def add_command(self, cmd) -> HandlerResult:
        """AddCommand under the lock (main.go:175); cmd=None is an
        unparseable body (the no-return 500 path, quirk §0.1.11)."""
        with self._lock:
            return self.oracle.add_command(
                dict(cmd) if cmd is not None else None,
                ts=self.clock.now_ms(),
            )

    def get_state(self):
        # GetState reads CurrentState without the lock (quirk §0.1.6);
        # faithfully lock-free here
        if not self.oracle.alive:
            return None
        return dict(self.oracle.state)

    def gossip_wire(self) -> Optional[str]:
        with self._lock:  # Gossip takes the lock (main.go:156)
            if not self.oracle.alive:
                return None
            return go_json_dumps(
                # log entries are (command, is_local): the pointer/value
                # distinction does not survive serialization (main.go:159),
                # which is exactly what makes quirk 0.1.1 asymmetric; a nil
                # command (invalid-body Put, main.go:187) marshals as null
                {str(k[0]): entry[0]
                 for k, entry in sorted(self.oracle.log.items())}
            )

    def receive_wire(self, body: str) -> None:
        """The gossip goroutine's unmarshal + merge (main.go:241-257)."""
        remote = {
            (int(ts),): (dict(cmd) if cmd is not None else None)
            for ts, cmd in json.loads(body).items()
        }
        with self._lock:
            self.oracle.merge(remote)


TEXT_PLAIN = "text/plain; charset=utf-8"     # gin c.String's content type
APP_JSON_CHARSET = "application/json; charset=utf-8"  # gin c.JSON's
APP_JSON = "application/json"  # Gossip sets the header by hand (main.go:163)


def _make_handler(node: OracleNode):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def _send(self, code, body, ctype=TEXT_PLAIN):
            data = body.encode()
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def do_GET(self):
            path = self.path.split("?")[0]
            if path == "/ping":
                if node.alive:
                    self._send(200, "Pong")  # main.go:120
                else:
                    self._send(502, "Unreachable")  # main.go:123
            elif path == "/data":
                state = node.get_state()
                if state is None:
                    self._send(502, "Unreachable")  # main.go:135
                else:
                    # c.JSON of map[string]string: sorted keys, HTML-escaped
                    self._send(200, go_json_dumps(state), APP_JSON_CHARSET)
            elif path == "/gossip":
                wire = node.gossip_wire()
                if wire is None:
                    self._send(502, "Unreachable")  # main.go:167
                else:
                    self._send(200, wire, APP_JSON)  # main.go:163-164
            elif path == "/condition":
                # the reference registered the route WITHOUT the parameter
                # binding (main.go:266 vs main.go:145), so the handler runs
                # ParseBool("") and 500s with its exact error (main.go:147)
                self._send(
                    500, 'strconv.ParseBool: parsing "": invalid syntax'
                )
            else:
                self._send(404, "404 page not found")  # gin's default 404

        def do_POST(self):
            if self.path.split("?")[0] != "/data":
                self._send(404, "404 page not found")
                return
            n = int(self.headers.get("Content-Length", 0))
            try:
                cmd = json.loads(self.rfile.read(n) or b"")
                assert isinstance(cmd, dict)
                cmd = {str(k): str(v) for k, v in cmd.items()}
            except Exception:
                # unparseable body: the handler 500s but does NOT return
                # (main.go:183-186, quirk §0.1.11) — the nil command is
                # still Put into the log and "Inserted" is appended to the
                # 500 body (main.go:187, main.go:208).  OracleNode models
                # this as add_command(None).
                cmd = None
            res = node.add_command(cmd)
            self._send(res.status, res.body)

    return Handler


class OracleHttpCluster:
    """N quirks-ON replicas served on real sockets + a manual gossip
    driver (pull `idx` from `peer` — the goroutine at main.go:226-261,
    driven deterministically for tests)."""

    def __init__(self, n: int = 2, clock: Optional[HostClock] = None):
        clock = clock or HostClock()
        self.nodes: List[OracleNode] = [
            OracleNode(rid=i, clock=clock) for i in range(n)
        ]
        self.servers: List[ThreadingHTTPServer] = []
        self.urls: List[str] = []

    def start(self) -> List[str]:
        for node in self.nodes:
            srv = ThreadingHTTPServer(("127.0.0.1", 0), _make_handler(node))
            self.servers.append(srv)
            self.urls.append(f"http://127.0.0.1:{srv.server_address[1]}")
            threading.Thread(target=srv.serve_forever, daemon=True).start()
        return self.urls

    def stop(self) -> None:
        for srv in self.servers:
            srv.shutdown()
            srv.server_close()
        self.servers.clear()

    def gossip_once(self, idx: int, peer: int) -> bool:
        """node idx pulls peer's full log over HTTP and merges."""
        import urllib.error
        import urllib.request

        try:
            with urllib.request.urlopen(
                self.urls[peer] + "/gossip", timeout=5
            ) as res:
                if res.status != 200:
                    return False
                self.nodes[idx].receive_wire(res.read().decode())
                return True
        except (urllib.error.URLError, OSError):
            # dead peer skipped (main.go:235-239); a MALFORMED payload from
            # a live peer still raises out of receive_wire — the oracle must
            # be loud where the reference was silently lossy (quirk §0.1.8)
            return False
