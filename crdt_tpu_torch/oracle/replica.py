"""Reference-semantics oracle (own plain-Python copy of
``crdt_tpu.oracle.replica``): a replica reproducing the Go server's op-log /
merge / rebuild behaviour exactly, with every documented quirk
individually togglable (SURVEY.md §0.1).

This is the ground truth for two parity surfaces:

* quirks OFF  → the *fixed* semantics the port's OpLog
  (crdt_tpu_torch.models.oplog) implements: op identity (ts, rid, seq),
  full union, all ops count;
* quirks ON   → the reference's observable behaviour bit-for-bit (local-op
  exclusion after merge, ts-only log keys, tail-drop, multi-key early return,
  local-wins collisions), for black-box parity against the Go server.

Citations refer to the reference's main.go.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple


@dataclasses.dataclass
class Quirks:
    """Each flag reproduces one reference quirk when True (defaults: all off
    = fixed semantics).  Numbering follows SURVEY.md §0.1."""

    # §0.1.1: local writes are stored as pointers and excluded from the
    # rebuild's type assertion (main.go:80-81) — after any merge, a replica's
    # own ops no longer count toward its *local* materialized state.
    local_op_exclusion: bool = False
    # §0.1.2: the log key is the millisecond timestamp alone (main.go:187) —
    # same-ms writes overwrite each other.
    ts_only_keys: bool = False
    # §0.1.3: the union loop stops at the shorter log (main.go:49) — remote
    # entries newer than the newest local entry are dropped this round.
    tail_drop: bool = False
    # §0.1.4: a multi-key command stops applying to CurrentState after the
    # first previously-unseen key (main.go:190-194).  (The log keeps all keys.)
    multikey_early_return: bool = False
    # §0.1.11-adjacent: a value that fails Atoi during the eager fold aborts
    # the whole handler (main.go:195-204) instead of skipping that key the
    # way the merge-time rebuild does (main.go:87-96).
    handler_error_return: bool = False

    @classmethod
    def reference(cls) -> "Quirks":
        return cls(
            local_op_exclusion=True,
            ts_only_keys=True,
            tail_drop=True,
            multikey_early_return=True,
            handler_error_return=True,
        )


INT64_MIN, INT64_MAX = -(2**63), 2**63 - 1


def _atoi_ex(s: str):
    """Go strconv.Atoi on a 64-bit platform: optional sign + digits, no
    '_'/whitespace, bounded to int64.  Returns (value_or_None, kind) with
    kind in {"ok", "syntax", "range"} — the reference surfaces the error
    KIND in handler bodies (err.Error(), main.go:197/202), so the oracle
    must distinguish ErrSyntax from ErrRange (Python ints are unbounded
    and would otherwise accept what Go rejects)."""
    if not s:
        return None, "syntax"
    body = s[1:] if s[0] in "+-" else s
    if not body or not body.isascii() or not body.isdigit():
        return None, "syntax"
    v = int(s)
    if not (INT64_MIN <= v <= INT64_MAX):
        return None, "range"
    return v, "ok"


def _atoi(s: str):
    """Value-only view of _atoi_ex (merge/rebuild only check err != nil,
    main.go:87-96 — both error kinds just skip the key)."""
    return _atoi_ex(s)[0]


@dataclasses.dataclass
class HandlerResult:
    """The gin outcome of one AddCommand call (main.go:173-215): exactly
    what the handler wrote — status code and body text.  The reference's
    error paths write gin's strconv error strings verbatim (main.go:197,
    main.go:202: ``c.String(500, err.Error())``)."""

    status: int
    body: str


def _copy_cmd(cmd: Optional[Dict[str, str]]) -> Optional[Dict[str, str]]:
    """Copy a command for log adoption; None is the nil command an invalid
    POST body Put into the log (marshals as JSON null, main.go:187)."""
    return dict(cmd) if cmd is not None else None


def _atoi_error(s: str, kind: str = "syntax") -> str:
    """Go's strconv.Atoi error text, as err.Error() renders it
    (strconv.NumError formatting; ErrSyntax vs ErrRange)."""
    reason = "value out of range" if kind == "range" else "invalid syntax"
    return f'strconv.Atoi: parsing "{s}": {reason}'


class OracleReplica:
    """One replica of the reference store.

    The log is a dict keyed by (ts,) under ts_only_keys else (ts, rid, seq);
    each entry is (command_dict, is_local).  `is_local` models the Go
    *Command-pointer vs plain-map distinction that drives quirk §0.1.1.
    """

    def __init__(self, rid: int = 0, quirks: Quirks | None = None):
        self.rid = rid
        self.quirks = quirks or Quirks()
        self.log: Dict[Tuple[int, ...], Tuple[Dict[str, str], bool]] = {}
        self.state: Dict[str, str] = {}
        self.alive = True
        self._seq = 0

    # ---- write path (AddCommand, main.go:173-215) ----

    def add_command(
        self, cmd: Optional[Dict[str, str]], ts: int
    ) -> HandlerResult:
        """One AddCommand call; returns the gin outcome (status, body).

        ``cmd=None`` models an unparseable request body: the handler writes
        500 "Request body is invalid" WITHOUT returning (main.go:183-186,
        quirk §0.1.11), still Puts the nil command into the log
        (main.go:187 — it serializes as JSON null in gossip), skips the
        nil-map range loop, and appends "Inserted" to the already-written
        500 response (main.go:208).
        """
        if not self.alive:
            return HandlerResult(502, "Unreachable")  # main.go:210-212
        seq = self._seq
        self._seq += 1
        key = (ts,) if self.quirks.ts_only_keys else (ts, self.rid, seq)
        self.log[key] = (dict(cmd) if cmd is not None else None, True)
        if cmd is None:
            return HandlerResult(500, "Request body is invalidInserted")
        # eager CurrentState fold (main.go:188-207)
        for k, v in cmd.items():
            if k not in self.state:
                self.state[k] = v
                if self.quirks.multikey_early_return:
                    # main.go:192-194's early return
                    return HandlerResult(200, "Inserted")
                continue
            curr, kind_c = _atoi_ex(self.state[k])
            if curr is None and self.quirks.handler_error_return:
                # main.go:195-198: 500s with Atoi's error and aborts
                return HandlerResult(500, _atoi_error(self.state[k], kind_c))
            change, kind_v = _atoi_ex(v)
            if change is None and self.quirks.handler_error_return:
                # main.go:200-203
                return HandlerResult(500, _atoi_error(v, kind_v))
            if curr is None or change is None:
                continue  # fixed semantics: skip this key, like the rebuild
            self.state[k] = str(curr + change)
        return HandlerResult(200, "Inserted")  # main.go:208

    # ---- gossip serving (Gossip, main.go:154-171) ----

    def gossip_payload(self) -> Dict[Tuple[int, ...], Dict[str, str]]:
        """Full op log, as the peer would receive it (values only — the
        pointer/local distinction does not survive serialization, which is
        exactly why remote-adopted entries DO count in the rebuild)."""
        if not self.alive:
            return {}
        return {
            k: (dict(v[0]) if v[0] is not None else None)
            for k, v in sorted(self.log.items())
        }

    # ---- anti-entropy (gossip goroutine + merge, main.go:226-261, 35-100) ----

    def receive(self, remote_log: Dict[Tuple[int, ...], Dict[str, str]]) -> None:
        # merge runs even for an EMPTY remote diff — the gossip goroutine
        # calls server.merge() unconditionally after the Put loop
        # (main.go:250-257), so a pull from an empty peer still triggers
        # the rebuild (and with quirks ON, the local-op exclusion §0.1.1).
        self.merge(remote_log)

    def merge(self, remote_log: Dict[Tuple[int, ...], Dict[str, str]]) -> None:
        local_keys = sorted(self.log)
        remote_keys = sorted(remote_log)
        if self.quirks.tail_drop:
            # two-pointer walk, stops when either side exhausts (main.go:49)
            i = j = 0
            while i < len(local_keys) and j < len(remote_keys):
                lk, rk = local_keys[i], remote_keys[j]
                if lk == rk:
                    # equal keys: local wins (main.go:54-65)
                    i += 1
                    j += 1
                elif lk > rk:
                    self.log[rk] = (_copy_cmd(remote_log[rk]), False)
                    j += 1
                else:
                    i += 1
        else:
            for rk in remote_keys:
                if rk not in self.log:
                    self.log[rk] = (_copy_cmd(remote_log[rk]), False)
                # else: local wins — keep the local entry (incl. its is_local)
        self._rebuild()

    # ---- state rebuild (main.go:76-98) ----

    def _rebuild(self) -> None:
        state: Dict[str, str] = {}
        # newest → oldest (reverse iteration, main.go:77-78)
        for key in sorted(self.log, reverse=True):
            cmd, is_local = self.log[key]
            if self.quirks.local_op_exclusion and is_local:
                # failed type assertion → nil map → no-op (main.go:80-81)
                continue
            if cmd is None:
                continue  # nil command: ranging over a nil map is a no-op
            for k, v in cmd.items():
                if k not in state:
                    state[k] = v
                    continue
                curr = _atoi(state[k])
                change = _atoi(v)
                if curr is None or change is None:
                    continue
                state[k] = str(curr + change)
        self.state = state

    def rebuilt_state(self) -> Dict[str, str]:
        """Force a rebuild and return the state.  NOTE: the reference's eager
        AddCommand fold and its merge-time rebuild genuinely disagree until
        the next merge (e.g. a non-numeric overwrite 500s eagerly but wins at
        rebuild); the device KVState always equals the rebuild, so parity tests
        compare against this, not the eager `state`."""
        self._rebuild()
        return dict(self.state)

    # ---- converged ground truth ----

    @staticmethod
    def converged_state(replicas: List["OracleReplica"]) -> Dict[str, str]:
        """The state every replica reaches at the gossip fixpoint: rebuild
        over the union of all logs (quirks-off semantics)."""
        union: Dict[Tuple[int, ...], Optional[Dict[str, str]]] = {}
        for r in replicas:
            for k, (cmd, _) in r.log.items():
                union.setdefault(k, _copy_cmd(cmd))
        probe = OracleReplica(rid=-1)
        probe.log = {k: (v, False) for k, v in union.items()}
        probe._rebuild()
        return probe.state
