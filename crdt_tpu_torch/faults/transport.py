"""FaultyTransport — the network boundary shim of the fault plane (own
copy of ``crdt_tpu.faults.transport``).

A drop-in ``RemotePeer`` subclass: the nemesis soak replaces each
NetworkAgent's peer clients with these, so EVERY wire interaction of the
runtime under test (gossip pulls, vv reads, barrier POSTs, the sibling
lattice surfaces) flows through the schedule's decisions — the runtime
itself is unmodified and unaware.

Fault semantics per kind (see also crdt_tpu_torch/faults/README.md):

* drop      — the message never arrives: counted as a TRANSPORT failure
              (trips the circuit breaker, exactly like a refused
              connection), caller takes its skip path.
* delay     — time.sleep(rule.arg) before the request (slow peer / long
              path); bounded small so soaks stay fast.
* truncate  — the response body is cut mid-byte.  For JSON endpoints the
              parse fails and the caller skips the round — deliberately:
              a PARTIAL gossip merge could adopt an op subset while the
              version vector claims the contiguous prefix, a permanent
              hole no later round repairs.  Truncation must surface as
              "no payload", never "some payload".
* corrupt   — bytes arrive altered.  Non-gossip bodies get a flipped
              first byte (breaks the JSON object → parse-skip); gossip
              and reshard-migration payloads get a mangled WIRE KEY /
              poisoned section instead — still valid JSON, so it reaches
              the node and must be QUARANTINED there (payload_quarantine
              / ks_reshard_quarantine event), which is the hardening this
              fault exists to exercise.
* duplicate — the payload is delivered now AND queued for redelivery on
              a later pull (same bytes twice; join idempotence makes the
              second a no-op).
* reorder   — the payload is withheld (caller sees an empty delta) and
              delivered on a LATER pull, after newer state already
              arrived — old-after-new delivery; join monotonicity makes
              it a no-op.
"""
from __future__ import annotations

import copy
import threading
import time
from typing import Any, Dict, List, Optional

from crdt_tpu_torch.api.net import RemotePeer
from crdt_tpu_torch.faults.schedule import FaultPlane

# cap injected per-message delays: a schedule with pathological args must
# slow the soak, not hang it
_MAX_DELAY_S = 0.05


def _op_of(path: str) -> str:
    """Wire path -> schedule op label: "/gossip?vv=..." -> "gossip",
    "/set/gossip" -> "set_gossip", "/condition/true" -> "condition_true"."""
    return path.split("?", 1)[0].strip("/").replace("/", "_") or "root"


def corrupt_page_bytes(raw: bytes, rng) -> bytes:
    """Wire corruption for a columnar op page (ingest/wire.py): flip one
    PAYLOAD byte at a seeded offset.  The page crc32 covers everything
    after the header, so one flipped payload byte always fails decode and
    the page must be quarantined WHOLE — no op prefix admitted.  The
    header's identity bytes (origin, page_seq) are deliberately not
    targeted: they sit outside the checksum, so flipping one forges a
    DIFFERENT valid page rather than a detectable corruption (an
    authenticity problem, out of scope for the integrity plane)."""
    from crdt_tpu_torch.ingest.wire import HEADER_SIZE

    assert len(raw) > HEADER_SIZE, "page has no payload to corrupt"
    i = rng.randrange(HEADER_SIZE, len(raw))
    return raw[:i] + bytes([raw[i] ^ 0xFF]) + raw[i + 1:]


class FaultyTransport(RemotePeer):
    """RemotePeer that consults a FaultPlane on every request."""

    def __init__(self, url: str, plane: FaultPlane, src: str, dst: str,
                 **kwargs: Any):
        super().__init__(url, **kwargs)
        self.plane = plane
        self.src = src
        self.dst = dst
        # held payloads awaiting duplicate/reorder redelivery; popped from
        # gossip calls that may run on fused-pull executor threads
        self._stale_lock = threading.Lock()
        self._stale: List[Dict[str, Any]] = []

    # ---- byte-level faults on the raw HTTP verbs ----

    def _apply_delay(self, faults: Dict[str, Any], op: str) -> None:
        rule = faults.get("delay")
        if rule is not None:
            self.plane.record("delay", src=self.src, dst=self.dst, op=op,
                              arg=rule.arg)
            time.sleep(min(rule.arg, _MAX_DELAY_S))

    def _get(self, path: str,
             headers: Optional[Dict[str, str]] = None) -> Optional[bytes]:
        op = _op_of(path)
        faults = self.plane.decide(self.src, self.dst, op)
        if "drop" in faults:
            self.plane.record("drop", src=self.src, dst=self.dst, op=op)
            self._note_transport_failure()
            return None
        self._apply_delay(faults, op)
        body = super()._get(path, headers=headers)
        if body:
            if "truncate" in faults:
                self.plane.record("truncate", src=self.src, dst=self.dst,
                                  op=op)
                body = body[: len(body) // 2]
            elif "corrupt" in faults and op != "gossip":
                # flip the opening byte: the body stops being a JSON
                # object and hits the caller's parse-skip path (gossip
                # corruption is payload-level — see gossip_payload)
                self.plane.record("corrupt", src=self.src, dst=self.dst,
                                  op=op)
                body = bytes([body[0] ^ 0xFF]) + body[1:]
        return body

    def _post(self, path: str, body: dict) -> bool:
        op = _op_of(path)
        faults = self.plane.decide(self.src, self.dst, op)
        if "drop" in faults:
            self.plane.record("drop", src=self.src, dst=self.dst, op=op)
            self._note_transport_failure()
            return False
        self._apply_delay(faults, op)
        return super()._post(path, body)

    def _post_json(self, path: str,
                   body: dict) -> Optional[Dict[str, Any]]:
        # the coordinator-lease legs (lease_grant, fenced push, CAS
        # forwarding) all route through _post_json; _op_of auto-labels
        # them ("/lease/grant" -> "lease_grant", "/cas" -> "cas",
        # "/push" -> "push") so schedule rules target them untouched
        op = _op_of(path)
        faults = self.plane.decide(self.src, self.dst, op)
        if "drop" in faults:
            self.plane.record("drop", src=self.src, dst=self.dst, op=op)
            self._note_transport_failure()
            return None
        self._apply_delay(faults, op)
        return super()._post_json(path, body)

    def _probe_get(self, path: str, flag_attr: str):
        op = _op_of(path)
        faults = self.plane.decide(self.src, self.dst, op)
        if "drop" in faults:
            self.plane.record("drop", src=self.src, dst=self.dst, op=op)
            self._note_transport_failure()
            return None
        self._apply_delay(faults, op)
        if "truncate" in faults:
            # a cut body fails _probe_get's parse: same skip the real
            # wire produces, recorded without re-implementing the probe
            self.plane.record("truncate", src=self.src, dst=self.dst,
                              op=op)
            return None
        out = super()._probe_get(path, flag_attr)
        if out and "corrupt" in faults:
            self.plane.record("corrupt", src=self.src, dst=self.dst, op=op)
            out = dict(out)
            # poison one entry with a non-dict value: still valid JSON,
            # so the lattice's receive must quarantine it
            out["__nemesis_corrupt__"] = 1
            for k in out:
                if not k.startswith("__"):
                    out[k] = "corrupted-by-nemesis"
                    break
        return out

    # ---- payload-level faults on the KV gossip surface ----

    def gossip_payload(
        self, since: Optional[Dict[int, int]] = None,
        trace: Optional[str] = None,
    ) -> Optional[Dict[str, Any]]:
        faults = self.plane.decide(self.src, self.dst, "gossip")
        # redeliver a held payload first (duplicate/reorder tail): it was
        # fetched against an OLDER vv, so delivering it now is exactly
        # old-after-new / same-bytes-twice — the join must no-op.  An
        # active drop window (partition) blocks redelivery too: the held
        # message is still "in the network"
        if "reorder" not in faults and "drop" not in faults:
            with self._stale_lock:
                stale = self._stale.pop(0) if self._stale else None
            if stale is not None:
                self.plane.record("redeliver", src=self.src, dst=self.dst,
                                  op="gossip")
                return stale
        payload = super().gossip_payload(since, trace=trace)
        if not payload:
            return payload  # dropped/truncated/empty: nothing to mutate
        if "corrupt" in faults:
            # mangled WIRE KEY: valid JSON that _parse_wire_key rejects —
            # the quarantine path, not the parse-skip path
            self.plane.record("corrupt", src=self.src, dst=self.dst,
                              op="gossip")
            payload = dict(payload)
            payload["nemesis:corrupt:key"] = {"Key": "x", "Value": "y"}
            return payload
        if "reorder" in faults:
            self.plane.record("reorder_hold", src=self.src, dst=self.dst,
                              op="gossip")
            with self._stale_lock:
                self._stale.append(copy.deepcopy(payload))
            return {}  # this round sees an empty delta; payload comes later
        if "duplicate" in faults:
            self.plane.record("duplicate", src=self.src, dst=self.dst,
                              op="gossip")
            with self._stale_lock:
                self._stale.append(copy.deepcopy(payload))
        return payload

    # ---- payload-level faults on the reshard migration stream ----

    def ks_migrate(self, shard: int, payload: Dict[str, Any], epoch: int,
                   trace: Optional[str] = None) -> Optional[Dict[str, Any]]:
        # drop/delay ride the generic _post_json override (op is
        # "ks_migrate" via _op_of); only CORRUPT needs payload-level
        # handling — a mangled WIRE KEY keeps the body valid JSON so it
        # reaches receive_migration and must be quarantined WHOLE there
        # (all-or-nothing: no row subset folded).  When drop co-fires on
        # the same decision, the message never arrives: record nothing,
        # so corrupt records reconcile 1:1 with receiver quarantines.
        faults = self.plane.decide(self.src, self.dst, "ks_migrate")
        if "corrupt" in faults and "drop" not in faults:
            self.plane.record("corrupt", src=self.src, dst=self.dst,
                              op="ks_migrate")
            payload = dict(payload)
            payload["nemesis:corrupt:key"] = {"Key": "x", "Value": "y"}
        return super().ks_migrate(shard, payload, epoch, trace=trace)

    def pending_redelivery(self) -> int:
        """Held payloads not yet redelivered (drained by heal-phase pulls;
        the soak asserts the queue empties before its final checks)."""
        with self._stale_lock:
            return len(self._stale)
