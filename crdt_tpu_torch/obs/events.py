"""Structured event log: the per-node forensic record (own copy of
``crdt_tpu.obs.events``).

Every gossip round, barrier and fault-relevant transition emits one event
carrying the round's trace ID (:mod:`crdt_tpu_torch.obs.trace`), so an
incident across nodes reconstructs by searching one ID.  Events are kept
in a bounded ring and, when a path is given (a daemon's ``--event-log``),
appended to a JSONL file with a flush per line: a SIGKILLed daemon's last
lines are its black box.  Each record is stamped with the schema version
``v`` and, when a driver installs a ``step_clock`` (the soak harness's
step counter, its deterministic time base), with the driver's ``step``.
"""
from __future__ import annotations

import collections
import json
import threading
import time
from typing import Any, Callable, Dict, List, Optional

# stamped into every record as "v"; the JAX package's schema version
SCHEMA_VERSION = 2


class EventLog:
    """Thread-safe bounded event ring with an optional JSONL file sink.
    ``registry`` (optional) receives the ring-eviction counter
    ``events_dropped``, so a post-mortem can tell a quiet node from a
    truncated ring (the file sink never drops)."""

    def __init__(self, node: str = "?", path: Optional[str] = None, capacity: int = 4096,
                 step_clock: Optional[Callable[[], int]] = None, registry=None):
        self.node = str(node)
        self.path = path
        self.step_clock = step_clock
        self.registry = registry
        self.dropped = 0
        self._lock = threading.Lock()
        self._ring: collections.deque = collections.deque(maxlen=capacity)
        self._fh = open(path, "a", encoding="utf-8") if path else None

    def emit(self, event: str, trace: Optional[str] = None,
             **fields: Any) -> Dict[str, Any]:
        rec: Dict[str, Any] = {
            "v": SCHEMA_VERSION,
            "ts_ms": int(time.time() * 1000),
            "node": self.node,
            "event": event,
        }
        if self.step_clock is not None:
            rec["step"] = int(self.step_clock())
        if trace is not None:
            rec["trace"] = trace
        rec.update(fields)
        with self._lock:
            if len(self._ring) == self._ring.maxlen:
                self.dropped += 1
                if self.registry is not None:
                    self.registry.inc("events_dropped", node=self.node)
            self._ring.append(rec)
            if self._fh is not None:
                self._fh.write(json.dumps(rec, sort_keys=True) + "\n")
                self._fh.flush()
        return rec

    def tail(self, n: int = 50) -> List[Dict[str, Any]]:
        with self._lock:
            return list(self._ring)[-n:]

    def find(self, trace: Optional[str] = None,
             event: Optional[str] = None) -> List[Dict[str, Any]]:
        with self._lock:
            recs = list(self._ring)
        return [r for r in recs
                if (trace is None or r.get("trace") == trace)
                and (event is None or r.get("event") == event)]

    def __len__(self) -> int:
        with self._lock:
            return len(self._ring)

    def close(self) -> None:
        with self._lock:
            if self._fh is not None:
                self._fh.close()
                self._fh = None


def read_jsonl(path: str) -> List[Dict[str, Any]]:
    """Parse an event-log file back into records; a torn final line (the
    SIGKILL case) ends the read, everything before it is intact."""
    out: List[Dict[str, Any]] = []
    try:
        with open(path, encoding="utf-8") as fh:
            for line in fh:
                line = line.strip()
                if not line:
                    continue
                try:
                    out.append(json.loads(line))
                except ValueError:
                    break
    except OSError:
        pass
    return out
