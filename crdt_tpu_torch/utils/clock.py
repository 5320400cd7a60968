"""Host-side time and sequence sources (own copy of
``crdt_tpu.utils.clock``).

Timestamps are inputs to device code, never computed on the device.  The
reference keys its op log by ``time.Now().UnixMilli()`` (its main.go:187),
an int64 and a collision source.  Here: int32 millisecond offsets from a
per-run epoch (about 24 days of range) plus a per-replica monotone
sequence number, so op identity (ts, rid, seq) is unique at any rate.
"""
from __future__ import annotations

import time


class HostClock:
    """Millisecond clock relative to a fixed epoch (defaults to creation)."""

    def __init__(self, epoch_ms: int | None = None):
        self.epoch_ms = int(time.time() * 1000) if epoch_ms is None else epoch_ms

    def now_ms(self) -> int:
        """int32-ranged ms offset from the epoch, clamped non-negative."""
        return max(0, int(time.time() * 1000) - self.epoch_ms)


class ManualClock(HostClock):
    """Deterministic clock for tests and oracles: advances only when told."""

    def __init__(self, start: int = 0):
        super().__init__(epoch_ms=0)
        self._now = start

    def now_ms(self) -> int:
        return self._now

    def advance(self, ms: int = 1) -> int:
        self._now += ms
        return self._now


class SeqGen:
    """Per-replica monotone sequence numbers (the op identity tiebreak).
    ``count`` is readable and settable so checkpoints can persist it:
    losing it would let a restored node mint an already-used
    (ts, rid, seq)."""

    def __init__(self, start: int = 0):
        self.count = start

    def next(self) -> int:
        n = self.count
        self.count += 1
        return n

    def reserve(self, n: int) -> int:
        """Mint ``n`` consecutive seqs in one step (the batched write path);
        returns the first.  Equivalent to n next() calls."""
        first = self.count
        self.count += n
        return first
