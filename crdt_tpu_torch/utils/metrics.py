"""The ``Metrics`` surface the node and cluster record through (own copy
of the part of ``crdt_tpu.utils.metrics`` they call): counters and
latency timers over one :class:`~crdt_tpu_torch.obs.registry.MetricsRegistry`,
which a LocalCluster's nodes share by sharing the Metrics.
"""
from __future__ import annotations

import time
from crdt_tpu_torch.obs.registry import MetricsRegistry


class Metrics:
    def __init__(self):
        self.registry = MetricsRegistry()

    def inc(self, name: str, n: int = 1) -> None:
        self.registry.inc(name, n)

    def observe(self, name: str, seconds: float) -> None:
        self.registry.observe(name, seconds)

    class _Timer:
        def __init__(self, m: "Metrics", name: str):
            self.m, self.name = m, name

        def __enter__(self):
            self.t0 = time.perf_counter()
            return self

        def __exit__(self, *exc):
            self.m.observe(self.name, time.perf_counter() - self.t0)

    def timer(self, name: str) -> "_Timer":
        return self._Timer(self, name)

    def snapshot(self) -> dict:
        """Counters by name + ``{name}_count``/``{name}_p50_ms`` per
        histogram, copied atomically."""
        return self.registry.snapshot()
