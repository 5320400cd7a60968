"""The ``Metrics`` surface the nodes, clusters and soaks record through (own
copy of ``crdt_tpu.utils.metrics``): counters and latency timers over one
:class:`~crdt_tpu_torch.obs.registry.MetricsRegistry`, which a LocalCluster's
nodes share by sharing the Metrics, and the readers over it (``rate``,
lifetime or windowed, ``p50``, ``quantile``).

``Metrics(registry=NULL_REGISTRY)`` runs a node, cluster or keyspace with
all recording off: the registry records nothing, and ``inc`` skips its
rate marks too.
"""
from __future__ import annotations

import collections
import threading
import time
from typing import Deque, Dict, Optional, Tuple

from crdt_tpu_torch.obs.registry import MetricsRegistry

# least spacing of the rate marks (bounds a counter's memory and the
# perf_counter cost on hot inc paths)
_SAMPLE_EVERY_S = 0.05
_SAMPLES_MAX = 128


class Metrics:
    """Thread-safe counters and latency histograms over a registry that
    several Metrics may share, or ``obs.NULL_REGISTRY`` to record nothing.
    Label-free fast paths only: labeled series are recorded straight on
    ``self.registry``."""

    def __init__(self, reservoir: int = 4096,
                 registry: Optional[MetricsRegistry] = None):
        # `reservoir` is accepted for the JAX package's signature; the
        # histograms are fixed-size
        self.registry = registry if registry is not None else MetricsRegistry()
        self._t0 = time.perf_counter()
        self._lock = threading.Lock()
        # windowed-rate marks: name -> deque[(t, cumulative count)]
        self._samples: Dict[str, Deque[Tuple[float, float]]] = {}

    # ---- recording ----

    def inc(self, name: str, n: int = 1) -> None:
        self.registry.inc(name, n)
        if not self.registry.enabled:  # the null registry: no rate marks
            return
        now = time.perf_counter()
        with self._lock:
            dq = self._samples.get(name)
            if dq is None:
                dq = self._samples[name] = collections.deque(maxlen=_SAMPLES_MAX)
            if not dq or now - dq[-1][0] >= _SAMPLE_EVERY_S:
                dq.append((now, self.registry.counter_value(name)))

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

    # ---- reading ----

    @property
    def _counts(self) -> Dict[str, int]:
        """The label-free counters by name."""
        out: Dict[str, int] = {}
        with self.registry._lock:
            for (name, labels), v in self.registry._counters.items():
                if not labels:
                    out[name] = int(v)
        return out

    def rate(self, name: str, window: Optional[float] = None) -> float:
        """Events/s: over the lifetime when ``window`` is None, else over
        (up to) the trailing ``window`` seconds of recorded activity."""
        now = time.perf_counter()
        cur = self.registry.counter_value(name)
        if window is None or now - window <= self._t0:
            # a window that covers the whole lifetime opens at a count of
            # exactly 0: it IS the lifetime rate (rebasing onto the first
            # mark would drop its events and shrink the denominator)
            return cur / max(now - self._t0, 1e-9)
        cutoff = now - window
        with self._lock:
            dq = self._samples.get(name)
            marks = list(dq) if dq else []
        # the newest mark before the window (the count already there when
        # it opened), else the oldest mark inside it
        older = [m for m in marks if m[0] <= cutoff]
        inside = [m for m in marks if m[0] > cutoff]
        base_t, base_v = cutoff, 0.0
        if older:
            base_v = older[-1][1]
        elif inside:
            base_t, base_v = inside[0]
        else:
            base_v = cur  # no activity recorded in the window at all
        return max(cur - base_v, 0.0) / max(now - base_t, 1e-9)

    def p50(self, name: str) -> float:
        return self.quantile(name, 0.5)

    def quantile(self, name: str, q: float) -> float:
        """The label-free histogram's q-quantile (NaN when absent)."""
        h = self.registry.histogram(name)
        return h.quantile(q) if h is not None else float("nan")

    def snapshot(self) -> dict:
        """Counters by name + ``{name}_count``/``{name}_p50_ms`` per
        histogram, copied atomically."""
        return self.registry.snapshot()
