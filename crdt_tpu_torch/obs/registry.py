"""Metrics registry: labeled counters, gauges and log2-bucket histograms
(own copy of the part of ``crdt_tpu.obs.registry`` the port records into;
the Prometheus exposition belongs to the HTTP shim, not ported).

Buckets are powers of two spanning ~1 us .. ~17 min, so a histogram is 33
ints; quantiles are bucket-upper-bound estimates, exact to one octave.
"""
from __future__ import annotations

import math
import re
import threading
from typing import Dict, Optional, Tuple

# log2 bucket boundaries: 2**LOG2_LO .. 2**LOG2_HI seconds, plus +Inf
LOG2_LO, LOG2_HI = -20, 10
N_BUCKETS = LOG2_HI - LOG2_LO + 2  # one per boundary + the +Inf bucket

_LABEL_BAD = re.compile(r"[^a-zA-Z0-9_]")

LabelKey = Tuple[Tuple[str, str], ...]


def _labels_key(labels: Dict[str, str]) -> LabelKey:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def _render_labels(labels: LabelKey) -> str:
    if not labels:
        return ""
    parts = []
    for k, v in labels:
        k = _LABEL_BAD.sub("_", k)
        v = v.replace("\\", r"\\").replace('"', r"\"").replace("\n", r"\n")
        parts.append(f'{k}="{v}"')
    return "{" + ",".join(parts) + "}"


def bucket_index(value: float) -> int:
    """Index of the log2 bucket ``value`` falls in (le 2**(LOG2_LO + i))."""
    if value <= 2.0 ** LOG2_LO:
        return 0
    if value > 2.0 ** LOG2_HI:
        return N_BUCKETS - 1  # +Inf
    return min(int(math.ceil(math.log2(value))) - LOG2_LO, N_BUCKETS - 2)


class Histogram:
    """Fixed log2-bucket histogram."""

    __slots__ = ("buckets", "sum", "count")

    def __init__(self):
        self.buckets = [0] * N_BUCKETS
        self.sum = 0.0
        self.count = 0

    def observe(self, value: float) -> None:
        self.buckets[bucket_index(value)] += 1
        self.sum += value
        self.count += 1

    def quantile(self, q: float) -> float:
        """Bucket-upper-bound estimate of the q-quantile (NaN when empty),
        ``q`` clamped into the observed mass."""
        if self.count == 0:
            return float("nan")
        rank = min(self.count, max(1, math.ceil(q * self.count)))
        cum = 0
        for i, b in enumerate(self.buckets):
            cum += b
            if cum >= rank:
                if i == N_BUCKETS - 1:
                    return float("inf")
                return 2.0 ** (LOG2_LO + i)
        return float("inf")

    def copy(self) -> "Histogram":
        out = Histogram()
        out.buckets = list(self.buckets)
        out.sum = self.sum
        out.count = self.count
        return out


class MetricsRegistry:
    """Thread-safe registry of labeled series, created on first touch."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: Dict[Tuple[str, LabelKey], float] = {}
        self._gauges: Dict[Tuple[str, LabelKey], float] = {}
        self._hists: Dict[Tuple[str, LabelKey], Histogram] = {}

    # ---- recording ----

    def inc(self, name: str, value: float = 1.0, **labels: str) -> None:
        key = (name, _labels_key(labels))
        with self._lock:
            self._counters[key] = self._counters.get(key, 0.0) + value

    def set_gauge(self, name: str, value: float, **labels: str) -> None:
        with self._lock:
            self._gauges[(name, _labels_key(labels))] = float(value)

    def observe(self, name: str, value: float, **labels: str) -> None:
        key = (name, _labels_key(labels))
        with self._lock:
            h = self._hists.get(key)
            if h is None:
                h = self._hists[key] = Histogram()
            h.observe(value)

    # ---- reading ----

    def counter_value(self, name: str, **labels: str) -> float:
        with self._lock:
            return self._counters.get((name, _labels_key(labels)), 0.0)

    def gauge_value(self, name: str, **labels: str) -> Optional[float]:
        with self._lock:
            return self._gauges.get((name, _labels_key(labels)))

    def histogram(self, name: str, **labels: str) -> Optional[Histogram]:
        with self._lock:
            h = self._hists.get((name, _labels_key(labels)))
            return h.copy() if h is not None else None

    def snapshot(self) -> dict:
        """Flat view: counters and gauges by name, ``{name}_count`` /
        ``{name}_p50_ms`` per histogram; labeled series keyed
        ``name{k="v",...}``.  The maps are copied under one lock."""
        with self._lock:
            counters = dict(self._counters)
            gauges = dict(self._gauges)
            hists = {k: h.copy() for k, h in self._hists.items()}
        out: dict = {}
        for (name, labels), v in counters.items():
            out[name + _render_labels(labels)] = v
        for (name, labels), v in gauges.items():
            out[name + _render_labels(labels)] = v
        for (name, labels), h in hists.items():
            tag = _render_labels(labels)
            out[f"{name}_count{tag}"] = h.count
            out[f"{name}_p50_ms{tag}"] = round(h.quantile(0.5) * 1e3, 3)
        return out
