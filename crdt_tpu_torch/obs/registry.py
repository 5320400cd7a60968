"""Metrics registry: labeled counters, gauges and mergeable log2-bucket
histograms, with the Prometheus text exposition (own copy of
``crdt_tpu.obs.registry``; the same series render to the same text).

A histogram's merge is an elementwise add, so per-node registries fold
fleet-wide in any order.  Buckets are powers of two spanning ~1 us .. ~17
min, so a histogram is 33 ints; quantiles are bucket-upper-bound
estimates, exact to one octave.  Callbacks registered with
``add_callback`` run at collection time (``snapshot`` and
``render_prometheus``).

``NULL_REGISTRY`` is the telemetry opt-out: every recording method exists
and does nothing, and every gate that reads ``registry.enabled`` (the
flight recorder, the audit digest, the merge's device attribution, the
rate marks of ``utils.metrics.Metrics``) stays off.  It is the control arm
of the instrumentation-overhead measurement.
"""
from __future__ import annotations

import math
import re
import threading
from typing import Callable, Dict, List, Optional, Tuple

# log2 bucket boundaries: 2**LOG2_LO .. 2**LOG2_HI seconds, plus +Inf
LOG2_LO, LOG2_HI = -20, 10
N_BUCKETS = LOG2_HI - LOG2_LO + 2  # one per boundary + the +Inf bucket

_NAME_OK = re.compile(r"[a-zA-Z_:][a-zA-Z0-9_:]*$")
_NAME_BAD = re.compile(r"[^a-zA-Z0-9_:]")
_LABEL_BAD = re.compile(r"[^a-zA-Z0-9_]")

LabelKey = Tuple[Tuple[str, str], ...]


def _labels_key(labels: Dict[str, str]) -> LabelKey:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def bucket_index(value: float) -> int:
    """Index of the log2 bucket ``value`` falls in (le 2**(LOG2_LO + i))."""
    if value <= 2.0 ** LOG2_LO:
        return 0
    if value > 2.0 ** LOG2_HI:
        return N_BUCKETS - 1  # +Inf
    return min(int(math.ceil(math.log2(value))) - LOG2_LO, N_BUCKETS - 2)


class Histogram:
    """Fixed log2-bucket histogram.  Mergeable: ``merge`` is elementwise
    add over (buckets, sum, count) — associative and commutative, so
    per-node histograms fold into fleet aggregates in any order."""

    __slots__ = ("buckets", "sum", "count")

    def __init__(self):
        self.buckets = [0] * N_BUCKETS
        self.sum = 0.0
        self.count = 0

    def observe(self, value: float) -> None:
        self.buckets[bucket_index(value)] += 1
        self.sum += value
        self.count += 1

    def merge(self, other: "Histogram") -> "Histogram":
        out = Histogram()
        out.buckets = [a + b for a, b in zip(self.buckets, other.buckets)]
        out.sum = self.sum + other.sum
        out.count = self.count + other.count
        return out

    def quantile(self, q: float) -> float:
        """Bucket-upper-bound estimate of the q-quantile (NaN when empty).
        ``q`` is clamped into the observed mass: q<=0 lands on the first
        occupied bucket, q>=1 on the last — so q=1 reports the max's
        bucket bound instead of falling through to +Inf."""
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


def sanitize_name(name: str) -> str:
    name = _NAME_BAD.sub("_", name)
    return name if _NAME_OK.match(name) else "_" + name


def _render_labels(labels: LabelKey) -> str:
    if not labels:
        return ""
    parts = []
    for k, v in labels:
        k = _LABEL_BAD.sub("_", k)
        v = v.replace("\\", r"\\").replace('"', r"\"").replace("\n", r"\n")
        parts.append(f'{k}="{v}"')
    return "{" + ",".join(parts) + "}"


class MetricsRegistry:
    """Thread-safe registry of labeled series.

    Series are created on first touch (``inc``/``set_gauge``/``observe``);
    callbacks registered with ``add_callback`` run at collection time so
    gauges sampled from live structures (op-log population, vv frontiers)
    are always scrape-fresh without a background thread.
    """

    # tells a real registry from NULL_REGISTRY without an isinstance check
    # on every hot-path call
    enabled = True

    def __init__(self, namespace: str = "crdt"):
        self.namespace = namespace
        self._lock = threading.Lock()
        self._counters: Dict[Tuple[str, LabelKey], float] = {}
        self._gauges: Dict[Tuple[str, LabelKey], float] = {}
        self._hists: Dict[Tuple[str, LabelKey], Histogram] = {}
        self._callbacks: List[Callable[["MetricsRegistry"], None]] = []

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

    def add_callback(self, fn: Callable[["MetricsRegistry"], None]) -> None:
        """Register a collection-time sampler (it may call set_gauge/inc)."""
        with self._lock:
            self._callbacks.append(fn)

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

    def histograms(self, name: str) -> List[Tuple[Dict[str, str], Histogram]]:
        """Every labeled series of one histogram name, as (labels, copy)
        pairs — callers fold them with Histogram.merge (fleet rollups)."""
        with self._lock:
            return [
                (dict(k[1]), h.copy())
                for k, h in self._hists.items()
                if k[0] == name
            ]

    def _run_callbacks(self) -> None:
        # outside the lock: callbacks call set_gauge themselves
        with self._lock:
            callbacks = list(self._callbacks)
        for fn in callbacks:
            fn(self)

    def snapshot(self) -> dict:
        """Flat JSON-friendly view: counters by name, ``{name}_count`` /
        ``{name}_p50_ms`` per histogram, gauges by name.  Labeled series
        are keyed ``name{k=v,...}``; the maps are copied under one lock."""
        self._run_callbacks()
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

    def render_prometheus(self) -> str:
        """Prometheus text exposition (format version 0.0.4)."""
        self._run_callbacks()
        with self._lock:
            counters = sorted(self._counters.items())
            gauges = sorted(self._gauges.items())
            hists = sorted((k, h.copy()) for k, h in self._hists.items())
        ns = self.namespace
        lines: List[str] = []
        seen_type: set = set()

        def emit_type(full: str, kind: str) -> None:
            if full not in seen_type:
                seen_type.add(full)
                lines.append(f"# TYPE {full} {kind}")

        for (name, labels), v in counters:
            full = f"{ns}_{sanitize_name(name)}_total"
            emit_type(full, "counter")
            lines.append(f"{full}{_render_labels(labels)} {_num(v)}")
        for (name, labels), v in gauges:
            full = f"{ns}_{sanitize_name(name)}"
            emit_type(full, "gauge")
            lines.append(f"{full}{_render_labels(labels)} {_num(v)}")
        for (name, labels), h in hists:
            # the implicit unit is seconds; a name that carries its own
            # unit (op_propagation_steps) is left alone
            full = f"{ns}_{sanitize_name(name)}"
            if not name.endswith("_steps"):
                full += "_seconds"
            emit_type(full, "histogram")
            cum = 0
            for i, b in enumerate(h.buckets):
                cum += b
                le = ("+Inf" if i == N_BUCKETS - 1
                      else repr(2.0 ** (LOG2_LO + i)))
                le_labels = _labels_key(dict(labels, le=le))
                lines.append(f"{full}_bucket{_render_labels(le_labels)} {cum}")
            lines.append(f"{full}_sum{_render_labels(labels)} {_num(h.sum)}")
            lines.append(f"{full}_count{_render_labels(labels)} {h.count}")
        return "\n".join(lines) + "\n"


def _num(v: float) -> str:
    return str(int(v)) if float(v).is_integer() else repr(float(v))


class NullRegistry(MetricsRegistry):
    """Every recording method is a no-op: the control arm of the
    instrumentation-overhead measurement, and an opt-out for embedding
    where telemetry costs too much.  Reads behave like an always-empty
    registry."""

    enabled = False

    def inc(self, name, value=1.0, **labels):
        pass

    def set_gauge(self, name, value, **labels):
        pass

    def observe(self, name, value, **labels):
        pass

    def add_callback(self, fn):
        pass


NULL_REGISTRY = NullRegistry()
