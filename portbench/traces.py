"""Reduction of a profiler trace of the measured window to what the
per-layer readers read: the device's busy time, the device work launched
inside a named host span, and the breakdown of device time and idle gaps.

The trace is ``torch.profiler``'s Chrome trace.  Device work is every
kernel, copy and fill on the device; a host span is a ``record_function``
range (the benchmark's ``portbench.*`` spans and the program's own
``trace_region``s); a launch belongs to a span when its runtime call lies
inside it, and its device work is matched to the call by correlation id.
"""
from __future__ import annotations

import bisect
import json
from collections import defaultdict

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


class Trace:
    """The events of one Chrome trace, times in seconds on the trace's
    clock, and the length of the traced window on the host's clock."""

    def __init__(self, events: list, window_s: float):
        self.window_s = window_s
        self.ops = []        # (start, end, name, correlation) of device work
        self.launches = []   # (host time, correlation) of runtime calls
        self.spans = defaultdict(list)  # name -> [(start, end)] of user annotations
        self.host = []       # (start, end, name) of the spans
        for e in events:
            cat = e.get("cat")
            if e.get("ph") != "X" or cat is None:
                continue
            start = float(e["ts"]) * 1e-6
            end = start + float(e.get("dur", 0.0)) * 1e-6
            corr = e.get("args", {}).get("correlation")
            if cat in DEVICE_CATS:
                self.ops.append((start, end, e.get("name", "?"), corr))
            elif cat in LAUNCH_CATS and corr is not None:
                self.launches.append((start, corr))
            elif cat == "user_annotation":
                self.host.append((start, end, e["name"]))
                self.spans[e["name"]].append((start, end))
        self.ops.sort()
        self.launches.sort()
        self._launch_times = [t for t, _ in self.launches]
        self._by_corr = defaultdict(list)
        for op in self.ops:
            if op[3] is not None:
                self._by_corr[op[3]].append(op)
        self.busy = _merge([(s, e) for s, e, _, _ in self.ops])

    @classmethod
    def load(cls, path, window_s: float) -> "Trace":
        with open(path) as f:
            return cls(json.load(f).get("traceEvents", []), window_s)

    @property
    def busy_s(self) -> float:
        """Seconds in which some device work ran."""
        return sum(e - s for s, e in self.busy)

    def span_ops(self, name: str) -> list:
        """For each host span ``name``: the device work launched inside it."""
        out = []
        for start, end in self.spans.get(name, []):
            lo = bisect.bisect_left(self._launch_times, start)
            hi = bisect.bisect_right(self._launch_times, end)
            out.append([op for _, corr in self.launches[lo:hi] for op in self._by_corr[corr]])
        return out

    def span_device_s(self, name: str) -> list:
        """For each span ``name``: seconds of device work launched in it."""
        return [sum(e - s for s, e, _, _ in ops) for ops in self.span_ops(name)]

    def span_extent_s(self, name: str) -> list:
        """For each span ``name`` that launched device work: from the start
        of its first device op to the end of its last, gaps included."""
        return [max(e for _, e, _, _ in ops) - min(s for s, _, _, _ in ops)
                for ops in self.span_ops(name) if ops]

    def top_device_ops(self, n: int = 10) -> list:
        """[[name, seconds]] of the device ops that took most time."""
        total = defaultdict(float)
        for s, e, name, _ in self.ops:
            total[name] += e - s
        return [[k, v] for k, v in sorted(total.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n: int = 10) -> list:
        """[[host activity, seconds]]: the device's idle gaps between its
        first and last op, summed by what the host was doing when each gap
        began (the innermost span open then)."""
        gaps = [(a_end, b_start) for (_, a_end), (b_start, _) in zip(self.busy, self.busy[1:])]
        host = sorted(self.host, key=lambda h: (h[0], -h[1]))
        total = defaultdict(float)
        stack, i = [], 0
        for g_start, g_end in gaps:
            while i < len(host) and host[i][0] <= g_start:
                while stack and stack[-1][1] < host[i][0]:
                    stack.pop()
                stack.append(host[i])
                i += 1
            while stack and stack[-1][1] < g_start:
                stack.pop()
            total[stack[-1][2] if stack else "outside any span"] += g_end - g_start
        return [[k, v] for k, v in sorted(total.items(), key=lambda kv: -kv[1])[:n]]


def _merge(intervals: list) -> list:
    """The union of (start, end) intervals, sorted and disjoint."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out
