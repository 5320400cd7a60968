"""Profiling and tracing hooks on ``torch.profiler`` (counterpart of the
JAX package's ``utils/tracing`` over ``jax.profiler``).

Usage:
    with trace_region("gossip_round"):
        col = gossip_round(...)
or ``start_trace(logdir)`` / ``stop_trace()`` (or ``with trace_to(logdir)``)
around a run, then open the Chrome trace it writes under ``logdir`` in
Perfetto or ``chrome://tracing``: named regions on the host timeline,
and, with a card present, the kernels they launched on the device's.
"""
from __future__ import annotations

import contextlib
import os
import time
from typing import Optional

import torch
from torch.profiler import ProfilerActivity, profile, record_function

_profiler: Optional[profile] = None
_logdir: Optional[str] = None


def start_trace(logdir: str) -> None:
    """Start the module's profiler: CPU activity, and CUDA activity when a
    card is present."""
    global _profiler, _logdir
    if _profiler is not None:
        raise RuntimeError("a trace is already running (stop_trace first)")
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    prof.start()
    _profiler, _logdir = prof, logdir


def stop_trace() -> str:
    """Stop the profiler and write its Chrome trace under the logdir;
    returns the trace file's path."""
    global _profiler, _logdir
    prof, logdir = _profiler, _logdir
    if prof is None:
        raise RuntimeError("no trace is running (start_trace first)")
    _profiler = _logdir = None
    prof.stop()
    os.makedirs(logdir, exist_ok=True)
    path = os.path.join(logdir, f"trace-{os.getpid()}-{time.time_ns()}.json")
    prof.export_chrome_trace(path)
    return path


def trace_region(name: str):
    """A named region in the trace (``record_function``); cheap enough to
    wrap every merge and gossip call, and a no-op cost when no profiler
    runs."""
    return record_function(name)


@contextlib.contextmanager
def trace_to(logdir: str):
    start_trace(logdir)
    try:
        yield
    finally:
        stop_trace()
