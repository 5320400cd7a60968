"""Profiling and tracing hooks on ``torch.profiler`` (counterpart of the
JAX package's ``utils/tracing`` over ``jax.profiler``).

Usage:
    with trace_region("gossip_round"):
        col = gossip_round(...)
or ``start_trace(logdir)`` / ``stop_trace()`` (or ``with trace_to(logdir)``)
around a run, then open the Chrome trace it writes under ``logdir`` in
Perfetto or ``chrome://tracing``: named regions on the host timeline,
and, with a card present, the runtime calls and the kernels they launched
on the device's.

Every range the port opens goes through :func:`trace_region`, which opens
a ``record_function`` range only while a profiler records on the calling
thread; otherwise it costs a flag read and a shared no-op context.
"""
from __future__ import annotations

import contextlib
import os
import time

import torch
from torch.profiler import record_function

# the context every trace_region returns while no profiler records
_NO_RANGE = contextlib.nullcontext()

# the profiler's own flag, per thread: true under torch.profiler.profile and
# under a session limited to user scopes (whose Python flag stays false)
_recording = torch._C._autograd._profiler_enabled

# the logdir of the running trace (None: no trace runs)
_logdir = None


def start_trace(logdir: str) -> None:
    """Start the module's profiler: the ``trace_region`` ranges (user
    scopes only, not every ATen op, so the host issues work at almost its
    untraced pace), and with a card present its runtime calls, kernels and
    copies."""
    global _logdir
    from torch._C._autograd import _enable_profiler, _prepare_profiler
    from torch._C._profiler import RecordScope
    from torch.autograd import profiler as autograd_profiler

    if _logdir is not None:
        raise RuntimeError("a trace is already running (stop_trace first)")
    prof = autograd_profiler.profile(
        use_device="cuda" if torch.cuda.is_available() else None, use_kineto=True)
    config, activities = prof.config(), prof.kineto_activities
    _prepare_profiler(config, activities)
    _enable_profiler(config, activities, {RecordScope.USER_SCOPE})
    _logdir = logdir


def stop_trace() -> str:
    """Stop the profiler and write its Chrome trace under the logdir;
    returns the trace file's path."""
    global _logdir
    from torch._C._autograd import _disable_profiler

    logdir = _logdir
    if logdir is None:
        raise RuntimeError("no trace is running (start_trace first)")
    _logdir = None
    result = _disable_profiler()
    os.makedirs(logdir, exist_ok=True)
    path = os.path.join(logdir, f"trace-{os.getpid()}-{time.time_ns()}.json")
    result.save(path)
    return path


def trace_region(name: str):
    """A named region in the trace: a ``record_function`` range while a
    profiler records on this thread, else a shared no-op context (a flag
    read, well under a microsecond), so it can wrap every merge, round and
    halving."""
    return record_function(name) if _recording() else _NO_RANGE


@contextlib.contextmanager
def trace_to(logdir: str):
    start_trace(logdir)
    try:
        yield
    finally:
        stop_trace()
