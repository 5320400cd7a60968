"""Time what one span costs the host: ``with <range>: pass``, enter and
exit, with no profiler recording and under ``utils.tracing.start_trace``'s
profiler, limited to user scopes as the benchmark's tracer is.

    python3 tools/time_spans.py [--n N] [--reps R]

Rows: the port's gate (``utils.tracing.trace_region``), an ungated
``torch.profiler.record_function``, and a shared no-op context (the
floor: what the gate returns while nothing records).  Prints one JSON
line: for each row and state, the least over ``--reps`` repeats of the
mean microseconds a span, and the host's CPU and torch version.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import platform
import sys
import tempfile
import timeit

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402
from torch.profiler import record_function  # noqa: E402

from crdt_tpu_torch.utils import tracing  # noqa: E402

_NO_RANGE = contextlib.nullcontext()

ROWS = {
    "trace_region": "with trace_region('x'): pass",
    "record_function": "with record_function('x'): pass",
    "no_op_context": "with no_op('x'): pass",
}


def no_op(name):
    return _NO_RANGE


def time_rows(n: int, reps: int) -> dict:
    names = {"trace_region": tracing.trace_region, "record_function": record_function,
             "no_op": no_op}
    return {row: min(timeit.repeat(stmt, globals=names, number=n, repeat=reps)) / n * 1e6
            for row, stmt in ROWS.items()}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=200_000, help="spans a repeat")
    ap.add_argument("--reps", type=int, default=7)
    args = ap.parse_args()
    off = time_rows(args.n, args.reps)
    # a recording profiler keeps every span it sees, and writes them out
    with tempfile.TemporaryDirectory() as logdir, tracing.trace_to(logdir):
        on = time_rows(max(args.n // 50, 1), args.reps)
    print(json.dumps({"us_per_span": {"no_profiler": off, "user_scope_profiler": on},
                      "cpu": platform.processor() or platform.machine(),
                      "torch": torch.__version__, "n": args.n, "reps": args.reps}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
