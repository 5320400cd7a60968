"""The benchmark of the PyTorch and CUDA port: one cell, one run.

``python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` loads, warms up, measures for ``--seconds``, checks what
the window produced against the plain reference, and prints one JSON
line last on standard output.

Everything about a cell is found by name from ``BENCHMARK.json``: the
configuration file it names (whose ``system`` picks the module
``portbench/systems/<system>.py`` that drives the program), the traffic
file ``portbench/traffic/<traffic>.json``, and one reader
``portbench/metrics/<metric>.py`` for each metric the cell reports.  A
new cell, mix, configuration or metric is new files and new entries.

With ``--trace 0`` the line carries the cell's end-to-end metrics; with
``--trace 1`` the window's first ``TRACE_SECONDS`` run under
``torch.profiler`` and the line carries the per-layer metrics, the
device's busy time in that traced window and a breakdown.
"""
from __future__ import annotations

import argparse
import contextlib
import importlib
import importlib.util
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from types import SimpleNamespace

# epochs run before the window: the first builds the caching allocator's
# pools and loads the kernels, the second runs as the window's will
WARM_EPOCHS = 2

# a --trace 1 run traces the first seconds of its window, enough epochs
# for every per-layer metric while its trace stays a few hundred MB
TRACE_SECONDS = 10.0

# top-level modules the measured process must not hold once the window
# has closed: JAX, and the JAX package the port was made from
BANNED = ("jax", "jaxlib", "flax", "crdt_tpu")


class Spec:
    """``BENCHMARK.json`` and the files it names, under ``root``."""

    def __init__(self, root):
        self.root = Path(root)
        self.data = json.loads((self.root / "BENCHMARK.json").read_text())
        self.cells = {c["name"]: c for c in self.data["workloads"]}
        self.configs = {c["name"]: c for c in self.data["configs"]}

    def config(self, cell: dict) -> dict:
        entry = self.configs[cell["config"]]
        return json.loads((self.root / entry["file"]).read_text())

    def traffic(self, cell: dict) -> dict:
        path = self.root / "portbench" / "traffic" / f"{cell['traffic']}.json"
        return json.loads(path.read_text())

    def metrics(self, cell: dict, trace: bool) -> list:
        """The metric entries a run of ``cell`` reports: its end-to-end ones,
        or with ``trace`` its per-layer ones (those that list the cell, or
        list none and move an end-to-end metric the cell reports)."""
        name = cell["name"]
        e2e = [m for m in self.data["end_to_end"]
               if "workloads" not in m or name in m["workloads"]]
        if not trace:
            return e2e
        moved = {m["name"] for m in e2e}
        return [m for m in self.data["per_layer"]
                if (name in m["workloads"] if "workloads" in m else m["moves"] in moved)]

    def reader(self, name: str):
        path = self.root / "portbench" / "metrics" / f"{name}.py"
        spec = importlib.util.spec_from_file_location(f"portbench_metric_{name}", path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        return module.read


def _sync(device) -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def run_cell(root, workload: str, seed: int, seconds: float, trace: bool, device,
             t0: float, system=None) -> dict:
    """One run of one cell on ``device``; returns the result line's fields
    and the run's other readings.  ``system`` puts another system in the
    program's place (the control; the tests' broken programs)."""
    import torch

    marks = {"imports": time.perf_counter() - t0}
    spec = Spec(root)
    cell = spec.cells[workload]
    config, traffic = spec.config(cell), spec.traffic(cell)
    module = importlib.import_module(f"portbench.systems.{config['system']}")
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.init()
        torch.empty(1, device=dev)
        marks["context"] = time.perf_counter() - t0
        if system is None:
            from crdt_tpu_torch import _build

            _build.build(_build.SOURCES)
            marks["kernels"] = time.perf_counter() - t0
    runner = module.Cell(config, traffic, seed, dev, system)
    _sync(dev)
    marks["inputs"] = time.perf_counter() - t0
    # a cell that issues epochs ahead of the one it waits for drains them
    # before the window and at its close
    drain = getattr(runner, "drain", lambda: None)
    for e in range(WARM_EPOCHS):
        runner.epoch(e, _no_span, keep=False)
    drain()
    _sync(dev)
    counters_before = runner.system.counters()

    tracing = trace
    if tracing:
        _start_tracer(dev)
    span = _span if trace else _no_span
    epoch_s = []
    start = time.perf_counter()
    setup_s = start - t0
    now, e, traced_s = start, 0, None
    while now - start < seconds or e == 0:
        runner.epoch(e, span)
        t = time.perf_counter()
        epoch_s.append(t - now)
        now, e = t, e + 1
        if tracing and now - start >= TRACE_SECONDS:
            kineto, traced_s = _stop_tracer(dev, start)
            tracing, span = False, _no_span
    # the window closes once all the work it issued is done: nothing
    # unfinished is counted, and a stall that runs to its end counts
    drain()
    window_s = time.perf_counter() - start
    if tracing:
        kineto, traced_s = _stop_tracer(dev, start)
    counters_after = runner.system.counters()
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    banned = sorted(m for m in sys.modules if m.split(".")[0] in BANNED)

    traced, trace_cost = None, {}
    if trace:
        folder = tempfile.mkdtemp(prefix="portbench-trace-")
        try:
            path = os.path.join(folder, "trace.json")
            t = time.perf_counter()
            kineto.save(path)
            del kineto
            from portbench.traces import Trace

            trace_cost["bytes"] = os.path.getsize(path)
            traced = Trace.load(path, traced_s)
            trace_cost["export_and_read_s"] = time.perf_counter() - t
        finally:
            shutil.rmtree(folder, ignore_errors=True)

    card = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    run = SimpleNamespace(
        cell=cell, config=config, traffic=traffic, card=card, setup_s=setup_s,
        window_s=window_s, epoch_s=epoch_s, totals=runner.totals(), trace=traced,
        counters=_delta(counters_before, counters_after))
    metrics = {}
    for m in spec.metrics(cell, trace):
        value = spec.reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    t = time.perf_counter()
    checks, failed = runner.check()
    check_s = time.perf_counter() - t
    result = {
        "correct": all(v <= limit for v, limit in checks.values()) and failed == 0,
        "attempted": len(epoch_s), "failed": failed, "metrics": metrics,
        "device": {"platform": "gpu" if dev.type == "cuda" else dev.type, "kind": card,
                   "count": cell["chips"], "memory_peak_bytes": peak},
    }
    if traced is not None:
        result["device"]["busy_s"] = traced.busy_s
        result["device"]["window_s"] = traced.window_s
        result["breakdown"] = {"device_ops": traced.top_device_ops(),
                               "idle_gaps": traced.idle_gaps()}
    result["compared"] = {k: {"value": v, "limit": limit} for k, (v, limit) in checks.items()}
    info = {"workload": workload, "seed": seed, "trace": int(trace), "setup_marks_s": marks,
            "setup_s": setup_s, "window_s": window_s, "epochs": len(epoch_s),
            "totals": run.totals, "counters": run.counters, "memory_peak_bytes": peak,
            "trace_cost": trace_cost, "check_s": check_s,
            "epoch_ms": _quantiles_ms(epoch_s)}
    return {"result": result, "info": info, "banned": banned}


def _quantiles_ms(xs: list) -> dict:
    """The spread of the epochs' times, for the info line."""
    if len(xs) < 2:
        return {}
    q = statistics.quantiles(xs, n=20, method="inclusive")
    return {"p5": q[0] * 1e3, "p50": statistics.median(xs) * 1e3, "p95": q[18] * 1e3,
            "max": max(xs) * 1e3, "mean": statistics.fmean(xs) * 1e3}


def _start_tracer(dev) -> None:
    """Start the profiler's Kineto session, with its record-function
    callbacks limited to user scopes: the benchmark's spans and the
    program's ``trace_region``s are recorded, the ATen ops are not, so the
    host issues the traced epochs almost as fast as the untraced ones."""
    from torch._C._autograd import _enable_profiler, _prepare_profiler
    from torch._C._profiler import RecordScope
    from torch.autograd import profiler as autograd_profiler

    session = autograd_profiler.profile(use_device="cuda" if dev.type == "cuda" else None,
                                        use_kineto=True)
    config, activities = session.config(), session.kineto_activities
    _prepare_profiler(config, activities)
    _enable_profiler(config, activities, {RecordScope.USER_SCOPE})


def _stop_tracer(dev, start: float):
    """Stop the session; returns its result, whose ``save`` writes the
    Chrome trace, and the traced window's length: from ``start`` until the
    device has run all it was given (epochs issued ahead included), before
    the profiler's own stop, which takes seconds."""
    from torch._C._autograd import _disable_profiler

    _sync(dev)
    traced_s = time.perf_counter() - start
    return _disable_profiler(), traced_s


@contextlib.contextmanager
def _no_span(name: str):
    yield


def _span(name: str):
    from torch.profiler import record_function

    return record_function(name)


def _delta(before: dict, after: dict) -> dict:
    """What each counter of ``after`` gained over ``before``."""
    out = {}
    for group, values in after.items():
        old = before.get(group, {})
        out[group] = {k: v - old.get(k, 0) for k, v in values.items() if v != old.get(k, 0)}
    return out


def _card_line() -> str:
    try:
        done = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30)
        return done.stdout.strip().splitlines()[0] if done.returncode == 0 else "not read"
    except (OSError, subprocess.TimeoutExpired, IndexError):
        return "not read"


def parse_args(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv, t0: float, root) -> int:
    args = parse_args(argv)
    spec = Spec(root)
    if args.workload not in spec.cells:
        print(f"portbench: no cell {args.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2
    chips = spec.cells[args.workload]["chips"]
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: the cell needs {chips} CUDA card(s); "
              f"{torch.cuda.device_count()} available, so nothing was measured",
              file=sys.stderr)
        return 2
    # the program's kernels build into build/kernels/ of the checkout
    # (crdt_tpu_torch/_build.py); any torch or Triton build goes beside them
    for name, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton")):
        os.environ[name] = str(Path(root) / "build" / "portbench" / sub)
    out = run_cell(root, args.workload, args.seed, args.seconds, bool(args.trace), "cuda", t0)
    if out["banned"]:
        print(f"portbench: the measured process holds {', '.join(out['banned'])}: "
              "the port must not load JAX or the JAX package", file=sys.stderr)
        return 3
    out["info"]["card"] = _card_line()
    print(json.dumps({"info": out["info"]}))
    result = out["result"]
    for name, c in result["compared"].items():
        print(f"compared {name} {c['value']} limit {c['limit']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
