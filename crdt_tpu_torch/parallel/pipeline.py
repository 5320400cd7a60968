"""Double-buffered stripe execution: overlap host staging with device
compute (counterpart of ``crdt_tpu.parallel.pipeline``).

The striped big-shape drivers (the 1M-lane OR-Set union, the
capacity-striped lexN engine) pay HOST time per stripe (numpy packing,
sorting, the host-to-device copy) that a serial loop serializes with the
device compute:

    serial:     [build 0][compute 0][build 1][compute 1]...
    pipelined:  [build 0][compute 0 | build 1][compute 1 | build 2]...

A torch call on a CUDA tensor returns once its kernels are queued, so
the pipeline needs no threads: dispatch stripe i, stage stripe i+1 on the
host while i runs, then block.  On top of that this module adds

* a BOUNDED in-flight window (:class:`DispatchQueue`): each dispatch
  records a ``torch.cuda.Event`` on the current stream, and blocking on
  the oldest stripe is ``event.synchronize()``; depth=1 is the double
  buffer (stripe i on the card + stripe i+1's operands staged);
* dispatch accounting (``pipeline_dispatches``) and an occupancy gauge
  (``pipeline_occupancy``) on the shared metrics registry;
* the ownership rule of the JAX package: ``run_striped`` drops its
  reference to each stripe's operands at dispatch.

Staging overlaps the card only if ``build`` copies from pinned host
memory with ``non_blocking=True``; a pageable copy blocks the host until
it lands.  The chip smoke's ``build`` packs each stripe into a pinned
host buffer and copies it with ``non_blocking=True``.  On a CPU tensor
nothing is pending: every dispatch has finished when it returns.

Determinism: pipelining reorders only HOST work; every stripe's device
program and operands are those of the serial schedule, so outputs are
bit-equal (pinned by tests/test_torch_pipeline.py).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from crdt_tpu_torch.obs import health


def _cuda_device(out: Any) -> Optional[torch.device]:
    """The card of the first CUDA tensor in ``out`` (tensors, containers
    and dataclasses; other values are skipped), or None."""
    if isinstance(out, torch.Tensor):
        return out.device if out.is_cuda else None
    if dataclasses.is_dataclass(out) and not isinstance(out, type):
        out = [getattr(out, f.name) for f in dataclasses.fields(out)]
    elif isinstance(out, dict):
        out = list(out.values())
    if isinstance(out, (list, tuple)):
        for x in out:
            dev = _cuda_device(x)
            if dev is not None:
                return dev
    return None


class DispatchQueue:
    """Bounded window of in-flight device dispatches.

    ``submit`` issues one dispatch and records an event after it, then
    blocks on the OLDEST in-flight dispatch only once more than ``depth``
    are outstanding.  depth=1 is the double buffer; depth=0 is the serial
    schedule (every dispatch blocked at once, the A/B reference arm).
    ``wait_s`` accumulates the host time spent blocked in
    ``event.synchronize()``."""

    def __init__(self, depth: int = 1, registry=None, label: str = "pipeline"):
        self.depth = max(0, int(depth))
        self.registry = registry
        self.label = label
        self.dispatches = 0
        self.wait_s = 0.0
        self._in_flight: List[Tuple[Any, Optional[torch.cuda.Event]]] = []
        self._done: List[Any] = []

    def submit(self, fn: Callable, *args: Any) -> None:
        out = fn(*args)  # returns once the card's work is queued
        event = None
        dev = _cuda_device(out)
        if dev is not None:
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(dev))
        self.dispatches += 1
        if self.registry is not None:
            self.registry.inc("pipeline_dispatches", pipeline=self.label)
        self._in_flight.append((out, event))
        while len(self._in_flight) > self.depth:
            self._done.append(self._block(*self._in_flight.pop(0)))

    def _block(self, out: Any, event: Optional[torch.cuda.Event]) -> Any:
        t0 = time.perf_counter()
        if event is not None:
            event.synchronize()
        self.wait_s += time.perf_counter() - t0
        return out

    def drain(self) -> List[Any]:
        """Block on everything still in flight; return ALL completed
        results in submission order and reset the queue."""
        while self._in_flight:
            self._done.append(self._block(*self._in_flight.pop(0)))
        done, self._done = self._done, []
        return done


def run_striped(
    n_stripes: int,
    build: Callable[[int], Any],
    dispatch: Callable[..., Any],
    *,
    pipelined: bool = True,
    registry=None,
    pipeline: str = "stripe",
) -> Tuple[List[Any], Dict[str, float]]:
    """Run ``n_stripes`` stripes of ``build`` (host staging) + ``dispatch``
    (device compute), double-buffered when ``pipelined``.

    ``build(i)`` stages stripe i's operands (return a tuple to pass
    several); ``dispatch(i, *operands)`` issues the stripe's device work and
    must not block.  ``run_striped`` drops its only reference to the
    operands at dispatch.

    Pipelined: stripe i's device window overlaps ``build(i+1)`` on the
    host; serial (``pipelined=False``) blocks each stripe before staging
    the next: identical outputs, no overlap.

    Returns ``(results, stats)`` with results in stripe order and stats
    ``{stage_s, wait_s, occupancy, dispatches}``.  ``occupancy`` is the
    share of the dispatch-to-block window the host spent staging the next
    stripe instead of waiting (0.0 for the serial schedule).  The stats go
    to ``registry`` too when one is given (``obs.health.observe_pipeline``).
    """
    q = DispatchQueue(depth=1 if pipelined else 0, registry=registry,
                      label=pipeline)
    stage_s = 0.0
    for i in range(n_stripes):
        t0 = time.perf_counter()
        operands = build(i)
        stage_s += time.perf_counter() - t0
        if not isinstance(operands, tuple):
            operands = (operands,)
        # bind i now; *operands is this scope's last reference
        q.submit(lambda *a, _i=i: dispatch(_i, *a), *operands)
        del operands
    results = q.drain()
    denom = stage_s + q.wait_s
    occupancy = (stage_s / denom) if (pipelined and denom > 0) else 0.0
    stats = {
        "stage_s": stage_s,
        "wait_s": q.wait_s,
        "occupancy": occupancy,
        "dispatches": q.dispatches,
    }
    if registry is not None:
        health.observe_pipeline(registry, pipeline, occupancy, n_stripes,
                                stage_s, q.wait_s)
    return results, stats
