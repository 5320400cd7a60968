"""Op-level propagation provenance: the convergence flight recorder (own
copy of ``crdt_tpu.obs.provenance``).

Every local write is stamped with a birth event; every merge derives which
origin-sequence ranges it made newly visible from the version-vector delta
alone.  The vector is monotone per writer, so the ranges
``(vv_before[origin], vv_after[origin]]`` of successive rounds are
disjoint, and a duplicated or reordered delivery (which does not move the
vector) records nothing: exactly once per (origin, seq, observer), with no
dedup table and no per-op scan on the device.

Two lags are recorded per origin→observer edge:

* ``op_propagation_steps``: the soak-step lag, when the driver installs a
  shared :class:`BirthLedger` and a step clock (the soak harness does);
* ``op_propagation`` (seconds): the wall lag from the op's wire timestamp
  (absolute Unix ms).
"""
from __future__ import annotations

import threading
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from crdt_tpu_torch.obs.trace import current_trace


class BirthLedger:
    """In-process shared map ``(origin rid, seq) -> birth step``, shared by
    every replica a driver hosts.  Seqs are per-writer contiguous from 0,
    so the store is a per-origin list indexed by seq."""

    def __init__(self):
        self._lock = threading.Lock()
        self._steps: Dict[int, List[int]] = {}

    def note(self, origin: int, seq: int, step: int) -> None:
        with self._lock:
            steps = self._steps.setdefault(int(origin), [])
            if seq == len(steps):
                steps.append(int(step))
            elif seq < len(steps):
                steps[seq] = int(step)
            else:
                # a hole (seqs skipped): backfill with this step so later
                # lookups stay conservative (lag >= 0)
                steps.extend([int(step)] * (seq - len(steps) + 1))

    def birth_step(self, origin: int, seq: int) -> Optional[int]:
        with self._lock:
            steps = self._steps.get(int(origin))
            if steps is None or not (0 <= seq < len(steps)):
                return None
            return steps[seq]

    def __len__(self) -> int:
        with self._lock:
            return sum(len(v) for v in self._steps.values())


class FlightRecorder:
    """Per-replica recorder: birth stamps on the write path, vv-delta
    visibility on the merge path.  It records while its registry is
    enabled and it is not ``muted``."""

    def __init__(self, rid: int, registry, events=None):
        self.rid = int(rid)
        self.node_label = str(rid)
        self.registry = registry
        self.events = events
        self.muted = False
        self.ledger: Optional[BirthLedger] = None
        self.step_clock: Optional[Callable[[], int]] = None
        # tier labels, stamped onto every observation and event
        self.extra: Dict[str, str] = {}
        # cmd dict -> tenant name (or None): labels each newly-visible op
        self.tenant_of: Optional[Callable[[Dict[str, str]], Optional[str]]] = None

    @property
    def enabled(self) -> bool:
        return not self.muted and bool(getattr(self.registry, "enabled", False))

    def bind(self, extra: Optional[Dict[str, str]] = None,
             tenant_of: Optional[Callable[[Dict[str, str]], Optional[str]]] = None) -> None:
        """Attach tier labels and/or a tenant extractor."""
        if extra is not None:
            self.extra = {str(k): str(v) for k, v in extra.items()}
        if tenant_of is not None:
            self.tenant_of = tenant_of

    def install(self, ledger: Optional[BirthLedger] = None,
                step_clock: Optional[Callable[[], int]] = None) -> None:
        """Attach the driver's shared ledger and step clock (either may be
        omitted; without them the recorder is wall-clock only)."""
        if ledger is not None:
            self.ledger = ledger
        if step_clock is not None:
            self.step_clock = step_clock

    def _now_step(self) -> Optional[int]:
        return int(self.step_clock()) if self.step_clock is not None else None

    # ---- write side ----

    def note_birth(self, seq: int, op_ts_ms: int) -> None:
        """Stamp one local write: ``(self.rid, seq, birth step)`` into the
        ledger (when installed) and an ``op_birth`` event; ``op_ts_ms`` is
        the op's wire timestamp (absolute Unix ms)."""
        step = self._now_step()
        if self.ledger is not None and step is not None:
            self.ledger.note(self.rid, seq, step)
        if self.events is not None:
            self.events.emit("op_birth", origin=self.rid, seq=seq,
                             op_ts_ms=int(op_ts_ms), **self.extra)

    def note_births(self, births: Sequence[Tuple[int, int]]) -> None:
        """Batched birth stamp for one write drain: every (seq, op_ts_ms)
        into the ledger, ONE ``op_births`` event for the drain's seq
        range."""
        if not births:
            return
        step = self._now_step()
        if self.ledger is not None and step is not None:
            for seq, _ts in births:
                self.ledger.note(self.rid, seq, step)
        if self.events is not None:
            self.events.emit(
                "op_births", origin=self.rid, n=len(births),
                seq_first=int(births[0][0]), seq_last=int(births[-1][0]),
                op_ts_ms_first=int(births[0][1]),
                op_ts_ms_last=int(births[-1][1]), **self.extra)

    # ---- merge side ----

    def note_visible(self, vv_before: Dict[int, int], vv_after: Dict[int, int],
                     births: Optional[Dict[Tuple[int, int], int]] = None,
                     trace: Optional[str] = None,
                     cmds: Optional[Dict[Tuple[int, int], Dict[str, str]]] = None) -> int:
        """Record the origin-seq ranges one merge made newly visible: one
        ``op_visible`` event per origin range; per (origin, seq) one
        ``op_propagation`` observation when it arrived as a raw row
        (``births`` maps its ident to the wire ts) and one
        ``op_propagation_steps`` observation when the ledger knows its
        birth step.  Returns the number of newly-visible ops."""
        now_ms = int(time.time() * 1000)
        step = self._now_step()
        tid = trace if trace is not None else current_trace()
        extra = self.extra
        tenant_of = self.tenant_of
        total = 0
        for origin in sorted(vv_after):
            hi = vv_after[origin]
            lo = vv_before.get(origin, -1)
            if hi <= lo or origin < 0 or origin == self.rid:
                # no progress / watermarkless Go-format ops / own writes
                # (local visibility is birth, not propagation)
                continue
            olab = str(origin)
            max_lag: Optional[int] = None
            tenants: Dict[str, int] = {}
            for seq in range(lo + 1, hi + 1):
                tenant: Optional[str] = None
                if tenant_of is not None and cmds is not None:
                    cmd = cmds.get((origin, seq))
                    if cmd:
                        tenant = tenant_of(cmd)
                        if tenant:
                            tenants[tenant] = tenants.get(tenant, 0) + 1
                lbl = dict(extra, origin=olab, node=self.node_label)
                if tenant:
                    lbl["tenant"] = tenant
                if births is not None:
                    born = births.get((origin, seq))
                    if born is not None:
                        self.registry.observe("op_propagation",
                                              max(0.0, (now_ms - born) / 1e3), **lbl)
                if step is not None and self.ledger is not None:
                    bstep = self.ledger.birth_step(origin, seq)
                    if bstep is not None:
                        lag = max(0, step - bstep)
                        self.registry.observe("op_propagation_steps", float(lag), **lbl)
                        max_lag = lag if max_lag is None else max(max_lag, lag)
            total += hi - lo
            if self.events is not None:
                fields: Dict[str, object] = dict(extra)
                if tenants:
                    fields["tenants"] = tenants
                self.events.emit("op_visible", trace=tid, origin=origin,
                                 seq_lo=lo + 1, seq_hi=hi, n=hi - lo,
                                 lag_steps=max_lag, **fields)
        return total


def propagation_summary(*registries) -> Dict[str, float]:
    """Fleet-wide rollup of the propagation histograms (every
    origin→observer edge of every given registry merged; the merge is an
    elementwise add, so the fold is order-free)."""
    out: Dict[str, float] = {}
    for name, unit in (("op_propagation_steps", "steps"), ("op_propagation", "s")):
        series = []
        for registry in registries:
            series.extend(registry.histograms(name))
        if not series:
            continue
        merged = series[0][1]
        for _, h in series[1:]:
            merged = merged.merge(h)
        out[f"propagation_{unit}_count"] = merged.count
        out[f"propagation_{unit}_p50"] = round(merged.quantile(0.5), 6)
        out[f"propagation_{unit}_p99"] = round(merged.quantile(0.99), 6)
    return out


def propagation_by_tenant(*registries) -> Dict[str, Dict[str, float]]:
    """Per-tenant fold of the propagation histograms: only the series a
    shard's recorder labeled with a tenant take part (the host plane's
    unlabeled series are another tier, not tenant traffic).  Returns
    ``{tenant: {steps_count, steps_p50, steps_p99, s_count, ...}}``."""
    out: Dict[str, Dict[str, float]] = {}
    for name, unit in (("op_propagation_steps", "steps"), ("op_propagation", "s")):
        folds: Dict[str, object] = {}
        for registry in registries:
            for labels, h in registry.histograms(name):
                tenant = labels.get("tenant")
                if not tenant:
                    continue
                cur = folds.get(tenant)
                folds[tenant] = h if cur is None else cur.merge(h)
        for tenant, h in folds.items():
            d = out.setdefault(tenant, {})
            d[f"{unit}_count"] = h.count
            d[f"{unit}_p50"] = round(h.quantile(0.5), 6)
            d[f"{unit}_p99"] = round(h.quantile(0.99), 6)
    return out
