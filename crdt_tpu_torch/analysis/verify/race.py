"""Witnessed-race detector: vector-clock happens-before over the threaded
runtime (counterpart of the JAX package's ``analysis/verify/race``).

A static concurrency lint says "this write *looks* unlocked".  This
module gives evidence instead: it instruments a curated set of shared
attributes (admission lanes, the NetworkAgent breaker state, error
records, flight-recorder state) with data descriptors, tracks a
per-thread vector clock through the runtime's actual synchronization
operations, and reports an access pair as a race ONLY when neither access
happens-before the other, with both stacks attached.  Zero witnesses on a
clean nemesis soak is the evidence; one witness is a reproducer.

Happens-before edges tracked (installed by patching the threading /
concurrent.futures surface, uninstallable):

* ``Thread.start`` / ``Thread.join``: fork / join edges;
* ``ThreadPoolExecutor.submit`` / ``Future.result``: submit / result
  edges (the task's end clock rides a box on the future);
* ``Event.set`` / ``Event.wait`` / ``Event.is_set``: the event carries
  the setter's clock; a waiter (or a True ``is_set`` poll) joins it;
* ``threading.Lock()`` release → acquire: the factory is patched to a
  traced wrapper, so every lock CREATED WHILE INSTALLED carries the last
  releaser's clock.  Locks created before install are invisible: install
  the detector before constructing the objects under test (the nemesis
  soak installs before building its node fleet).

The detector's own state is guarded by a raw ``_thread.allocate_lock``
mutex (never ``threading.Lock``, so tracing cannot recurse) plus a
thread-local re-entrancy guard: GC can run finalizers on the thread
holding the mutex, and a finalizer touching a traced lock or watched
attribute must skip the detector instead of self-deadlocking.

Access epochs: each access is recorded as ``(tid, c)`` where ``c`` is the
accessor's own clock component at access time.  A prior access
``(pt, pc)`` happens-before the current thread ``t`` iff
``clock_t[pt] >= pc``; otherwise the accesses are concurrent and a write
among them is a race witness.

The bridge from the static lint (``watch_from_static``, and
``install(include_static=True)``) turns the port's CRDT201 findings
("self.X written in Class.method without a lock") into watch points on
the ``crdt_tpu_torch`` classes they name.
"""
from __future__ import annotations

import _thread
import contextlib
import dataclasses
import threading
import traceback
from typing import Any, Dict, List, Optional, Sequence, Tuple

#: raw mutex (NOT threading.Lock — that factory gets patched)
_MUTEX = _thread.allocate_lock()

#: thread-local re-entrancy guard.  The mutex is NOT re-entrant, and GC
#: can run arbitrary finalizers on the thread currently holding it (the
#: bookkeeping itself allocates — stack capture, dict growth).  A
#: finalizer that touches a traced lock/attr would then self-deadlock on
#: _MUTEX, so every detector entry point bails out when this thread is
#: already inside the detector.
_REENTRY = threading.local()


def _reentrant() -> bool:
    return getattr(_REENTRY, "busy", False)


@contextlib.contextmanager
def _lock():
    # raise the busy flag BEFORE taking the mutex: from that point any
    # finalizer the interpreter runs on this thread sees it and skips
    # detector bookkeeping entirely
    _REENTRY.busy = True
    _MUTEX.acquire()
    try:
        yield
    finally:
        _MUTEX.release()
        _REENTRY.busy = False


_ENABLED = False

#: tid -> vector clock {tid: int}
_CLOCKS: Dict[int, Dict[int, int]] = {}

#: (obj id, class name, attr) -> {"write": (tid, c, stack) | None,
#:                                "reads": {tid: (c, stack)}}
_HISTORY: Dict[Tuple[int, str, str], dict] = {}

#: (class name, attr) -> {"reads": int, "writes": int}
_COUNTS: Dict[Tuple[str, str], Dict[str, int]] = {}

_WITNESSES: List["RaceWitness"] = []
_MAX_WITNESSES = 200
_STACK_LIMIT = 16

#: (class, attr) -> original class attribute (sentinel _MISSING if none)
_PATCHED_ATTRS: Dict[Tuple[type, str], Any] = {}
_MISSING = object()

_SAVED: Dict[str, Any] = {}  # patched threading/futures callables


@dataclasses.dataclass
class RaceWitness:
    """One concrete unordered conflicting-access pair."""

    cls: str
    attr: str
    kind: str  # "write/write" | "read/write" | "write/read"
    prior_thread: int
    prior_stack: List[str]
    current_thread: int
    current_stack: List[str]

    def render(self) -> str:
        a = "\n    ".join(self.prior_stack[-4:]) or "?"
        b = "\n    ".join(self.current_stack[-4:]) or "?"
        return (f"RACE {self.kind} on {self.cls}.{self.attr}: "
                f"thread {self.prior_thread} at\n    {a}\n"
                f"  unordered with thread {self.current_thread} at\n    {b}")


# ---- vector-clock plumbing --------------------------------------------------


def _tid() -> int:
    return threading.get_ident()


def _vc(tid: int) -> Dict[int, int]:
    vc = _CLOCKS.get(tid)
    if vc is None:
        vc = _CLOCKS[tid] = {tid: 1}
    return vc


def _join_into(dst: Dict[int, int], src: Dict[int, int]) -> None:
    for k, v in src.items():
        if dst.get(k, 0) < v:
            dst[k] = v


def _tick(tid: int) -> None:
    vc = _vc(tid)
    vc[tid] = vc.get(tid, 0) + 1


def _stack() -> List[str]:
    frames = traceback.extract_stack(limit=_STACK_LIMIT)
    out = []
    for f in frames:
        if f.filename.endswith("verify/race.py"):
            continue
        out.append(f"{f.filename}:{f.lineno} in {f.name}")
    return out


def _note(cls_name: str, obj_id: int, attr: str, kind: str) -> None:
    """Record one read/write access and emit witnesses for any prior
    access not ordered before it."""
    if _reentrant():
        return  # finalizer fired inside the detector: don't deadlock
    t = _tid()
    with _lock():
        if not _ENABLED:
            return
        vc = _vc(t)
        c = vc.get(t, 1)
        stack = _stack()
        counts = _COUNTS.setdefault((cls_name, attr),
                                    {"reads": 0, "writes": 0})
        hist = _HISTORY.setdefault((obj_id, cls_name, attr),
                                   {"write": None, "reads": {}})

        def emit(pkind: str, pt: int, pc: int, pstack: List[str]) -> None:
            if pt == t or vc.get(pt, 0) >= pc:
                return  # same thread, or ordered before us
            if len(_WITNESSES) >= _MAX_WITNESSES:
                return
            _WITNESSES.append(RaceWitness(
                cls=cls_name, attr=attr, kind=pkind,
                prior_thread=pt, prior_stack=pstack,
                current_thread=t, current_stack=stack))

        if kind == "write":
            counts["writes"] += 1
            if hist["write"] is not None:
                emit("write/write", *hist["write"])
            for rt, (rc, rstack) in hist["reads"].items():
                emit("read/write", rt, rc, rstack)
            hist["write"] = (t, c, stack)
            hist["reads"] = {}
        else:
            counts["reads"] += 1
            if hist["write"] is not None:
                emit("write/read", *hist["write"])
            hist["reads"][t] = (c, stack)


# ---- attribute instrumentation ----------------------------------------------


class TracedList(list):
    """List wrapper: mutators count as writes on the owning attribute,
    element/length reads as reads.  Left behind after uninstall it
    degrades to a plain list (the enabled flag gates every note)."""

    __slots__ = ("_race_cls", "_race_oid", "_race_attr")

    def _race_bind(self, cls_name: str, oid: int, attr: str) -> "TracedList":
        self._race_cls, self._race_oid, self._race_attr = cls_name, oid, attr
        return self

    def _w(self) -> None:
        if _ENABLED:
            _note(self._race_cls, self._race_oid, self._race_attr, "write")

    def _r(self) -> None:
        if _ENABLED:
            _note(self._race_cls, self._race_oid, self._race_attr, "read")

    def append(self, item):
        self._w()
        return list.append(self, item)

    def extend(self, items):
        self._w()
        return list.extend(self, items)

    def insert(self, i, item):
        self._w()
        return list.insert(self, i, item)

    def remove(self, item):
        self._w()
        return list.remove(self, item)

    def pop(self, *a):
        self._w()
        return list.pop(self, *a)

    def clear(self):
        self._w()
        return list.clear(self)

    def __setitem__(self, i, v):
        self._w()
        return list.__setitem__(self, i, v)

    def __delitem__(self, i):
        self._w()
        return list.__delitem__(self, i)

    def __iadd__(self, other):
        self._w()
        return list.__iadd__(self, other)

    def __len__(self):
        self._r()
        return list.__len__(self)

    def __getitem__(self, i):
        self._r()
        return list.__getitem__(self, i)

    def __iter__(self):
        self._r()
        return list.__iter__(self)

    def __bool__(self):
        self._r()
        return list.__len__(self) > 0


class _TracedAttr:
    """Data descriptor installed over a watched class attribute.

    Plain classes: values live in the instance ``__dict__`` (so the
    descriptor's removal leaves working objects).  ``__slots__`` classes
    (e.g. admission.Ticket): the original slot descriptor is kept and
    delegated to.  Plain-list values are wrapped in TracedList so their
    in-place mutations register as writes.
    """

    def __init__(self, cls: type, name: str, orig: Any):
        self._cls_name = cls.__name__
        self._name = name
        self._orig = orig  # original descriptor (slot) or _MISSING

    def _load(self, obj):
        if self._orig is not _MISSING and hasattr(self._orig, "__get__"):
            return self._orig.__get__(obj, type(obj))
        try:
            return obj.__dict__[self._name]
        except KeyError:
            raise AttributeError(self._name) from None

    def _store(self, obj, value) -> None:
        if self._orig is not _MISSING and hasattr(self._orig, "__set__"):
            self._orig.__set__(obj, value)
        else:
            obj.__dict__[self._name] = value

    def _maybe_wrap(self, obj, value):
        if _ENABLED and type(value) is list:
            value = TracedList(value)._race_bind(
                self._cls_name, id(obj), self._name)
            self._store(obj, value)
        return value

    def __get__(self, obj, objtype=None):
        if obj is None:
            return self
        value = self._load(obj)
        if _ENABLED:
            _note(self._cls_name, id(obj), self._name, "read")
            value = self._maybe_wrap(obj, value)
        return value

    def __set__(self, obj, value) -> None:
        if _ENABLED:
            _note(self._cls_name, id(obj), self._name, "write")
            if type(value) is list:
                value = TracedList(value)._race_bind(
                    self._cls_name, id(obj), self._name)
        self._store(obj, value)

    def __delete__(self, obj) -> None:
        if _ENABLED:
            _note(self._cls_name, id(obj), self._name, "write")
        if self._orig is not _MISSING and hasattr(self._orig, "__delete__"):
            self._orig.__delete__(obj)
        else:
            obj.__dict__.pop(self._name, None)


# ---- synchronization patches ------------------------------------------------


class _TracedLock:
    """threading.Lock stand-in carrying the last releaser's clock."""

    def __init__(self):
        self._inner = _thread.allocate_lock()
        self._race_vc: Optional[Dict[int, int]] = None

    def acquire(self, blocking: bool = True, timeout: float = -1):
        got = self._inner.acquire(blocking, timeout)
        if got and _ENABLED and not _reentrant():
            with _lock():
                if self._race_vc:
                    _join_into(_vc(_tid()), self._race_vc)
        return got

    def release(self) -> None:
        if _ENABLED and not _reentrant():
            with _lock():
                t = _tid()
                self._race_vc = dict(_vc(t))
                _tick(t)
        self._inner.release()

    def locked(self) -> bool:
        return self._inner.locked()

    __enter__ = acquire

    def __exit__(self, *exc) -> None:
        self.release()

    def _at_fork_reinit(self) -> None:
        self._inner = _thread.allocate_lock()
        self._race_vc = None


def _patched_thread_start(self):
    if _reentrant():
        return _SAVED["thread_start"](self)
    t = _tid()
    with _lock():
        snap = dict(_vc(t))
        _tick(t)
    orig_run = self.run

    def run(*a, **k):
        child = _tid()
        with _lock():
            vc = _vc(child)
            _join_into(vc, snap)
            _tick(child)
        try:
            return orig_run(*a, **k)
        finally:
            with _lock():
                self._race_end_vc = dict(_vc(child))

    self.run = run
    return _SAVED["thread_start"](self)


def _patched_thread_join(self, timeout=None):
    out = _SAVED["thread_join"](self, timeout)
    end = getattr(self, "_race_end_vc", None)
    if end is not None and not self.is_alive() and not _reentrant():
        with _lock():
            _join_into(_vc(_tid()), end)
    return out


def _patched_submit(self, fn, /, *args, **kwargs):
    if _reentrant():
        return _SAVED["executor_submit"](self, fn, *args, **kwargs)
    t = _tid()
    with _lock():
        snap = dict(_vc(t))
        _tick(t)
    box: Dict[str, Dict[int, int]] = {}

    def wrapped(*a, **k):
        worker = _tid()
        with _lock():
            vc = _vc(worker)
            _join_into(vc, snap)
            _tick(worker)
        try:
            return fn(*a, **k)
        finally:
            with _lock():
                box["end"] = dict(_vc(worker))

    fut = _SAVED["executor_submit"](self, wrapped, *args, **kwargs)
    fut._race_end_box = box
    return fut


def _patched_future_result(self, timeout=None):
    try:
        return _SAVED["future_result"](self, timeout)
    finally:
        box = getattr(self, "_race_end_box", None)
        if box and "end" in box and not _reentrant():
            with _lock():
                _join_into(_vc(_tid()), box["end"])


def _patched_event_set(self):
    if _reentrant():
        return _SAVED["event_set"](self)
    with _lock():
        t = _tid()
        vc = getattr(self, "_race_vc", None) or {}
        merged = dict(vc)
        _join_into(merged, _vc(t))
        self._race_vc = merged
        _tick(t)
    return _SAVED["event_set"](self)


def _patched_event_wait(self, timeout=None):
    out = _SAVED["event_wait"](self, timeout)
    if out and not _reentrant():
        vc = getattr(self, "_race_vc", None)
        if vc:
            with _lock():
                _join_into(_vc(_tid()), vc)
    return out


def _patched_event_is_set(self):
    out = _SAVED["event_is_set"](self)
    if out and not _reentrant():
        # a True poll is an acquire edge: callers branch on it to read
        # data the setter published before set()
        vc = getattr(self, "_race_vc", None)
        if vc:
            with _lock():
                _join_into(_vc(_tid()), vc)
    return out


# ---- watch lists ------------------------------------------------------------

#: (module, class, attrs): the curated shared-state surface of the
#: threaded runtime.  Every entry is either lock-guarded (the lock is
#: created at instance construction, hence traced when the detector is
#: installed first) or event-published — so a clean run reports ZERO
#: witnesses, and any witness is a real ordering hole.
DEFAULT_WATCH: Sequence[Tuple[str, str, Tuple[str, ...]]] = (
    ("crdt_tpu_torch.api.net", "NetworkAgent", ("errors",)),
    ("crdt_tpu_torch.api.net", "NodeHost", ("_ckpt_errors",)),
    ("crdt_tpu_torch.api.net", "RemotePeer",
     ("failures", "retry_at", "_delay", "_state")),
    ("crdt_tpu_torch.api.cluster", "LocalCluster", ("errors",)),
    ("crdt_tpu_torch.ingest.admission", "AdmissionQueue",
     ("_depth", "_pending", "_oldest")),
    ("crdt_tpu_torch.ingest.admission", "Ticket", ("_result", "_error")),
    ("crdt_tpu_torch.obs.provenance", "BirthLedger", ("_steps",)),
)

def watch_from_static() -> List[Tuple[type, str]]:
    """Bridge from CRDT201: map the static lint's findings ("self.X
    written in Class.method without a lock") to concrete (class, attr)
    watch points on the port's classes, best-effort (unresolvable scopes
    are skipped)."""
    import importlib

    from crdt_tpu_torch.analysis import concurrency, iter_py_files, package_root, repo_root

    findings = concurrency.check_files(iter_py_files([package_root()]), repo_root())
    points: List[Tuple[type, str]] = []
    seen = set()
    for f in findings:
        if f.rule != "CRDT201" or "." not in f.scope:
            continue
        cls_name = f.scope.split(".")[0]
        if not f.detail.startswith("self."):
            continue
        attr = f.detail[len("self."):].split(".")[0].split("(")[0]
        # f.path is repo-relative, e.g. "crdt_tpu_torch/api/net.py"
        mod_name = f.path.removesuffix(".py").replace("/", ".")
        try:
            cls = getattr(importlib.import_module(mod_name), cls_name)
        except (ImportError, AttributeError):
            continue
        if not isinstance(cls, type) or (cls, attr) in seen:
            continue
        seen.add((cls, attr))
        points.append((cls, attr))
    return points


def _resolve_default_watch() -> List[Tuple[type, str]]:
    import importlib

    points: List[Tuple[type, str]] = []
    for mod_name, cls_name, attrs in DEFAULT_WATCH:
        try:
            cls = getattr(importlib.import_module(mod_name), cls_name)
        except (ImportError, AttributeError):
            continue
        for attr in attrs:
            points.append((cls, attr))
    return points


# ---- lifecycle --------------------------------------------------------------


def install(watch: Optional[Sequence[Tuple[type, str]]] = None, *,
            include_static: bool = False) -> int:
    """Instrument the runtime.  ``watch`` defaults to DEFAULT_WATCH
    (resolved lazily); ``include_static=True`` unions in the CRDT201
    bridge points.  Returns the number of watched (class, attr) pairs.
    Idempotent: a second install is a no-op returning 0."""
    global _ENABLED
    import concurrent.futures

    with _lock():
        if _ENABLED:
            return 0

    points = list(watch) if watch is not None else _resolve_default_watch()
    if include_static:
        have = set(points)
        points.extend(p for p in watch_from_static() if p not in have)

    _SAVED["thread_start"] = threading.Thread.start
    _SAVED["thread_join"] = threading.Thread.join
    _SAVED["executor_submit"] = concurrent.futures.ThreadPoolExecutor.submit
    _SAVED["future_result"] = concurrent.futures.Future.result
    _SAVED["event_set"] = threading.Event.set
    _SAVED["event_wait"] = threading.Event.wait
    _SAVED["event_is_set"] = threading.Event.is_set
    _SAVED["lock_factory"] = threading.Lock
    threading.Thread.start = _patched_thread_start
    threading.Thread.join = _patched_thread_join
    concurrent.futures.ThreadPoolExecutor.submit = _patched_submit
    concurrent.futures.Future.result = _patched_future_result
    threading.Event.set = _patched_event_set
    threading.Event.wait = _patched_event_wait
    threading.Event.is_set = _patched_event_is_set
    threading.Lock = _TracedLock

    for cls, attr in points:
        key = (cls, attr)
        if key in _PATCHED_ATTRS:
            continue
        _PATCHED_ATTRS[key] = cls.__dict__.get(attr, _MISSING)
        setattr(cls, attr, _TracedAttr(cls, attr, _PATCHED_ATTRS[key]))

    with _lock():
        # fresh monitoring session: clocks/epochs/witnesses from any
        # previous install describe threads that no longer exist
        _CLOCKS.clear()
        _HISTORY.clear()
        _COUNTS.clear()
        _WITNESSES.clear()
        _ENABLED = True
    return len(points)


def add_watch(points: Sequence[Tuple[type, str]]) -> int:
    """Patch additional (class, attr) pairs while installed (tests use
    this to watch their own fixture classes).  Returns pairs added."""
    added = 0
    with _lock():
        enabled = _ENABLED
    if not enabled:
        return 0
    for cls, attr in points:
        key = (cls, attr)
        if key in _PATCHED_ATTRS:
            continue
        _PATCHED_ATTRS[key] = cls.__dict__.get(attr, _MISSING)
        setattr(cls, attr, _TracedAttr(cls, attr, _PATCHED_ATTRS[key]))
        added += 1
    return added


def uninstall() -> None:
    """Restore every patch.  Traced locks/lists already embedded in live
    objects keep working (their tracing is gated on the enabled flag)."""
    global _ENABLED
    import concurrent.futures

    with _lock():
        if not _ENABLED:
            return
        _ENABLED = False

    threading.Thread.start = _SAVED.pop("thread_start")
    threading.Thread.join = _SAVED.pop("thread_join")
    concurrent.futures.ThreadPoolExecutor.submit = \
        _SAVED.pop("executor_submit")
    concurrent.futures.Future.result = _SAVED.pop("future_result")
    threading.Event.set = _SAVED.pop("event_set")
    threading.Event.wait = _SAVED.pop("event_wait")
    threading.Event.is_set = _SAVED.pop("event_is_set")
    threading.Lock = _SAVED.pop("lock_factory")

    for (cls, attr), orig in _PATCHED_ATTRS.items():
        if orig is _MISSING:
            try:
                delattr(cls, attr)
            except AttributeError:
                pass
        else:
            setattr(cls, attr, orig)
    _PATCHED_ATTRS.clear()


def reset() -> None:
    """Drop clocks, histories, counters, and witnesses (keep patches)."""
    with _lock():
        _CLOCKS.clear()
        _HISTORY.clear()
        _COUNTS.clear()
        _WITNESSES.clear()


def witnesses() -> List[RaceWitness]:
    with _lock():
        return list(_WITNESSES)


def access_counts() -> Dict[str, Dict[str, int]]:
    """"Cls.attr" -> {reads, writes} — proof the run exercised the
    watched surface (a zero-witness report over zero accesses proves
    nothing)."""
    with _lock():
        return {f"{c}.{a}": dict(v) for (c, a), v in sorted(_COUNTS.items())}


def report() -> dict:
    """The soak-facing summary: witnesses (rendered) + access counts."""
    return {
        "witnesses": [w.render() for w in witnesses()],
        "witness_count": len(_WITNESSES),
        "access_counts": access_counts(),
    }
