"""crdtflow: path-sensitive lock-discipline and resource-typestate lint
(counterpart of ``crdt_tpu.analysis.flow``, over the port's tree).

The mesh plane's review fixed three deadlock bugs by hand — PendingMerge lanes
built in a comprehension leaking every earlier shard's held node lock on
a mid-build failure, ``MeshPlane.converge`` stopping its commit sweep at
the first failing lane, and ``flush_all_fused`` stranding DrainClaims
when converge raised.  CRDT201 (unlocked writes) is structurally blind
to all three: they are *path* bugs — a lock or a lock-holding handle is
live on SOME path (usually a raise edge) that never reaches the release.
This module walks every function with a small abstract interpreter over
the statement structure (the CFG with exception edges, materialized as
recursive evaluation with explicit raise/return/break/continue
channels), tracking two facts per path:

* the ordered multiset of HELD LOCKS — pushed by ``x.acquire()`` and
  lock-shaped ``with`` blocks, popped by ``x.release()`` / ``with`` exit
* the set of LIVE LINEAR HANDLES — values returned by protocol creator
  methods (``merge_begin``, ``add_commands_begin``, ``claim``,
  ``submit_many``) that must reach a terminal method on every path

Four rules ride on that state:

CRDT210 lock-leak
    An ``acquire()`` must be post-dominated by ``release()`` on every
    path *including raise edges*.  ``with`` blocks discharge trivially
    (the interpreter strips their token on every exit edge); functions
    named ``*_locked`` follow the caller-holds-the-lock convention and
    never acquire; protocol creator methods (``merge_begin`` et al.)
    intentionally RETURN holding their lock — their normal exits are
    exempt, their raise edges are not.

CRDT211 lock-order
    The global acquisition-order graph is extracted from every observed
    (held-class, acquired-class) pair — lexically held locks, locks held
    through live handles, the ambient node lock of ``*_locked``
    functions, and callee acquisitions through conservative call-graph
    summaries.  The declared order (the JAX package's
    ``parallel/README.md`` "Locking", and the port's own documents):
    shard/lane index ascending within a class, drain (lane) locks
    strictly before node locks on the fused ingest path — the class edge
    ``_drain_lock -> _lock`` — and the card's device lock after the node
    lock — ``_lock -> device_lock`` (``device_lock`` is "taken inside a
    node's own lock, never the other way round", api/node.py; innermost
    at a reshard's cutover, keyspace/reshard.py; after the node locks,
    in ascending device order, in the mesh step, parallel/meshplane.py).
    Any observed edge against a declared
    edge, and any cycle in the class graph, is flagged at the
    acquisition site that introduced it.  Same-class pairs are skipped:
    index-ascending order within a class is a dynamic property the
    static pass cannot see (the nemesis soak's witnessed-race bridge is
    the runtime side of that check).

CRDT212 resource typestate
    Linear-handle protocols, declared per class below: every created
    handle must reach a terminal method (``commit``/``commit_inline``/
    ``abort``, ``resolve``/``fail``, ``wait``/``shed``) on every path.
    Handles that ESCAPE — returned, yielded, stored, appended, or passed
    to a callee such as ``converge``/``land_all_inline`` — transfer the
    obligation and stop being tracked (callees own their cleanup; the
    fixed ``receive_all`` builds its pending list incrementally inside a
    try that lands every already-held lane, which is exactly this
    shape).  Creating lock-holding handles inside a comprehension or
    generator expression is flagged unconditionally: that is the mesh
    plane's leak shape — there is no way to release the earlier elements when a
    later one raises mid-build.

CRDT213 blocking-under-lock
    HTTP/socket/``sleep``/host-sync (``np.asarray``, ``.item()``,
    ``.block_until_ready()``, ``jax.device_get``, and torch's ``.cpu()``,
    ``.tolist()``, ``.numpy()``, ``int()``/``bool()`` of a computed value,
    ``synchronize()``) calls while a node or drain lock is statically held
    — lexically, through a live handle, or inside a ``*_locked`` function
    — directly or through a callee whose summary says it may block.

What the port adds to lock recognition: a ``device_lock(...)`` call is
an acquisition of lock class ``device_lock`` (whatever its device
argument), in a ``with`` item, as the receiver of ``.acquire()`` /
``.release()``, and through ``<stack>.enter_context(...)`` on an
``ExitStack`` bound by an enclosing ``with`` (the stack's ``with`` then
discharges it on every exit edge, as it does at run time).  The items of
one ``with a, b:`` are taken in order, so ``b`` is recorded as acquired
while ``a`` is held.

Findings carry line-free ``detail`` payloads so their fingerprints ride
the existing baseline ratchet and SARIF output unchanged.  Parsing goes
through ``analysis.astcache`` so a combined lint+flow run reads each
file once.
"""
from __future__ import annotations

import ast
import pathlib
import re
from typing import (Any, Callable, Dict, FrozenSet, Iterable, List,
                    Optional, Set, Tuple)

from crdt_tpu_torch.analysis import Finding, ast_checks, astcache

# --------------------------------------------------------------- protocols


class Protocol:
    """One linear-handle protocol: creator methods mint a handle that
    must reach a terminal method on every path.  ``holds`` names the lock
    class the live handle keeps held (None = the handle holds no lock);
    ``raise_edges`` extends the obligation to exception paths (a Ticket
    abandoned by an exception sheds cooperatively, so only its normal
    paths are checked).  ``creators`` maps creator method name -> index
    of the handle in the returned tuple (0 = the whole return value)."""

    def __init__(self, name: str, creators: Dict[str, int],
                 terminals: Set[str], holds: Optional[str],
                 raise_edges: bool = True):
        self.name = name
        self.creators = creators
        self.terminals = terminals
        self.holds = holds
        self.raise_edges = raise_edges


PROTOCOLS: Dict[str, Protocol] = {
    "PendingMerge": Protocol(
        "PendingMerge",
        creators={"merge_begin": 0, "add_commands_begin": 1},
        terminals={"commit", "commit_inline", "abort"},
        holds="_lock"),
    "DrainClaim": Protocol(
        "DrainClaim",
        creators={"claim": 0},
        terminals={"resolve", "fail"},
        holds="_drain_lock"),
    "Ticket": Protocol(
        "Ticket",
        creators={"submit_many": 0},
        terminals={"wait", "shed"},
        holds=None, raise_edges=False),
}

#: creator method name -> protocol (creator names are globally unique)
_CREATOR_TO_PROTO: Dict[str, Protocol] = {
    c: p for p in PROTOCOLS.values() for c in p.creators
}

#: lock classes whose holders must not block (CRDT213's "node or drain
#: lock"); door/metrics/accounting locks guard O(1) sections and are out
#: of scope.  The card's ``device_lock`` is not in it: its holders sync by
#: design (a merge's ``int(n_unique)``, a checkpoint's one ``.cpu()``),
#: and the node lock they are taken under is what CRDT213 reports.
_BLOCK_SENSITIVE = {"_lock", "_drain_lock"}

#: declared order edges: drain (lane) locks strictly precede node locks on
#: the fused ingest path (the JAX package's parallel/README.md "Locking"),
#: and the card's device lock comes after the node lock (api/node.py
#: ``device_lock``; keyspace/reshard.py's cutover order;
#: parallel/meshplane.py's step order)
DECLARED_ORDER: Tuple[Tuple[str, str], ...] = (
    ("_drain_lock", "_lock"), ("_lock", "device_lock"))

#: why each declared edge holds (CRDT211's message)
_ORDER_REASON = {
    ("_drain_lock", "_lock"): "drain/lane locks strictly precede node locks "
                              "(the fused ingest path)",
    ("_lock", "device_lock"): "the card's device lock is taken inside a "
                              "node's own lock, never the other way round "
                              "(api/node.py device_lock)",
}

#: the card's device-lock factory (api/node.py): a call to it is a lock
DEVICE_LOCK = "device_lock"

#: calls assumed non-raising (bounds exception-edge fan-out; anything
#: not listed here conservatively MAY raise)
_NO_RAISE = {
    "len", "isinstance", "issubclass", "getattr", "hasattr", "id",
    "repr", "str", "bool", "print", "min", "max", "enumerate", "zip",
    "range", "format", "type", "callable", "vars", "locals", "globals",
    "append", "appendleft", "extend", "add", "discard", "get", "items",
    "keys", "values", "setdefault", "join", "split", "startswith",
    "endswith", "lower", "upper", "strip", "copy", "is_set", "set",
    "clear", "acquire", "release", "locked", "time", "monotonic",
    "perf_counter", "inc", "dec", "observe", "set_gauge", "emit",
    # the port's device-lock factory: a dict lookup under its guard, so
    # ``device_lock(d).acquire()`` raises no more than ``x._lock.acquire()``
    "device_lock",
}

_LOCK_RE = re.compile(r"[A-Za-z_][A-Za-z0-9_]*")

# ------------------------------------------------------- function indexing


class _Func:
    def __init__(self, module: str, cls: Optional[str], name: str,
                 node: ast.AST, relpath: str):
        self.module = module
        self.cls = cls
        self.name = name
        self.node = node
        self.relpath = relpath

    @property
    def key(self) -> Tuple[str, Optional[str], str]:
        return (self.module, self.cls, self.name)

    @property
    def qualname(self) -> str:
        return f"{self.cls}.{self.name}" if self.cls else self.name


class _Tree:
    """The whole analyzed tree: function index, lock-attribute registry,
    and per-function summaries."""

    def __init__(self) -> None:
        self.funcs: Dict[Tuple[str, Optional[str], str], _Func] = {}
        self.method_owners: Dict[str, Set[Tuple[str, Optional[str]]]] = {}
        #: attribute names assigned threading.Lock()/RLock()/Condition()
        #: anywhere in the tree — catches door locks like ``_adm`` whose
        #: name lacks the "lock" substring the lexical heuristic keys on
        self.lock_attrs: Set[str] = set()
        #: key -> set of lock classes the function (transitively) acquires
        self.sum_acquires: Dict[Tuple, FrozenSet[str]] = {}
        #: key -> blocking reason (None = does not block)
        self.sum_blocks: Dict[Tuple, Optional[str]] = {}


def _is_lock_ctor(call: ast.AST) -> bool:
    if not isinstance(call, ast.Call):
        return False
    f = call.func
    name = f.attr if isinstance(f, ast.Attribute) else \
        f.id if isinstance(f, ast.Name) else ""
    return name in ("Lock", "RLock", "Condition", "Semaphore",
                    "BoundedSemaphore")


def _index_file(tree_ix: _Tree, tree: ast.Module, module: str,
                relpath: str) -> None:
    def add(node: ast.AST, cls: Optional[str]) -> None:
        f = _Func(module, cls, node.name, node, relpath)
        tree_ix.funcs[f.key] = f
        tree_ix.method_owners.setdefault(node.name, set()).add((module, cls))

    for stmt in tree.body:
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
            add(stmt, None)
        elif isinstance(stmt, ast.ClassDef):
            for m in stmt.body:
                if isinstance(m, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    add(m, stmt.name)
    for n in ast.walk(tree):
        if isinstance(n, ast.Assign) and _is_lock_ctor(n.value):
            for t in n.targets:
                if isinstance(t, ast.Attribute):
                    tree_ix.lock_attrs.add(t.attr)
                elif isinstance(t, ast.Name):
                    tree_ix.lock_attrs.add(t.id)


def _resolve_call(tree_ix: _Tree, call: ast.Call, module: str,
                  cls: Optional[str]) -> Optional[_Func]:
    f = call.func
    if isinstance(f, ast.Attribute):
        if isinstance(f.value, ast.Name) and f.value.id == "self" and cls:
            key = (module, cls, f.attr)
            if key in tree_ix.funcs:
                return tree_ix.funcs[key]
        owners = {o for o in tree_ix.method_owners.get(f.attr, set())
                  if o[1] is not None}
        if len(owners) == 1:
            (m, c) = next(iter(owners))
            return tree_ix.funcs[(m, c, f.attr)]
        return None
    if isinstance(f, ast.Name):
        key = (module, None, f.id)
        if key in tree_ix.funcs:
            return tree_ix.funcs[key]
    return None


# -------------------------------------------------------- call classifiers


def _callee_name(call: ast.Call) -> str:
    f = call.func
    if isinstance(f, ast.Attribute):
        return f.attr
    if isinstance(f, ast.Name):
        return f.id
    return ""


def _unparse(node: ast.AST) -> str:
    try:
        src = ast.unparse(node)
    except Exception:  # pragma: no cover - unparse is total on 3.9+
        src = ""
    return src


def _lock_token(tree_ix: _Tree, recv: ast.AST) -> Optional[str]:
    """The lock token for an acquire/release receiver (or a bare
    lock-shaped ``with`` context), else None.  Recognized when any
    identifier in the expression contains "lock" (case-insensitive) or
    names an attribute the tree assigns a ``threading.Lock()`` to."""
    src = _unparse(recv)
    if not src:
        return None
    for ident in _LOCK_RE.findall(src):
        if "lock" in ident.lower() or "mutex" in ident.lower():
            return src
        if ident in tree_ix.lock_attrs:
            return src
    return None


_DEVICE_LOCK_RE = re.compile(r"^(?:[A-Za-z_][A-Za-z0-9_]*\.)*device_lock\(")


def _lock_class(token: str) -> str:
    """The lock CLASS of a token: the identifier that made it a lock
    (``self._drain_lock`` -> ``_drain_lock``, ``self._adm`` -> ``_adm``,
    ``self.lanes[i]._lock`` -> ``_lock``, ``device_lock(d)`` ->
    ``device_lock``)."""
    if _DEVICE_LOCK_RE.match(token):
        return DEVICE_LOCK
    idents = _LOCK_RE.findall(token)
    for ident in reversed(idents):
        if "lock" in ident.lower() or "mutex" in ident.lower():
            return ident
    return idents[-1] if idents else token


_HTTP_NAMES = {"urlopen", "getresponse", "create_connection"}
_SOCKET_NAMES = {"recv", "accept", "sendall", "makefile", "connect_ex"}
_REQUESTS_VERBS = {"get", "post", "put", "delete", "request", "head"}


def _blocking_reason(call: ast.Call) -> Optional[str]:
    """Why this call blocks (sleep / host sync / HTTP / socket), or
    None."""
    name = _callee_name(call)
    if name == "sleep":
        return "sleep()"
    if name == "block_until_ready":
        return ".block_until_ready() host sync"
    if name == "device_get":
        return "jax.device_get host sync"
    if name == "item" and not call.args and not call.keywords:
        return ".item() host sync"
    if ast_checks.torch_host_sync(call) is not None:
        return f"{name}() host sync"
    if name == "asarray":
        f = call.func
        if isinstance(f, ast.Attribute) and isinstance(f.value, ast.Name) \
                and f.value.id in ("np", "numpy"):
            return "np.asarray host sync"
    if name in _HTTP_NAMES:
        return f"{name}() network I/O"
    if name in _SOCKET_NAMES:
        return f"{name}() socket I/O"
    if name in _REQUESTS_VERBS:
        f = call.func
        if isinstance(f, ast.Attribute) and isinstance(f.value, ast.Name) \
                and f.value.id == "requests":
            return f"requests.{name}() network I/O"
    return None


def _is_exit_stack(expr: ast.AST) -> bool:
    """``contextlib.ExitStack()`` / ``ExitStack()``."""
    return isinstance(expr, ast.Call) and _callee_name(expr) == "ExitStack"


def _may_raise_call(call: ast.Call) -> bool:
    return _callee_name(call) not in _NO_RAISE


class _CallScan(ast.NodeVisitor):
    """Calls executed at a statement's site, in AST order — descends into
    comprehensions (their element code runs here) but not into lambda or
    nested def/class bodies (theirs doesn't)."""

    def __init__(self) -> None:
        self.calls: List[ast.Call] = []

    def visit_Call(self, node: ast.Call) -> None:
        self.calls.append(node)
        self.generic_visit(node)

    def visit_Lambda(self, node: ast.Lambda) -> None:
        pass

    def visit_FunctionDef(self, node: ast.FunctionDef) -> None:
        pass

    def visit_AsyncFunctionDef(self, node: ast.AsyncFunctionDef) -> None:
        pass

    def visit_ClassDef(self, node: ast.ClassDef) -> None:
        pass


def _calls_at(node: ast.AST) -> List[ast.Call]:
    scan = _CallScan()
    scan.visit(node)
    return scan.calls


# --------------------------------------------------------------- summaries


def _direct_facts(tree_ix: _Tree, fn: _Func) -> Tuple[Set[str],
                                                      Optional[str],
                                                      List[ast.Call]]:
    """(directly acquired lock classes, direct blocking reason, calls)
    for one function body — the seed of the summary fixpoint."""
    acquires: Set[str] = set()
    blocks: Optional[str] = None
    calls: List[ast.Call] = []
    for node in ast.walk(fn.node):
        if isinstance(node, ast.Call):
            calls.append(node)
            name = _callee_name(node)
            if name == "acquire" and isinstance(node.func, ast.Attribute):
                tok = _lock_token(tree_ix, node.func.value)
                if tok is not None:
                    acquires.add(_lock_class(tok))
            if name == "enter_context" and node.args:
                tok = _lock_token(tree_ix, node.args[0])
                if tok is not None:
                    acquires.add(_lock_class(tok))
            proto = _CREATOR_TO_PROTO.get(name)
            if proto is not None and proto.holds is not None:
                acquires.add(proto.holds)
            if blocks is None:
                blocks = _blocking_reason(node)
        elif isinstance(node, (ast.With, ast.AsyncWith)):
            for item in node.items:
                tok = _lock_token(tree_ix, item.context_expr)
                if tok is not None:
                    acquires.add(_lock_class(tok))
    return acquires, blocks, calls


def _build_summaries(tree_ix: _Tree) -> None:
    """Fixpoint over the conservative call graph: what lock classes each
    function may acquire (transitively) and whether it may block."""
    direct: Dict[Tuple, Tuple[Set[str], Optional[str], List[ast.Call]]] = {}
    for key, fn in tree_ix.funcs.items():
        direct[key] = _direct_facts(tree_ix, fn)
        tree_ix.sum_acquires[key] = frozenset(direct[key][0])
        tree_ix.sum_blocks[key] = direct[key][1]
    changed = True
    while changed:
        changed = False
        for key, fn in tree_ix.funcs.items():
            acq = set(tree_ix.sum_acquires[key])
            blk = tree_ix.sum_blocks[key]
            for call in direct[key][2]:
                callee = _resolve_call(tree_ix, call, fn.module, fn.cls)
                if callee is None or callee.key == key:
                    continue
                acq |= tree_ix.sum_acquires[callee.key]
                if blk is None:
                    inner = tree_ix.sum_blocks[callee.key]
                    if inner is not None:
                        blk = f"{callee.qualname}() -> {inner}"
            if frozenset(acq) != tree_ix.sum_acquires[key] or \
                    blk != tree_ix.sum_blocks[key]:
                tree_ix.sum_acquires[key] = frozenset(acq)
                tree_ix.sum_blocks[key] = blk
                changed = True


# ------------------------------------------------------ the abstract state

#: one held lock: (token expr, lock class, acquire line, auto) — auto
#: tokens come from ``with`` blocks (True) or from ``enter_context`` on an
#: ExitStack the enclosing ``with`` owns (the stack's mark); both are
#: stripped on every exit edge by construction, so they can never appear
#: in a CRDT210 finding
_Held = Tuple[str, str, int, Any]
#: one live handle: (variable name, protocol name, creator call source,
#: creation line)
_Handle = Tuple[str, str, str, int]
#: a path state: (held locks in acquisition order, live handles)
_State = Tuple[Tuple[_Held, ...], Tuple[_Handle, ...]]

_EMPTY: _State = ((), ())

#: per-block state-set cap: beyond this, paths are merged coarsely (the
#: analysis stays sound for the codebase's function sizes; the cap only
#: guards pathological fixtures)
_MAX_STATES = 64


def _held_classes(state: _State, ambient: FrozenSet[str]) -> Set[str]:
    out = set(ambient)
    out.update(cls for (_tok, cls, _ln, _auto) in state[0])
    for (_var, proto, _src, _ln) in state[1]:
        holds = PROTOCOLS[proto].holds
        if holds is not None:
            out.add(holds)
    return out


class _Edges:
    """The nonlocal-exit channels of the block under evaluation."""

    def __init__(self, raise_to: Callable[[_State, ast.AST], None],
                 return_to: Callable[[_State, ast.AST], None],
                 break_to: Optional[Callable[[_State], None]] = None,
                 continue_to: Optional[Callable[[_State], None]] = None):
        self.raise_to = raise_to
        self.return_to = return_to
        self.break_to = break_to
        self.continue_to = continue_to

    def wrap(self, fix: Callable[[_State], _State]) -> "_Edges":
        return _Edges(
            lambda st, n: self.raise_to(fix(st), n),
            lambda st, n: self.return_to(fix(st), n),
            None if self.break_to is None
            else (lambda st: self.break_to(fix(st))),
            None if self.continue_to is None
            else (lambda st: self.continue_to(fix(st))),
        )


# ------------------------------------------------------- the interpreter


class _FuncFlow:
    """Path-sensitive walk of ONE function body."""

    def __init__(self, tree_ix: _Tree, fn: _Func,
                 order_edges: Dict[Tuple[str, str], Tuple[str, int, str]],
                 findings: List[Finding]):
        self.t = tree_ix
        self.fn = fn
        self.order_edges = order_edges
        self.findings = findings
        self.seen_details: Set[Tuple[str, str]] = set()
        #: the caller-holds-the-lock convention: a ``*_locked`` function
        #: runs with its object's node lock held
        self.ambient: FrozenSet[str] = frozenset(
            {"_lock"} if fn.name.endswith("_locked") else ())
        self.is_creator = fn.name in _CREATOR_TO_PROTO
        #: ExitStack names bound by the enclosing ``with`` blocks -> the
        #: mark their ``enter_context`` locks carry (stripped at its exit)
        self._stacks: Dict[str, str] = {}

    # ---- reporting ----

    def _emit(self, rule: str, line: int, message: str, detail: str,
              col: int = 0) -> None:
        if (rule, detail) in self.seen_details:
            return
        self.seen_details.add((rule, detail))
        self.findings.append(Finding(
            rule=rule, path=self.fn.relpath, line=line, col=col,
            scope=self.fn.qualname, message=message, detail=detail))

    def _at_exit(self, state: _State, kind: str, node: ast.AST) -> None:
        """A path left the function: everything still held/live leaks."""
        for (tok, cls, line, auto) in state[0]:
            if auto:
                continue
            if kind == "return" and self.is_creator:
                continue  # creators return holding by contract
            how = ("not released on an exception path" if kind == "raise"
                   else "not released on every return path")
            self._emit(
                "CRDT210", line,
                f"{tok}.acquire() in {self.fn.qualname} is {how} "
                f"(wrap in try/finally or `with {tok}:`)",
                f"{tok}|{kind}")
        for (var, proto_name, src, line) in state[1]:
            proto = PROTOCOLS[proto_name]
            if kind == "raise" and not proto.raise_edges:
                continue
            if kind == "return" and self.is_creator:
                continue
            terms = "/".join(sorted(proto.terminals))
            how = ("leaks on an exception path" if kind == "raise"
                   else "may reach function exit")
            held = (f" with {proto.holds} still held"
                    if proto.holds is not None else "")
            self._emit(
                "CRDT212", line,
                f"{proto_name} handle `{var}` from {src} {how} without "
                f"{terms}{held} in {self.fn.qualname}",
                f"{proto_name}:{var}|{kind}")

    def _record_order(self, state: _State, acquired_cls: str,
                      line: int) -> None:
        for held_cls in _held_classes(state, self.ambient):
            if held_cls == acquired_cls:
                continue  # intra-class order is dynamic (index ascending)
            edge = (held_cls, acquired_cls)
            if edge not in self.order_edges:
                self.order_edges[edge] = (self.fn.relpath, line,
                                          self.fn.qualname)

    def _check_blocking(self, state: _State, reason: str, line: int,
                        src: str) -> None:
        held = _held_classes(state, self.ambient) & _BLOCK_SENSITIVE
        if not held:
            return
        via = "+".join(sorted(held))
        self._emit(
            "CRDT213", line,
            f"blocking call {src} while {via} is statically held "
            f"in {self.fn.qualname}",
            f"{src[:80]}|{via}")

    # ---- statement effects ----

    def _apply_stmt(self, stmt: ast.stmt, state: _State,
                    edges: _Edges) -> List[_State]:
        """One simple statement: classify its calls in order, emit
        findings, push the exception edge if it may raise, and return the
        normal-continuation states."""
        norm_held = list(state[0])
        norm_live = list(state[1])
        exc_live = list(state[1])
        may_raise = isinstance(stmt, (ast.Raise, ast.Assert))
        live_names = {h[0] for h in norm_live}
        bound_here: List[_Handle] = []

        # creation binding shape: `x = creator(...)` / `a, x = creator(...)`
        creator_value: Optional[ast.Call] = None
        if isinstance(stmt, ast.Assign) and isinstance(stmt.value, ast.Call):
            proto = _CREATOR_TO_PROTO.get(_callee_name(stmt.value))
            if proto is not None:
                creator_value = stmt.value

        for call in _calls_at(stmt):
            name = _callee_name(call)
            src = _unparse(call)
            line = call.lineno
            if _may_raise_call(call):
                may_raise = True
            # a lock entered on an ExitStack of an enclosing ``with``
            if name == "enter_context" and call.args and \
                    isinstance(call.func, ast.Attribute) and \
                    isinstance(call.func.value, ast.Name) and \
                    call.func.value.id in self._stacks:
                tok = _lock_token(self.t, call.args[0])
                if tok is not None:
                    cur = (tuple(norm_held), tuple(norm_live))
                    self._record_order(cur, _lock_class(tok), line)
                    norm_held.append((tok, _lock_class(tok), line,
                                      self._stacks[call.func.value.id]))
                    continue
            # lock primitives
            if name in ("acquire", "release") and \
                    isinstance(call.func, ast.Attribute):
                tok = _lock_token(self.t, call.func.value)
                if tok is not None:
                    if name == "acquire":
                        cur = (tuple(norm_held), tuple(norm_live))
                        self._record_order(cur, _lock_class(tok), line)
                        norm_held.append((tok, _lock_class(tok), line, False))
                    else:
                        for i in range(len(norm_held) - 1, -1, -1):
                            if norm_held[i][0] == tok:
                                del norm_held[i]
                                break
                    continue
            # terminal method on a live handle: consumed on BOTH edges
            # (the protocols' terminals release in finally blocks)
            if isinstance(call.func, ast.Attribute) and \
                    isinstance(call.func.value, ast.Name):
                recv = call.func.value.id
                if recv in live_names:
                    proto = PROTOCOLS[next(
                        h[1] for h in norm_live if h[0] == recv)]
                    if name in proto.terminals:
                        norm_live = [h for h in norm_live if h[0] != recv]
                        exc_live = [h for h in exc_live if h[0] != recv]
                        live_names.discard(recv)
                        continue
            # creator call: bind, drop, or escape
            proto = _CREATOR_TO_PROTO.get(name)
            if proto is not None and isinstance(call.func, ast.Attribute):
                handle_src = f"{src[:60]}"
                if call is creator_value:
                    var = self._bind_target(stmt, proto)
                    if var is not None:
                        bound_here.append((var, proto.name, handle_src, line))
                elif isinstance(stmt, ast.Expr) and stmt.value is call:
                    self._emit(
                        "CRDT212", line,
                        f"{proto.name} handle from {handle_src} is "
                        f"discarded without reaching a terminal in "
                        f"{self.fn.qualname}",
                        f"{proto.name}:<dropped>:{handle_src}")
                # otherwise the fresh handle is passed straight into a
                # container/callee: the obligation escapes with it
                cur = (tuple(norm_held), tuple(norm_live))
                if proto.holds is not None:
                    self._record_order(cur, proto.holds, line)
                continue
            # blocking + callee-summary effects
            reason = _blocking_reason(call)
            cur = (tuple(norm_held), tuple(norm_live))
            if reason is not None:
                self._check_blocking(cur, reason, line, src[:60])
            callee = _resolve_call(self.t, call, self.fn.module, self.fn.cls)
            if callee is not None and callee.key != self.fn.key:
                for acq in self.t.sum_acquires[callee.key]:
                    self._record_order(cur, acq, line)
                inner = self.t.sum_blocks[callee.key]
                if inner is not None and reason is None and \
                        not callee.name.endswith("_locked"):
                    self._check_blocking(
                        cur, inner, line, f"{callee.qualname}()")

        # escapes: a live handle name read anywhere except as the
        # receiver of its own method call transfers the obligation
        if live_names:
            escaped = self._escaped_names(stmt, live_names)
            if escaped:
                norm_live = [h for h in norm_live if h[0] not in escaped]
                exc_live = [h for h in exc_live if h[0] not in escaped]

        # rebinding a live name loses the old handle
        for tgt in self._assigned_names(stmt):
            norm_live = [h for h in norm_live if h[0] != tgt]
            exc_live = [h for h in exc_live if h[0] != tgt]
        norm_live.extend(bound_here)

        if may_raise:
            edges.raise_to((tuple(norm_held), tuple(exc_live)), stmt)
        if isinstance(stmt, ast.Raise):
            return []
        return [(tuple(norm_held), tuple(norm_live))]

    def _bind_target(self, stmt: ast.Assign,
                     proto: Protocol) -> Optional[str]:
        """The simple name the creator's handle lands in, honoring the
        protocol's tuple index (``idents, pending = add_commands_begin``
        puts the handle at index 1)."""
        if len(stmt.targets) != 1:
            return None
        tgt = stmt.targets[0]
        idx = proto.creators[_callee_name(stmt.value)]
        if isinstance(tgt, ast.Name):
            return tgt.id if idx == 0 else None
        if isinstance(tgt, ast.Tuple) and idx < len(tgt.elts):
            el = tgt.elts[idx]
            if isinstance(el, ast.Name):
                return el.id
        return None

    def _escaped_names(self, stmt: ast.stmt,
                       live: Set[str]) -> Set[str]:
        out: Set[str] = set()
        receiver_ids = set()
        for n in ast.walk(stmt):
            if isinstance(n, ast.Call) and \
                    isinstance(n.func, ast.Attribute) and \
                    isinstance(n.func.value, ast.Name):
                receiver_ids.add(id(n.func.value))
            elif isinstance(n, ast.Attribute) and \
                    isinstance(n.value, ast.Name):
                # plain attribute reads (claim.batch) don't escape
                receiver_ids.add(id(n.value))
        for n in ast.walk(stmt):
            if isinstance(n, ast.Name) and isinstance(n.ctx, ast.Load) \
                    and n.id in live and id(n) not in receiver_ids:
                out.add(n.id)
        return out

    def _assigned_names(self, stmt: ast.stmt) -> Set[str]:
        out: Set[str] = set()
        targets: List[ast.AST] = []
        if isinstance(stmt, ast.Assign):
            targets = list(stmt.targets)
        elif isinstance(stmt, (ast.AugAssign, ast.AnnAssign)):
            targets = [stmt.target]
        for t in targets:
            for n in ast.walk(t):
                if isinstance(n, ast.Name) and \
                        isinstance(n.ctx, ast.Store):
                    out.add(n.id)
        return out

    def _expr_effects(self, expr: ast.AST, states: Set[_State],
                      edges: _Edges) -> Set[_State]:
        """Calls inside a test/iter expression: blocking + raise edges,
        no binding or escape semantics."""
        may_raise = False
        for call in _calls_at(expr):
            if _may_raise_call(call):
                may_raise = True
            reason = _blocking_reason(call)
            if reason is not None:
                for st in states:
                    self._check_blocking(st, reason, call.lineno,
                                         _unparse(call)[:60])
        if may_raise:
            for st in states:
                edges.raise_to(st, expr)
        return states

    # ---- narrowing ----

    @staticmethod
    def _narrow(states: Set[_State], name: str,
                drop: bool) -> Set[_State]:
        if not drop:
            return states
        return {(held, tuple(h for h in live if h[0] != name))
                for (held, live) in states}

    def _branch_states(self, test: ast.AST, states: Set[_State]
                       ) -> Tuple[Set[_State], Set[_State]]:
        """(body states, else states) after None/truthiness narrowing:
        `if x is None:` means no handle exists in the body branch."""
        name, none_in_body = None, False
        if isinstance(test, ast.Compare) and len(test.ops) == 1 and \
                isinstance(test.left, ast.Name) and \
                isinstance(test.comparators[0], ast.Constant) and \
                test.comparators[0].value is None:
            name = test.left.id
            none_in_body = isinstance(test.ops[0], ast.Is)
        elif isinstance(test, ast.UnaryOp) and \
                isinstance(test.op, ast.Not) and \
                isinstance(test.operand, ast.Name):
            name, none_in_body = test.operand.id, True
        if name is None:
            return states, states
        return (self._narrow(states, name, none_in_body),
                self._narrow(states, name, not none_in_body))

    # ---- compound statements ----

    def exec_block(self, stmts: List[ast.stmt], states: Set[_State],
                   edges: _Edges) -> Set[_State]:
        cur = set(states)
        for stmt in stmts:
            if not cur:
                break
            cur = self.exec_stmt(stmt, cur, edges)
            if len(cur) > _MAX_STATES:
                cur = set(list(cur)[:_MAX_STATES])
        return cur

    def exec_stmt(self, stmt: ast.stmt, states: Set[_State],
                  edges: _Edges) -> Set[_State]:
        if isinstance(stmt, ast.If):
            states = self._expr_effects(stmt.test, states, edges)
            body_in, else_in = self._branch_states(stmt.test, states)
            out = self.exec_block(stmt.body, body_in, edges)
            out |= self.exec_block(stmt.orelse, else_in, edges)
            return out
        if isinstance(stmt, (ast.While, ast.For, ast.AsyncFor)):
            return self._exec_loop(stmt, states, edges)
        if isinstance(stmt, ast.Try):
            return self._exec_try(stmt, states, edges)
        if isinstance(stmt, (ast.With, ast.AsyncWith)):
            return self._exec_with(stmt, states, edges)
        if isinstance(stmt, ast.Return):
            out: Set[_State] = set()
            if stmt.value is not None:
                for st in states:
                    for nxt in self._apply_stmt(stmt, st, edges):
                        edges.return_to(nxt, stmt)
            else:
                for st in states:
                    edges.return_to(st, stmt)
            return out
        if isinstance(stmt, ast.Break):
            for st in states:
                if edges.break_to is not None:
                    edges.break_to(st)
            return set()
        if isinstance(stmt, ast.Continue):
            for st in states:
                if edges.continue_to is not None:
                    edges.continue_to(st)
            return set()
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef, ast.Import, ast.ImportFrom,
                             ast.Global, ast.Nonlocal, ast.Pass)):
            return states
        # simple statements (Expr/Assign/AugAssign/Raise/Assert/Delete/…)
        out = set()
        for st in states:
            out.update(self._apply_stmt(stmt, st, edges))
        return out

    def _exec_loop(self, stmt: ast.stmt, states: Set[_State],
                   edges: _Edges) -> Set[_State]:
        breaks: Set[_State] = set()
        conts: Set[_State] = set()
        inner = _Edges(edges.raise_to, edges.return_to,
                       breaks.add, conts.add)
        if isinstance(stmt, (ast.For, ast.AsyncFor)):
            states = self._expr_effects(stmt.iter, states, edges)
            # the loop target shadows any live handle of the same name
            tgt_names = {n.id for n in ast.walk(stmt.target)
                         if isinstance(n, ast.Name)}
            states = {(held, tuple(h for h in live
                                   if h[0] not in tgt_names))
                      for (held, live) in states}
        else:
            states = self._expr_effects(stmt.test, states, edges)
        seen: Set[_State] = set(states)
        frontier: Set[_State] = set(states)
        for _ in range(3):
            if not frontier:
                break
            conts.clear()
            out = self.exec_block(stmt.body, frontier, inner)
            nxt = out | set(conts)
            frontier = nxt - seen
            seen |= nxt
        exits = set(seen)
        infinite = isinstance(stmt, ast.While) and \
            isinstance(stmt.test, ast.Constant) and stmt.test.value is True
        if infinite:
            exits = set()
        exits |= breaks
        if stmt.orelse:
            exits = self.exec_block(stmt.orelse, exits, edges)
        return exits

    def _exec_try(self, stmt: ast.Try, states: Set[_State],
                  edges: _Edges) -> Set[_State]:
        if not stmt.finalbody:
            return self._try_core(stmt, states, edges)
        # finally: intercept every nonlocal exit of body+handlers, funnel
        # each through finalbody, then let it resume its journey.  This
        # is what discharges `acquire(); try: ... finally: release()` on
        # the raise edge — the release in finalbody pops the token from
        # the intercepted exception state before it propagates.
        raised: Set[_State] = set()
        returns: List[Tuple[_State, ast.AST]] = []
        breaks: Set[_State] = set()
        conts: Set[_State] = set()
        inner = _Edges(
            lambda st, n: raised.add(st),
            lambda st, n: returns.append((st, n)),
            breaks.add if edges.break_to is not None else None,
            conts.add if edges.continue_to is not None else None)
        normal = self._try_core(stmt, states, inner)

        def through_final(src: Set[_State]) -> Set[_State]:
            if not src:
                return set()
            return self.exec_block(stmt.finalbody, src, edges)

        out = through_final(normal)
        for st in through_final(raised):
            edges.raise_to(st, stmt)
        if returns:
            for st in through_final({s for s, _ in returns}):
                edges.return_to(st, returns[0][1])
        for st in through_final(breaks):
            edges.break_to(st)
        for st in through_final(conts):
            edges.continue_to(st)
        return out

    def _try_core(self, stmt: ast.Try, states: Set[_State],
                  edges: _Edges) -> Set[_State]:
        """try/except/else without finally: body raises enter the
        handlers; narrow handlers ALSO propagate (they may not match);
        raises inside handler/else bodies propagate out unconditionally."""
        raised: Set[_State] = set()
        body_edges = _Edges(lambda st, n: raised.add(st),
                            edges.return_to, edges.break_to,
                            edges.continue_to)
        after_body = self.exec_block(stmt.body, states, body_edges)
        broad = any(h.type is None or
                    (isinstance(h.type, ast.Name) and
                     h.type.id in ("Exception", "BaseException"))
                    for h in stmt.handlers)
        snapshot = frozenset(raised)
        handler_out: Set[_State] = set()
        for h in stmt.handlers:
            handler_out |= self.exec_block(h.body, set(snapshot), edges)
        if not stmt.handlers or not broad:
            for st in snapshot:
                edges.raise_to(st, stmt)
        normal = after_body
        if stmt.orelse:
            normal = self.exec_block(stmt.orelse, normal, edges)
        return normal | handler_out

    def _exec_with(self, stmt: ast.stmt, states: Set[_State],
                   edges: _Edges) -> Set[_State]:
        auto_toks: List[_Held] = []
        stacks: Dict[str, str] = {}
        for item in stmt.items:
            states = self._expr_effects(item.context_expr, states, edges)
            if _is_exit_stack(item.context_expr) and \
                    isinstance(item.optional_vars, ast.Name):
                name = item.optional_vars.id
                stacks[name] = f"stack@{stmt.lineno}:{name}"
                continue
            tok = _lock_token(self.t, item.context_expr)
            if tok is not None:
                # the earlier items of this ``with`` are held already
                earlier = tuple(auto_toks)
                for st in states:
                    self._record_order((st[0] + earlier, st[1]),
                                       _lock_class(tok),
                                       item.context_expr.lineno)
                auto_toks.append((tok, _lock_class(tok),
                                  item.context_expr.lineno, True))
        if not auto_toks and not stacks:
            return self.exec_block(stmt.body, states, edges)
        tagged = tuple(auto_toks)
        marks = set(stacks.values())

        def add(st: _State) -> _State:
            return (st[0] + tagged, st[1])

        def strip(st: _State) -> _State:
            held = [h for h in st[0] if h[3] not in marks]
            for tok in tagged:
                for i in range(len(held) - 1, -1, -1):
                    if held[i] == tok:
                        del held[i]
                        break
            return (tuple(held), st[1])

        entered = {add(st) for st in states}
        outer = self._stacks
        self._stacks = {**outer, **stacks}
        try:
            out = self.exec_block(stmt.body, entered, edges.wrap(strip))
        finally:
            self._stacks = outer
        return {strip(st) for st in out}

    # ---- comprehension creations (the mesh plane's leak shape) ----

    def _scan_comprehensions(self) -> None:
        for node in ast.walk(self.fn.node):
            if not isinstance(node, (ast.ListComp, ast.SetComp,
                                     ast.GeneratorExp, ast.DictComp)):
                continue
            elts = [node.key, node.value] if isinstance(node, ast.DictComp) \
                else [node.elt]
            for elt in elts:
                for call in _calls_at(elt):
                    proto = _CREATOR_TO_PROTO.get(_callee_name(call))
                    if proto is None or proto.holds is None:
                        continue
                    src = _unparse(call)[:60]
                    self._emit(
                        "CRDT212", call.lineno,
                        f"{proto.name} handles built in a comprehension in "
                        f"{self.fn.qualname}: a failure mid-build leaks "
                        f"every earlier element's {proto.holds} (build "
                        f"incrementally under try, landing held lanes on "
                        f"error — the fixed receive_all's shape)",
                        f"{proto.name}:<comprehension>:{src}")

    # ---- entry ----

    def run(self) -> None:
        self._scan_comprehensions()
        exits: List[Tuple[_State, str, ast.AST]] = []
        edges = _Edges(
            lambda st, n: exits.append((st, "raise", n)),
            lambda st, n: exits.append((st, "return", n)))
        out = self.exec_block(self.fn.node.body, {_EMPTY}, edges)
        for st in out:
            exits.append((st, "return", self.fn.node))
        for st, kind, node in exits:
            self._at_exit(st, kind, node)


# ----------------------------------------------------------- order verdict


def _order_findings(order_edges: Dict[Tuple[str, str],
                                      Tuple[str, int, str]]
                    ) -> List[Finding]:
    findings: List[Finding] = []
    flagged: Set[Tuple[str, str]] = set()
    for (a, b) in DECLARED_ORDER:
        edge = (b, a)  # acquiring `a` while holding `b` = against order
        if edge in order_edges:
            path, line, scope = order_edges[edge]
            flagged.add(edge)
            findings.append(Finding(
                rule="CRDT211", path=path, line=line, scope=scope,
                detail=f"{b}->{a}",
                message=(f"acquires {a} while holding {b}: the declared "
                         f"order is {a} before {b} — "
                         + _ORDER_REASON[(a, b)])))
    # cycles in the observed class graph (beyond the declared pairs)
    graph: Dict[str, Set[str]] = {}
    for (src, dst) in order_edges:
        graph.setdefault(src, set()).add(dst)

    def on_cycle(edge: Tuple[str, str]) -> bool:
        src, dst = edge
        seen = {dst}
        stack = [dst]
        while stack:
            cur = stack.pop()
            if cur == src:
                return True
            for nxt in graph.get(cur, ()):
                if nxt not in seen:
                    seen.add(nxt)
                    stack.append(nxt)
        return False

    for edge, (path, line, scope) in sorted(order_edges.items()):
        if edge in flagged or not on_cycle(edge):
            continue
        src, dst = edge
        findings.append(Finding(
            rule="CRDT211", path=path, line=line, scope=scope,
            detail=f"cycle:{src}->{dst}",
            message=(f"lock acquisition {src} -> {dst} closes a cycle in "
                     f"the observed acquisition-order graph (deadlock "
                     f"risk: another path acquires these classes in the "
                     f"opposite order)")))
    return findings


# ------------------------------------------------------------ entry point


def check_files(paths: Iterable[pathlib.Path],
                rel_base: pathlib.Path) -> List[Finding]:
    """Run CRDT210-213 over ``paths`` (the flow layer of ``run_all``)."""
    tree_ix = _Tree()
    parsed: List[Tuple[ast.Module, str]] = []
    for p in paths:
        entry = astcache.load(p)
        if entry is None:
            continue
        tree, _lines = entry
        try:
            rel = p.resolve().relative_to(rel_base).as_posix()
        except ValueError:
            rel = p.as_posix()
        module = rel[:-3].replace("/", ".")
        parsed.append((tree, rel))
        _index_file(tree_ix, tree, module, rel)
    _build_summaries(tree_ix)

    findings: List[Finding] = []
    order_edges: Dict[Tuple[str, str], Tuple[str, int, str]] = {}
    for key in sorted(tree_ix.funcs,
                      key=lambda k: (k[0], k[1] or "", k[2])):
        fn = tree_ix.funcs[key]
        if fn.name in ("__init__", "__new__"):
            continue  # construction precedes sharing (CRDT201's rule too)
        _FuncFlow(tree_ix, fn, order_edges, findings).run()
    findings.extend(_order_findings(order_edges))
    return findings


# --------------------------------------------- nemesis-soak bridge (flow)

_FRAME_RE = re.compile(r"([\w./-]+\.py):(\d+)(?:\s+in\s+([\w.<>]+))?")


def map_witnesses(witnesses: List[str],
                  findings: Optional[List[Finding]] = None) -> List[dict]:
    """The race-detector cross-check: map each runtime witness (a
    rendered vector-clock race from ``verify.race.report()``) to the
    static CRDT210-213 finding(s) covering its frames, or mark it
    UNCOVERED — a witness the static pass missed is a gap in crdtflow,
    and the soak report says so loudly (mirrors the CRDT201 ->
    ``watch_from_static`` bridge in the other direction)."""
    if findings is None and witnesses:
        # (no witness maps to nothing: the whole-tree pass is skipped)
        from crdt_tpu_torch.analysis import (iter_py_files, package_root,
                                             repo_root)
        findings = check_files(iter_py_files([package_root()]), repo_root())
    flow_findings = [f for f in findings or ()
                     if f.rule in ("CRDT210", "CRDT211", "CRDT212",
                                   "CRDT213")]
    out: List[dict] = []
    for w in witnesses:
        covering: List[str] = []
        for path, _line, func in _FRAME_RE.findall(w):
            for f in flow_findings:
                if not (f.path.endswith(path) or path.endswith(f.path)):
                    continue
                if func and f.scope and not (
                        f.scope == func or f.scope.endswith("." + func)
                        or func.endswith("." + f.scope)):
                    continue
                ref = f"{f.rule} {f.path}:{f.line} [{f.scope}]"
                if ref not in covering:
                    covering.append(ref)
        head = w.strip().splitlines()[0] if w.strip() else "<witness>"
        out.append({"witness": head, "covered": bool(covering),
                    "covered_by": covering})
    return out


def bridge_report(witnesses: List[str]) -> dict:
    """The ``flow`` section of the nemesis soak's --race-check report."""
    mapped = map_witnesses(witnesses)
    uncovered = [m for m in mapped if not m["covered"]]
    return {
        "witness_count": len(witnesses),
        "mapped": mapped,
        "uncovered_count": len(uncovered),
    }
