"""CRDT201: shared mutable state written without a lock from code
reachable by another thread (counterpart of
``crdt_tpu.analysis.concurrency``, the same rule over the port's tree).

The codebase's thread inventory is small and explicit — ``NetworkAgent``'s
gossip loop, ``NodeHost``'s checkpoint loop, ``LocalCluster``'s per-replica
loops, the HTTP servers' handler threads, and the ``ThreadPoolExecutor``
fan-outs inside the barrier/fused-pull paths — but the state they touch
(peer backoff clocks, error lists, metrics) is shared with the main
thread.  This checker walks a conservative, name-based call graph seeded
at every thread entry and flags writes to shared state that are not
lexically under a lock.

Entry points
    * ``threading.Thread(target=X)``
    * ``pool.submit(X, ...)`` / ``pool.map(X, ...)`` (ThreadPoolExecutor)
    * callables handed to ``DispatchQueue.submit`` (``run_striped`` hands
      its stripes' dispatch to it as a lambda, parallel/pipeline.py)
    * lambdas in any of the above positions (their bodies are scanned
      directly in the defining function's class context)

Call-graph resolution (deliberately conservative)
    * ``self.m()``       → method ``m`` of the enclosing class
    * ``f()``            → function ``f`` of the same module
    * ``obj.m()``        → method ``m`` IF exactly one class in the
                           analyzed tree defines it (unambiguous)

Mutations flagged
    * ``self.attr = ...`` / ``self.attr += ...``
    * ``self.attr.append/extend/add/update/pop/clear/remove/...`` calls
    * assignment to a ``global``-declared name

Guards honored
    * the write is lexically inside ``with <expr>`` where the context
      expression mentions a lock (``lock`` substring, case-insensitive)
    * the enclosing function's name ends in ``_locked`` (the codebase's
      caller-holds-the-lock convention, e.g. ``_payload_locked``)
    * ``__init__``/``__new__`` (construction precedes sharing)
"""
from __future__ import annotations

import ast
import pathlib
from typing import Dict, Iterable, List, Optional, Set, Tuple

from crdt_tpu_torch.analysis import Finding, astcache

_MUTATORS = {
    "append", "appendleft", "extend", "extendleft", "add", "update",
    "pop", "popleft", "popitem", "clear", "remove", "discard",
    "insert", "setdefault", "sort", "reverse",
}

_ENTRY_SUBMITTERS = {"submit", "map"}


def _callee_name(func: ast.AST) -> str:
    if isinstance(func, ast.Attribute):
        return func.attr
    if isinstance(func, ast.Name):
        return func.id
    return ""


class _Func:
    """One function/method in the analyzed tree."""

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


class _Index:
    def __init__(self) -> None:
        self.funcs: Dict[Tuple[str, Optional[str], str], _Func] = {}
        # method name -> set of (module, cls) that define it
        self.method_owners: Dict[str, Set[Tuple[str, str]]] = {}
        # thread/executor entry points: (func key, how)
        self.entries: List[Tuple[Tuple[str, Optional[str], str], str]] = []
        # lambda entries: (lambda node, module, cls, defining qualname, relpath)
        self.lambda_entries: List[Tuple[ast.Lambda, str, Optional[str], str, str]] = []


def _index_file(index: _Index, tree: ast.Module, module: str,
                relpath: str) -> None:
    def add_func(node, cls: Optional[str]) -> None:
        f = _Func(module, cls, node.name, node, relpath)
        index.funcs[f.key] = f
        if cls is not None:
            index.method_owners.setdefault(node.name, set()).add((module, cls))

    for stmt in tree.body:
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
            add_func(stmt, None)
            for inner in ast.walk(stmt):
                if isinstance(inner, ast.ClassDef):
                    for m in inner.body:
                        if isinstance(m, (ast.FunctionDef, ast.AsyncFunctionDef)):
                            add_func(m, inner.name)
        elif isinstance(stmt, ast.ClassDef):
            for m in stmt.body:
                if isinstance(m, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    add_func(m, stmt.name)
            # nested defs inside methods are reachable only via their
            # enclosing method's body scan; no separate index entry needed


def _entry_callable(node: ast.AST) -> Optional[ast.AST]:
    """The callable expression handed to a Thread/executor, if any."""
    if not isinstance(node, ast.Call):
        return None
    name = _callee_name(node.func)
    if name == "Thread":
        for kw in node.keywords:
            if kw.arg == "target":
                return kw.value
        return None
    if name in _ENTRY_SUBMITTERS or name == "submit":
        # pool.map(f, xs) / pool.submit(f, ...) / q.submit(fn, ...)
        if node.args:
            return node.args[0]
    return None


def _collect_entries(index: _Index, tree: ast.Module, module: str,
                     relpath: str) -> None:
    # walk with (cls, func) context so `self.x` targets resolve
    def walk(node: ast.AST, cls: Optional[str], fn: Optional[str]) -> None:
        for child in ast.iter_child_nodes(node):
            ccls, cfn = cls, fn
            if isinstance(child, ast.ClassDef):
                ccls = child.name
            elif isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                cfn = child.name
            target = _entry_callable(child)
            if target is not None:
                if isinstance(target, ast.Lambda):
                    index.lambda_entries.append(
                        (target, module, cls, fn or "<module>", relpath))
                elif isinstance(target, ast.Attribute) and \
                        isinstance(target.value, ast.Name) and \
                        target.value.id == "self" and cls is not None:
                    index.entries.append(((module, cls, target.attr),
                                          f"{cls}.{fn}"))
                elif isinstance(target, ast.Name):
                    index.entries.append(((module, None, target.id),
                                          fn or "<module>"))
            walk(child, ccls, cfn)

    walk(tree, None, None)


def _calls_in(body: Iterable[ast.AST]) -> List[ast.Call]:
    out = []
    for n in body:
        for c in ast.walk(n):
            if isinstance(c, ast.Call):
                out.append(c)
    return out


def _resolve_call(index: _Index, call: ast.Call, module: str,
                  cls: Optional[str]) -> Optional[Tuple[str, Optional[str], str]]:
    f = call.func
    if isinstance(f, ast.Attribute):
        if isinstance(f.value, ast.Name) and f.value.id == "self" and cls:
            key = (module, cls, f.attr)
            if key in index.funcs:
                return key
        owners = index.method_owners.get(f.attr, set())
        if len(owners) == 1:
            (m, c) = next(iter(owners))
            return (m, c, f.attr)
        return None
    if isinstance(f, ast.Name):
        key = (module, None, f.id)
        if key in index.funcs:
            return key
    return None


def _under_lock(node: ast.AST, parents: Dict[int, ast.AST]) -> bool:
    cur = node
    while id(cur) in parents:
        cur = parents[id(cur)]
        if isinstance(cur, (ast.With, ast.AsyncWith)):
            for item in cur.items:
                try:
                    src = ast.unparse(item.context_expr)
                except Exception:  # pragma: no cover - unparse is total on 3.9+
                    src = ""
                if "lock" in src.lower():
                    return True
        if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
            break
    return False


def _mutations(fn_node: ast.AST) -> List[Tuple[ast.AST, str]]:
    """(node, description) for every shared-state write in a function body."""
    out: List[Tuple[ast.AST, str]] = []
    globals_declared: Set[str] = set()
    for n in ast.walk(fn_node):
        if isinstance(n, ast.Global):
            globals_declared.update(n.names)
    for n in ast.walk(fn_node):
        if isinstance(n, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
            targets = n.targets if isinstance(n, ast.Assign) else [n.target]
            for t in targets:
                if isinstance(t, ast.Attribute) and \
                        isinstance(t.value, ast.Name) and t.value.id == "self":
                    out.append((n, f"self.{t.attr}"))
                elif isinstance(t, ast.Name) and t.id in globals_declared:
                    out.append((n, f"global {t.id}"))
        elif isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute) \
                and n.func.attr in _MUTATORS:
            base = n.func.value
            if isinstance(base, ast.Attribute) and \
                    isinstance(base.value, ast.Name) and base.value.id == "self":
                out.append((n, f"self.{base.attr}.{n.func.attr}()"))
    return out


def _parent_map(root: ast.AST) -> Dict[int, ast.AST]:
    parents: Dict[int, ast.AST] = {}
    for node in ast.walk(root):
        for child in ast.iter_child_nodes(node):
            parents[id(child)] = node
    return parents


def check_files(paths: Iterable[pathlib.Path],
                rel_base: pathlib.Path) -> List[Finding]:
    index = _Index()
    trees: Dict[str, Tuple[ast.Module, str]] = {}
    for p in paths:
        try:
            rel = p.resolve().relative_to(rel_base).as_posix()
        except ValueError:
            rel = p.as_posix()
        module = rel[:-3].replace("/", ".")
        entry = astcache.load(p)
        if entry is None:
            continue  # ast_checks already surfaced the CRDT000
        tree = entry[0]
        trees[module] = (tree, rel)
        _index_file(index, tree, module, rel)
    for module, (tree, rel) in trees.items():
        _collect_entries(index, tree, module, rel)

    # BFS over the call graph from every entry
    reachable: Dict[Tuple[str, Optional[str], str], str] = {}
    work: List[Tuple[Tuple[str, Optional[str], str], str]] = []
    for key, how in index.entries:
        if key in index.funcs and key not in reachable:
            reachable[key] = how
            work.append((key, how))
    # lambda entries: scan their bodies for calls to seed the graph, and
    # for direct mutations (handled below)
    lambda_mutation_findings: List[Finding] = []
    for lam, module, cls, defined_in, rel in index.lambda_entries:
        for call in _calls_in([lam.body]):
            key = _resolve_call(index, call, module, cls)
            if key is not None and key not in reachable:
                how = f"lambda in {defined_in}"
                reachable[key] = how
                work.append((key, how))
        parents = _parent_map(lam)
        for node, desc in _mutations(lam):
            if not _under_lock(node, parents):
                lambda_mutation_findings.append(Finding(
                    rule="CRDT201", path=rel, line=node.lineno,
                    col=getattr(node, "col_offset", 0),
                    scope=f"lambda in {defined_in}", detail=desc,
                    message=(f"{desc} written in a thread-submitted lambda "
                             f"without a lock"),
                ))
    while work:
        key, how = work.pop()
        fn = index.funcs[key]
        for call in _calls_in(fn.node.body):
            nxt = _resolve_call(index, call, fn.module, fn.cls)
            if nxt is not None and nxt not in reachable:
                reachable[nxt] = f"{how} -> {fn.qualname}"
                work.append((nxt, reachable[nxt]))

    findings: List[Finding] = list(lambda_mutation_findings)
    for key, how in sorted(reachable.items(),
                           key=lambda kv: (kv[0][0], kv[0][1] or "", kv[0][2])):
        fn = index.funcs[key]
        if fn.name in ("__init__", "__new__") or fn.name.endswith("_locked"):
            continue
        parents = _parent_map(fn.node)
        seen: Set[str] = set()
        for node, desc in _mutations(fn.node):
            if desc in seen or _under_lock(node, parents):
                continue
            seen.add(desc)
            findings.append(Finding(
                rule="CRDT201", path=fn.relpath, line=node.lineno,
                col=getattr(node, "col_offset", 0), scope=fn.qualname,
                detail=desc,
                message=(f"{desc} written without a lock in {fn.qualname}, "
                         f"reachable from thread entry ({how})"),
            ))
    return findings
