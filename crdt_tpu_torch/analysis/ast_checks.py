"""AST-level checkers (counterpart of ``crdt_tpu.analysis.ast_checks``):
the hazards this codebase hits, in JAX's spellings and in the port's.

All four rules are pure-stdlib (ast only) and per-file; whole-package
reachability lives in crdt_tpu_torch.analysis.concurrency.  Rule IDs,
severities, scopes and details are the JAX package's, so the same source
gives the same finding in both packages; what the port adds is named
below.

CRDT001 donation-after-use (error)
    A name passed at a donated position of a ``joins.donating(...)`` /
    ``jax.jit(..., donate_argnums=...)`` call site and read afterwards in
    the same scope.  The port's ``joins.donating`` is the identity (torch
    has no buffer donation, ``ops/joins.py``), so the rule finds nothing
    that would fail today; it is kept because the port's API keeps JAX's
    contract: a caller that reads a donated operand is wrong against the
    contract, and a donating implementation (an in-place join) would make
    it wrong in fact.

CRDT002 compile-cache construction in a loop (warn)
    ``jax.jit`` / ``pl.pallas_call`` and, in the port, ``torch.compile``,
    ``torch.jit.script`` / ``torch.jit.trace`` and
    ``torch.utils.cpp_extension.load`` / ``load_inline`` constructed
    lexically inside a ``for``/``while`` body (including via decorator on
    a def inside a loop).  Each construction starts with an empty cache:
    per-round construction recompiles every round.  ``_build.load`` is not
    one: it caches by name.

CRDT003 host-sync (warn, hot-path packages only)
    Inside crdt_tpu_torch/{ops,models,parallel}: JAX's ``.item()``,
    ``np.asarray(...)``, ``jax.device_get(...)`` and
    ``float(<call/attr>)``, and torch's own syncs: ``.cpu()``,
    ``.tolist()``, ``.numpy()`` (not again on a ``.cpu()`` it follows),
    ``int(<call/attr>)`` / ``bool(<call/attr>)`` (not again around a
    sync already flagged) and ``torch.cuda.synchronize()`` /
    ``<event or stream>.synchronize()``.  Each is a device→host round trip
    that serializes the card's queue.  Intentional host-path
    materializations are baselined, not exempted: new ones must be
    triaged.

CRDT004 silent-except (error)
    ``except Exception``/``except BaseException``/bare ``except`` whose
    body neither re-raises, nor calls anything (no ``obs.events`` emit,
    no logging, no metrics, no HTTP error response), nor records the
    failure in an assignment.  ``__del__`` finalizers are exempt (they
    must never raise).
"""
from __future__ import annotations

import ast
import pathlib
from typing import Dict, Iterable, List, Optional, Tuple

from crdt_tpu_torch.analysis import Finding, astcache

#: packages whose files are on the device-dispatch hot path (CRDT003)
HOT_PACKAGES = ("crdt_tpu_torch/ops/", "crdt_tpu_torch/models/",
                "crdt_tpu_torch/parallel/")

_JIT_NAMES = {"jit", "pallas_call"}


def _relpath(path: pathlib.Path, base: pathlib.Path) -> str:
    try:
        return path.resolve().relative_to(base).as_posix()
    except ValueError:
        return path.as_posix()


def _callee_name(func: ast.AST) -> str:
    """Trailing name of a call target: ``jax.jit`` → 'jit', ``jit`` → 'jit'."""
    if isinstance(func, ast.Attribute):
        return func.attr
    if isinstance(func, ast.Name):
        return func.id
    return ""


def _dotted(node: ast.AST) -> str:
    """``torch.jit.script`` for that attribute chain, "" for anything else."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if not isinstance(node, ast.Name):
        return ""
    parts.append(node.id)
    return ".".join(reversed(parts))


def _cache_ctor_name(func: ast.AST) -> str:
    """The name CRDT002 reports if calling ``func`` builds a fresh
    compile cache, else "": JAX's ``jit``/``pallas_call`` by trailing name,
    and torch's constructions by their qualified spelling."""
    name = _callee_name(func)
    if name in _JIT_NAMES:
        return name
    dotted = _dotted(func)
    if dotted in ("torch.compile", "torch.jit.script", "torch.jit.trace",
                  "jit.script", "jit.trace") or name == "load_inline" or \
            dotted.endswith("cpp_extension.load"):
        return dotted or name
    return ""


def _src_of(node: ast.AST, lines: List[str]) -> str:
    ln = getattr(node, "lineno", 0)
    if 1 <= ln <= len(lines):
        return lines[ln - 1].strip()
    return ""


class _Scope:
    """One function (or module) body analyzed for donation-after-use."""

    def __init__(self, qualname: str):
        self.qualname = qualname
        # name -> donated argnums, for names bound to donating callables
        self.donating_fns: Dict[str, Tuple[int, ...]] = {}
        # name -> line it was donated at
        self.consumed: Dict[str, int] = {}


def _donate_argnums_of_call(call: ast.Call) -> Optional[Tuple[int, ...]]:
    """If ``call`` constructs a donating callable, the donated argnums.

    Recognized constructors: ``donating(f)`` / ``joins.donating(f)`` (with
    an optional literal ``argnums`` second arg/kwarg, default ``(0,)``)
    and ``jax.jit(f, donate_argnums=...)`` with a literal int/tuple.
    """
    name = _callee_name(call.func)
    if name == "donating":
        spec = None
        if len(call.args) >= 2:
            spec = call.args[1]
        for kw in call.keywords:
            if kw.arg == "argnums":
                spec = kw.value
        return _literal_argnums(spec, default=(0,))
    if name == "jit":
        for kw in call.keywords:
            if kw.arg == "donate_argnums":
                return _literal_argnums(kw.value, default=None)
    return None


def _literal_argnums(node: Optional[ast.AST],
                     default: Optional[Tuple[int, ...]]) -> Optional[Tuple[int, ...]]:
    if node is None:
        return default
    try:
        val = ast.literal_eval(node)
    except (ValueError, SyntaxError):
        return default
    if isinstance(val, int):
        return (val,)
    if isinstance(val, (tuple, list)) and all(isinstance(v, int) for v in val):
        return tuple(val)
    return default


def check_donation_after_use(tree: ast.Module, lines: List[str],
                             relpath: str) -> List[Finding]:
    """CRDT001 over every def in the file (module-level donating bindings
    are visible inside defs, matching Python scoping)."""
    findings: List[Finding] = []
    module_donating: Dict[str, Tuple[int, ...]] = {}

    # pass 1: module-level `merge = donating(join)` style bindings
    for stmt in tree.body:
        if isinstance(stmt, ast.Assign) and isinstance(stmt.value, ast.Call):
            nums = _donate_argnums_of_call(stmt.value)
            if nums:
                for tgt in stmt.targets:
                    if isinstance(tgt, ast.Name):
                        module_donating[tgt.id] = nums

    def scan_scope(body: List[ast.stmt], qualname: str,
                   inherited: Dict[str, Tuple[int, ...]]) -> None:
        donating_fns = dict(inherited)
        consumed: Dict[str, Tuple[int, str]] = {}  # name -> (line, src)

        class V(ast.NodeVisitor):
            def visit_FunctionDef(self, node: ast.FunctionDef) -> None:
                scan_scope(node.body, f"{qualname}.{node.name}".lstrip("."),
                           donating_fns)

            visit_AsyncFunctionDef = visit_FunctionDef  # type: ignore[assignment]

            def visit_Assign(self, node: ast.Assign) -> None:
                if isinstance(node.value, ast.Call):
                    nums = _donate_argnums_of_call(node.value)
                    if nums:
                        for tgt in node.targets:
                            if isinstance(tgt, ast.Name):
                                donating_fns[tgt.id] = nums
                # visit the RHS first (it may consume operands), THEN
                # clear the targets: `a = merge(a, b)` rebinds `a` to the
                # merge OUTPUT, which is live even though the old `a` was
                # donated
                self.generic_visit(node)
                for tgt in node.targets:
                    if isinstance(tgt, ast.Name):
                        consumed.pop(tgt.id, None)

            def visit_Call(self, node: ast.Call) -> None:
                self.generic_visit(node)
                nums: Optional[Tuple[int, ...]] = None
                if isinstance(node.func, ast.Name) and \
                        node.func.id in donating_fns:
                    nums = donating_fns[node.func.id]
                elif isinstance(node.func, ast.Call):
                    # direct `donating(f)(a, b)` / `jax.jit(f, ...)(a, b)`
                    nums = _donate_argnums_of_call(node.func)
                if not nums:
                    return
                for i in nums:
                    if i < len(node.args) and isinstance(node.args[i], ast.Name):
                        arg = node.args[i]
                        consumed[arg.id] = (node.lineno, _src_of(node, lines))

            def visit_Name(self, node: ast.Name) -> None:
                if isinstance(node.ctx, ast.Load) and node.id in consumed:
                    don_line, _src = consumed[node.id]
                    if node.lineno > don_line:
                        findings.append(Finding(
                            rule="CRDT001", path=relpath, line=node.lineno,
                            col=node.col_offset, scope=qualname,
                            detail=f"{node.id}|{_src_of(node, lines)}",
                            message=(
                                f"`{node.id}` was donated at line {don_line} "
                                f"and is read again — a donated buffer is "
                                f"deleted at dispatch (TPU/GPU raise; CPU "
                                f"silently aliases nothing)"),
                        ))
                        consumed.pop(node.id, None)  # one finding per donation

        # visit statements in order so lineno comparisons are meaningful
        v = V()
        for stmt in body:
            v.visit(stmt)

    scan_scope(tree.body, "", module_donating)
    return findings


def check_jit_in_loop(tree: ast.Module, lines: List[str],
                      relpath: str) -> List[Finding]:
    """CRDT002: jit/pallas_call constructed under a for/while."""
    findings: List[Finding] = []

    def walk(node: ast.AST, loop_depth: int, qualname: str) -> None:
        for child in ast.iter_child_nodes(node):
            depth = loop_depth
            qn = qualname
            if isinstance(child, (ast.For, ast.AsyncFor, ast.While)):
                depth += 1
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                qn = f"{qualname}.{child.name}".lstrip(".")
                if loop_depth > 0:
                    for dec in child.decorator_list:
                        target = dec.func if isinstance(dec, ast.Call) else dec
                        if _cache_ctor_name(target):
                            findings.append(Finding(
                                rule="CRDT002", path=relpath,
                                line=child.lineno, col=child.col_offset,
                                scope=qn, detail=_src_of(dec, lines) or child.name,
                                message=(f"@{_cache_ctor_name(target)} on a def "
                                         f"inside a loop: each iteration "
                                         f"builds a fresh compile cache"),
                            ))
            if isinstance(child, ast.Call) and loop_depth > 0 \
                    and _cache_ctor_name(child.func):
                findings.append(Finding(
                    rule="CRDT002", path=relpath, line=child.lineno,
                    col=child.col_offset, scope=qualname,
                    detail=_src_of(child, lines),
                    message=(f"{_cache_ctor_name(child.func)}(...) constructed "
                             f"inside a loop: a fresh callable recompiles "
                             f"every iteration (hoist it, or cache per "
                             f"static shape)"),
                ))
            walk(child, depth, qn)

    walk(tree, 0, "")
    return findings


#: torch's device→host syncs by method name (CRDT003's port additions)
_TORCH_SYNC_METHODS = {
    "cpu": ".cpu() copies to the host and waits for the card's queue",
    "tolist": ".tolist() copies to the host and waits for the card's queue",
    "numpy": ".numpy() of a device value waits for the card's queue",
    "synchronize": "synchronize() blocks the host on the card's queue",
}

#: calls whose value is a host value whatever their operands: ``int()`` /
#: ``bool()`` of one of them is no device sync
_HOST_CALLS = {"len", "round", "abs", "ord", "hash", "str", "repr", "get",
               "getattr", "isinstance", "time", "monotonic", "perf_counter"}

#: roots of an attribute chain that name host modules or a numpy RNG
_HOST_ROOTS = {"np", "numpy", "math", "os", "sys", "json", "time", "random",
               "rng", "struct", "operator"}


def _root_name(node: ast.AST) -> str:
    """The name an attribute/call/subscript chain starts from."""
    while True:
        if isinstance(node, ast.Call):
            node = node.func
        elif isinstance(node, (ast.Attribute, ast.Subscript)):
            node = node.value
        else:
            return node.id if isinstance(node, ast.Name) else ""


def torch_host_sync(node: ast.Call) -> Optional[str]:
    """CRDT003's message for one of torch's device→host syncs (the
    port's additions to JAX's spellings, which crdtflow's CRDT213 reads
    too), else None."""
    func = node.func
    if isinstance(func, ast.Attribute) and func.attr in _TORCH_SYNC_METHODS \
            and (func.attr == "synchronize" or not (node.args or node.keywords)):
        inner = func.value
        if func.attr in ("numpy", "tolist") and isinstance(inner, ast.Call) \
                and isinstance(inner.func, ast.Attribute) \
                and inner.func.attr == "cpu":
            return None  # x.cpu().numpy(): one sync, flagged at .cpu()
        if func.attr in ("numpy", "tolist") and \
                _root_name(inner) in _HOST_ROOTS:
            return None  # a numpy value's conversion
        return _TORCH_SYNC_METHODS[func.attr]
    if isinstance(func, ast.Name) and func.id in ("int", "bool") \
            and len(node.args) == 1 \
            and isinstance(node.args[0], (ast.Call, ast.Attribute)):
        arg = node.args[0]
        if isinstance(arg, ast.Call) and (
                _host_sync_message(arg) is not None
                or _callee_name(arg.func) in _HOST_CALLS
                or _root_name(arg) in _HOST_ROOTS):
            # int(x.item()): one sync, flagged inside; int(len(xs)),
            # int(rng.integers(n)): host values
            return None
        return f"{func.id}(...) on a computed value forces a device sync"
    return None


def _host_sync_message(node: ast.Call) -> Optional[str]:
    """CRDT003's message for a call that syncs the host with the device,
    else None."""
    func = node.func
    if isinstance(func, ast.Attribute) and func.attr == "item" \
            and not node.args and not node.keywords:
        return ".item() blocks on the device stream (one host round-trip)"
    if isinstance(func, ast.Attribute) and func.attr == "asarray" \
            and isinstance(func.value, ast.Name) \
            and func.value.id in ("np", "numpy"):
        return "np.asarray on a device value synchronizes the dispatch stream"
    if isinstance(func, ast.Attribute) and func.attr == "device_get":
        return "jax.device_get is an explicit device→host sync"
    if isinstance(func, ast.Name) and func.id == "float" \
            and len(node.args) == 1 \
            and isinstance(node.args[0], (ast.Call, ast.Attribute)):
        return "float(...) on a computed value forces a device sync"
    return torch_host_sync(node)


def check_host_sync(tree: ast.Module, lines: List[str],
                    relpath: str) -> List[Finding]:
    """CRDT003, only inside the hot-path packages."""
    if not any(relpath.startswith(p) for p in HOT_PACKAGES):
        return []
    findings: List[Finding] = []

    def qualnames() -> Dict[int, str]:
        # map every node id to its enclosing def qualname
        owner: Dict[int, str] = {}

        def mark(node: ast.AST, qn: str) -> None:
            for child in ast.iter_child_nodes(node):
                cqn = qn
                if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    cqn = f"{qn}.{child.name}".lstrip(".")
                owner[id(child)] = cqn
                mark(child, cqn)

        mark(tree, "")
        return owner

    owner = qualnames()

    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        msg = _host_sync_message(node)
        if msg:
            findings.append(Finding(
                rule="CRDT003", path=relpath, line=node.lineno,
                col=node.col_offset, scope=owner.get(id(node), ""),
                detail=_src_of(node, lines),
                message=msg + " — keep it off the per-round path or baseline it",
            ))
    return findings


def _is_broad_handler(handler: ast.ExceptHandler) -> bool:
    t = handler.type
    if t is None:
        return True
    names = []
    if isinstance(t, ast.Tuple):
        names = [_callee_name(e) for e in t.elts]
    else:
        names = [_callee_name(t)]
    return any(n in ("Exception", "BaseException") for n in names)


def check_silent_except(tree: ast.Module, lines: List[str],
                        relpath: str) -> List[Finding]:
    """CRDT004: broad handlers whose body provably does nothing with the
    failure: no raise, no call of any kind, no assignment."""
    findings: List[Finding] = []

    def scan(node: ast.AST, qualname: str, in_del: bool) -> None:
        for child in ast.iter_child_nodes(node):
            qn, child_in_del = qualname, in_del
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                qn = f"{qualname}.{child.name}".lstrip(".")
                child_in_del = child.name == "__del__"
            if isinstance(child, ast.ExceptHandler) and not child_in_del \
                    and _is_broad_handler(child):
                handled = False
                for n in ast.walk(ast.Module(body=child.body, type_ignores=[])):
                    if isinstance(n, (ast.Raise, ast.Call, ast.Assign,
                                      ast.AugAssign, ast.AnnAssign)):
                        handled = True
                        break
                if not handled:
                    findings.append(Finding(
                        rule="CRDT004", path=relpath, line=child.lineno,
                        col=child.col_offset, scope=qualname,
                        detail=_src_of(child, lines),
                        message=("broad except swallows silently — narrow "
                                 "the exception type or record it "
                                 "(obs.events.emit / metrics / re-raise)"),
                    ))
            scan(child, qn, child_in_del)

    scan(tree, "", False)
    return findings


ALL_CHECKS = (
    check_donation_after_use,
    check_jit_in_loop,
    check_host_sync,
    check_silent_except,
)


def check_file(path: pathlib.Path, rel_base: pathlib.Path) -> List[Finding]:
    relpath = _relpath(path, rel_base)
    entry = astcache.load(path)
    if entry is None:
        try:  # re-read outside the cache to surface the actual error
            ast.parse(path.read_text(encoding="utf-8"))
            return []  # pragma: no cover - raced a concurrent edit
        except (OSError, SyntaxError) as e:
            return [Finding(rule="CRDT000", path=relpath, line=1,
                            message=f"unparseable: {e}", detail=str(e))]
    tree, lines = entry
    findings: List[Finding] = []
    for check in ALL_CHECKS:
        findings.extend(check(tree, lines, relpath))
    return findings


def check_files(paths: Iterable[pathlib.Path],
                rel_base: pathlib.Path) -> List[Finding]:
    out: List[Finding] = []
    for p in paths:
        out.extend(check_file(p, rel_base))
    return out
