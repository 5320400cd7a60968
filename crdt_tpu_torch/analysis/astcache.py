"""Shared parse cache: every analysis layer reads each source file ONCE
(counterpart of ``crdt_tpu.analysis.astcache``).

The AST layers (ast_checks), the concurrency lint, and the crdtflow
CFG/typestate pass (flow) all walk the same ~110 files.  Parsing is the
dominant cost of a lint run without the join-graph layer, so the layers share one in-process
cache keyed by resolved path + (mtime, size); an edited file re-parses,
an unchanged one is free.  This is what keeps the full-tree crdtflow run
inside its 60 s budget even though it runs *after* the classic lint
pass in the same process.
"""
from __future__ import annotations

import ast
import pathlib
from typing import Dict, List, Optional, Tuple

#: resolved path -> ((mtime_ns, size), (tree, lines))
_CACHE: Dict[str, Tuple[Tuple[int, int], Tuple[ast.Module, List[str]]]] = {}


def load(path: pathlib.Path) -> Optional[Tuple[ast.Module, List[str]]]:
    """(tree, source lines) for ``path``, or None if unreadable or
    syntactically invalid (callers surface their own CRDT000 finding)."""
    try:
        resolved = str(path.resolve())
        st = path.stat()
        key = (st.st_mtime_ns, st.st_size)
    except OSError:
        return None
    hit = _CACHE.get(resolved)
    if hit is not None and hit[0] == key:
        return hit[1]
    try:
        src = path.read_text(encoding="utf-8")
        tree = ast.parse(src)
    except (OSError, SyntaxError):
        return None
    entry = (tree, src.splitlines())
    _CACHE[resolved] = (key, entry)
    return entry


def clear() -> None:
    _CACHE.clear()


def stats() -> Dict[str, int]:
    return {"entries": len(_CACHE)}
