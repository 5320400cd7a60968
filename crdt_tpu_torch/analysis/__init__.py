"""crdtlint and crdtprove for the port (counterpart of ``crdt_tpu.analysis``),
pointed at ``crdt_tpu_torch/``.

Four lint layers, one gate (``python -m crdt_tpu_torch.analysis``):

* AST checkers (ast_checks): donated-buffer reuse, compile-cache
  constructions in per-round loops (``jit``/``pallas_call`` and torch's
  ``torch.compile``, ``torch.jit.script``/``trace``,
  ``cpp_extension.load``/``load_inline``), blocking host syncs in the
  hot-path packages (torch's ``.cpu()``, ``.tolist()``, ``.numpy()``,
  ``int()``/``bool()`` of a computed value and ``synchronize()`` beside
  JAX's spellings), and ``except Exception`` blocks that swallow without
  telling anyone.
* Graph checkers (fx_checks, the counterpart of ``jaxpr_checks``): every
  join in the ops/joins.py registry is traced to its ``make_fx`` aten graph
  on the CPU example and asserted pure, shape/dtype-closed, and (where
  claimed) operand-swap symmetric, with the semantic hazard pass
  (``verify.hazards``, CRDT105-107) on the same graph.
* Concurrency lint (concurrency): shared mutable state written from
  thread-reachable code without a lock (CRDT201).
* Flow analysis (flow, "crdtflow"): path-sensitive lock discipline and
  resource typestate with exception edges (CRDT210-213), which also sees
  the card's ``device_lock`` (in ``with`` items, through
  ``ExitStack.enter_context`` and ``.acquire()``) and the declared order
  node lock before device lock.

Above these sits crdtprove (``python -m crdt_tpu_torch.analysis verify``,
the ``verify`` subpackage): exhaustive small-domain lattice-law
verification with the port's own committed verdict ledger (the CRDT301
and CRDT302 gate), and the witnessed-race detector that the nemesis
soak's ``--race-check`` installs, fed by the CRDT201 findings
(``race.watch_from_static``) and cross-checked against crdtflow
(``flow.bridge_report``).

Findings carry file:line, severity and a drift-stable fingerprint; the
port's committed suppressions file (``analysis/baseline.json``) holds
the triaged warns (baseline module).
"""
from __future__ import annotations

import dataclasses
import pathlib
from typing import Iterable, List, Optional

SEV_ERROR = "error"
SEV_WARN = "warn"

#: every rule the suite implements, with a one-line summary (the CLI's
#: --rules filter and the docs both read from here)
RULES = {
    "CRDT001": "donation-after-use: a buffer donated to a jitted call is read again",
    "CRDT002": "jit/pallas_call/torch.compile constructed inside a loop (recompile trap)",
    "CRDT003": "blocking host sync (.item()/.cpu()/.tolist()/int()/synchronize()) in a hot-path package",
    "CRDT004": "except Exception swallows silently (no raise/log/handling)",
    "CRDT101": "registered join traces a non-aten call or a host sync (impure graph)",
    "CRDT102": "registered join is not closed (out shapes/dtypes != self operand's)",
    "CRDT103": "join claimed structurally commutative has an asymmetric graph",
    "CRDT104": "composite claims structural commutativity its parts don't all claim",
    "CRDT105": "float accumulation inside a join (order-dependent merge results)",
    "CRDT106": "RNG/arange/nondeterministic-accumulation op inside a join",
    "CRDT107": "narrow-int add/mul inside a join (overflow wrap breaks inflationarity)",
    "CRDT201": "shared mutable state written from thread-reachable code without a lock",
    "CRDT210": "acquire() not post-dominated by release() on every path (incl. raise edges)",
    "CRDT211": "lock acquisition against the declared order, or closing an order-graph cycle",
    "CRDT212": "linear handle (PendingMerge/DrainClaim/Ticket) misses its terminal on a path",
    "CRDT213": "blocking call (sleep/host-sync/network) while a node or drain lock is held",
    "CRDT301": "registered join refuted by the crdtprove bit-blaster",
    "CRDT302": "registered join missing from (or drifted against) the verdict ledger",
}

SEVERITY = {
    "CRDT001": SEV_ERROR,
    "CRDT002": SEV_WARN,
    "CRDT003": SEV_WARN,
    "CRDT004": SEV_ERROR,
    "CRDT101": SEV_ERROR,
    "CRDT102": SEV_ERROR,
    "CRDT103": SEV_ERROR,
    "CRDT104": SEV_ERROR,
    "CRDT105": SEV_ERROR,
    "CRDT106": SEV_ERROR,
    "CRDT107": SEV_WARN,
    "CRDT201": SEV_WARN,
    "CRDT210": SEV_ERROR,
    "CRDT211": SEV_ERROR,
    "CRDT212": SEV_ERROR,
    "CRDT213": SEV_WARN,
    "CRDT301": SEV_ERROR,
    "CRDT302": SEV_ERROR,
}


@dataclasses.dataclass
class Finding:
    """One lint finding.  ``scope`` (enclosing def/class qualname, or the
    join's name) and ``detail`` (a line-number-free payload: normalized
    source text or the offending name) feed the fingerprint, so findings
    survive unrelated line drift without churning the baseline."""

    rule: str
    path: str  # repo-relative, forward slashes
    line: int
    message: str
    scope: str = ""
    detail: str = ""
    col: int = 0

    @property
    def severity(self) -> str:
        return SEVERITY.get(self.rule, SEV_WARN)

    def to_dict(self) -> dict:
        return {
            "rule": self.rule,
            "severity": self.severity,
            "path": self.path,
            "line": self.line,
            "col": self.col,
            "scope": self.scope,
            "message": self.message,
        }

    def render(self) -> str:
        where = f"{self.path}:{self.line}"
        scope = f" [{self.scope}]" if self.scope else ""
        return f"{where}: {self.rule} {self.severity}:{scope} {self.message}"


def package_root() -> pathlib.Path:
    """The crdt_tpu_torch package directory (the default analysis target)."""
    return pathlib.Path(__file__).resolve().parent.parent


def repo_root() -> pathlib.Path:
    return package_root().parent


def iter_py_files(roots: Iterable[pathlib.Path]) -> List[pathlib.Path]:
    out: List[pathlib.Path] = []
    for root in roots:
        if root.is_file():
            out.append(root)
            continue
        for p in sorted(root.rglob("*.py")):
            if "__pycache__" in p.parts:
                continue
            out.append(p)
    return out


def run_all(roots: Optional[Iterable[pathlib.Path]] = None, *,
            jaxpr: bool = True,
            rules: Optional[Iterable[str]] = None) -> List[Finding]:
    """Run every layer over ``roots`` (default: the crdt_tpu_torch package).

    ``jaxpr=False`` skips the join-graph layer (fx_checks: it imports the
    model modules and traces every registered join with ``make_fx``; the
    AST layers need only the standard library).  The keyword keeps the
    JAX package's name so one call drives either package.  ``rules``
    filters to a subset of rule IDs, and a layer none of whose rules is
    in the subset is not run.
    """
    from crdt_tpu_torch.analysis import ast_checks, concurrency, flow

    keep = set(rules) if rules is not None else None

    def wanted(layer_rules) -> bool:
        return keep is None or bool(keep & set(layer_rules))

    root_list = list(roots) if roots is not None else [package_root()]
    rel_base = repo_root()
    findings: List[Finding] = []
    files = iter_py_files(root_list)
    if wanted(("CRDT000", "CRDT001", "CRDT002", "CRDT003", "CRDT004")):
        findings.extend(ast_checks.check_files(files, rel_base))
    if wanted(("CRDT201",)):
        findings.extend(concurrency.check_files(files, rel_base))
    if wanted(("CRDT210", "CRDT211", "CRDT212", "CRDT213")):
        findings.extend(flow.check_files(files, rel_base))
    if jaxpr and wanted(tuple(f"CRDT10{i}" for i in range(1, 8))):
        from crdt_tpu_torch.analysis import fx_checks

        findings.extend(fx_checks.check_registered_joins(rel_base))
    if keep is not None:
        findings = [f for f in findings if f.rule in keep]
    findings.sort(key=lambda f: (f.path, f.line, f.rule))
    return findings
