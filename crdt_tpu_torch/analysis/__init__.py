"""The analysis layer of the port (counterpart of ``crdt_tpu.analysis``),
pointed at ``crdt_tpu_torch/``.

Ported so far: crdtprove (``python -m crdt_tpu_torch.analysis verify``,
the ``verify`` subpackage): exhaustive small-domain lattice-law
verification with the port's own committed verdict ledger (the CRDT301
and CRDT302 gate) and SARIF output, and the witnessed-race detector that
the nemesis soak's ``--race-check`` installs.  The lint tiers (the AST,
concurrency and flow checks, the join-graph checks, the suppression
baseline) are ROADMAP Queue 1 item 8's last part, not ported: the CLI's
other subcommands exit 2 naming it.
"""
from __future__ import annotations

import dataclasses
import pathlib

SEV_ERROR = "error"
SEV_WARN = "warn"

#: the rules this layer implements so far, with a one-line summary
RULES = {
    "CRDT301": "registered join refuted by the crdtprove bit-blaster",
    "CRDT302": "registered join missing from (or drifted against) the verdict ledger",
}

SEVERITY = {
    "CRDT301": SEV_ERROR,
    "CRDT302": SEV_ERROR,
}


@dataclasses.dataclass
class Finding:
    """One finding.  ``scope`` (the join's name) and ``detail`` (a
    line-number-free payload) feed the fingerprint, so findings survive
    unrelated line drift."""

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
