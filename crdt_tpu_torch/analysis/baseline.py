"""Finding fingerprints (the part of ``crdt_tpu.analysis.baseline`` the
SARIF export needs).

A finding's fingerprint is a hash of (rule, path, scope, detail), no
line numbers, plus an occurrence index for identical quadruples, so it
survives unrelated edits.  The suppression file itself (save, load,
diff) comes with the lint tiers (ROADMAP Queue 1 item 8).
"""
from __future__ import annotations

import hashlib
from typing import Dict, Iterable, List, Tuple

from crdt_tpu_torch.analysis import Finding


def fingerprint(f: Finding, occurrence: int = 0) -> str:
    payload = "|".join((f.rule, f.path, f.scope, f.detail, str(occurrence)))
    return hashlib.sha1(payload.encode("utf-8")).hexdigest()[:16]


def fingerprints(findings: Iterable[Finding]) -> List[Tuple[Finding, str]]:
    """Pair every finding with its fingerprint, disambiguating identical
    (rule, path, scope, detail) quadruples by source order."""
    counts: Dict[Tuple[str, str, str, str], int] = {}
    out: List[Tuple[Finding, str]] = []
    for f in sorted(findings, key=lambda x: (x.path, x.line, x.rule, x.col)):
        key = (f.rule, f.path, f.scope, f.detail)
        n = counts.get(key, 0)
        counts[key] = n + 1
        out.append((f, fingerprint(f, n)))
    return out
