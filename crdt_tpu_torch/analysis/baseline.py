"""Suppression baseline: the ratchet that lets the gate start green
(counterpart of ``crdt_tpu.analysis.baseline``; the port's own file,
``crdt_tpu_torch/analysis/baseline.json``).

A finding's fingerprint is a hash of (rule, path, scope, detail) — no
line numbers — plus an occurrence index for identical quadruples, so the
baseline survives unrelated edits but a NEW instance of a known hazard in
the same function still trips the gate.  SARIF export reuses it as the
annotation identity.

``--write-baseline`` regenerates the committed file; ``--check-baseline``
exits non-zero on any finding whose fingerprint is not in it, and reports
(without failing) baseline entries that no longer match anything, so the
file only ever shrinks by deliberate edits.  It holds triaged warns only:
errors are fixed, never baselined.
"""
from __future__ import annotations

import hashlib
import json
import pathlib
from typing import Dict, Iterable, List, Tuple

from crdt_tpu_torch.analysis import Finding

DEFAULT_BASELINE = pathlib.Path(__file__).resolve().parent / "baseline.json"


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


def save(findings: Iterable[Finding],
         path: pathlib.Path = DEFAULT_BASELINE) -> int:
    entries = [
        {
            "fingerprint": fp,
            "rule": f.rule,
            "path": f.path,
            "scope": f.scope,
            "message": f.message,
        }
        for f, fp in fingerprints(findings)
    ]
    path.write_text(json.dumps({
        "comment": ("crdtlint suppressions: pre-existing, triaged findings. "
                    "Regenerate with `python -m crdt_tpu_torch.analysis "
                    "--write-baseline`; the gate fails on anything new."),
        "entries": entries,
    }, indent=1, sort_keys=True) + "\n", encoding="utf-8")
    return len(entries)


def load(path: pathlib.Path = DEFAULT_BASELINE) -> Dict[str, dict]:
    if not path.exists():
        return {}
    data = json.loads(path.read_text(encoding="utf-8"))
    return {e["fingerprint"]: e for e in data.get("entries", [])}


def diff(findings: Iterable[Finding], path: pathlib.Path = DEFAULT_BASELINE):
    """(new_findings, stale_entries): findings not in the baseline, and
    baseline entries matching nothing anymore (ratchet candidates)."""
    known = load(path)
    paired = fingerprints(findings)
    new = [f for f, fp in paired if fp not in known]
    seen = {fp for _, fp in paired}
    stale = [e for fp, e in sorted(known.items()) if fp not in seen]
    return new, stale
