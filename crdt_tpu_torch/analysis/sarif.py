"""SARIF 2.1.0 output for crdtprove findings (counterpart of
``crdt_tpu.analysis.sarif``).

Minimal but valid Static Analysis Results Interchange Format, enough for
code scanning to render findings as annotations: one run, one driver
("crdtlint"), one rule entry per rule id referenced, one result per
finding anchored at its repo-relative path:line.  Results carry the
finding's fingerprint as a partialFingerprint, so an annotation's
identity survives line drift.
"""
from __future__ import annotations

import json
from typing import Iterable, List

from crdt_tpu_torch.analysis import RULES, SEVERITY, Finding, baseline

SARIF_VERSION = "2.1.0"
SARIF_SCHEMA = ("https://raw.githubusercontent.com/oasis-tcs/sarif-spec/"
                "master/Schemata/sarif-schema-2.1.0.json")

_LEVEL = {"error": "error", "warn": "warning"}


def to_sarif(findings: Iterable[Finding]) -> dict:
    paired = baseline.fingerprints(findings)
    rule_ids: List[str] = sorted({f.rule for f, _ in paired})
    rules = [{
        "id": rid,
        "shortDescription": {"text": RULES.get(rid, rid)},
        "defaultConfiguration": {
            "level": _LEVEL.get(SEVERITY.get(rid, "warn"), "warning"),
        },
    } for rid in rule_ids]
    results = [{
        "ruleId": f.rule,
        "ruleIndex": rule_ids.index(f.rule),
        "level": _LEVEL.get(f.severity, "warning"),
        "message": {"text": f.message},
        "locations": [{
            "physicalLocation": {
                "artifactLocation": {"uri": f.path, "uriBaseId": "%SRCROOT%"},
                "region": {"startLine": max(1, f.line),
                           "startColumn": max(1, f.col + 1)},
            },
        }],
        "partialFingerprints": {"crdtlint/v1": fp},
    } for f, fp in paired]
    return {
        "$schema": SARIF_SCHEMA,
        "version": SARIF_VERSION,
        "runs": [{
            "tool": {"driver": {
                "name": "crdtlint",
                "informationUri": "https://github.com/tpu-crdt/tpu-crdt",
                "rules": rules,
            }},
            "results": results,
        }],
    }


def write_sarif(findings: Iterable[Finding], path) -> None:
    with open(path, "w") as fh:
        json.dump(to_sarif(findings), fh, indent=1, sort_keys=True)
        fh.write("\n")
