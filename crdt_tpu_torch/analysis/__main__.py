"""The analysis CLI: ``python -m crdt_tpu_torch.analysis`` (counterpart of
``crdt_tpu.analysis.__main__``).

Subcommand ``verify`` (crdtprove, lattice-law verification):
    verify                    recompute verdicts (ledger-cached), exit 1 on
                              any refuted join
    verify --write-ledger     recompute and write analysis/verdicts.json
    verify --check-ledger     fingerprint-only gate: exit 0 iff every
                              registered join has a matching, non-refuted
                              ledger entry (no bit-blasting)
    verify --json / --sarif   machine-readable verdicts / findings
    verify --device DEV       where the sweeps run (default: the CUDA card)

Every other invocation is the linter, whose tiers are not ported (ROADMAP
Queue 1 item 8): it exits 2 naming them.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys

from crdt_tpu_torch import analysis
from crdt_tpu_torch.analysis import Finding

LINT_NOT_PORTED = (
    "python -m crdt_tpu_torch.analysis: the lint tiers (ast_checks, "
    "concurrency, flow, the join-graph checks, the suppression baseline) are "
    "not ported (ROADMAP Queue 1 item 8); only the `verify` subcommand is")


def _join_location(spec):
    """(relpath, line) of a join's def, repo-relative, so SARIF
    annotations land on the source."""
    import inspect

    try:
        fn = inspect.unwrap(spec.join)
        src_file = pathlib.Path(inspect.getsourcefile(fn) or "?")
        line = inspect.getsourcelines(fn)[1]
        return src_file.resolve().relative_to(analysis.repo_root()).as_posix(), line
    except (TypeError, OSError, ValueError):
        return "crdt_tpu_torch/ops/joins.py", 1


def _ledger_findings(led, registry) -> list:
    """Ledger state as CRDT301/CRDT302 findings (the Finding/SARIF
    language of the analysis layer)."""
    from crdt_tpu_torch.analysis.verify import prove

    findings = []
    entries = (led or {}).get("joins", {})
    for name, spec in sorted(registry.items()):
        relpath, line = _join_location(spec)
        entry = entries.get(name)
        if entry is None:
            findings.append(Finding(
                rule="CRDT302", path=relpath, line=line, scope=name, detail="missing",
                message=f"join '{name}' has no verdict ledger entry — run "
                        f"`python -m crdt_tpu_torch.analysis verify --write-ledger`"))
            continue
        if entry.get("fingerprint") != prove.join_fingerprint(spec):
            findings.append(Finding(
                rule="CRDT302", path=relpath, line=line, scope=name, detail="drift",
                message=f"join '{name}' drifted against the verdict ledger "
                        f"(graph fingerprint changed) — rerun "
                        f"`verify --write-ledger` to re-prove it"))
        if entry.get("verdict") == "refuted":
            bad = entry.get("refuted_laws", []) + entry.get("refuted_obligations", [])
            findings.append(Finding(
                rule="CRDT301", path=relpath, line=line, scope=name,
                detail=",".join(bad) or "law",
                message=f"join '{name}' REFUTED: {', '.join(bad) or 'law'} "
                        f"fails with a concrete counterexample (see "
                        f"analysis/verdicts.json)"))
    return findings


def verify_main(argv=None) -> int:
    from crdt_tpu_torch.analysis import sarif as sarif_mod
    from crdt_tpu_torch.analysis.verify import ledger
    from crdt_tpu_torch.ops import joins

    ap = argparse.ArgumentParser(
        prog="python -m crdt_tpu_torch.analysis verify",
        description="crdtprove: exhaustive small-domain lattice-law "
                    "verification over the join registry.")
    ap.add_argument("--write-ledger", action="store_true",
                    help="recompute and write analysis/verdicts.json")
    ap.add_argument("--check-ledger", action="store_true",
                    help="fingerprint-only gate against the committed ledger "
                         "(no bit-blasting)")
    ap.add_argument("--ledger", type=pathlib.Path, default=None,
                    help=f"ledger path (default: {ledger.DEFAULT_LEDGER})")
    ap.add_argument("--cap", type=int, default=None,
                    help="max states per join domain (default: "
                         "verify.domains.DEFAULT_CAP)")
    ap.add_argument("--no-cache", action="store_true",
                    help="re-blast every join even if its fingerprint matches")
    ap.add_argument("--json", action="store_true", dest="as_json")
    ap.add_argument("--sarif", type=pathlib.Path, default=None,
                    help="write CRDT301/302 findings as SARIF 2.1.0")
    ap.add_argument("--device", default=None,
                    help="where the sweeps run (default: the CUDA card)")
    args = ap.parse_args(argv)

    registry = joins.registered_joins()

    if args.check_ledger:
        led = ledger.load(args.ledger)
        problems, stale = ledger.check(led, args.ledger, registry)
        findings = _ledger_findings(led, registry)
        if args.sarif:
            sarif_mod.write_sarif(findings, args.sarif)
        if args.as_json:
            print(json.dumps({"problems": problems, "stale": stale,
                              "findings": [f.to_dict() for f in findings]}, indent=1))
        else:
            for f in findings:
                print(f.render())
            for s in stale:
                print(f"crdtprove: stale ledger entry '{s}' (join no longer "
                      f"registered) — ratchet out with --write-ledger")
            verdict = "FAIL" if problems else "ok"
            print(f"crdtprove: ledger gate {verdict} — {len(registry)} join(s), "
                  f"{len(problems)} problem(s), {len(stale)} stale "
                  f"entr{'y' if len(stale) == 1 else 'ies'}")
        return 1 if problems else 0

    cached = None if args.no_cache else ledger.load(args.ledger)
    led, recomputed = ledger.compute(cached, cap=args.cap, registry=registry,
                                     device=args.device)
    entries = led["joins"]
    refuted = sorted(n for n, e in entries.items() if e["verdict"] == "refuted")
    assumed = sorted(n for n, e in entries.items() if e["verdict"] == "assumed")

    if args.write_ledger:
        ledger.save(led, args.ledger)

    findings = _ledger_findings(led, registry)
    if args.sarif:
        sarif_mod.write_sarif(findings, args.sarif)
    if args.as_json:
        print(json.dumps(led, indent=1, sort_keys=True))
    else:
        for name in sorted(entries):
            e = entries[name]
            mark = {"proved": "✓", "assumed": "~", "refuted": "✗"}[e["verdict"]]
            extra = ""
            if e["verdict"] == "assumed":
                extra = f"  ({e.get('reason', '')})"
            elif e["verdict"] == "refuted":
                bad = e.get("refuted_laws", []) + e.get("refuted_obligations", [])
                extra = f"  ({', '.join(bad)})"
            cachemark = "" if name in recomputed else "  [cached]"
            print(f"  {mark} {name:24s} {e['verdict']:8s}"
                  f" states={e['domain']['states']}{cachemark}{extra}")
        if args.write_ledger:
            print(f"crdtprove: wrote {len(entries)} verdict(s) to "
                  f"{args.ledger or ledger.DEFAULT_LEDGER}")
        print(f"crdtprove: {len(entries)} join(s) — "
              f"{len(entries) - len(refuted) - len(assumed)} proved, "
              f"{len(assumed)} assumed, {len(refuted)} refuted "
              f"({len(recomputed)} recomputed)")
    return 1 if refuted else 0


def main(argv=None) -> int:
    if argv is None:
        argv = sys.argv[1:]
    if argv and argv[0] == "verify":
        return verify_main(argv[1:])
    print(LINT_NOT_PORTED, file=sys.stderr)
    return 2


if __name__ == "__main__":
    sys.exit(main())
