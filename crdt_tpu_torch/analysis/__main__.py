"""crdtlint CLI: ``python -m crdt_tpu_torch.analysis`` (counterpart of
``crdt_tpu.analysis.__main__``, the same argv).

Modes
    (default)            run all layers, print findings, exit 1 if any
    --check-baseline     exit 0 iff nothing NEW vs analysis/baseline.json
                         (the gate; stale entries are reported but pass)
    --write-baseline     regenerate the baseline from the current tree
    --json               machine-readable output (findings + fingerprints)
    --sarif PATH         also write findings as SARIF 2.1.0
    --no-jaxpr           AST/concurrency/flow layers only (skips the
                         join-graph layer, fx_checks; the name is JAX's)
    --rules CRDT001,...  restrict to a rule subset
    --list-rules         the rule table
    PATHS                files or directories (default: the crdt_tpu_torch
                         package)

Subcommand ``verify`` (crdtprove, lattice-law verification):
    verify                    recompute verdicts (ledger-cached), exit 1 on
                              any refuted join
    verify --write-ledger     recompute and write analysis/verdicts.json
    verify --check-ledger     fingerprint-only gate: exit 0 iff every
                              registered join has a matching, non-refuted
                              ledger entry (no bit-blasting)
    verify --json / --sarif   machine-readable verdicts / findings
    verify --device DEV       where the sweeps run (default: the CUDA card)
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

from crdt_tpu_torch import analysis
from crdt_tpu_torch.analysis import RULES, Finding, baseline


def _ledger_findings(led, registry) -> list:
    """Ledger state as CRDT301/CRDT302 findings (the Finding/SARIF
    language of the analysis layer)."""
    from crdt_tpu_torch.analysis.fx_checks import join_location
    from crdt_tpu_torch.analysis.verify import prove

    findings = []
    entries = (led or {}).get("joins", {})
    for name, spec in sorted(registry.items()):
        relpath, line = join_location(spec, analysis.repo_root())
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

    ap = argparse.ArgumentParser(
        prog="python -m crdt_tpu_torch.analysis",
        description="crdtlint: device-hazard, concurrency and lock-flow "
                    "static analysis with a ratcheting baseline gate.",
    )
    ap.add_argument("paths", nargs="*",
                    help="files/dirs to analyze (default: crdt_tpu_torch/)")
    ap.add_argument("--json", action="store_true", dest="as_json",
                    help="emit findings as JSON")
    ap.add_argument("--check-baseline", action="store_true",
                    help="exit 0 iff no findings outside the baseline")
    ap.add_argument("--write-baseline", action="store_true",
                    help="regenerate the suppressions file from this tree")
    ap.add_argument("--baseline", type=pathlib.Path,
                    default=baseline.DEFAULT_BASELINE)
    ap.add_argument("--sarif", type=pathlib.Path, default=None,
                    help="also write findings as SARIF 2.1.0")
    ap.add_argument("--no-jaxpr", action="store_true",
                    help="skip the join-graph layer (no make_fx traces)")
    ap.add_argument("--rules", type=str, default=None,
                    help="comma-separated rule subset (e.g. CRDT001,CRDT201)")
    ap.add_argument("--list-rules", action="store_true")
    args = ap.parse_args(argv)

    if args.list_rules:
        for rule, desc in sorted(RULES.items()):
            print(f"{rule}  [{analysis.SEVERITY.get(rule, 'warn'):5s}]  {desc}")
        return 0

    roots = [pathlib.Path(p) for p in args.paths] or None
    rules = args.rules.split(",") if args.rules else None
    t0 = time.perf_counter()
    findings = analysis.run_all(roots, jaxpr=not args.no_jaxpr, rules=rules)
    elapsed = time.perf_counter() - t0
    if not args.as_json:
        # the chip smoke records this wall against the 60 s crdtflow budget
        print(f"crdtlint: analyzed in {elapsed:.2f}s"
              f"{' (rules: ' + args.rules + ')' if args.rules else ''}")

    if args.sarif:
        from crdt_tpu_torch.analysis import sarif as sarif_mod

        sarif_mod.write_sarif(findings, args.sarif)

    if args.write_baseline:
        n = baseline.save(findings, args.baseline)
        print(f"crdtlint: wrote {n} baseline entr{'y' if n == 1 else 'ies'} "
              f"to {args.baseline}")
        return 0

    if args.check_baseline:
        new, stale = baseline.diff(findings, args.baseline)
        if rules:
            # a rules-filtered run can't see the other layers' findings,
            # so their baseline entries are absent by construction, not
            # stale — only report staleness for the active subset
            keep = set(rules)
            stale = [e for e in stale if e.get("rule") in keep]
        if args.as_json:
            print(json.dumps({
                "new": [dict(f.to_dict(), fingerprint=fp)
                        for f, fp in baseline.fingerprints(new)],
                "stale": stale,
                "total": len(findings),
            }, indent=1))
        else:
            for f in new:
                print(f.render())
            for e in stale:
                print(f"crdtlint: stale baseline entry {e['fingerprint']} "
                      f"({e['rule']} {e['path']} {e.get('scope', '')}) — "
                      f"fixed? ratchet it out with --write-baseline")
            print(f"crdtlint: {len(findings)} finding(s), {len(new)} new, "
                  f"{len(stale)} stale baseline entr"
                  f"{'y' if len(stale) == 1 else 'ies'}")
        return 1 if new else 0

    if args.as_json:
        print(json.dumps(
            [dict(f.to_dict(), fingerprint=fp)
             for f, fp in baseline.fingerprints(findings)], indent=1))
    else:
        for f in findings:
            print(f.render())
        errors = sum(1 for f in findings if f.severity == "error")
        print(f"crdtlint: {len(findings)} finding(s) ({errors} error)")
    return 1 if findings else 0


if __name__ == "__main__":
    sys.exit(main())
