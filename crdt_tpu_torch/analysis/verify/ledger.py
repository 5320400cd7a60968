"""The port's committed verdict ledger
(``crdt_tpu_torch/analysis/verdicts.json``; counterpart of
``crdt_tpu.analysis.verify.ledger``).

One entry per registered join, keyed by name, carrying the join's
fingerprint and its law verdict:

* ``proved``: every lattice law (and every combinator obligation) holds
  exhaustively over a join-closed small domain, and, for composites,
  every part is itself ``proved``;
* ``refuted``: some law or obligation has a concrete counterexample
  (recorded in the entry);
* ``assumed``: the laws hold on the checked subspace but something keeps
  the verdict short of proved; the ``reason`` field says what.

The fingerprint (``verify.prove.join_fingerprint``) is the cache key: a
recompute SKIPS bit-blasting for any join whose fingerprint is unchanged,
and the gate (``--check-ledger``) is fingerprint-only: it traces every
registered join (cheap) and fails when a registered join has no entry,
an entry's fingerprint differs from the live join, or an entry is
``refuted``.  Entries of joins no longer registered are reported as
stale but do not fail the gate.

The ledger is written on the CPU (``verify --write-ledger``); the JAX
package's ledger is its own and stays untouched.
"""
from __future__ import annotations

import json
import pathlib
from typing import Dict, List, Optional, Tuple

DEFAULT_LEDGER = pathlib.Path(__file__).resolve().parent.parent / "verdicts.json"

LEDGER_VERSION = 1


def load(path: Optional[pathlib.Path] = None) -> Optional[dict]:
    p = pathlib.Path(path) if path else DEFAULT_LEDGER
    if not p.exists():
        return None
    return json.loads(p.read_text())


def save(ledger: dict, path: Optional[pathlib.Path] = None) -> None:
    p = pathlib.Path(path) if path else DEFAULT_LEDGER
    p.write_text(json.dumps(ledger, indent=1, sort_keys=True) + "\n")


def _downgrade_composites(entries: Dict[str, dict]) -> None:
    """A composite is only ``proved`` when every part is.  Runs to a
    fixpoint so composites of composites propagate."""
    changed = True
    while changed:
        changed = False
        for entry in entries.values():
            if entry["verdict"] != "proved" or not entry.get("parts"):
                continue
            weak = [p for p in entry["parts"]
                    if entries.get(p, {}).get("verdict") != "proved"]
            if weak:
                entry["verdict"] = "assumed"
                entry["reason"] = (
                    "own laws and obligations proved, but part(s) "
                    + ", ".join(repr(p) for p in weak)
                    + " are not themselves proved")
                changed = True


def _registry(registry):
    if registry is None:
        from crdt_tpu_torch.ops.joins import registered_joins

        registry = registered_joins()
    return registry


def compute(cached: Optional[dict] = None, cap: Optional[int] = None,
            registry=None, device=None) -> Tuple[dict, List[str]]:
    """Build a fresh ledger over every registered join, proving on
    ``device`` (None: the CUDA card).  ``cached`` (a loaded ledger)
    short-circuits bit-blasting for joins whose fingerprint is
    unchanged.  Returns (ledger, names actually recomputed)."""
    from crdt_tpu_torch.analysis.verify import prove
    from crdt_tpu_torch.analysis.verify.domains import DEFAULT_CAP

    registry = _registry(registry)
    cap = cap or DEFAULT_CAP
    old = (cached or {}).get("joins", {})
    entries: Dict[str, dict] = {}
    recomputed: List[str] = []
    for name, spec in sorted(registry.items()):
        fp = prove.join_fingerprint(spec)
        prior = old.get(name)
        if prior is not None and prior.get("fingerprint") == fp:
            entries[name] = dict(prior)
            continue
        entry = prove.prove_spec(spec, registry, cap=cap, device=device)
        entry["fingerprint"] = fp
        entry["parts"] = list(spec.parts)
        entry["combinator"] = spec.combinator
        entries[name] = entry
        recomputed.append(name)
    _downgrade_composites(entries)
    return {"version": LEDGER_VERSION, "cap": cap, "joins": entries}, recomputed


def check(ledger: Optional[dict] = None, path: Optional[pathlib.Path] = None,
          registry=None) -> Tuple[List[str], List[str]]:
    """Fingerprint-only gate: (problems, stale).  No problems ⇔ every
    registered join has a matching non-refuted ledger entry."""
    from crdt_tpu_torch.analysis.verify import prove

    if ledger is None:
        ledger = load(path)
    registry = _registry(registry)
    problems: List[str] = []
    if ledger is None:
        return ([f"no verdict ledger at {path or DEFAULT_LEDGER}; run "
                 f"`python -m crdt_tpu_torch.analysis verify --write-ledger`"], [])
    entries = ledger.get("joins", {})
    for name, spec in sorted(registry.items()):
        entry = entries.get(name)
        if entry is None:
            problems.append(f"join '{name}' is registered but has no ledger verdict — "
                            f"run `verify --write-ledger`")
            continue
        fp = prove.join_fingerprint(spec)
        if entry.get("fingerprint") != fp:
            problems.append(f"join '{name}' drifted: ledger fingerprint "
                            f"{entry.get('fingerprint')} != live {fp} — rerun "
                            f"`verify --write-ledger` to re-prove it")
        if entry.get("verdict") == "refuted":
            bad = entry.get("refuted_laws", []) + entry.get("refuted_obligations", [])
            problems.append(f"join '{name}' is REFUTED ({', '.join(bad) or 'law'}) — "
                            f"see its counterexample in the ledger")
    stale = sorted(set(entries) - set(registry))
    return problems, stale


def annotate_registry(path: Optional[pathlib.Path] = None) -> None:
    """Push ledger verdicts into the live registry's ``verified`` field:
    True iff the entry is ``proved`` AND its fingerprint still matches the
    live join (a drifted join is not verified, whatever the ledger
    says)."""
    from crdt_tpu_torch.analysis.verify import prove
    from crdt_tpu_torch.ops.joins import mark_verified, registered_joins

    entries = (load(path) or {}).get("joins", {})
    for name, spec in registered_joins().items():
        entry = entries.get(name)
        ok = (entry is not None
              and entry.get("verdict") == "proved"
              and entry.get("fingerprint") == prove.join_fingerprint(spec))
        mark_verified(name, ok)
