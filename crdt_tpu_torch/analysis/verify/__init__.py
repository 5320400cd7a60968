"""crdtprove: machine-checked lattice-law verification (counterpart of
``crdt_tpu.analysis.verify``).

Every registered join of the port is run over a tiny reachable state
domain (``JoinSpec.small`` seeds, or fixed-seed ``rand`` draws), the
domain is closed under the join, and the five lattice laws are checked
over the FULL product space (pairs for commutativity, triples for
associativity) with the spec's batched join.  Composites are proved over
their own domains AND owe combinator obligations (semidirect act laws,
the lexicographic rank chain) over the part domains.

Verdicts (``proved`` / ``refuted`` / ``assumed`` with a reason) are keyed
by drift-stable fingerprints of each join's ``make_fx`` graph and
committed to ``crdt_tpu_torch/analysis/verdicts.json`` (ledger module),
the port's own ledger.  The gate (``python -m crdt_tpu_torch.analysis
verify --check-ledger``) fails on a refuted law, a fingerprint that
drifted from the ledger, or a registered join with no verdict.

The package also ships the witnessed-race detector (race module): a
vector-clock happens-before checker over the threaded runtime.
"""
from __future__ import annotations

from crdt_tpu_torch.analysis.verify.prove import (  # noqa: F401
    LAWS,
    blast_call_count,
    join_fingerprint,
    prove_spec,
)
