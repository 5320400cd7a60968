"""Graph-level checks over the ops/joins.py join registry (the port's
counterpart of ``crdt_tpu.analysis.jaxpr_checks``).

Every lattice join the package exports
(crdt_tpu_torch.ops.joins.registered_joins) is traced to its ``make_fx``
aten graph on its CPU example operands (``prove.trace_join``, the trace
the verdict ledger's fingerprint reads) and statically audited.  Like
the JAX package's abstract trace, this reads the join's body: it builds
no state of the program and launches no kernel of the card, so it is the
same check on any host, not a CPU stand-in for a device path.

CRDT101 purity
    Every call in the graph is an aten/prims operator or
    ``operator.getitem`` (which unpacks a multi-output op such as
    ``sort``).  Anything else, an ``aten._local_scalar_dense`` (a host
    sync inside a join: ``.item()``, ``int()`` of a tensor, torch's form
    of a callback), or a join that fails to trace, makes the merge
    something other than a pure device function of its operands.

CRDT102 closure
    The output leaves' (shape, dtype) equal the first operand's: joins
    are endomorphisms ``join : S × S → S`` on one layout, or
    tree_reduce_join/converge are unsound.

CRDT103 swap symmetry (only where claimed)
    For joins registered ``structurally_commutative=True``, the graph of
    ``join(a, b)`` must equal the graph of ``join(b, a)`` after
    alpha-renaming and canonicalizing the operand order of commutative
    aten ops (``prove._canonical_lines``, the fingerprint's
    canonicalizer).  Select-based joins are extensionally commutative but
    not operand-symmetric: they claim False and are covered by the
    runtime law tests instead.

CRDT104 metadata propagation (composites only)
    A composite (``spec.parts`` non-empty, built by
    crdt_tpu_torch.ops.algebra) registered ``structurally_commutative=True``
    must have every part registered with the same claim.

CRDT105-107 come from the semantic hazard pass over the same graph
(``verify.hazards``).
"""
from __future__ import annotations

import inspect
import operator
import pathlib
from typing import List, Tuple

from crdt_tpu_torch.analysis import Finding

#: operator namespaces a pure join's graph may call
_PURE_NAMESPACES = ("aten", "prims")

#: the aten op that reads a tensor's value into the host (make_fx refuses
#: it on a traced tensor, which the trace failure reports under this name)
_HOST_SYNC_OP = "_local_scalar_dense"


def join_location(spec, rel_base: pathlib.Path) -> Tuple[str, int]:
    """(relpath, line) of a join's def, repo-relative: findings anchor
    at the join's own definition site."""
    try:
        fn = inspect.unwrap(spec.join)
        src_file = pathlib.Path(inspect.getsourcefile(fn) or "?")
        line = inspect.getsourcelines(fn)[1]
        return src_file.resolve().relative_to(rel_base).as_posix(), line
    except (TypeError, OSError, ValueError):
        return "crdt_tpu_torch/ops/joins.py", 1


def op_name(node) -> str:
    """``add`` for ``aten.add.Tensor`` (the overload packet's name, an
    in-place op's trailing underscore kept); "" for a non-operator
    target."""
    packet = getattr(node.target, "overloadpacket", None)
    return getattr(packet, "__name__", "") if packet is not None else ""


def _impurity(node) -> str:
    """Why a graph node makes the join impure, else ""."""
    if node.op != "call_function":
        return ""
    if node.target is operator.getitem:
        return ""
    namespace = getattr(node.target, "namespace", "")
    if namespace not in _PURE_NAMESPACES:
        return getattr(node.target, "__name__", str(node.target))
    if op_name(node) == _HOST_SYNC_OP:
        return _HOST_SYNC_OP
    return ""


def _out_avals(gm) -> List[Tuple[tuple, str]]:
    out = next(n for n in gm.graph.nodes if n.op == "output")
    return [(tuple(n.meta["val"].shape), str(n.meta["val"].dtype))
            for n in out.args[0]]


def check_registered_joins(rel_base: pathlib.Path) -> List[Finding]:
    from crdt_tpu_torch.analysis.verify import hazards, prove
    from crdt_tpu_torch.ops import joins as joins_mod

    findings: List[Finding] = []
    registry = joins_mod.registered_joins()
    for name, spec in sorted(registry.items()):
        relpath, line = join_location(spec, rel_base)

        # CRDT104: a composite claiming structural commutativity needs
        # every part to claim it too
        parts = getattr(spec, "parts", ())
        if parts and spec.structurally_commutative:
            bad = [p for p in parts
                   if p not in registry
                   or not registry[p].structurally_commutative]
            if bad:
                findings.append(Finding(
                    rule="CRDT104", path=relpath, line=line, scope=name,
                    detail=f"{name}|parts-claim|{','.join(bad)}",
                    message=(f"composite '{name}' claims structural "
                             f"commutativity but part(s) "
                             f"{', '.join(repr(p) for p in bad)} don't — "
                             f"metadata must propagate as the AND of the "
                             f"parts' claims"),
                ))

        try:
            gm, a, _b = prove.trace_join(spec)
        except Exception as e:  # the failure IS the finding
            sync = _HOST_SYNC_OP in str(e)
            findings.append(Finding(
                rule="CRDT101", path=relpath, line=line, scope=name,
                detail=f"{name}|{_HOST_SYNC_OP if sync else 'untraceable'}",
                message=(f"join '{name}' reads a tensor's value into the host "
                         f"({_HOST_SYNC_OP}): joins must be pure device "
                         f"functions of their operands" if sync else
                         f"join '{name}' failed to trace: {e}"),
            ))
            continue

        # CRDT101: purity
        for node in gm.graph.nodes:
            what = _impurity(node)
            if what:
                findings.append(Finding(
                    rule="CRDT101", path=relpath, line=line, scope=name,
                    detail=f"{name}|{what}",
                    message=(f"join '{name}' calls '{what}', which is no "
                             f"aten operator of the join's operands: joins "
                             f"must be pure device functions of their "
                             f"operands"),
                ))

        # CRDT105-107: the semantic hazard pass over the same graph
        findings.extend(hazards.check_join_hazards(name, spec, gm, relpath, line))

        # CRDT102: closure — out (shape, dtype) == the first operand's
        in_avals = prove._leaf_avals(a)
        out_avals = _out_avals(gm)
        if in_avals != out_avals:
            findings.append(Finding(
                rule="CRDT102", path=relpath, line=line, scope=name,
                detail=f"{name}|aval-closure",
                message=(f"join '{name}' is not closed: inputs {in_avals} vs "
                         f"outputs {out_avals} — joins must map S × S → S "
                         f"on one layout"),
            ))

        # CRDT103: operand-swap symmetry where claimed
        if spec.structurally_commutative:
            swapped, _, _ = prove.trace_join(spec, swapped=True)
            if prove._canonical_lines(gm) != prove._canonical_lines(swapped):
                findings.append(Finding(
                    rule="CRDT103", path=relpath, line=line, scope=name,
                    detail=f"{name}|swap-asymmetry",
                    message=(f"join '{name}' claims structural commutativity "
                             f"but its graph differs under operand swap — "
                             f"drop the claim (and rely on the runtime law "
                             f"tests) or fix the join"),
                ))
    return findings
