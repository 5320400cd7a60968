"""Semantic hazard pass over registered joins' aten graphs (CRDT105-107;
counterpart of ``crdt_tpu.analysis.verify.hazards``, which reads
jaxprs).

The graph tier (``analysis.fx_checks``) proves structural facts: purity,
closure, swap symmetry.  This pass reads the SEMANTICS of the traced aten
ops, by the dtype ``make_fx`` records for each node's output
(``node.meta["val"]``), and flags computations that can silently break
the lattice laws even when every structural check passes:

CRDT105 float accumulation (error)
    Floating-point add / sub / mul / div / sum / cumsum / mm / bmm /
    addmm / matmul inside a join.  Float arithmetic is not associative,
    so a join built on it cannot satisfy the associativity law bitwise.
    Every shipped lattice is int/bool.

CRDT106 nondeterminism (error)
    RNG ops (``rand*``, ``randint``, ``randn``, ``normal``, ``bernoulli``,
    ``uniform``, ``random_``, ``multinomial``) make the join a function of
    hidden state; float ``scatter_add`` / ``index_add`` /
    ``index_put(accumulate=True)`` apply colliding updates in an
    unspecified order; and ``arange`` inside a join *claiming*
    ``structurally_commutative`` is an index-dependent value source that
    swap canonicalization can mask (JAX's ``iota``).

CRDT107 narrow-int wrap (warn)
    add / mul on int8/int16/uint8/uint16: two mid-range values overflow
    and wrap, which breaks inflationarity.  The bit-blaster's
    inflationarity law is the ground truth.
"""
from __future__ import annotations

from typing import List

import torch

from crdt_tpu_torch.analysis import Finding

#: accumulation ops that are order-sensitive on floats
_FLOAT_ACC_OPS = {"add", "sub", "mul", "div", "sum", "cumsum", "mm", "bmm",
                  "addmm", "matmul"}

#: RNG ops (besides every ``rand*``)
_RNG_OPS = {"normal", "bernoulli", "uniform", "random", "multinomial"}

#: accumulating scatters whose float form is order-dependent
_SCATTER_ACC_OPS = {"scatter_add", "index_add"}

#: dtypes whose add/mul wrap within plausible lattice value ranges
_NARROW_INTS = {"int8", "int16", "uint8", "uint16"}


def _out_dtype(node) -> torch.dtype | None:
    val = node.meta.get("val")
    if isinstance(val, (tuple, list)):
        val = next((v for v in val if isinstance(v, torch.Tensor)), None)
    return val.dtype if isinstance(val, torch.Tensor) else None


def _accumulates(node, base: str) -> bool:
    if base in _SCATTER_ACC_OPS:
        return True
    if base in ("index_put", "_index_put_impl"):
        acc = node.args[3] if len(node.args) > 3 else node.kwargs.get("accumulate", False)
        return bool(acc)
    return False


def check_join_hazards(name: str, spec, gm, relpath: str,
                       line: int) -> List[Finding]:
    """Hazard findings for one traced join (called from the fx_checks
    loop so run_all and the baseline gate cover them)."""
    from crdt_tpu_torch.analysis.fx_checks import op_name

    findings: List[Finding] = []
    seen = set()  # (rule, tag): one finding per hazard kind per join

    def emit(rule: str, tag: str, message: str) -> None:
        if (rule, tag) in seen:
            return
        seen.add((rule, tag))
        findings.append(Finding(
            rule=rule, path=relpath, line=line, scope=name,
            detail=f"{name}|{tag}", message=message))

    for node in gm.graph.nodes:
        if node.op != "call_function":
            continue
        op = op_name(node)
        if not op:
            continue
        base = op.rstrip("_") or op
        dt = _out_dtype(node)
        dtype = str(dt).replace("torch.", "") if dt is not None else ""
        is_float = dt is not None and dt.is_floating_point

        if base in _FLOAT_ACC_OPS and is_float:
            emit("CRDT105", f"{base}:{dtype}",
                 f"join '{name}' accumulates in floating point "
                 f"('{base}' on {dtype}): float arithmetic is not "
                 f"associative, so merge results depend on gossip "
                 f"order — use an order-independent encoding "
                 f"(fixed-point int) or drop the join claim")

        if base.startswith("rand") or base in _RNG_OPS:
            emit("CRDT106", base,
                 f"join '{name}' traces RNG op '{base}': the merge is a "
                 f"function of hidden randomness, not of its operands — "
                 f"replicas cannot converge")
        if _accumulates(node, base) and is_float:
            emit("CRDT106", f"{base}:{dtype}",
                 f"join '{name}' float {base}: colliding updates apply in "
                 f"unspecified order (non-associative float accumulation)")
        if base == "arange" and spec.structurally_commutative:
            emit("CRDT106", "arange",
                 f"join '{name}' claims structural commutativity but "
                 f"traces 'arange': index-generated values are operand-"
                 f"order artifacts the swap canonicalization can mask "
                 f"— drop the claim or derive indices from operands")

        if base in ("add", "mul") and dtype in _NARROW_INTS:
            emit("CRDT107", f"{base}:{dtype}",
                 f"join '{name}' does '{base}' on {dtype}: narrow-int "
                 f"overflow wraps (a ∨ b can land BELOW a, breaking "
                 f"inflationarity) — saturate explicitly or widen "
                 f"before accumulating")
    return findings
