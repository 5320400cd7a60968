"""Exhaustive lattice-law checking over small domains, the bit-blaster
(counterpart of ``crdt_tpu.analysis.verify.prove``).

For one :class:`~crdt_tpu_torch.ops.joins.JoinSpec` the prover builds a
small reachable domain (domains module), stacks it, and checks the five
lattice laws over the FULL product space with the spec's batched join:

=================  ==========================================  =========
law                equation checked                            space
=================  ==========================================  =========
commutative        join(a, b) == join(b, a)                    n² pairs
associative        join(join(a,b), c) == join(a, join(b,c))    n³ triples
idempotent         join(a, a) == a                             n states
neutral            join(a, z) == a == join(z, a)               n states
inflationary       join(a, join(a,b)) == join(a,b) (a ≤ a∨b    n² pairs
                   in the join-characterized order, both
                   operands)
=================  ==========================================  =========

Equality is bitwise per leaf.  The first violating row is decoded back
into concrete operand states and reported as the law's counterexample.
The sweeps run where the domain lives (``device``; None: the CUDA card),
so a registry join that routes to a hand kernel launches it there.

Combinator obligations (composites): a composite's own laws are checked
over its own domain like any join, and additionally

* ``semidirect(a, act, b)``: the act laws (identity, composition over
  join-generated frame chains, join-homomorphism) over the part domains;
* ``lexicographic(a, b, rank)``: ``rank`` must be injective over the
  a-domain (equal rank ⇒ identical state).

The fingerprint (:func:`join_fingerprint`) is the counterpart of the JAX
package's canonical jaxpr: a sha1 over the alpha-renamed aten graph that
``make_fx`` records for the join on its CPU example, with the operand
order of commutative aten ops canonicalised, plus the leaf layouts.
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from crdt_tpu_torch import default_device
from crdt_tpu_torch.analysis.verify import domains as dom_mod
from crdt_tpu_torch.analysis.verify.domains import (
    DEFAULT_CAP,
    Domain,
    batched_join,
    build_domain,
    gather,
    stack,
)
from crdt_tpu_torch.ops import joins
from crdt_tpu_torch.utils.tree import leaves, tree_map

LAWS = ("commutative", "associative", "idempotent", "neutral", "inflationary")

#: triple-sweep chunk: bounds peak memory on the big-leaf lattices
_CHUNK = 8192

#: how many times prove_spec actually blasted (the ledger's cache tests
#: pin recomputes against this)
_BLAST_CALLS = 0


def blast_call_count() -> int:
    return _BLAST_CALLS


# ---- the fingerprint ----

#: aten ops whose first two operands commute: the canonical form sorts
#: them, so ``maximum a b`` ≡ ``maximum b a``
_COMMUTATIVE_OPS = {
    "aten.add.Tensor", "aten.mul.Tensor", "aten.maximum.default",
    "aten.minimum.default", "aten.bitwise_and.Tensor", "aten.bitwise_or.Tensor",
    "aten.bitwise_xor.Tensor", "aten.logical_and.default", "aten.logical_or.default",
    "aten.logical_xor.default", "aten.eq.Tensor", "aten.ne.Tensor",
}


def _canonical_lines(gm: torch.fx.GraphModule) -> List[str]:
    """Alpha-renamed, commutativity-canonicalized node listing of an fx
    graph (constants named by their content)."""
    names: Dict[str, str] = {}

    def nm(v) -> str:
        if isinstance(v, torch.fx.Node):
            return names[v.name]
        if isinstance(v, (list, tuple)):
            return "[" + ", ".join(nm(x) for x in v) + "]"
        return repr(v)

    lines: List[str] = []
    for node in gm.graph.nodes:
        if node.op == "placeholder":
            names[node.name] = f"v{len(names)}"
        elif node.op == "get_attr":
            const = getattr(gm, node.target)
            digest = hashlib.sha1(const.detach().cpu().numpy().tobytes()).hexdigest()[:12]
            names[node.name] = f"v{len(names)}"
            lines.append(f"{names[node.name]} = const {tuple(const.shape)} "
                         f"{const.dtype} {digest}")
        elif node.op == "call_function":
            op = str(node.target)
            ins = [nm(a) for a in node.args]
            if op in _COMMUTATIVE_OPS and len(ins) == 2:
                ins = sorted(ins)
            ins += [f"{k}={nm(v)}" for k, v in sorted(node.kwargs.items())]
            names[node.name] = f"v{len(names)}"
            lines.append(f"{names[node.name]} = {op} {' '.join(ins)}")
        elif node.op == "output":
            lines.append("ret " + nm(node.args[0]))
    return lines


def _leaf_avals(state) -> list:
    return [(tuple(x.shape), str(x.dtype)) for x in leaves(state)]


def trace_join(spec, swapped: bool = False):
    """``(gm, a, b)``: the ``make_fx`` aten graph of ``spec.join(a, b)``
    (``spec.join(b, a)`` when ``swapped``) on ``spec.example(device="cpu")``,
    over the operands' flattened leaves in the order a's then b's, and the
    operands.  The one trace the fingerprint and the graph lint tier
    (``analysis.fx_checks``) read."""
    from torch.fx.experimental.proxy_tensor import make_fx

    a, b = spec.example(device="cpu")
    la, lb = leaves(a), leaves(b)

    def flat(*xs):
        x, y = joins._unflatten(a, xs[:len(la)]), joins._unflatten(b, xs[len(la):])
        out = spec.join(y, x) if swapped else spec.join(x, y)
        return tuple(leaves(out))

    return make_fx(flat)(*la, *lb), a, b


def join_fingerprint(spec) -> str:
    """Line-drift-stable identity of a join's traced body: sha1 over the
    alpha-renamed, commutativity-canonicalized ``make_fx`` graph of
    ``spec.join`` on ``spec.example(device="cpu")`` plus the operand
    layouts.  Changes iff the join's computation (or its registered state
    layout) changes: the ledger's cache key."""
    gm, a, b = trace_join(spec)
    payload = ("\n".join(_canonical_lines(gm))
               + repr(_leaf_avals(a)) + repr(_leaf_avals(b)))
    return hashlib.sha1(payload.encode()).hexdigest()[:16]


# ---- reports ----


def _paths(state, prefix=""):
    """(path, leaf) pairs in leaf order, paths written as JAX's keystr."""
    if isinstance(state, torch.Tensor):
        return [(prefix or ".", state)]
    if dataclasses.is_dataclass(state):
        out = []
        for f in dataclasses.fields(state):
            x = getattr(state, f.name)
            if isinstance(x, torch.Tensor) or dataclasses.is_dataclass(x) \
                    or isinstance(x, dict):
                out += _paths(x, f"{prefix}.{f.name}")
        return out
    if isinstance(state, dict):
        return [p for k, v in state.items() for p in _paths(v, f"{prefix}[{k!r}]")]
    return [p for i, v in enumerate(state) for p in _paths(v, f"{prefix}[{i}]")]


def summarize_state(state, max_elems: int = 24) -> Dict[str, str]:
    """Compact leaf-wise repr of one state for counterexample reports."""
    out: Dict[str, str] = {}
    for path, leaf in _paths(state):
        arr = leaf.detach().cpu().numpy()
        vals = arr.ravel()[:max_elems].tolist()
        text = f"{arr.dtype}{list(arr.shape)}:{vals}"
        if arr.size > max_elems:
            text += "..."
        out[path] = text
    return out


def _rows_equal(x, y, rows: int) -> np.ndarray:
    """Bitwise per-row equality of two stacked states (one host copy)."""
    eq = None
    for lx, ly in zip(leaves(x), leaves(y)):
        e = (lx.reshape(rows, -1) == ly.reshape(rows, -1)).all(dim=1)
        eq = e if eq is None else eq & e
    return eq.cpu().numpy()


def _first_bad(eq: np.ndarray) -> Optional[int]:
    bad = np.flatnonzero(~eq)
    return int(bad[0]) if bad.size else None


def _row(tree, r: int):
    return tree_map(lambda x: x[r], tree)


def _vmapped(fn):
    """``fn`` over n single states mapped over a leading axis of n stacked
    states (``torch.func.vmap`` over their leaves)."""
    def call(*states):
        shape = {}

        def flat(*xss):
            out = fn(*(joins._unflatten(s, xs) for s, xs in zip(states, xss)))
            shape["out"] = out
            return tuple(leaves(out)) if not isinstance(out, torch.Tensor) else out

        outs = torch.func.vmap(flat)(*(tuple(leaves(s)) for s in states))
        if isinstance(shape["out"], torch.Tensor):
            return outs
        return joins._unflatten(shape["out"], outs)

    return call


def _chunked(vfn, rows: int, *operands):
    """Apply a batched fn over stacked operands in bounded chunks."""
    if rows <= _CHUNK:
        return vfn(*operands)
    outs = []
    for lo in range(0, rows, _CHUNK):
        sel = np.arange(lo, min(lo + _CHUNK, rows))
        outs.append(vfn(*(gather(op, sel) for op in operands)))
    return tree_map(lambda *xs: torch.cat(xs), *outs)


def _law(holds: bool, space: int, counterexample=None) -> dict:
    entry = {"holds": bool(holds), "space": int(space)}
    if counterexample is not None:
        entry["counterexample"] = counterexample
    return entry


def _pair_ce(dom: Domain, ii, jj, r: int, lhs, rhs) -> dict:
    return {
        "a": summarize_state(dom.states[int(ii[r])]),
        "b": summarize_state(dom.states[int(jj[r])]),
        "lhs": summarize_state(_row(lhs, r)),
        "rhs": summarize_state(_row(rhs, r)),
    }


def check_laws(spec, dom: Domain, device=None) -> Dict[str, dict]:
    """The five-law sweep over a prebuilt domain.  Returns per-law
    {holds, space, counterexample?}."""
    n = len(dom.states)
    S = stack(dom.states)
    vjoin = batched_join(spec)
    laws: Dict[str, dict] = {}

    ii, jj = (m.ravel() for m in np.meshgrid(np.arange(n), np.arange(n), indexing="ij"))
    A, B = gather(S, ii), gather(S, jj)
    jab = vjoin(A, B)

    # commutative: join(a,b) == join(b,a)
    jba = vjoin(B, A)
    r = _first_bad(_rows_equal(jab, jba, n * n))
    laws["commutative"] = _law(
        r is None, n * n, None if r is None else _pair_ce(dom, ii, jj, r, jab, jba))

    # idempotent: join(a,a) == a
    jaa = vjoin(S, S)
    r = _first_bad(_rows_equal(jaa, S, n))
    laws["idempotent"] = _law(
        r is None, n,
        None if r is None else {
            "a": summarize_state(dom.states[r]),
            "lhs": summarize_state(_row(jaa, r)),
            "rhs": summarize_state(dom.states[r]),
        })

    # neutral: join(a,z) == a == join(z,a)
    if spec.neutral is None:
        laws["neutral"] = _law(True, 0)
        laws["neutral"]["skipped"] = "no neutral registered"
    else:
        Z = stack([spec.neutral(device=device)] * n)
        az = vjoin(S, Z)
        za = vjoin(Z, S)
        r = _first_bad(_rows_equal(az, S, n) & _rows_equal(za, S, n))
        laws["neutral"] = _law(
            r is None, n,
            None if r is None else {
                "a": summarize_state(dom.states[r]),
                "lhs": summarize_state(_row(az, r)),
                "rhs": summarize_state(dom.states[r]),
            })

    # associative over triples, reusing jab for both association orders,
    # in chunks of _CHUNK rows
    i3, j3, k3 = (m.ravel() for m in np.meshgrid(
        np.arange(n), np.arange(n), np.arange(n), indexing="ij"))
    rows3 = n * n * n
    bad3 = None
    for lo in range(0, rows3, _CHUNK):
        sel = np.arange(lo, min(lo + _CHUNK, rows3))
        left = vjoin(gather(jab, i3[sel] * n + j3[sel]), gather(S, k3[sel]))
        right = vjoin(gather(S, i3[sel]), gather(jab, j3[sel] * n + k3[sel]))
        r = _first_bad(_rows_equal(left, right, sel.size))
        if r is not None:
            bad3 = (int(sel[r]), summarize_state(_row(left, r)),
                    summarize_state(_row(right, r)))
            break
    laws["associative"] = _law(
        bad3 is None, rows3,
        None if bad3 is None else {
            "a": summarize_state(dom.states[int(i3[bad3[0]])]),
            "b": summarize_state(dom.states[int(j3[bad3[0]])]),
            "c": summarize_state(dom.states[int(k3[bad3[0]])]),
            "lhs": bad3[1],
            "rhs": bad3[2],
        })

    # inflationary: a ≤ join(a,b) and b ≤ join(a,b) in the
    # join-characterized order (x ≤ y iff join(x,y) == y)
    a_le = vjoin(A, jab)
    b_le = vjoin(B, jab)
    r = _first_bad(_rows_equal(a_le, jab, n * n) & _rows_equal(b_le, jab, n * n))
    laws["inflationary"] = _law(
        r is None, n * n, None if r is None else _pair_ce(dom, ii, jj, r, a_le, jab))
    return laws


# ---- combinator obligations ----


def _semidirect_obligations(spec, registry, cap: int, device) -> Dict[str, dict]:
    from crdt_tpu_torch.ops import algebra

    act = algebra.act_of(spec.name)
    if act is None:
        return {"act-laws": {
            "holds": False, "space": 0,
            "skipped": "no act registered in the algebra side table"}}
    a_spec = registry[spec.parts[0]]
    b_spec = registry[spec.parts[1]]
    # part domains capped tighter: the obligations sweep nA³ × nB rows
    dom_a = build_domain(a_spec, cap=min(cap, 12), device=device)
    dom_b = build_domain(b_spec, cap=min(cap, 12), device=device)
    na, nb = len(dom_a.states), len(dom_b.states)
    A, B = stack(dom_a.states), stack(dom_b.states)
    vact = _vmapped(act)
    vjoin_a = batched_join(a_spec)
    vjoin_b = batched_join(b_spec)
    out: Dict[str, dict] = {}

    # identity: act(f, f, x) == x
    fi, xi = (m.ravel() for m in np.meshgrid(np.arange(na), np.arange(nb), indexing="ij"))
    F, X = gather(A, fi), gather(B, xi)
    got = vact(F, F, X)
    r = _first_bad(_rows_equal(got, X, na * nb))
    out["act-identity"] = _law(
        r is None, na * nb,
        None if r is None else {
            "frame": summarize_state(dom_a.states[int(fi[r])]),
            "b": summarize_state(dom_b.states[int(xi[r])]),
            "lhs": summarize_state(_row(got, r)),
            "rhs": summarize_state(dom_b.states[int(xi[r])]),
        })

    # composition over join-generated monotone chains f1 ≤ f12 ≤ f123:
    # act(f123, f12, act(f12, f1, x)) == act(f123, f1, x)
    i3, j3, k3, x3 = (m.ravel() for m in np.meshgrid(
        np.arange(na), np.arange(na), np.arange(na), np.arange(nb), indexing="ij"))
    rows = i3.size
    F1 = gather(A, i3)
    F12 = _chunked(vjoin_a, rows, F1, gather(A, j3))
    F123 = _chunked(vjoin_a, rows, F12, gather(A, k3))
    X3 = gather(B, x3)
    step = _chunked(vact, rows, F12, F1, X3)
    lhs = _chunked(vact, rows, F123, F12, step)
    rhs = _chunked(vact, rows, F123, F1, X3)
    r = _first_bad(_rows_equal(lhs, rhs, rows))
    out["act-composition"] = _law(
        r is None, rows,
        None if r is None else {
            "f1": summarize_state(dom_a.states[int(i3[r])]),
            "b": summarize_state(dom_b.states[int(x3[r])]),
            "lhs": summarize_state(_row(lhs, r)),
            "rhs": summarize_state(_row(rhs, r)),
        })

    # join-homomorphism for f ≥ g (g = A[i], f = g ∨ A[j]):
    # act(f, g, x ∨ y) == act(f, g, x) ∨ act(f, g, y)
    gi, fj, xi2, yi2 = (m.ravel() for m in np.meshgrid(
        np.arange(na), np.arange(na), np.arange(nb), np.arange(nb), indexing="ij"))
    rows = gi.size
    G = gather(A, gi)
    F = _chunked(vjoin_a, rows, G, gather(A, fj))
    X2, Y2 = gather(B, xi2), gather(B, yi2)
    xy = _chunked(vjoin_b, rows, X2, Y2)
    lhs = _chunked(vact, rows, F, G, xy)
    rhs = _chunked(vjoin_b, rows, _chunked(vact, rows, F, G, X2),
                   _chunked(vact, rows, F, G, Y2))
    r = _first_bad(_rows_equal(lhs, rhs, rows))
    out["act-join-homomorphism"] = _law(
        r is None, rows,
        None if r is None else {
            "g": summarize_state(dom_a.states[int(gi[r])]),
            "x": summarize_state(dom_b.states[int(xi2[r])]),
            "y": summarize_state(dom_b.states[int(yi2[r])]),
            "lhs": summarize_state(_row(lhs, r)),
            "rhs": summarize_state(_row(rhs, r)),
        })
    return out


def _lexicographic_obligations(spec, registry, cap: int, device) -> Dict[str, dict]:
    from crdt_tpu_torch.ops import algebra

    rank = algebra.rank_of(spec.name)
    if rank is None:
        return {"rank-chain": {
            "holds": False, "space": 0,
            "skipped": "no rank registered in the algebra side table"}}
    a_spec = registry[spec.parts[0]]
    dom_a = build_domain(a_spec, cap=cap, device=device)
    na = len(dom_a.states)
    ranks = _vmapped(rank)(stack(dom_a.states)).cpu().numpy().reshape(na, -1)
    keys = [dom_mod.state_key(s) for s in dom_a.states]
    bad = None
    for i in range(na):
        for j in range(i + 1, na):
            if (ranks[i] == ranks[j]).all() and keys[i] != keys[j]:
                bad = (i, j)
                break
        if bad:
            break
    out = _law(
        bad is None, na * (na - 1) // 2,
        None if bad is None else {
            "a": summarize_state(dom_a.states[bad[0]]),
            "b": summarize_state(dom_a.states[bad[1]]),
            "rank": ranks[bad[0]].tolist(),
        })
    return {"rank-chain": out}


def combinator_obligations(spec, registry, cap: int = DEFAULT_CAP,
                           device=None) -> Dict[str, dict]:
    device = default_device(device)
    if spec.combinator == "semidirect":
        return _semidirect_obligations(spec, registry, cap, device)
    if spec.combinator == "lexicographic":
        return _lexicographic_obligations(spec, registry, cap, device)
    return {}


# ---- whole-spec verdict ----


def prove_spec(spec, registry=None, cap: int = DEFAULT_CAP, device=None) -> dict:
    """Blast one join: domain, five laws, combinator obligations, with
    the domain's states on ``device`` (None: the CUDA card).

    Returns the ledger entry body (verdict/laws/domain/obligations/...).
    The verdict is LOCAL (``proved`` / ``refuted`` / ``assumed`` from this
    join's own evidence); the ledger downgrades a composite's ``proved``
    to ``assumed`` when a part is not itself proved."""
    global _BLAST_CALLS
    _BLAST_CALLS += 1
    device = default_device(device)
    if registry is None:
        registry = joins.registered_joins()

    dom = build_domain(spec, cap=cap, device=device)
    if not dom.states:
        return {
            "verdict": "assumed",
            "reason": ("no domain: join registered neither small, rand, "
                       "nor neutral metadata"),
            "laws": {},
            "domain": {"states": 0, "closed": False, "source": dom.source},
            "obligations": {},
        }
    laws = check_laws(spec, dom, device)
    obligations = combinator_obligations(spec, registry, cap, device)

    refuted_laws = [k for k, v in laws.items() if not v["holds"]]
    refuted_obls = [k for k, v in obligations.items() if not v["holds"]]
    if refuted_laws or refuted_obls:
        verdict, reason = "refuted", None
    elif not dom.closed:
        verdict = "assumed"
        reason = (f"domain closure capped at {len(dom.states)} states "
                  f"(cap={cap}); all laws hold on the sampled subspace "
                  f"but it is not a closed sub-semilattice")
    else:
        verdict, reason = "proved", None

    entry: Dict[str, Any] = {
        "verdict": verdict,
        "laws": laws,
        "domain": {
            "states": len(dom.states),
            "closed": bool(dom.closed),
            "source": dom.source,
            "closure_rounds": dom.rounds,
        },
        "obligations": obligations,
    }
    if reason:
        entry["reason"] = reason
    if refuted_laws:
        entry["refuted_laws"] = refuted_laws
    if refuted_obls:
        entry["refuted_obligations"] = refuted_obls
    return entry
