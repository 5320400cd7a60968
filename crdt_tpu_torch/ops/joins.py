"""Join combinators and the join registry (counterpart of
``crdt_tpu.ops.joins``).

* ``batched(join)`` — a single-instance pairwise join mapped over a
  leading replica axis (``torch.func.vmap`` where JAX uses ``jax.vmap``);
* ``tree_reduce_join`` / ``converge`` — log-depth reduction of a stacked
  swarm to the least upper bound of every replica's state;
* the registry — every lattice join the package ships, with its neutral
  element, a reachable-state generator (``crdt_tpu_torch.ops.randstate``),
  the parts and combinator of a composite (``crdt_tpu_torch.ops.algebra``)
  and, where ``batched`` cannot serve (a kernel call does not run under
  vmap), the join over stacked states.  ``JoinSpec.verified`` is None
  until the port's crdtprove ledger
  (``crdt_tpu_torch/analysis/verdicts.json``) is consulted, then True iff
  every lattice law is ``proved`` for the join (:func:`verified_joins`).

Every ``neutral``, ``rand``, ``small`` and ``example`` of a spec takes
``device=None`` (the CUDA card), like every constructor of the port.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple, Union

import torch

from crdt_tpu_torch.utils.tracing import trace_region
from crdt_tpu_torch.utils.tree import leaves, tree_map


def _unflatten(template: Any, xs) -> Any:
    """``template``'s structure (and static fields) with the leaves ``xs``."""
    it = iter(xs)
    return tree_map(lambda _: next(it), template)


def batched(join_fn: Callable) -> Callable:
    """Map a single-instance pairwise join over a leading replica axis
    (``torch.func.vmap`` over the states' tensor leaves)."""

    def call(a, b):
        shape = {}

        def flat(xs, ys):
            out = join_fn(_unflatten(a, xs), _unflatten(b, ys))
            shape["out"] = out
            return tuple(leaves(out))

        outs = torch.func.vmap(flat)(tuple(leaves(a)), tuple(leaves(b)))
        return _unflatten(shape["out"], outs)

    return call


def donating(join_fn: Callable, argnums=(0,)) -> Callable:
    """JAX's donating jit lets XLA write a join's result into a donated
    operand's buffer.  Torch has no buffer donation and the port's joins
    are eager, so this is ``join_fn`` itself: the same results, and a
    caller's operands stay usable."""
    del argnums
    return join_fn


def _leading_dim(state: Any) -> int:
    return leaves(state)[0].shape[0]


def pad_to_pow2(state: Any, neutral: Any) -> Any:
    """Pad the leading replica axis up to a power of two with copies of the
    join identity element `neutral` (a single-instance state)."""
    r = _leading_dim(state)
    p = 1
    while p < r:
        p *= 2
    if p == r:
        return state
    return tree_map(
        lambda x, n: torch.cat([x, n[None].expand((p - r,) + n.shape)], dim=0),
        state,
        neutral,
    )


def _as_batched_join_and_neutral(join_fn, neutral, device):
    """Resolve the (batched join, neutral) pair the reductions
    consume: ``join_fn`` is a bare batched callable (``neutral`` then
    required), a :class:`JoinSpec` or a registered join name (the batched
    join and the neutral, on ``device``, come from the registry)."""
    if isinstance(join_fn, str):
        registry = registered_joins()
        if join_fn not in registry:
            raise KeyError(f"no registered join named {join_fn!r}; known: {sorted(registry)}")
        join_fn = registry[join_fn]
    if isinstance(join_fn, JoinSpec):
        spec = join_fn
        if neutral is None:
            if spec.neutral is None:
                raise ValueError(f"join {spec.name!r} registered no neutral element; "
                                 "pass one explicitly")
            neutral = spec.neutral(device=device)
        return spec.batched or batched(spec.join), neutral
    if neutral is None:
        raise ValueError(
            "neutral is required when join_fn is a bare callable; pass a JoinSpec or "
            "registered name to derive it from the registry")
    return join_fn, neutral


def tree_reduce_join(join_fn: Union[Callable, "JoinSpec", str], state: Any,
                     neutral: Any = None) -> Any:
    """Reduce a stacked swarm state (leading axis = replicas) to the join of
    all replicas, in log2(R) batched join steps.  ``join_fn`` joins two
    stacked states (with an explicit single-instance ``neutral``), or is a
    :class:`JoinSpec` / registered join name."""
    join_fn, neutral = _as_batched_join_and_neutral(join_fn, neutral,
                                                    leaves(state)[0].device)
    with trace_region("crdt.tree_reduce_join"):
        state = pad_to_pow2(state, neutral)
        p = _leading_dim(state)
        while p > 1:
            p //= 2
            lo = tree_map(lambda x: x[:p], state)
            hi = tree_map(lambda x: x[p : 2 * p], state)
            state = join_fn(lo, hi)
        return tree_map(lambda x: x[0], state)


def converge(join_fn: Union[Callable, "JoinSpec", str], state: Any,
             neutral: Any = None) -> Any:
    """Drive every replica to the swarm-wide least upper bound (the gossip
    loop's fixpoint).  Accepts the forms of :func:`tree_reduce_join`."""
    r = _leading_dim(state)
    top = tree_reduce_join(join_fn, state, neutral)
    return tree_map(lambda t: t[None].expand((r,) + t.shape).clone(), top)


# ---- the join registry ----


@dataclasses.dataclass(frozen=True)
class JoinSpec:
    """One registered lattice join: the function, an example-operand
    factory, its claims, the neutral element, a reachable-state generator
    (np rng in, state out), the parts and combinator of a composite, a
    deterministic list of tiny seed states, and — the port's own field —
    ``batched``, the join over stacked states where :func:`batched` of
    the single-instance join cannot serve (None: it can)."""

    name: str
    join: Callable
    example: Callable[..., Tuple[Any, Any]]
    structurally_commutative: bool = False
    neutral: Optional[Callable[..., Any]] = None
    rand: Optional[Callable[..., Any]] = None
    parts: Tuple[str, ...] = ()
    small: Optional[Callable[..., Any]] = None
    combinator: str = ""
    verified: Optional[bool] = dataclasses.field(default=None, compare=False)
    batched: Optional[Callable] = dataclasses.field(default=None, compare=False)


_JOIN_REGISTRY: Dict[str, JoinSpec] = {}
_BUILTINS_REGISTERED = False


def register_join(name: str, join_fn: Callable,
                  example: Optional[Callable[..., Tuple[Any, Any]]] = None, *,
                  structurally_commutative: bool = False,
                  neutral: Optional[Callable[..., Any]] = None,
                  rand: Optional[Callable[..., Any]] = None,
                  parts: Tuple[str, ...] = (),
                  small: Optional[Callable[..., Any]] = None,
                  combinator: str = "",
                  batched: Optional[Callable] = None) -> JoinSpec:
    """Register a lattice join.  ``example`` builds an (a, b) operand pair;
    omitted, it is a pair of ``neutral`` elements (one of the two must be
    given)."""
    if example is None:
        if neutral is None:
            raise ValueError(f"register_join({name!r}) needs an example factory or a "
                             "neutral to derive one from")

        def example(device=None):
            return neutral(device=device), neutral(device=device)
    spec = JoinSpec(name=name, join=join_fn, example=example,
                    structurally_commutative=structurally_commutative,
                    neutral=neutral, rand=rand, parts=tuple(parts), small=small,
                    combinator=combinator, batched=batched)
    _JOIN_REGISTRY[name] = spec
    return spec


def mark_verified(name: str, verified: bool) -> None:
    """Stamp a registered join's ``verified`` field from the crdtprove
    ledger (``crdt_tpu_torch.analysis.verify.ledger.annotate_registry`` is
    the only intended caller: ops stays free of analysis imports, and the
    analysis layer pushes its verdicts in)."""
    spec = _JOIN_REGISTRY.get(name)
    if spec is not None:
        object.__setattr__(spec, "verified", bool(verified))


def verified_joins() -> Dict[str, JoinSpec]:
    """Name → JoinSpec for every registered join whose lattice laws are
    ``proved`` in the port's committed crdtprove ledger
    (``crdt_tpu_torch/analysis/verdicts.json``) with a fingerprint that
    still matches the live join.  The stability-frontier GC and
    strong-read layers should draw joins from here."""
    from crdt_tpu_torch.analysis.verify import ledger

    registry = registered_joins()
    ledger.annotate_registry()
    return {n: s for n, s in registry.items() if s.verified}


def registered_joins() -> Dict[str, JoinSpec]:
    """Name → JoinSpec for every join the package exports (the builtins
    register on first access; the imports are deferred to dodge the
    ops ↔ models import cycle)."""
    _register_builtin_joins()
    return dict(_JOIN_REGISTRY)


def _columnar_bucketed(a, b):
    """orset_bucketed's join over stacked [R, C] states: the replicas are
    the lanes of one bucketed union (kernel 3 on a CUDA state)."""
    from crdt_tpu_torch.models import orset
    from crdt_tpu_torch.ops import hopper_union

    if a.n_buckets != b.n_buckets or a.keys.shape != b.keys.shape:
        raise ValueError("bucketed join needs equal layouts")
    ko, vo, _, _ = hopper_union.bucketed_union_columnar(
        *(x.T.contiguous() for x in (a.keys, a.removed, b.keys, b.removed)),
        n_buckets=a.n_buckets)
    return orset.ORSetBucketed(keys=ko.T.contiguous(), removed=vo.T.contiguous(),
                               n_buckets=a.n_buckets, key_bits=a.key_bits)


def _register_builtin_joins() -> None:
    global _BUILTINS_REGISTERED
    if _BUILTINS_REGISTERED:
        return
    _BUILTINS_REGISTERED = True

    from crdt_tpu_torch.consistency import vvclock
    from crdt_tpu_torch.models import (
        compactlog,
        flags,
        gcounter,
        gset,
        lww,
        mvregister,
        oplog,
        orset,
        pncounter,
        rseq,
    )
    from crdt_tpu_torch.ops import randstate as rs

    def seeded(rand_fn, fill):
        return lambda device=None: rs.small_seeded(rand_fn, fill=fill, device=device)

    register_join("gcounter", gcounter.join,
                  neutral=lambda device=None: gcounter.zero(8, device=device),
                  rand=rs.rand_gcounter, small=rs.small_gcounter,
                  structurally_commutative=True)
    register_join("pncounter", pncounter.join,
                  neutral=lambda device=None: pncounter.zero(8, device=device),
                  rand=rs.rand_pncounter, small=rs.small_pncounter,
                  structurally_commutative=True)
    register_join("vvclock", vvclock.join,
                  neutral=lambda device=None: vvclock.zero(8, device=device),
                  rand=rs.rand_vvclock, small=rs.small_vvclock,
                  structurally_commutative=True)
    register_join("lww", lww.join, neutral=lambda device=None: lww.zero(device=device),
                  rand=rs.rand_lww, small=rs.small_lww)
    register_join("lww_packed", lww.join_packed,
                  neutral=lambda device=None: lww.pack(lww.zero(device=device)),
                  rand=rs.rand_lww_packed, small=rs.small_lww_packed)
    register_join("mvregister", mvregister.join,
                  neutral=lambda device=None: mvregister.zero(4, device=device),
                  rand=rs.rand_mvregister)
    register_join("token_plane", flags.plane_join,
                  neutral=lambda device=None: flags.plane_zero(4, device=device),
                  rand=rs.rand_token_plane, structurally_commutative=True)
    register_join("ew_flag", flags.ew_join,
                  neutral=lambda device=None: flags.ew_zero(4, device=device),
                  rand=rs.rand_ew_flag, structurally_commutative=True)
    register_join("dw_flag", flags.dw_join,
                  neutral=lambda device=None: flags.dw_zero(4, device=device),
                  rand=rs.rand_dw_flag, structurally_commutative=True)
    register_join("gset", gset.g_join,
                  neutral=lambda device=None: gset.g_empty(16, device=device),
                  rand=rs.rand_gset, small=rs.small_gset)
    register_join("twopset", gset.tp_join,
                  neutral=lambda device=None: gset.tp_empty(16, device=device),
                  rand=rs.rand_twopset, small=rs.small_twopset)
    # sorted fixed-capacity family: small = fixed-seed draws at a fill
    # tight enough that the union of all seeds stays within capacity
    register_join("orset", orset.join,
                  neutral=lambda device=None: orset.empty(16, device=device),
                  rand=rs.rand_orset, small=seeded(rs.rand_orset, 2))
    register_join("orset_bitmap", orset.bitmap_join,
                  neutral=lambda device=None: orset.bitmap_empty(64, device=device),
                  rand=rs.rand_orset_bitmap, small=rs.small_orset_bitmap,
                  structurally_commutative=True)
    register_join("orset_bucketed", orset.bucketed_join,
                  neutral=lambda device=None: orset.bucketed_empty(32, 4, key_bits=8,
                                                                   device=device),
                  rand=rs.rand_orset_bucketed, small=seeded(rs.rand_orset_bucketed, 1),
                  # a kernel call cannot run under vmap: the stacked states
                  # go to the kernel as lanes instead
                  batched=_columnar_bucketed)
    register_join("rseq", rseq.join,
                  neutral=lambda device=None: rseq.empty(16, device=device),
                  rand=rs.rand_rseq, small=seeded(rs.rand_rseq, 2))
    register_join("oplog", oplog.merge,
                  neutral=lambda device=None: oplog.empty(32, device=device),
                  rand=rs.rand_oplog, small=seeded(rs.rand_oplog, 3))
    register_join("compactlog", compactlog.merge,
                  neutral=lambda device=None: compactlog.empty(32, 8, 4, device=device),
                  rand=rs.rand_compactlog, small=seeded(rs.rand_compactlog, 3))

    # the derived composites register through the combinator layer (same
    # late import as the leaf models)
    from crdt_tpu_torch.models import composite

    composite.register_builtin_composites()
