"""Compositional CRDT algebra: lattice combinators over the join registry
(counterpart of ``crdt_tpu.ops.algebra``).

New lattices are derived from registered parts:

* ``product(a, b)``        — componentwise join over a :class:`Pair`;
* ``lexicographic(a, b, rank)`` — the a-part dominates by a total-order
  rank key, b joins only on rank ties;
* ``mapof(inner)``         — add-wins keyed map of any registered lattice
  (the ormap presence token plane + the inner join over the key axis);
* ``semidirect(a, act, b)`` — b's state transported into the joined
  a-frame by ``act`` before joining.

Every combinator returns a **registered** :class:`~crdt_tpu_torch.ops.joins
.JoinSpec` whose neutral element and generator derive from its parts.
``structurally_commutative`` propagates as in the JAX package: product =
AND of the parts, mapof = the inner part's claim, lexicographic and
semidirect = False.  ``act`` must satisfy identity
(``act(f, f, b) == b``), composition along monotone frame chains and
join-homomorphism (tests/test_torch_algebra.py checks them on the
shipped instance).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Union

import torch

from crdt_tpu_torch.ops.joins import JoinSpec, batched, register_join, registered_joins
from crdt_tpu_torch.utils.tree import tree_map

# the act / rank callables a composite was built with, keyed by its name
_ACTS: Dict[str, Callable[[Any, Any, Any], Any]] = {}
_RANKS: Dict[str, Callable[[Any], Any]] = {}


def act_of(name: str) -> Optional[Callable[[Any, Any, Any], Any]]:
    """The ``act`` callable a semidirect composite was built with."""
    return _ACTS.get(name)


def rank_of(name: str) -> Optional[Callable[[Any], Any]]:
    """The ``rank`` callable a lexicographic composite was built with."""
    return _RANKS.get(name)


def resolve(spec: Union[JoinSpec, str]) -> JoinSpec:
    """A registered JoinSpec, from itself or its registry name."""
    if isinstance(spec, JoinSpec):
        return spec
    registry = registered_joins()
    if spec not in registry:
        raise KeyError(f"no registered join named {spec!r}; known: {sorted(registry)}")
    return registry[spec]


def _tree_select(cond, x, y):
    """State-wide ``torch.where`` (``cond`` broadcasts against every leaf)."""
    return tree_map(lambda u, v: torch.where(cond, u, v), x, y)


def _derived_rand(build: Callable, *parts: JoinSpec):
    """Compose part generators into a composite generator; None if any
    part registered none."""
    if any(p.rand is None for p in parts):
        return None
    return build


def _pair_parts(a: JoinSpec, b: JoinSpec):
    """The (neutral, rand, example) of a Pair-shaped composite."""
    from crdt_tpu_torch.models.composite import Pair

    neutral = None
    if a.neutral is not None and b.neutral is not None:
        def neutral(device=None):
            return Pair(fst=a.neutral(device=device), snd=b.neutral(device=device))

    def rand(rng, device=None) -> Pair:
        return Pair(fst=a.rand(rng, device=device), snd=b.rand(rng, device=device))

    def example(device=None):
        (xa, ya), (xb, yb) = a.example(device=device), b.example(device=device)
        return Pair(fst=xa, snd=xb), Pair(fst=ya, snd=yb)

    return neutral, _derived_rand(rand, a, b), example


# ---- product ----


def product(a: Union[JoinSpec, str], b: Union[JoinSpec, str], *,
            name: Optional[str] = None) -> JoinSpec:
    """Componentwise product lattice over a :class:`Pair` of the parts."""
    from crdt_tpu_torch.models.composite import Pair

    a, b = resolve(a), resolve(b)
    name = name or f"product({a.name},{b.name})"
    join_a, join_b = a.join, b.join

    def join(x: Pair, y: Pair) -> Pair:
        return Pair(fst=join_a(x.fst, y.fst), snd=join_b(x.snd, y.snd))

    neutral, rand, example = _pair_parts(a, b)
    return register_join(
        name, join, example,
        structurally_commutative=a.structurally_commutative and b.structurally_commutative,
        neutral=neutral, rand=rand, parts=(a.name, b.name), combinator="product",
    )


# ---- lexicographic ----


def lexicographic(a: Union[JoinSpec, str], b: Union[JoinSpec, str],
                  rank: Callable[[Any], Any], *, name: Optional[str] = None) -> JoinSpec:
    """Lexicographic composition: the side with the greater ``rank`` of its
    a-part is taken whole; only on rank ties do both parts join.  The
    a-part must be a chain under ``rank`` over reachable states (lww's
    packed (ts, rid) key is the canonical instance)."""
    from crdt_tpu_torch.models.composite import Pair

    a, b = resolve(a), resolve(b)
    name = name or f"lexicographic({a.name},{b.name})"
    join_a, join_b = a.join, b.join

    def join(x: Pair, y: Pair) -> Pair:
        kx, ky = rank(x.fst), rank(y.fst)
        x_dom, y_dom = kx > ky, ky > kx
        fst = _tree_select(x_dom, x.fst, _tree_select(y_dom, y.fst, join_a(x.fst, y.fst)))
        snd = _tree_select(x_dom, x.snd, _tree_select(y_dom, y.snd, join_b(x.snd, y.snd)))
        return Pair(fst=fst, snd=snd)

    neutral, rand, example = _pair_parts(a, b)
    spec = register_join(
        name, join, example, structurally_commutative=False,
        neutral=neutral, rand=rand, parts=(a.name, b.name), combinator="lexicographic",
    )
    _RANKS[name] = rank
    return spec


# ---- mapof ----


def mapof(inner: Union[JoinSpec, str], *, n_keys: int = 4, n_writers: int = 4,
          name: Optional[str] = None) -> JoinSpec:
    """Add-wins keyed map of any registered lattice: an
    :class:`~crdt_tpu_torch.models.ormap.ORMap` whose join is the presence
    plane join × the inner join over the key axis (the inner spec's
    batched form).  The join is shape-generic; ``n_keys``/``n_writers``
    size only the neutral and generated states."""
    from crdt_tpu_torch.models import flags, ormap

    inner = resolve(inner)
    name = name or f"mapof({inner.name})"
    value_join_batched = inner.batched or batched(inner.join)

    def join(x, y):
        return ormap.join(x, y, value_join_batched)

    neutral = None
    if inner.neutral is not None:
        def neutral(device=None):
            return ormap.empty(n_keys, n_writers, inner.neutral(device=device), device=device)

    def rand(rng, device=None):
        from crdt_tpu_torch.ops.randstate import _i32

        vals = [inner.rand(rng, device=device) for _ in range(n_keys)]
        values = tree_map(lambda *xs: torch.stack(xs), *vals)
        presence = flags.TokenPlane(
            tok=_i32(rng, -1, 4, (n_keys, n_writers), device),
            obs=_i32(rng, -1, 4, (n_keys, n_writers, n_writers), device),
        )
        return ormap.ORMap(presence=presence, values=values)

    return register_join(
        name, join,
        structurally_commutative=inner.structurally_commutative,
        neutral=neutral, rand=_derived_rand(rand, inner), parts=(inner.name,),
        combinator="mapof",
    )


# ---- semidirect ----


def semidirect(a: Union[JoinSpec, str], act: Callable[[Any, Any, Any], Any],
               b: Union[JoinSpec, str], *, name: Optional[str] = None) -> JoinSpec:
    """Semidirect product: ``join((xa, xb), (ya, yb)) = (za, join_b(act(za,
    xa, xb), act(za, ya, yb)))`` with ``za = join_a(xa, ya)`` — each side's
    b-state transported from its own frame into the joined frame before
    the b-join.  The epoch-reset counter
    (:func:`crdt_tpu_torch.models.composite.reset_act`) is the shipped
    instance."""
    from crdt_tpu_torch.models.composite import Pair

    a, b = resolve(a), resolve(b)
    name = name or f"semidirect({a.name},{b.name})"
    join_a, join_b = a.join, b.join

    def join(x: Pair, y: Pair) -> Pair:
        za = join_a(x.fst, y.fst)
        zb = join_b(act(za, x.fst, x.snd), act(za, y.fst, y.snd))
        return Pair(fst=za, snd=zb)

    neutral, rand, example = _pair_parts(a, b)
    spec = register_join(
        name, join, example, structurally_commutative=False,
        neutral=neutral, rand=rand, parts=(a.name, b.name), combinator="semidirect",
    )
    _ACTS[name] = act
    return spec
