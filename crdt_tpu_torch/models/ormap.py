"""OR-Map: observed-remove map composing a per-key value lattice
(counterpart of ``crdt_tpu.models.ormap``).

For a key space of size ``K`` and writer universe ``W``:

* presence = a batched observed-token plane (``flags.TokenPlane``):
  ``tok: int32[K, W]``, ``obs: int32[K, W, W]`` — an update drops a token
  for the key, a remove clears the tokens it has observed; ``contains`` =
  some token unobserved;
* values = the caller's value-lattice state with leading axis K; the map
  join is presence join × value join (a product lattice).

A removed key's value state is not reset (reset is not monotone): a
re-added key surfaces its accumulated value (``ormap_gc`` adds resets at
barriers).  Key and writer indices follow JAX's ``.at[]`` rules: an update
drops where the index is out of range after one wrap of a negative index
(:func:`crdt_tpu_torch.models.oplog.at_slot`), and :func:`get` clamps as
JAX's gather does.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from crdt_tpu_torch import default_device
from crdt_tpu_torch.models import flags
from crdt_tpu_torch.models.oplog import at_slot
from crdt_tpu_torch.utils.tree import tree_map


@dataclasses.dataclass
class ORMap:
    presence: flags.TokenPlane  # tok[K, W], obs[K, W, W]
    values: Any                 # value-lattice state, leading axis K

    @property
    def n_keys(self) -> int:
        return self.presence.tok.shape[-2]

    @property
    def n_writers(self) -> int:
        return self.presence.tok.shape[-1]


def empty(n_keys: int, n_writers: int, value_zero: Any, device=None) -> ORMap:
    """``value_zero``: ONE value-lattice instance (the join identity),
    broadcast across the key axis."""
    device = default_device(device)
    values = tree_map(
        lambda l: l.to(device)[None].expand((n_keys,) + l.shape).clone(), value_zero)
    return ORMap(presence=flags.plane_zero(n_writers, batch=(n_keys,), device=device),
                 values=values)


def _gather_slot(index, n: int) -> int:
    """The row ``x[index]`` of a JAX array with ``n`` rows reads: a negative
    index wraps once, then the index is clamped into range."""
    slot = int(index)
    if slot < 0:
        slot += n
    return min(max(slot, 0), n - 1)


def update(m: ORMap, key, writer, apply_fn: Callable[[Any], Any]) -> ORMap:
    """Mutate key ``key``: a fresh presence token for ``writer`` and
    ``apply_fn`` applied to that key's value instance (e.g.
    ``lambda v: pncounter.add(v, node, 5)``)."""
    k = at_slot(key, m.n_keys)
    if k is None:
        return m
    new_row = apply_fn(tree_map(lambda l: l[k], m.values))
    tok = m.presence.tok.clone()
    w = at_slot(writer, m.n_writers)
    if w is not None:
        tok[k, w] += 1

    def put(l, r):
        out = l.clone()
        out[k] = r
        return out

    return ORMap(presence=flags.TokenPlane(tok=tok, obs=m.presence.obs),
                 values=tree_map(put, m.values, new_row))


def remove(m: ORMap, key, writer) -> ORMap:
    """Observed-remove of ``key``: clears only the presence tokens this
    state has seen; a concurrent update survives the join (add-wins)."""
    k, w = at_slot(key, m.n_keys), at_slot(writer, m.n_writers)
    if k is None or w is None:
        return m
    obs = m.presence.obs.clone()
    obs[k, w, :] = m.presence.tok[k]
    return ORMap(presence=flags.TokenPlane(tok=m.presence.tok, obs=obs), values=m.values)


def contains(m: ORMap) -> torch.Tensor:
    """bool[K]: which keys are present (some update unobserved by every
    remove)."""
    return flags.plane_active(m.presence)


def get(m: ORMap, key) -> Any:
    """The value instance at ``key`` (meaningful when contains(m)[key])."""
    k = _gather_slot(key, m.n_keys)
    return tree_map(lambda l: l[k], m.values)


def join(a: ORMap, b: ORMap, value_join_batched: Callable) -> ORMap:
    """Product join: presence max-join × batched value join (the value
    joiner sees the whole [K, ...] plane)."""
    return ORMap(presence=flags.plane_join(a.presence, b.presence),
                 values=value_join_batched(a.values, b.values))


def joiner(value_join_batched: Callable) -> Callable:
    """A two-argument ORMap join closure (for engines that take
    ``join(a, b)``)."""
    return lambda a, b: join(a, b, value_join_batched)


def joiner_recorded(value_join_batched: Callable, path: str = "sort",
                    registry=None) -> Callable:
    """Like :func:`joiner`, but each host-level call lands on the
    ``union_path`` tally (``crdt_tpu_torch.ops.union_engine``) under
    ``path`` — the value join's engine."""
    from crdt_tpu_torch.ops import union_engine

    def _join(a, b):
        union_engine.record_union_path(path, registry=registry)
        return join(a, b, value_join_batched)

    return _join
