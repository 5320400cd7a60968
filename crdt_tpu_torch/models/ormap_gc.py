"""OR-Map GC: reclaim the accumulated state of stably removed keys
(counterpart of ``crdt_tpu.models.ormap_gc``).

A GC barrier upgrades the map to reset-on-stable-remove: a key whose
removal every member has converged on is reset wholesale — presence planes
to empty, value row to the caller's zero — and a key re-added afterwards
starts fresh.  Without barriers nothing changes.

* **Full-fleet barriers only**: a reset is minted only when every replica
  is alive and converged (any dead replica makes the barrier a no-op).
* **Per-key epochs, reset-wins**: ``epoch[k]`` counts resets; the join is
  the lexicographic product (epoch, planes): the higher epoch wins the key
  wholesale, equal epochs join planes elementwise.  An update minted on a
  state that had not yet learned of an agreed reset loses to it.

Functions take a single map or leading replica axes alike (a ``[K]``
mask broadcasts over a key's planes).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Tuple

import torch

from crdt_tpu_torch import default_device
from crdt_tpu_torch.models import flags, ormap
from crdt_tpu_torch.utils.tree import leaves, tree_map


@dataclasses.dataclass
class MapGc:
    """An ORMap plus its per-key reset epoch."""

    map: ormap.ORMap
    epoch: torch.Tensor  # int32[K]  resets folded into this key (monotone)

    @property
    def n_keys(self) -> int:
        return self.map.n_keys

    @property
    def n_writers(self) -> int:
        return self.map.n_writers


def wrap(m: ormap.ORMap, device=None) -> MapGc:
    """Wrap a map with every key at epoch 0 (the map moves to ``device``)."""
    device = default_device(device)
    return MapGc(map=tree_map(lambda x: x.to(device), m),
                 epoch=torch.zeros((m.n_keys,), dtype=torch.int32, device=device))


def _sel(mask: torch.Tensor, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Per-key select: broadcast a [..., K] mask over [..., K, ...] planes."""
    return torch.where(mask.reshape(mask.shape + (1,) * (x.dim() - mask.dim())), x, y)


def join(a: MapGc, b: MapGc, value_join_batched: Callable) -> MapGc:
    """Epoch-guarded product join: per key, the higher epoch wins
    wholesale; equal epochs join planes elementwise."""
    j = ormap.join(a.map, b.map, value_join_batched)
    eq = a.epoch == b.epoch
    ta = a.epoch > b.epoch

    def pick(xa, xb, xj):
        return _sel(eq, xj, _sel(ta, xa, xb))

    presence = flags.TokenPlane(
        tok=pick(a.map.presence.tok, b.map.presence.tok, j.presence.tok),
        obs=pick(a.map.presence.obs, b.map.presence.obs, j.presence.obs),
    )
    values = tree_map(pick, a.map.values, b.map.values, j.values)
    return MapGc(map=ormap.ORMap(presence=presence, values=values),
                 epoch=torch.maximum(a.epoch, b.epoch))


def joiner(value_join_batched: Callable) -> Callable:
    return lambda a, b: join(a, b, value_join_batched)


# ---- passthroughs (the MapGc is an ORMap plus bookkeeping) ----


def update(g: MapGc, key, writer, apply_fn: Callable) -> MapGc:
    return MapGc(map=ormap.update(g.map, key, writer, apply_fn), epoch=g.epoch)


def remove(g: MapGc, key, writer) -> MapGc:
    return MapGc(map=ormap.remove(g.map, key, writer), epoch=g.epoch)


def contains(g: MapGc) -> torch.Tensor:
    return ormap.contains(g.map)


def get(g: MapGc, key) -> Any:
    return ormap.get(g.map, key)


# ---- the reset barrier ----


def reset_keys(g: MapGc, keys_mask: torch.Tensor, value_zero: Any) -> MapGc:
    """Reset the masked keys to pristine: presence planes emptied, value
    rows to ``value_zero``, epoch bumped.  Callers go through
    :func:`reset_barrier`."""
    m = g.map
    presence = flags.TokenPlane(
        tok=_sel(keys_mask, torch.full_like(m.presence.tok, -1), m.presence.tok),
        obs=_sel(keys_mask, torch.full_like(m.presence.obs, -1), m.presence.obs),
    )
    values = tree_map(lambda z, l: _sel(keys_mask, z.to(l.device).expand(l.shape), l),
                      value_zero, m.values)
    return MapGc(map=ormap.ORMap(presence=presence, values=values),
                 epoch=g.epoch + keys_mask.to(torch.int32))


def reset_barrier(sw, value_join_batched: Callable, value_zero: Any) -> Tuple[Any, int]:
    """One swarm-wide reset barrier over a Swarm of batched MapGc states.

    Full-fleet rule: if ANY replica is dead the barrier is a no-op
    (returns ``(sw, 0)``).  Otherwise converge everyone through the
    epoch-guarded join, reset every key removed in the converged state
    that has history, bump its epoch, and broadcast the result to the
    whole fleet.  Returns (swarm, n_reset)."""
    if not bool(sw.alive.all()):
        return sw, 0
    r = leaves(sw.state)[0].shape[0]
    acc = tree_map(lambda x: x[0], sw.state)
    for i in range(1, r):
        acc = join(acc, tree_map(lambda x, _i=i: x[_i], sw.state), value_join_batched)
    had_history = (acc.map.presence.tok > -1).any(dim=-1)
    removed = had_history & ~ormap.contains(acc.map)
    n_reset = int(removed.sum())
    top = reset_keys(acc, removed, value_zero)
    state = tree_map(lambda t: t[None].expand((r,) + t.shape).clone(), top)
    return dataclasses.replace(sw, state=state), n_reset
