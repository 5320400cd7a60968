"""Anti-entropy swarm engine: N replicas as tensor rows on one card
(counterpart of ``crdt_tpu.parallel.swarm``).

The reference runs 5 replicas in one OS process, each pulling a random
peer's full state every 1500 ms and merging.  Here a swarm is a *stacked
lattice state* (leading axis = replicas); one gossip round is a gather +
batched join, and full convergence is a log-depth tree reduction.

Fault model (reference parity): an ``alive`` mask gates participation — a
dead replica neither serves gossip (the puller skips it) nor pulls; a
revived replica catches up in one round because gossip ships full state.

Where the JAX package vmaps a single-replica function over the swarm
(``compaction_round``'s callables), the port's take the batched state.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from crdt_tpu_torch import default_device
from crdt_tpu_torch.ops import joins
from crdt_tpu_torch.utils.tree import leaves, tree_map


@dataclasses.dataclass
class Swarm:
    state: Any            # every tensor leaf has leading axis R (replicas)
    alive: torch.Tensor   # bool[R]


def make(state: Any, alive: torch.Tensor | None = None) -> Swarm:
    first = leaves(state)[0]
    if alive is None:
        alive = torch.ones((first.shape[0],), dtype=torch.bool, device=first.device)
    return Swarm(state=state, alive=alive)


def n_replicas(s: Swarm) -> int:
    return s.alive.shape[0]


def set_alive(s: Swarm, rid, alive_status) -> Swarm:
    """Failure injection / recovery — the reference's /condition
    capability, with its routing bug fixed."""
    alive = s.alive.clone()
    alive[rid] = alive_status
    return dataclasses.replace(s, alive=alive)


def random_peers(generator: torch.Generator, r: int, include_self: bool = False,
                 device=None) -> torch.Tensor:
    """Uniform random peer choice per replica, drawn from ``generator`` and
    returned on ``device`` (None: the CUDA card).  With include_self=True
    the draw is uniform over all r replicas (the reference's friend list
    includes self; self-gossip is a harmless no-op join); with
    include_self=False it is uniform over the r-1 others (a random offset
    in [1, r) from the replica's own index).  The bits differ from
    ``jax.random``'s: tests feed both packages the same numpy-drawn
    peers."""
    device = default_device(device)
    gdev = generator.device
    if include_self:
        peers = torch.randint(0, r, (r,), generator=generator, device=gdev)
    else:
        offsets = torch.randint(1, r, (r,), generator=generator, device=gdev)
        peers = (torch.arange(r, device=gdev) + offsets) % r
    return peers.to(device)


def _alive_mask(alive: torch.Tensor, leaf: torch.Tensor) -> torch.Tensor:
    return alive.reshape((-1,) + (1,) * (leaf.dim() - 1))


def mask_dead_with_neutral(state: Any, alive: torch.Tensor, neutral: Any) -> Any:
    """Replace dead replicas' rows with the join identity so they contribute
    nothing to a reduction (the skip of an unreachable peer)."""
    return tree_map(
        lambda x, n: torch.where(_alive_mask(alive, x), x, n[None].expand(x.shape)),
        state,
        neutral,
    )


def alive_lub(state: Any, alive: torch.Tensor, join_batched: Callable, neutral: Any) -> Any:
    """Least upper bound of the alive replicas' states (single-instance)."""
    masked = mask_dead_with_neutral(state, alive, neutral)
    return joins.tree_reduce_join(join_batched, masked, neutral)


def broadcast_where_alive(state: Any, alive: torch.Tensor, top: Any) -> Any:
    """Set every alive replica's row to `top`; dead rows keep their state."""
    return tree_map(
        lambda t, x: torch.where(_alive_mask(alive, x), t[None].expand(x.shape), x),
        top,
        state,
    )


def gossip_round(s: Swarm, peers: torch.Tensor, join_batched: Callable) -> Swarm:
    """One pull round: replica i fetches peers[i]'s full state and joins it.

    `join_batched` joins two stacked states ([R, ...] x [R, ...] -> [R, ...]).
    Joins are gated on both endpoints being alive (dead peer -> skipped
    pull; dead puller -> no merge)."""
    peers = peers.to(device=s.alive.device, dtype=torch.long)
    peer_state = tree_map(lambda x: x[peers], s.state)
    joined = join_batched(s.state, peer_state)
    ok = s.alive & s.alive[peers]
    state = tree_map(
        lambda j, x: torch.where(_alive_mask(ok, j), j, x), joined, s.state
    )
    return dataclasses.replace(s, state=state)


def converge(s: Swarm, join_batched: Callable, neutral: Any) -> Swarm:
    """Drive all *alive* replicas to the least upper bound of alive states
    in one call (the gossip fixpoint).  Dead replicas contribute nothing
    and keep their stale state; `neutral` is the single-instance join
    identity."""
    top = alive_lub(s.state, s.alive, join_batched, neutral)
    return dataclasses.replace(s, state=broadcast_where_alive(s.state, s.alive, top))


def stable_frontier(received: torch.Tensor, alive: torch.Tensor,
                    frontiers: torch.Tensor | None = None) -> torch.Tensor:
    """The swarm's stable frontier: elementwise min over the *alive*
    replicas' received version vectors (``received``: int32[R, W]).  Every
    op at or under it is held by every alive replica.  Dead replicas'
    knowledge is excluded (an op only they hold is above every alive
    watermark for its writer).

    ``frontiers`` (int32[R, W], every replica's current folded watermark,
    dead included) enforces the chain rule: the new barrier must dominate
    every existing fold, else the result is all -1 (fold nothing this
    round).  With no alive replicas the frontier is likewise -1."""
    masked = torch.where(alive[:, None], received, 2**31 - 1)
    f = masked.amin(dim=0)
    ok = alive.any()
    if frontiers is not None:
        ok &= (f >= frontiers.amax(dim=0)).all()
    return torch.where(ok, f, -1).to(torch.int32)


def compaction_round(s: Swarm, received_vv: Callable, compact: Callable,
                     frontier_of: Callable) -> Swarm:
    """One swarm-wide compaction barrier: agree on the stable frontier and
    have every alive replica fold exactly that op set.

    The callables take the batched state (leading axis = replicas):
    ``received_vv`` -> int32[R, W]; ``compact(state, frontier[W])`` ->
    state; ``frontier_of`` -> every replica's current int32[R, W] folded
    watermark (the chain-rule input of :func:`stable_frontier`).  Dead
    replicas keep their state (and their old frontier)."""
    frontier = stable_frontier(received_vv(s.state), s.alive, frontier_of(s.state))
    folded = compact(s.state, frontier)
    state = tree_map(
        lambda f, x: torch.where(_alive_mask(s.alive, f), f, x), folded, s.state
    )
    return dataclasses.replace(s, state=state)


def n_diverged(s: Swarm, join_batched: Callable, neutral: Any) -> torch.Tensor:
    """Convergence-lag metric: how many alive replicas are NOT yet at the
    swarm-wide least upper bound (0 = converged)."""
    top = alive_lub(s.state, s.alive, join_batched, neutral)
    all_eq = torch.ones_like(s.alive)
    for x, t in zip(leaves(s.state), leaves(top)):
        eq = x == t[None].expand(x.shape)
        all_eq &= eq.reshape(eq.shape[0], -1).all(dim=1)
    return (s.alive & ~all_eq).sum(dtype=torch.int32)
