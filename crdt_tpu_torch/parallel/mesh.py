"""Multi-device anti-entropy over ``torch.distributed`` (counterpart of
``crdt_tpu.parallel.mesh``).

The JAX package is single-controller: one process drives a device mesh
and ``shard_map`` runs the per-device program with XLA collectives.  The
port takes PyTorch's SPMD idiom instead: one process per card, each
holding its own shard of the replica axis, with collectives over a
``torch.distributed`` process group (NCCL on cards, gloo for the CPU
rehearsal).  Every function here is called by every rank of the mesh with
its own shard, and returns that rank's shard of the result.

* max-lattices (G/PN-Counter): the local masked max, then one
  ``all_reduce(MAX)`` (:func:`pmax_converge`);
* arbitrary lattices (OR-Set, OpLog): a power-of-two mesh runs JAX's
  XOR-partner butterfly, log2(P) rounds of ``batch_isend_irecv`` pairs
  each followed by ``join(x, y)``; any other size ``all_gather`` s and
  tree-reduces the rows in rank order (:func:`allreduce_join`), so every
  intermediate state equals JAX's.

With no process group initialised, :func:`make_mesh` gives a one-rank
mesh whose collectives are identities: JAX's single-process mesh of one
device.  A world of 1 has a group, and its collectives run through the
backend.

The gloo path.  gloo's support for CUDA tensors covers only some
collectives (its point-to-point ops abort with "Bad address" on an H100
machine), so on a gloo mesh every collective stages its CUDA tensors
through host memory explicitly (:func:`_host_staged`) and copies the
result back to the card.  Every join stays on the card.

JAX's ``test_pjit_auto_sharding_gossip_round`` jits the plain
``swarm.gossip_round`` over sharded inputs and lets GSPMD insert the
gathers.  Torch has no such mechanism, so that program has no function
here: its twin all-gathers the state (:func:`all_gather_rows`) and runs
the port's ``swarm.gossip_round`` on the gathered rows.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Tuple

import torch
import torch.distributed as dist

from crdt_tpu_torch import default_device
from crdt_tpu_torch.ops import joins
from crdt_tpu_torch.parallel import swarm as swarm_lib
from crdt_tpu_torch.utils.tree import leaves, tree_map


@dataclasses.dataclass
class Mesh:
    """A 1-D mesh over the ranks of a process group: the axis name, its
    size, this rank's position on it and this rank's device.  ``group``
    None is the default (world) group; ``backend`` "" is the one-rank mesh
    of a process without a group."""

    axis: str
    size: int
    rank: int
    device: torch.device
    group: Any = None
    backend: str = ""

    def global_rank(self, r: int) -> int:
        """The world rank of mesh position ``r``."""
        if self.group is None:
            return r
        return dist.get_global_rank(self.group, r)


def make_mesh(n_devices: Optional[int] = None, axis: str = "replica",
              device=None) -> Optional[Mesh]:
    """1-D mesh over the first n (default: all) ranks of the initialised
    default process group, on this rank's ``device`` (None: the CUDA
    card).  With no group initialised it is the one-rank mesh, and asking
    for n > 1 raises.  A subgroup of the first n ranks is created
    collectively: every rank of the world calls this, and a rank outside
    the first n gets None."""
    device = default_device(device)
    if not dist.is_initialized():
        if n_devices not in (None, 1):
            raise RuntimeError(
                f"make_mesh({n_devices}): no torch.distributed process group is "
                "initialised, so the mesh has one rank (see multihost.init_from_env)")
        return Mesh(axis=axis, size=1, rank=0, device=device)
    world = dist.get_world_size()
    n = n_devices or world
    if n > world:
        raise ValueError(f"make_mesh({n}): the world has {world} ranks")
    backend = str(dist.get_backend())
    if n == world:
        return Mesh(axis=axis, size=n, rank=dist.get_rank(), device=device,
                    backend=backend)
    group = dist.new_group(ranks=list(range(n)))
    rank = dist.get_rank()
    if rank >= n:
        return None
    return Mesh(axis=axis, size=n, rank=rank, device=device, group=group,
                backend=backend)


def shard_swarm(s: swarm_lib.Swarm, mesh: Mesh) -> swarm_lib.Swarm:
    """This rank's rows of a swarm (every rank holds the whole swarm), on
    its device.  The replica count must divide evenly, as a JAX sharding
    requires."""
    r = swarm_lib.n_replicas(s)
    if r % mesh.size:
        raise ValueError(f"{r} replicas do not split evenly over {mesh.size} ranks")
    k = r // mesh.size
    lo, hi = mesh.rank * k, (mesh.rank + 1) * k
    return swarm_lib.Swarm(
        state=tree_map(lambda x: x[lo:hi].contiguous().to(mesh.device), s.state),
        alive=s.alive[lo:hi].contiguous().to(mesh.device))


# ---- collectives (identities on the one-rank mesh without a group) ----


def _local(mesh: Mesh) -> bool:
    """The one-rank mesh of a process without a group: no collective runs.
    A world of 1 has a group, and its collectives go through the backend."""
    return not mesh.backend


def _host_staged(mesh: Mesh, t: torch.Tensor) -> bool:
    """Does this collective run on host copies?  The gloo path does for a
    CUDA tensor (see the module docstring)."""
    return mesh.backend == "gloo" and t.is_cuda


def _wire(t: torch.Tensor, staged: bool) -> torch.Tensor:
    """The tensor a collective sends: contiguous, bool as uint8, on the
    host on the gloo path."""
    t = t.contiguous()
    if t.dtype == torch.bool:
        t = t.to(torch.uint8)
    return t.cpu() if staged else t


def _unwire(t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return t.to(device=like.device, dtype=like.dtype)


def all_gather_leaf(mesh: Mesh, t: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """Every rank's ``t``, concatenated along ``dim`` in rank order (JAX's
    ``all_gather(..., tiled=True)``)."""
    if _local(mesh):
        return t
    staged = _host_staged(mesh, t)
    w = _wire(t, staged)
    parts = [torch.empty_like(w) for _ in range(mesh.size)]
    dist.all_gather(parts, w, group=mesh.group)
    return _unwire(torch.cat(parts, dim=dim), t)


def all_gather_rows(mesh: Mesh, state: Any) -> Any:
    """Every rank's rows (leading axis) of ``state``, in rank order."""
    return tree_map(lambda x: all_gather_leaf(mesh, x, 0), state)


def all_reduce_max(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """The elementwise max of ``t`` over the mesh (JAX's ``pmax``)."""
    if _local(mesh):
        return t
    staged = _host_staged(mesh, t)
    w = _wire(t, staged).clone()
    dist.all_reduce(w, op=dist.ReduceOp.MAX, group=mesh.group)
    return _unwire(w, t)


def exchange(mesh: Mesh, state: Any, partner: int) -> Any:
    """Send ``state`` to mesh position ``partner`` and receive its state
    (one ``batch_isend_irecv`` pair a leaf; JAX's ``ppermute`` step)."""
    peer = mesh.global_rank(partner)
    ops, pending = [], []
    for x in leaves(state):
        staged = _host_staged(mesh, x)
        w = _wire(x, staged)
        buf = torch.empty_like(w)
        ops += [dist.P2POp(dist.isend, w, peer, group=mesh.group),
                dist.P2POp(dist.irecv, buf, peer, group=mesh.group)]
        pending.append((buf, x))
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    it = iter([_unwire(buf, x) for buf, x in pending])
    return tree_map(lambda _: next(it), state)


# ---- the join all-reduce and the converges ----


def allreduce_join(join_fn: Callable, x: Any, mesh: Mesh, neutral: Any,
                   join_batched: Optional[Callable] = None) -> Any:
    """Generic join all-reduce: after it every rank holds the join of all
    ranks' ``x`` (a single-instance state).

    A power-of-two mesh runs the XOR-partner butterfly (log2(P) rounds,
    ``x = join_fn(x, partner's x)``); another size all-gathers the rows and
    tree-reduces them in rank order with ``join_batched`` (default
    ``joins.batched(join_fn)``).  ``neutral`` must be the lattice's true
    join identity (e.g. oplog.empty, NOT zeros, which for sorted-log
    lattices is a real key)."""
    p = mesh.size
    if p & (p - 1) == 0:
        step = 1
        while step < p:
            y = exchange(mesh, x, mesh.rank ^ step)
            x = join_fn(x, y)
            step *= 2
        return x
    gathered = all_gather_rows(mesh, tree_map(lambda leaf: leaf[None], x))
    return joins.tree_reduce_join(join_batched or joins.batched(join_fn), gathered,
                                  neutral)


def sharded_converge(mesh: Mesh, join_batched: Callable, join_single: Callable,
                     neutral: Any) -> Callable:
    """The global-convergence step over a sharded swarm: the local
    tree-reduction of this rank's replica shard, the join all-reduce over
    the mesh, then the broadcast back to the shard's alive replicas.
    ``step(shard) -> shard``; one call on every rank is the gossip
    fixpoint of the whole swarm."""
    def step(s: swarm_lib.Swarm) -> swarm_lib.Swarm:
        top_local = swarm_lib.alive_lub(s.state, s.alive, join_batched, neutral)
        top = allreduce_join(join_single, top_local, mesh, neutral, join_batched)
        return dataclasses.replace(
            s, state=swarm_lib.broadcast_where_alive(s.state, s.alive, top))

    return step


def pmax_converge(mesh: Mesh) -> Callable:
    """Max-lattice fast path: the global convergence of a counter swarm as
    the local masked max and one ``all_reduce(MAX)``."""
    def step(s: swarm_lib.Swarm) -> swarm_lib.Swarm:
        def leaf(x):
            m = s.alive.reshape((-1,) + (1,) * (x.dim() - 1))
            masked = torch.where(m, x, torch.zeros_like(x))
            top = all_reduce_max(mesh, masked.amax(dim=0))
            return torch.where(m, top[None].expand(x.shape), x)

        return dataclasses.replace(s, state=tree_map(leaf, s.state))

    return step


def gather_lanes(mesh: Mesh, planes: Tuple[torch.Tensor, ...]) -> Tuple[torch.Tensor, ...]:
    """Every rank's one-lane planes concatenated along the lane (last)
    axis in rank order: phase 2 of the columnar sharded converges."""
    return tuple(all_gather_leaf(mesh, p, p.dim() - 1) for p in planes)
