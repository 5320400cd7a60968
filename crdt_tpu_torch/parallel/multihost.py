"""Multi-host scaling: the ``torch.distributed`` bootstrap and the global
mesh (counterpart of ``crdt_tpu.parallel.multihost``).

The reference "scales" by adding loopback HTTP servers in one process
(/root/reference/main.go:316-323).  The port has two rungs:

* **one host** — ``parallel.mesh`` over the ranks of a process group;
* **many hosts** — THIS module: the same SPMD program spans hosts once
  the process group is initialised from torchrun's standard environment,
  one process per card.

Pattern (the same code in every process):

    multihost.init_from_env()                     # the process group
    mesh = multihost.global_mesh()                # every rank of the world
    shard = multihost.shard_host_local(rows, mesh)    # this rank's rows
    step = oplog_columnar.sharded_converge(mesh, ...)
    shard, max_nu = step(shard, alive_shard)      # one global fixpoint

SPMD has no global array: the sharded steps take each rank's local shard
and return it, and a caller that wants the whole swarm concatenates the
ranks' outputs in rank order.  Host-level ingress stays on the HTTP
runtime (``crdt_tpu_torch.api.net``): ops land in the rank's own replica
rows between steps.

With no cluster configured :func:`init_from_env` returns False and the
global mesh is the one-rank mesh, so the same code runs in one process.
"""
from __future__ import annotations

import os
from typing import Any, Optional

import torch
import torch.distributed as dist

from crdt_tpu_torch import default_device
from crdt_tpu_torch.parallel import mesh as mesh_lib
from crdt_tpu_torch.utils.tree import tree_map

#: this process's rank device, set by :func:`init_from_env`
_DEVICE: Optional[torch.device] = None


def rank_device(device=None) -> torch.device:
    """The device of this process's rank: ``device`` if given, else the
    one :func:`init_from_env` chose, else ``cuda:LOCAL_RANK`` (the card of
    torchrun's local rank; raises without a card)."""
    if device is not None:
        return torch.device(device)
    if _DEVICE is not None:
        return _DEVICE
    default_device(None)
    return torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))


def init_from_env(init_method: Optional[str] = None,
                  world_size: Optional[int] = None,
                  rank: Optional[int] = None,
                  autodetect: Optional[bool] = None,
                  device=None) -> bool:
    """Initialise the default ``torch.distributed`` process group when a
    cluster is configured; a no-op returning False otherwise.

    Three ways in:
    * explicit arguments;
    * torchrun's standard environment (``MASTER_ADDR``/``MASTER_PORT``,
      ``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``);
    * ``autodetect=True`` (or ``CRDT_TPU_MULTIHOST=1``): ``env://`` with
      whatever the launcher exported.  An explicit opt-in: a bare laptop
      run cannot be told from a cluster host by missing variables alone.

    The rank's device is ``device`` (None: ``cuda:LOCAL_RANK``); the
    backend is NCCL for a card and gloo for ``device="cpu"``.  Safe to
    call twice (already initialised returns True).  A FAILED bootstrap
    raises: proceeding single-host would let every host converge its own
    partition believing it is the global swarm."""
    global _DEVICE
    if dist.is_initialized():
        return True
    if autodetect is None:
        autodetect = os.environ.get("CRDT_TPU_MULTIHOST") == "1"
    env = os.environ
    if init_method is None and env.get("MASTER_ADDR") and env.get("MASTER_PORT"):
        init_method = f"tcp://{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
    if init_method is None and env.get("WORLD_SIZE") is None and not autodetect:
        return False  # single process: nothing to do
    try:
        world_size = int(world_size if world_size is not None else env["WORLD_SIZE"])
        rank = int(rank if rank is not None else env["RANK"])
    except KeyError as e:
        raise RuntimeError(f"multihost bootstrap: no world size or rank given and "
                           f"{e.args[0]} is not set") from None
    dev = rank_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                            init_method=init_method or "env://",
                            world_size=world_size, rank=rank)
    _DEVICE = dev
    return True


def global_mesh(axis: str = "replica", device=None) -> mesh_lib.Mesh:
    """1-D mesh over every rank of every participating host (the one-rank
    mesh in a single process), on this rank's device."""
    return mesh_lib.make_mesh(None, axis=axis, device=rank_device(device))


def shard_host_local(host_local_state: Any, mesh: mesh_lib.Mesh) -> Any:
    """This rank's own replica rows, on its device: the local shard a
    sharded step takes (SPMD has no global array to build)."""
    return tree_map(lambda x: x.to(mesh.device), host_local_state)


def process_span() -> tuple[int, int]:
    """(rank, world size): writer-id ranges for multi-host deployments come
    from this (ClusterConfig.rid_base = rank * per_host)."""
    if not dist.is_initialized():
        return 0, 1
    return dist.get_rank(), dist.get_world_size()
