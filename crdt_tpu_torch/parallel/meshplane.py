"""The replica-sharded merge plane: every keyspace shard folds in ONE step
(counterpart of the JAX package's ``parallel/meshplane``).

The keyspace tier (:mod:`crdt_tpu_torch.keyspace`) carves the host plane
into S independent ``ReplicaNode`` shards, each merging with its own
device merge, so a fleet pull round or a tenant page costs S merges of
~150 torch launches each, one after another.  This module stacks the S
shard op-logs into ``[S, C]`` planes on the keyspace's device and folds
every lane's ingest batch in one batched step: sort each lane's batch,
run the checked sorted union over all lanes at once (every
``models.oplog`` function works along the last dimension, so the batch
dimension is written out where the JAX package vmaps), unstack.
``merge_dispatches`` ticks once per step whatever S is.

Engines.  :func:`select_engine` keeps the JAX package's rules: ``off``
never fuses, ``on`` always does, ``auto`` fuses only with at least 2
lanes and at least 2 local devices of the keyspace's type, and where at
least 2 of those devices divide the lane count it picks the partitioned
engine ``pjit``, else ``vmap``.

* ``vmap``: one batched step for all S lanes on the keyspace's device.
* ``pjit`` (also answering to ``shard_map``): the S lanes split into d
  contiguous groups, d the largest device count that divides S; group
  k's stacked logs, batch columns and digest rows go to device k, the
  same batched fold and lane sum run there, and the results come back to
  the keyspace's device.  JAX's ``shard_map`` engine is only the
  version-drift fallback of its ``pjit`` engine (a ``jax.shard_map``
  spelling where jit-level sharding is missing), and torch has no second
  way to spell a partition, so both names build this one engine.  The
  devices are every local card of the keyspace's device type; tests pass
  ``devices=`` (four ``"cpu"`` entries, say) to rehearse the partition
  as the JAX tests do on their virtual CPU devices.

Bit-parity.  A lane's fold is a stable 4-key sort of its SENTINEL-padded
batch, then ``oplog.merge_checked``: exactly the host path's
``from_ops`` + ``merge_checked`` (SENTINEL keys sort last and the union
treats them as padding, so pad-then-sort equals concat-then-sort).  The
audit digest's lane sum (:func:`crdt_tpu_torch.ops.digest.lane_sum`)
rides the same step, and the lane counts and digest sums come back to
the host in ONE transfer.

The plane works on ``PendingMerge`` handles (:mod:`crdt_tpu_torch.api.node`):
each lane's host bookkeeping already happened under that node's lock,
which stays HELD across the step so commit rebinds the merged log
race-free.  Lock order: drain slots, then node locks by shard index, then
the ``device_lock`` of every device the step touches, in ascending device
order, taken once for the whole step.  If the step fails (any group's,
on the partitioned engine), ``meshplane_fallbacks`` ticks and every lane
lands with its own inline merge (``commit_inline``): a lane is never left
with host indexes ahead of its log, and no lock is left held.
"""
from __future__ import annotations

import contextlib
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from crdt_tpu_torch import default_device
from crdt_tpu_torch.models import oplog
from crdt_tpu_torch.ops import digest as digkernel
from crdt_tpu_torch.ops import union_engine
from crdt_tpu_torch.utils.constants import SENTINEL_PY
from crdt_tpu_torch.utils.metrics import Metrics
from crdt_tpu_torch.utils.tree import tree_map

MESH_MODES = ("auto", "on", "off")

_BATCH_COLS = oplog._FIELDS

ENGINES = ("pjit", "shard_map", "vmap")
PARTITIONED = ("pjit", "shard_map")


def _mesh_divisor(n_lanes: int, n_devices: int) -> int:
    """Largest device count d <= min(n_lanes, n_devices) with d | n_lanes
    (the lane axis must split evenly across a multi-device mesh)."""
    for d in range(min(n_lanes, n_devices), 0, -1):
        if n_lanes % d == 0:
            return d
    return 1


def _device_count(device) -> int:
    """Devices of ``device``'s type (None: the CUDA card, the port's
    default device)."""
    kind = "cuda" if device is None else torch.device(device).type
    return torch.cuda.device_count() if kind == "cuda" else 1


def _local_devices(device: torch.device) -> List[torch.device]:
    """Every local device of ``device``'s type: the cards in index order,
    or ``device`` itself for the CPU."""
    if device.type == "cuda":
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [device]


def _device_order(device: torch.device):
    return (device.type, device.index if device.index is not None else 0)


def select_engine(n_lanes: int, mode: str = "auto", device=None) -> Optional[str]:
    """The fused engine for ``n_lanes`` shard lanes, or None for the
    per-lane host path.  ``auto`` fuses only when fusion can win (at least
    2 devices of ``device``'s type and at least 2 lanes); ``on`` always
    fuses; ``off`` never does.  The fused engine is ``pjit`` where at least
    2 of those devices divide the lane count, else ``vmap``."""
    if mode not in MESH_MODES:
        raise ValueError(
            f"keyspace_mesh={mode!r}: must be one of {'|'.join(MESH_MODES)}")
    if mode == "off" or n_lanes < 1:
        return None
    n_dev = _device_count(device)
    if mode == "auto" and (n_lanes < 2 or n_dev < 2):
        return None
    if _mesh_divisor(n_lanes, n_dev) >= 2:
        return "pjit"
    return "vmap"


def _lane_fold(logs: oplog.OpLog, cols: Tuple[torch.Tensor, ...]):
    """Every lane at once: the stable 4-key sort of each lane's padded
    batch (== from_ops) and the checked sorted union along the rows."""
    return oplog.merge_checked(logs, oplog._sort_log(list(cols)))


class MeshPlane:
    """The fused cross-shard merge engine of one ``ShardedKeyspace``."""

    def __init__(self, n_lanes: int, *, mode: str = "auto",
                 metrics: Optional[Metrics] = None, engine: Optional[str] = None,
                 device=None, devices: Optional[Sequence[Any]] = None):
        if engine not in (None,) + ENGINES:
            raise ValueError(f"unknown mesh engine {engine!r}")
        self.n_lanes = n_lanes
        self.device = default_device(device)
        self.metrics = metrics if metrics is not None else Metrics()
        self.engine = engine if engine is not None \
            else select_engine(n_lanes, mode, self.device)
        self.devices = [self.device]
        if self.engine in PARTITIONED:
            local = [torch.device(d) for d in devices] if devices is not None \
                else _local_devices(self.device)
            self.devices = local[:_mesh_divisor(n_lanes, len(local))]
        self.n_devices = len(self.devices)
        # the step's device locks, each once, in ascending device order
        self._lock_devices = sorted({str(d): d for d in self.devices + [self.device]}
                                    .values(), key=_device_order)

    # ---- the step ----

    def _fold(self, logs: oplog.OpLog, cols: Tuple[torch.Tensor, ...],
              digs: torch.Tensor):
        """Every lane of ``logs`` at once on their device: the merged logs,
        the lane counts and the audit digest's lane sums (each lane's sum
        of its batch's digest rows mod 2**32; zero padding rows are the
        additive identity, and commit() compares it with the host's)."""
        merged, n_unique = _lane_fold(logs, cols)
        return merged, n_unique, digkernel.lane_sum(digs)

    def _fold_group(self, k: int, logs: oplog.OpLog,
                    cols: Tuple[torch.Tensor, ...], digs: torch.Tensor):
        """Group k of the partitioned engine: its contiguous lanes moved to
        device k and folded there."""
        per = self.n_lanes // self.n_devices
        lanes, dev = slice(k * per, (k + 1) * per), self.devices[k]
        return self._fold(tree_map(lambda x: x[lanes].to(dev), logs),
                          tuple(c[lanes].to(dev) for c in cols), digs[lanes].to(dev))

    def _step(self, logs: oplog.OpLog, cols: Tuple[torch.Tensor, ...],
              digs: torch.Tensor):
        if self.engine in PARTITIONED:
            groups = [self._fold_group(k, logs, cols, digs)
                      for k in range(self.n_devices)]
            merged, n_unique, dig_sum = (
                tree_map(lambda *xs: torch.cat([x.to(self.device) for x in xs]),
                         *(g[i] for g in groups))
                for i in range(3))
        else:
            merged, n_unique, dig_sum = self._fold(logs, cols, digs)
        lanes = [oplog.OpLog(*(getattr(merged, f)[i] for f in _BATCH_COLS))
                 for i in range(self.n_lanes)]
        return lanes, n_unique, dig_sum

    def _step_for(self, capacity: int, batch_cap: int) -> Callable:
        """The step for a (lane capacity, batch capacity) shape: one batched
        program serves every shape (the JAX package compiles one a
        shape)."""
        return self._step

    # ---- the fused converge ----

    def converge(self, pendings: List[Any]) -> int:
        """Fold every pending lane in ONE step and commit.

        ``pendings`` are ``PendingMerge`` handles whose node locks are HELD
        (merge_begin / add_commands_begin); all are released on return,
        success or failure.  Returns the total absorbed (fresh + adopted)
        across lanes.  Zero-fresh lanes ride along as identity folds.
        """
        from crdt_tpu_torch.api.node import device_lock

        if not pendings:
            return 0
        if len(pendings) != self.n_lanes:
            for p in pendings:
                p.abort()
            raise ValueError(
                f"mesh plane built for {self.n_lanes} lanes, "
                f"got {len(pendings)} pendings")
        if not any(p.fresh for p in pendings):
            # nothing anywhere: no device work (as the host path's no-op)
            return land_all_inline(pendings)
        s = len(pendings)
        try:
            # a uniform lane capacity: every lane grows (tail padding,
            # lossless) to the largest need, rounded to a power of two
            need = max(p.rows_held() + p.fresh for p in pendings)
            cap = max(p.node.log.capacity for p in pendings)
            while cap < need:
                cap *= 2
            batch_cap = 1
            while batch_cap < max(p.fresh for p in pendings):
                batch_cap *= 2
            cols_host = [np.stack([_pad_col(p.ops, name, p.fresh, batch_cap)
                                   for p in pendings]) for name in _BATCH_COLS]
            digs_host = np.stack([_pad_dig(p.dig, batch_cap) for p in pendings])
            step = self._step_for(cap, batch_cap)
            with contextlib.ExitStack() as locks, self.metrics.timer("merge"):
                for d in self._lock_devices:
                    locks.enter_context(device_lock(d))
                for p in pendings:
                    if p.node.log.capacity < cap:
                        p.node.log = oplog.grow(p.node.log, cap)
                        p.node.metrics.inc("log_grow")
                logs = oplog.OpLog(*(torch.stack([getattr(p.node.log, f) for p in pendings])
                                     for f in _BATCH_COLS))
                cols = tuple(torch.from_numpy(c).to(self.device) for c in cols_host)
                digs = torch.from_numpy(digs_host.astype(np.int64)).to(self.device)
                lanes, n_unique, dig_sum = step(logs, cols, digs)
                # ONE host sync for every lane's count AND digest sum
                host = torch.cat([n_unique.to(torch.int64), dig_sum.reshape(-1)]).cpu().numpy()
            n_host = host[:s]
            dig_host = host[s:].reshape(s, digkernel.LANES).astype(np.uint32)
        except Exception:
            # engine failure: every lane lands with its own inline merge so
            # none is left with host indexes ahead of its log
            self.metrics.inc("meshplane_fallbacks")
            return land_all_inline(pendings)
        # one fused step for ALL lanes: the counter the one-dispatch-a-step
        # checks pin; per-lane attribution comes from each node's
        # _count_lane_fold (merge_dispatches{shard=i})
        self.metrics.inc("merge_dispatches")
        union_engine.record_union_path("sort", registry=self.metrics.registry)
        total = 0
        first_exc: Optional[BaseException] = None
        for i, p in enumerate(pendings):
            try:
                total += p.commit(
                    lanes[i], int(n_host[i]),
                    digest=dig_host[i] if p.dig_sum is not None else None)
            except BaseException as exc:
                # commit's finally released THIS lane's lock; keep
                # committing the siblings so none of their locks leak,
                # then surface the first failure
                if first_exc is None:
                    first_exc = exc
        if first_exc is not None:
            raise first_exc
        return total


def land_all_inline(pendings: List[Any]) -> int:
    """Commit every still-open pending with its own inline merge.  Keeps
    draining after a lane's ``commit_inline`` raises (its finally already
    released that lane's lock), so NO lane's node lock leaks, then
    re-raises the first failure."""
    total = 0
    first_exc: Optional[BaseException] = None
    for p in pendings:
        if p.done:
            continue
        try:
            total += p.commit_inline()
        except BaseException as exc:
            if first_exc is None:
                first_exc = exc
    if first_exc is not None:
        raise first_exc
    return total


def _pad_col(ops: Optional[Dict[str, np.ndarray]], name: str, fresh: int,
             cap: int) -> np.ndarray:
    """One lane's batch column padded to ``cap`` with from_ops's padding
    (SENTINEL lex keys, zero values): pad-then-sort in the step is
    bit-identical to from_ops's concat-then-sort."""
    if name == "is_num":
        out = np.zeros(cap, bool)
    elif name in ("val", "payload"):
        out = np.zeros(cap, np.int32)
    else:
        out = np.full(cap, SENTINEL_PY, np.int32)
    if fresh:
        out[:fresh] = ops[name]
    return out


def _pad_dig(dig: Optional[np.ndarray], cap: int) -> np.ndarray:
    """One lane's audit-digest rows zero-padded to ``cap``.  A lane with the
    audit off contributes zeros, and its commit gets digest=None."""
    out = np.zeros((cap, digkernel.LANES), np.uint32)
    if dig is not None and len(dig):
        out[:len(dig)] = dig
    return out
