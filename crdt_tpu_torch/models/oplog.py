"""OpLog store — the flagship model (counterpart of
``crdt_tpu.models.oplog``): the reference's replicated key-value counter
store as fixed-shape sorted op tensors.

Reference semantics being reproduced (SURVEY.md §0):

* a replica's durable state is a grow-only op log: timestamp → command;
* merge = order-insensitive union of two logs;
* the materialized key-value view is rebuilt from the log: per key, the
  newest entry seeds the value and every *numeric* entry accumulates by
  integer addition (PN-Counter for ints, LWW-Register for other strings).

Op identity is ``(ts, rid, seq)`` + the key column; strings are
host-interned to int32 ids (``crdt_tpu_torch.utils.intern``).  The log is
a sorted, sentinel-padded, fixed-capacity tensor; merge is the sorted
union (``crdt_tpu_torch.ops.sorted_union``) and the rebuild is two
scatters.

Every function here works along the last (row) dimension, so a batched
``[R, C]`` swarm of logs goes through the same calls as one ``[C]`` log —
where the JAX package vmaps, the port writes the batch dimension out.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Mapping

import numpy as np
import torch

from crdt_tpu_torch import default_device
from crdt_tpu_torch.ops import sorted_union as su
from crdt_tpu_torch.utils.constants import SENTINEL_PY
from crdt_tpu_torch.utils.tables import grow_into

_FIELDS = ("ts", "rid", "seq", "key", "val", "payload", "is_num")


@dataclasses.dataclass
class OpLog:
    """One replica's op log (or a batch of them along leading dims).  Rows
    sorted by (ts, rid, seq, key); padding rows have ts = rid = seq = key =
    SENTINEL, val = 0, is_num = False."""

    ts: torch.Tensor       # int32[..., C] ms offset from host epoch
    rid: torch.Tensor      # int32[..., C] writer replica id
    seq: torch.Tensor      # int32[..., C] writer-local sequence number
    key: torch.Tensor      # int32[..., C] interned key id
    val: torch.Tensor      # int32[..., C] numeric delta (0 for non-numeric)
    payload: torch.Tensor  # int32[..., C] interned id of the RAW value string
    is_num: torch.Tensor   # bool[..., C]  does the value parse as an integer

    @property
    def capacity(self) -> int:
        return self.ts.shape[-1]


@dataclasses.dataclass
class KVState:
    """Materialized view over an interned key space of size K (or a batch
    of views along leading dims).

    Decode rule: a key resolves to the raw string `payload` when not
    numeric, OR when numeric with num_count == 1 — the reference seeds the
    newest value verbatim and only canonicalizes once an addition fires."""

    present: torch.Tensor    # bool[..., K]  key has at least one op
    is_num: torch.Tensor     # bool[..., K]  resolved value is numeric
    num: torch.Tensor        # int32[..., K] counter value (sum of deltas)
    num_count: torch.Tensor  # int32[..., K] how many numeric ops contributed
    payload: torch.Tensor    # int32[..., K] interned raw string of the newest op


def empty(capacity: int, device=None) -> OpLog:
    device = default_device(device)
    s = torch.full((capacity,), SENTINEL_PY, dtype=torch.int32, device=device)
    z = torch.zeros((capacity,), dtype=torch.int32, device=device)
    return OpLog(ts=s, rid=s.clone(), seq=s.clone(), key=s.clone(), val=z,
                 payload=z.clone(),
                 is_num=torch.zeros((capacity,), dtype=torch.bool, device=device))


def size(log: OpLog) -> torch.Tensor:
    return (log.ts != SENTINEL_PY).sum(dim=-1, dtype=torch.int32)


def _sort_log(cols) -> OpLog:
    keys, vals = su._sort_by_keys(list(cols[:4]), list(cols[4:]), 4)
    return OpLog(*keys, *vals)


def from_ops(capacity: int, ops: Mapping[str, object], device=None) -> OpLog:
    """Build a log from unsorted op columns (host ingestion path).

    `ops` maps {'ts','rid','seq','key','val','payload','is_num'} to
    equal-length arrays (numpy or tensors); rows beyond `capacity` must not
    exist."""
    device = default_device(device)
    m = len(ops["ts"])
    if m > capacity:
        raise ValueError(f"op batch {m} exceeds log capacity {capacity}")
    pad = capacity - m

    def col(name, fill, dtype):
        x = ops[name]
        if not isinstance(x, torch.Tensor):
            x = torch.as_tensor(np.asarray(x))
        x = x.to(device=device, dtype=dtype)
        return torch.cat([x, torch.full((pad,), fill, dtype=dtype, device=device)])

    i32 = torch.int32
    return _sort_log([
        col("ts", SENTINEL_PY, i32), col("rid", SENTINEL_PY, i32),
        col("seq", SENTINEL_PY, i32), col("key", SENTINEL_PY, i32),
        col("val", 0, i32), col("payload", 0, i32),
        col("is_num", False, torch.bool),
    ])


def grow(log: OpLog, new_capacity: int) -> OpLog:
    """Capacity migration: append tail padding (rows are sorted with
    padding last, so contents and merge results are unchanged)."""
    if new_capacity < log.capacity:
        raise ValueError(f"cannot shrink capacity {log.capacity} -> {new_capacity}")
    return grow_into(log, empty(new_capacity, device=log.ts.device))


def merge(local: OpLog, remote: OpLog) -> OpLog:
    """CRDT join: union of the two logs keyed by (ts, rid, seq, key),
    capacity-bounded by ``local`` (the largest keys are silently dropped on
    overflow — use `merge_checked` where that must be detected).  Identical
    keys carry identical payloads, so the duplicate combiner is keep-first."""
    out, _ = merge_checked(local, remote)
    return out


def merge_checked(local: OpLog, remote: OpLog):
    """merge returning (OpLog, n_unique): n_unique > local.capacity means
    the true union overflowed and the newest ops were dropped."""
    keys, vals, n_unique = su.sorted_union(
        (local.ts, local.rid, local.seq, local.key),
        {"val": local.val, "payload": local.payload, "is_num": local.is_num},
        (remote.ts, remote.rid, remote.seq, remote.key),
        {"val": remote.val, "payload": remote.payload, "is_num": remote.is_num},
        combine=su.keep_first,
        out_size=local.capacity,
    )
    return (
        OpLog(
            ts=keys[0], rid=keys[1], seq=keys[2], key=keys[3],
            val=vals["val"], payload=vals["payload"], is_num=vals["is_num"],
        ),
        n_unique,
    )


# The JAX package donates ``local``'s buffers here; torch has no buffer
# donation, so the host-ingest variant is the same function.
merge_checked_donating = merge_checked


def version_vector(log: OpLog, n_writers: int) -> torch.Tensor:
    """Per-writer received watermark: ``vv[w]`` = max seq of any op authored
    by writer ``w`` in this log, ``-1`` when none.  Rows with rid outside
    [0, n_writers) have no watermark and are never considered covered."""
    valid = (log.ts != SENTINEL_PY) & (log.rid >= 0) & (log.rid < n_writers)
    rid_safe = torch.where(valid, log.rid, n_writers).long()
    vv = torch.full(log.ts.shape[:-1] + (n_writers + 1,), -1,
                    dtype=torch.int32, device=log.ts.device)
    vv.scatter_reduce_(-1, rid_safe, torch.where(valid, log.seq, -1),
                       reduce="amax", include_self=True)
    return vv[..., :n_writers]


def covered_by(log: OpLog, vv: torch.Tensor) -> torch.Tensor:
    """bool[..., C]: which rows a peer holding version vector ``vv`` has."""
    n_writers = vv.shape[-1]
    valid = log.ts != SENTINEL_PY
    in_range = (log.rid >= 0) & (log.rid < n_writers)
    rid_safe = log.rid.clamp(0, n_writers - 1).long()
    return valid & in_range & (log.seq <= vv[rid_safe])


def delta_since(log: OpLog, vv: torch.Tensor) -> OpLog:
    """Delta extraction: the sub-log of ops NOT covered by version vector
    ``vv``, canonically re-sorted and padded (same capacity)."""
    cov = covered_by(log, vv)
    keys = [getattr(log, f).masked_fill(cov, SENTINEL_PY) for f in _FIELDS[:4]]
    vals = [getattr(log, f).masked_fill(cov, 0) for f in _FIELDS[4:]]
    return _sort_log(keys + vals)


def append_batch(log: OpLog, ops: Mapping[str, object],
                 batch_capacity: int | None = None) -> OpLog:
    """Local write path (the reference's AddCommand log append): merge a
    freshly packed op batch into the log."""
    cap = batch_capacity or log.capacity
    return merge(log, from_ops(cap, ops, device=log.ts.device))


def _scatter_slots(idx: torch.Tensor, n_slots: int) -> torch.Tensor:
    """Flat scatter targets for ``idx`` (int32[..., C]) into one table of
    ``n_slots`` entries per batch row, with JAX's ``.at[idx]`` rules: a
    negative index counts from the end, and an index still outside
    [0, n_slots) is DROPPED (torch's scatter raises instead).  Dropped rows
    go to a spare slot ``n_slots`` that the caller cuts off, so each batch
    row owns ``n_slots + 1`` flat entries."""
    slot = torch.where(idx < 0, idx + n_slots, idx)
    slot = torch.where((slot < 0) | (slot >= n_slots), n_slots, slot).long()
    rows = torch.arange(math.prod(idx.shape[:-1]), device=idx.device)
    return (slot + rows.reshape(idx.shape[:-1] + (1,)) * (n_slots + 1)).reshape(-1)


def at_slot(index, n_slots: int) -> int | None:
    """The entry that ``x.at[..., index]`` of a JAX array with ``n_slots``
    entries on its last axis updates, for one scalar ``index``: the rules of
    :func:`_scatter_slots` on the host, no tensor op.  None when JAX drops
    the update."""
    slot = int(index)
    if slot < 0:
        slot += n_slots
    return slot if 0 <= slot < n_slots else None


def rebuild(log: OpLog, n_keys: int) -> KVState:
    """Rebuild the materialized view from the log as two scatters:

    * numeric keys: one segment-sum scatter-add of every numeric delta
      (int32, wrapping as XLA's does);
    * the per-key *newest* op decides the mode: rows are sorted ascending by
      (ts, rid, seq), so "newest" is the largest row index per key → one
      scatter-max of row indices.

    A batched ``[..., C]`` log scatters once over flattened
    ``(batch · (K+1))`` slots (slot K absorbs padding rows, as in the JAX
    package)."""
    valid = log.ts != SENTINEL_PY
    key_safe = torch.where(valid, log.key, n_keys)
    batch_shape = log.ts.shape[:-1]
    n_slots = n_keys + 1
    flat = _scatter_slots(key_safe, n_slots)
    dev = log.ts.device

    def table(fill):
        size = math.prod(batch_shape) * (n_slots + 1)
        return torch.full((size,), fill, dtype=torch.int32, device=dev)

    def cut(x):
        return x.reshape(batch_shape + (n_slots + 1,))[..., :n_keys]

    numeric = valid & log.is_num
    sums = cut(table(0).index_add_(
        0, flat, torch.where(numeric, log.val, 0).reshape(-1)))
    num_count = cut(table(0).index_add_(
        0, flat, numeric.to(torch.int32).reshape(-1)))
    idx = torch.arange(log.capacity, dtype=torch.int32, device=dev).expand_as(log.ts)
    last = cut(table(-1).scatter_reduce_(
        0, flat, torch.where(valid, idx, -1).reshape(-1),
        reduce="amax", include_self=True))

    present = last >= 0
    last_c = last.clamp(min=0).long()
    newest_is_num = log.is_num.gather(-1, last_c) & present
    return KVState(
        present=present,
        is_num=newest_is_num,
        num=torch.where(newest_is_num, sums, 0),
        num_count=num_count,
        payload=torch.where(present, log.payload.gather(-1, last_c), 0),
    )


def materialize(kv: KVState, keys, values) -> dict:
    """Decode one KVState back to the reference's {key: string} map using
    the host interners.  Implements the KVState decode rule: verbatim raw
    string unless ≥2 numeric ops summed."""
    present = kv.present.cpu().numpy()
    is_num = kv.is_num.cpu().numpy()
    num = kv.num.cpu().numpy()
    num_count = kv.num_count.cpu().numpy()
    payload = kv.payload.cpu().numpy()
    out = {}
    for i in range(len(keys)):
        if not present[i]:
            continue
        k = keys.lookup(i)
        if is_num[i] and num_count[i] > 1:
            out[k] = str(int(num[i]))
        else:
            out[k] = values.lookup(int(payload[i]))
    return out
