"""Seeded reference-shaped writes for driving the OpLog swarm.

The reference's workload (its ``dummyInsertions``; the JAX package's
``harness/workload.py`` and ``utils/config.py`` defaults): single-key
commands, keys uniform over the 62-character alphabet, deltas uniform in
[-20, -11], each posted to a uniformly random replica, which becomes the
op's writer.  Writers number their ops contiguously from 0 (``seq``) and
stamp them with a millisecond ``ts`` that several writes share.  A share
of the writes carries a non-numeric string, exercising the LWW payload
path of the rebuild.

Everything is drawn from a numpy generator seeded by the caller.
"""
from __future__ import annotations

import dataclasses
import string
from typing import List, Tuple

import numpy as np
import torch

from crdt_tpu_torch import default_device
from crdt_tpu_torch.models import oplog
from crdt_tpu_torch.utils.constants import SENTINEL_PY
from crdt_tpu_torch.utils.intern import Interner, encode_value

ALPHABET = string.ascii_letters + string.digits  # the reference's 62 keys
DELTA_MIN, DELTA_MAX = -20, -11
# The reference's writers post free text as well as integers; about one
# write in ten carries a non-numeric string, enough to drive the LWW path.
NON_NUMERIC = 0.1
# The reference stamps writes with a millisecond clock, so writes that land
# in the same millisecond share a ts; three per millisecond makes such
# collisions common, and the (rid, seq) tie-break decides their order.
WRITES_PER_MS = 3


@dataclasses.dataclass
class Writes:
    """A pool of writes as op columns (numpy, in write order) plus the
    interners that decode them and the commands as the reference saw them:
    ``commands[i] = (writer, {key: value}, ts)``."""

    ops: dict
    keys: Interner
    values: Interner
    commands: List[Tuple[int, dict, int]]

    @property
    def n_keys(self) -> int:
        return len(self.keys)


def reference_writes(n_writes: int, n_replicas: int, seed: int) -> Writes:
    rng = np.random.default_rng(seed)
    keys, values = Interner(), Interner()
    for ch in ALPHABET:
        keys.intern(ch)
    key = rng.integers(0, len(ALPHABET), n_writes)
    delta = rng.integers(DELTA_MIN, DELTA_MAX + 1, n_writes)
    writer = rng.integers(0, n_replicas, n_writes)
    text = rng.random(n_writes) < NON_NUMERIC
    word = rng.integers(0, 1000, n_writes)

    seq_of = np.zeros(n_replicas, np.int64)
    cols = {f: np.zeros(n_writes, np.int32) for f in
            ("ts", "rid", "seq", "key", "val", "payload")}
    cols["is_num"] = np.zeros(n_writes, bool)
    commands = []
    for i in range(n_writes):
        w = int(writer[i])
        value = f"v{word[i]}" if text[i] else str(int(delta[i]))
        val, payload, is_num = encode_value(value, values)
        ts = i // WRITES_PER_MS
        for f, x in (("ts", ts), ("rid", w), ("seq", seq_of[w]), ("key", key[i]),
                     ("val", val), ("payload", payload), ("is_num", is_num)):
            cols[f][i] = x
        seq_of[w] += 1
        commands.append((w, {ALPHABET[key[i]]: value}, ts))
    return Writes(ops=cols, keys=keys, values=values, commands=commands)


def subset_swarm(ops: dict, n_replicas: int, capacity: int, fraction: float,
                 seed: int, device=None) -> Tuple[oplog.OpLog, np.ndarray]:
    """A batched [R, C] OpLog whose replicas each hold a seeded random
    subset of the pool (a mid-gossip swarm: cross-replica duplicates are
    plentiful).  A replica that draws more than ``capacity`` ops keeps the
    first ``capacity`` of them in log order.  Built in bulk on ``device``.
    Returns (logs, held) with ``held[r, i]`` true when replica r holds pool
    op i."""
    device = default_device(device)
    n = len(ops["ts"])
    held = np.random.default_rng(seed).random((n_replicas, n)) < fraction
    pool = oplog.from_ops(n, ops, device=device)      # sorted pool, no padding
    order = np.lexsort([ops[f] for f in ("key", "seq", "rid", "ts")])
    held_sorted = held[:, order]
    held_sorted &= np.cumsum(held_sorted, axis=1) <= capacity
    held[:, order] = held_sorted
    held_sorted = torch.as_tensor(held_sorted, device=device)
    # per replica: its held rows first, in pool (= log) order
    pick = torch.sort((~held_sorted).to(torch.uint8), dim=1, stable=True).indices
    pick = pick[:, :capacity]
    keep = held_sorted.gather(1, pick)

    def col(name, fill):
        x = getattr(pool, name)[pick].masked_fill(~keep, fill)
        pad = torch.full((n_replicas, capacity - x.shape[1]), fill, dtype=x.dtype,
                         device=device)
        return torch.cat([x, pad], dim=1)

    logs = oplog.OpLog(
        ts=col("ts", SENTINEL_PY), rid=col("rid", SENTINEL_PY),
        seq=col("seq", SENTINEL_PY), key=col("key", SENTINEL_PY),
        val=col("val", 0), payload=col("payload", 0), is_num=col("is_num", False),
    )
    return logs, held


def converged_view(ops: dict, held_by_alive: np.ndarray, keys: Interner,
                   values: Interner) -> dict:
    """The {key: value} map every alive replica reaches, folded straight
    from the pool by the reference's rebuild rule (newest op by (ts, rid,
    seq) seeds the value; numeric values add up while both sides parse as
    integers) — an independent plain check of the device path.
    ``held_by_alive[i]`` marks the pool ops some alive replica holds."""
    idx = np.nonzero(held_by_alive)[0]
    order = idx[np.lexsort([ops[f][idx] for f in ("seq", "rid", "ts")])][::-1]
    state: dict = {}
    numeric: dict = {}
    for i in order:
        k = keys.lookup(int(ops["key"][i]))
        v = values.lookup(int(ops["payload"][i]))
        if k not in state:
            state[k] = v
            numeric[k] = (int(ops["val"][i]), 1) if ops["is_num"][i] else None
        elif numeric[k] is not None and ops["is_num"][i]:
            total, count = numeric[k]
            numeric[k] = (total + int(ops["val"][i]), count + 1)
    for k, acc in numeric.items():
        if acc is not None and acc[1] > 1:
            state[k] = str(acc[0])
    return state
