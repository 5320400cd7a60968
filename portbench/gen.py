"""The benchmark's seeded inputs: frozen copies of the port's generators.

Copied from ``crdt_tpu_torch/workload.py`` (``reference_writes``,
``subset_swarm``, ``set_pool``, ``set_swarm``, with their constants) and
``crdt_tpu_torch/parallel/swarm.py`` (``random_peers``), rewritten so that
nothing here imports the port: the values are interned by a plain list,
the per-replica logs are built as plain tensors, and the held mask of the
KV swarm is drawn on the device in the pool's sorted order.  The program
may change its own copies; these stay as they are, so that every later
run draws the same inputs from the same seed.

Everything is a function of its arguments: the sizes come from a cell's
configuration and traffic files, the randomness from ``subseed``.
"""
from __future__ import annotations

import dataclasses
import string

import numpy as np
import torch

SENTINEL = 2**31 - 1

# the reference's key alphabet and delta range (main.go:274-282)
ALPHABET = string.ascii_letters + string.digits
LOG_FIELDS = ("ts", "rid", "seq", "key", "val", "payload", "is_num")
# OR-Set tags pack as elem | rid | seq into one order-preserving int32
SET_ELEM_BITS, SET_RID_BITS, SET_SEQ_BITS = 14, 6, 11
# lanes drawn per generator pass (bounds the draw's temporaries)
SET_CHUNK = 1 << 16


def subseed(seed: int, *path: int) -> int:
    """A 63-bit seed for one stream of the run, from the run's ``--seed``
    (any whole number) and a path of small ints naming the stream."""
    entropy = [int(seed) % (1 << 64)] + [int(p) for p in path]
    return int(np.random.SeedSequence(entropy).generate_state(1, np.uint64)[0] >> 1)


def device_generator(device, seed: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed)


# ---- the KV store: reference-shaped write bursts ----


@dataclasses.dataclass
class Pool:
    """A burst of writes as numpy op columns sorted by (ts, rid, seq, key),
    the log's own row order, and the value strings by payload id."""

    ops: dict
    values: list

    def __len__(self) -> int:
        return len(self.ops["ts"])


def reference_writes(n_writes: int, n_replicas: int, seed: int, *, delta_min: int,
                     delta_max: int, non_numeric: float, writes_per_ms: int) -> Pool:
    """``workload.reference_writes``: single-key commands, keys uniform
    over the alphabet, deltas uniform in [delta_min, delta_max], a
    ``non_numeric`` share of free-text values, each posted to a uniformly
    random writer that numbers its ops from 0; ``writes_per_ms`` writes
    share a millisecond ts."""
    rng = np.random.default_rng(seed)
    key = rng.integers(0, len(ALPHABET), n_writes)
    delta = rng.integers(delta_min, delta_max + 1, n_writes)
    writer = rng.integers(0, n_replicas, n_writes)
    text = rng.random(n_writes) < non_numeric
    word = rng.integers(0, 1000, n_writes)

    values: list = []
    ids: dict = {}
    seq_of = np.zeros(n_replicas, np.int64)
    cols = {f: np.zeros(n_writes, np.int32) for f in LOG_FIELDS[:-1]}
    cols["is_num"] = np.zeros(n_writes, bool)
    for i in range(n_writes):
        w = int(writer[i])
        value = f"v{word[i]}" if text[i] else str(int(delta[i]))
        if value not in ids:
            ids[value] = len(values)
            values.append(value)
        cols["ts"][i] = i // writes_per_ms
        cols["rid"][i] = w
        cols["seq"][i] = seq_of[w]
        cols["key"][i] = key[i]
        cols["val"][i] = 0 if text[i] else delta[i]
        cols["payload"][i] = ids[value]
        cols["is_num"][i] = not text[i]
        seq_of[w] += 1
    order = np.lexsort([cols[f] for f in ("key", "seq", "rid", "ts")])
    return Pool(ops={f: x[order] for f, x in cols.items()}, values=values)


def draw_held(n_replicas: int, n_ops: int, fraction: float,
              gen: torch.Generator) -> torch.Tensor:
    """bool[R, P]: which pool ops (in pool order) each replica holds."""
    return torch.rand((n_replicas, n_ops), generator=gen, device=gen.device) < fraction


def logs_from_held(pool: Pool, held: torch.Tensor, capacity: int) -> dict:
    """``workload.subset_swarm``'s layout from a held mask: per replica its
    held ops in pool (= log) order, the first ``capacity`` of them, then
    padding (SENTINEL in the identity columns, 0 / False in the values).
    Returns ({field: [R, capacity] tensor}, the mask of what was kept)."""
    device = held.device
    held = held & (torch.cumsum(held, dim=1) <= capacity)
    pick = torch.sort((~held).to(torch.uint8), dim=1, stable=True).indices[:, :capacity]
    keep = held.gather(1, pick)
    out = {}
    for f in LOG_FIELDS:
        fill = False if f == "is_num" else SENTINEL if f in ("ts", "rid", "seq", "key") else 0
        col = torch.as_tensor(pool.ops[f], device=device)
        x = col[pick].masked_fill(~keep, fill)
        pad = torch.full((x.shape[0], capacity - x.shape[1]), fill, dtype=x.dtype, device=device)
        out[f] = torch.cat([x, pad], dim=1)
    return out, held


def random_peers(gen: torch.Generator, r: int) -> torch.Tensor:
    """``swarm.random_peers`` without self: replica j pulls from a uniform
    one of the r - 1 others (a random offset in [1, r))."""
    offsets = torch.randint(1, r, (r,), generator=gen, device=gen.device)
    return (torch.arange(r, device=gen.device) + offsets) % r


# ---- the OR-Set swarm (BASELINE.json configs[3]) ----


@dataclasses.dataclass
class SetPool:
    """The add-tags every replica draws from, numpy columns sorted by
    (elem, rid, seq), the table's own row order."""

    elem: np.ndarray
    rid: np.ndarray
    seq: np.ndarray
    removable: np.ndarray

    def __len__(self) -> int:
        return len(self.elem)

    def packed(self) -> np.ndarray:
        return ((self.elem.astype(np.int64) << (SET_RID_BITS + SET_SEQ_BITS))
                | (self.rid.astype(np.int64) << SET_SEQ_BITS) | self.seq).astype(np.int32)


def set_pool(seed: int, *, elems: int, writers: int, tags_per_writer: int,
             removable: float) -> SetPool:
    """``workload.set_pool``: ``writers`` x ``tags_per_writer`` add-tags on
    elements uniform over ``elems`` ids; a seeded ``removable`` share of
    them has been removed somewhere."""
    rng = np.random.default_rng(seed)
    n = writers * tags_per_writer
    rid = np.repeat(np.arange(writers, dtype=np.int32), tags_per_writer)
    seq = np.tile(np.arange(tags_per_writer, dtype=np.int32), writers)
    elem = rng.integers(0, elems, n).astype(np.int32)
    dead = np.zeros(n, bool)
    dead[rng.choice(n, int(round(removable * n)), replace=False)] = True
    order = np.lexsort((seq, rid, elem))
    return SetPool(elem=elem[order], rid=rid[order], seq=seq[order], removable=dead[order])


def relabel_elems(pool: SetPool, elems: int, seed: int) -> SetPool:
    """``pool`` with its element ids permuted by ``seed``, in key order
    again: pools relabelled by different seeds have the same element
    multiplicities, which set the member mask's work, in another order."""
    elem = np.random.default_rng(seed).permutation(elems).astype(np.int32)[pool.elem]
    order = np.lexsort((pool.seq, pool.rid, elem))
    return SetPool(elem=elem[order], rid=pool.rid[order], seq=pool.seq[order],
                   removable=pool.removable[order])


def set_draws(pool: SetPool, n_replicas: int, capacity: int, seed: int, *, hold: float,
              seen_remove: float, device):
    """``workload.set_swarm``'s draw, lane block by lane block: yields
    (start, held[n, P], seen[n, P]) for blocks of ``SET_CHUNK`` lanes.  A
    replica holds a ``hold`` share of the pool (its first ``capacity`` in
    key order) and has seen the remove of each removable tag it holds with
    probability ``seen_remove``.  The same seed yields the same blocks."""
    gen = device_generator(device, seed)
    p = len(pool)
    removable = torch.as_tensor(pool.removable, device=device)[None]
    for start in range(0, n_replicas, SET_CHUNK):
        n = min(SET_CHUNK, n_replicas - start)
        h = torch.rand((n, p), generator=gen, device=device) < hold
        h &= torch.cumsum(h, dim=1, dtype=torch.int32) <= capacity
        sn = h & removable & (torch.rand((n, p), generator=gen, device=device) < seen_remove)
        yield start, h, sn


def set_swarm(pool: SetPool, n_replicas: int, capacity: int, seed: int, *, hold: float,
              seen_remove: float, device) -> dict:
    """The swarm's rows as plain [R, C] tensors {elem, rid, seq: int32,
    removed: bool}: per replica its held tags in key order, then SENTINEL
    padding."""
    cols = {f: torch.as_tensor(getattr(pool, f), device=device)[None]
            for f in ("elem", "rid", "seq")}
    out = {f: torch.full((n_replicas, capacity), SENTINEL, dtype=torch.int32, device=device)
           for f in cols}
    out["removed"] = torch.zeros((n_replicas, capacity), dtype=torch.bool, device=device)
    for start, h, sn in set_draws(pool, n_replicas, capacity, seed, hold=hold,
                                  seen_remove=seen_remove, device=device):
        n = h.shape[0]
        row = torch.cumsum(h, dim=1, dtype=torch.int32) - 1
        # held tags to their row in key order; the rest to a spare column
        dest = torch.where(h, row, capacity).long()
        for f, src, fill in (("elem", cols["elem"], SENTINEL), ("rid", cols["rid"], SENTINEL),
                             ("seq", cols["seq"], SENTINEL), ("removed", sn, False)):
            table = torch.full((n, capacity + 1), fill, dtype=out[f].dtype, device=device)
            out[f][start:start + n] = table.scatter_(1, dest, src.expand(n, -1))[:, :capacity]
    return out
