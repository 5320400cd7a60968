"""Randomized reachable-state generators for every registered join
(counterpart of ``crdt_tpu.ops.randstate``).

Each ``rand_*`` takes a ``numpy.random.Generator`` and returns one lattice
state from the join's reachable state space, consuming the generator in
exactly the JAX package's order, so one seed gives both packages the same
state.  Each ``small_*`` returns a deterministic list of tiny reachable
states.  Every generator takes ``device=None`` (the CUDA card).

Two soundness rules keep independently drawn states mutually consistent:

* **payload-from-identity** — wherever a row carries an identity, its
  payload is a pure function of that identity;
* **capacity headroom** — sorted fixed-capacity lattices are filled to at
  most ~capacity/3 so pairwise and three-way law joins stay within
  capacity.
"""
from __future__ import annotations

import itertools

import numpy as np
import torch

from crdt_tpu_torch import default_device
from crdt_tpu_torch.utils.constants import SENTINEL_PY


def _t(x, dtype, device) -> torch.Tensor:
    return torch.tensor(np.asarray(x)).to(dtype=dtype, device=default_device(device))


def _i32(rng: np.random.Generator, lo: int, hi: int, shape=(), device=None):
    return _t(rng.integers(lo, hi, shape), torch.int32, device)


def rand_gcounter(rng, n_nodes: int = 8, device=None):
    from crdt_tpu_torch.models import gcounter

    return gcounter.GCounter(counts=_i32(rng, 0, 100, (n_nodes,), device))


def rand_pncounter(rng, n_nodes: int = 8, device=None):
    from crdt_tpu_torch.models import pncounter

    return pncounter.PNCounter(
        pos=_i32(rng, 0, 100, (n_nodes,), device),
        neg=_i32(rng, 0, 100, (n_nodes,), device),
    )


def _lww_payload(ts, rid):
    # payload-from-identity: the value of write (ts, rid) is a fixed hash
    return (ts * 131 + rid * 17) % 997


def _lww_reg(ts: int, rid: int, device):
    from crdt_tpu_torch.models import lww

    return lww.LWWRegister(ts=_t(ts, torch.int32, device), rid=_t(rid, torch.int32, device),
                           payload=_t(_lww_payload(ts, rid), torch.int32, device))


def rand_lww(rng, device=None):
    ts = int(rng.integers(0, 50))
    rid = int(rng.integers(0, 8))
    return _lww_reg(ts, rid, device)


def rand_lww_packed(rng, device=None):
    from crdt_tpu_torch.models import lww

    return lww.pack(rand_lww(rng, device=device))


def rand_mvregister(rng, n_writers: int = 4, device=None):
    from crdt_tpu_torch.models import mvregister

    # per-writer cells: only the zero element's bounds matter
    # (seq/obs >= -1, ts/payload >= 0)
    return mvregister.MVRegister(
        seq=_i32(rng, -1, 5, (n_writers,), device),
        ts=_i32(rng, 0, 50, (n_writers,), device),
        payload=_i32(rng, 0, 100, (n_writers,), device),
        obs=_i32(rng, -1, 5, (n_writers, n_writers), device),
    )


def rand_vvclock(rng, n_writers: int = 8, device=None):
    from crdt_tpu_torch.consistency import vvclock

    # any value >= -1 is reachable, so the draw spans the whole encoding
    return vvclock.VVClock(seqs=_i32(rng, -1, 20, (n_writers,), device))


def rand_token_plane(rng, n_writers: int = 4, device=None):
    from crdt_tpu_torch.models import flags

    return flags.TokenPlane(
        tok=_i32(rng, -1, 5, (n_writers,), device),
        obs=_i32(rng, -1, 5, (n_writers, n_writers), device),
    )


def rand_ew_flag(rng, n_writers: int = 4, device=None):
    from crdt_tpu_torch.models import flags

    return flags.EWFlag(plane=rand_token_plane(rng, n_writers, device))


def rand_dw_flag(rng, n_writers: int = 4, device=None):
    from crdt_tpu_torch.models import flags

    return flags.DWFlag(
        plane=rand_token_plane(rng, n_writers, device),
        touched=_t(bool(rng.integers(0, 2)), torch.bool, device),
    )


def _sorted_pad(elems, capacity: int, device):
    """Sorted int32[capacity] column with SENTINEL tail padding."""
    xs = sorted(elems) + [SENTINEL_PY] * (capacity - len(elems))
    return _t(np.asarray(xs, np.int64), torch.int32, device)


def rand_gset(rng, capacity: int = 16, fill: int = 5, device=None):
    from crdt_tpu_torch.models import gset

    elems = rng.choice(40, size=int(rng.integers(0, fill + 1)), replace=False)
    return gset.GSet(elem=_sorted_pad([int(e) for e in elems], capacity, device))


def rand_twopset(rng, capacity: int = 16, fill: int = 5, device=None):
    from crdt_tpu_torch.models import gset

    elems = sorted(int(e) for e in rng.choice(40, size=int(rng.integers(0, fill + 1)),
                                              replace=False))
    removed = [bool(rng.random() < 0.3) for _ in elems]
    pad = [False] * (capacity - len(elems))
    return gset.TwoPSet(elem=_sorted_pad(elems, capacity, device),
                        removed=_t(removed + pad, torch.bool, device))


def rand_orset(rng, capacity: int = 16, fill: int = 5, device=None):
    from crdt_tpu_torch.models import orset

    s = orset.empty(capacity, device=device)
    taken = set()
    for _ in range(int(rng.integers(0, fill + 1))):
        while True:
            tag = (int(rng.integers(0, 6)), int(rng.integers(0, 3)),
                   int(rng.integers(0, 50)))
            if tag not in taken:
                taken.add(tag)
                break
        s = orset.add(s, *tag)
        if rng.random() < 0.3:
            s = orset.remove(s, tag[0])
    return s


def rand_rseq(rng, capacity: int = 16, fill: int = 5, device=None):
    from crdt_tpu_torch.models import rseq

    depth = rseq.DEPTH
    rows = set()
    for _ in range(int(rng.integers(0, fill + 1))):
        rows.add(tuple(int(v) for v in rng.integers(0, 30, 4 * depth)))
    rows = sorted(rows)  # lexicographic row order == the table's sort order
    keys = np.full((capacity, 4 * depth), SENTINEL_PY, np.int64)
    elem = np.zeros((capacity,), np.int64)
    removed = np.zeros((capacity,), bool)
    for i, row in enumerate(rows):
        keys[i] = row
        # payload-from-identity: the element at a path key is a fixed hash
        elem[i] = sum((j + 3) * v for j, v in enumerate(row)) % 1009
        removed[i] = bool(rng.random() < 0.3)
    return rseq.RSeq(keys=_t(keys, torch.int32, device), elem=_t(elem, torch.int32, device),
                     removed=_t(removed, torch.bool, device))


def _rand_op_rows(rng, n: int, n_keys: int, n_rids: int):
    rows = set()
    while len(rows) < n:
        rows.add((
            int(rng.integers(0, 40)),
            int(rng.integers(0, n_rids)),
            int(rng.integers(0, 20)),
            int(rng.integers(0, n_keys)),
        ))
    rows = sorted(rows)
    # payload-from-identity: val / payload / is_num are fixed hashes of the
    # op identity (ts, rid, seq, key)
    ident = [ts * 7 + rid * 5 + seq * 3 + key for ts, rid, seq, key in rows]
    return {
        "ts": np.asarray([r[0] for r in rows], np.int32),
        "rid": np.asarray([r[1] for r in rows], np.int32),
        "seq": np.asarray([r[2] for r in rows], np.int32),
        "key": np.asarray([r[3] for r in rows], np.int32),
        "val": np.asarray([h % 41 - 20 for h in ident], np.int32),
        "payload": np.asarray([h % 499 for h in ident], np.int32),
        "is_num": np.asarray([h % 5 < 4 for h in ident], bool),
    }


def rand_oplog(rng, capacity: int = 32, fill: int = 10, n_keys: int = 6,
               n_rids: int = 3, device=None):
    from crdt_tpu_torch.models import oplog

    n = int(rng.integers(0, fill + 1))
    if n == 0:
        return oplog.empty(capacity, device=device)
    return oplog.from_ops(capacity, _rand_op_rows(rng, n, n_keys, n_rids), device=device)


def rand_compactlog(rng, capacity: int = 32, n_keys: int = 8, n_writers: int = 4,
                    fill: int = 10, device=None):
    from crdt_tpu_torch.models import compactlog

    # frontier = -1 everywhere (nothing folded): merge degenerates to a
    # plain tail union, where independently drawn states are law-abiding
    return compactlog.fresh(
        rand_oplog(rng, capacity=capacity, fill=fill, n_keys=n_keys, n_rids=n_writers,
                   device=device),
        n_keys, n_writers,
    )


# ---- deterministic tiny seed domains ----
#
# Each ``small_*`` returns a LIST of tiny reachable states at the SAME
# shapes as the registered neutral.  For sorted fixed-capacity lattices the
# union of every seed's keys must fit in capacity.


def small_gcounter(n_nodes: int = 8, vals=(0, 1, 2), slots: int = 2, device=None):
    """Every counts-vector over ``vals`` on the first ``slots`` coordinates
    (rest zero)."""
    from crdt_tpu_torch.models import gcounter

    out = []
    for combo in itertools.product(vals, repeat=slots):
        counts = [0] * n_nodes
        counts[:slots] = combo
        out.append(gcounter.GCounter(counts=_t(counts, torch.int32, device)))
    return out


def small_pncounter(n_nodes: int = 8, vals=(0, 1), slots: int = 2, device=None):
    from crdt_tpu_torch.models import pncounter

    out = []
    for pos in itertools.product(vals, repeat=slots):
        for neg in itertools.product(vals, repeat=slots):
            p = [0] * n_nodes
            n = [0] * n_nodes
            p[:slots] = pos
            n[:slots] = neg
            out.append(pncounter.PNCounter(pos=_t(p, torch.int32, device),
                                           neg=_t(n, torch.int32, device)))
    return out


def small_vvclock(n_writers: int = 8, vals=(-1, 0, 1), slots: int = 2, device=None):
    """Every watermark over ``vals`` on the first ``slots`` writers (rest
    unseen = -1)."""
    from crdt_tpu_torch.consistency import vvclock

    out = []
    for combo in itertools.product(vals, repeat=slots):
        seqs = [-1] * n_writers
        seqs[:slots] = combo
        out.append(vvclock.VVClock(seqs=_t(seqs, torch.int32, device)))
    return out


def small_lww(device=None):
    """zero plus every write with ts in {0,1,2} x rid in {0,1}."""
    from crdt_tpu_torch.models import lww

    out = [lww.zero(device=device)]
    for ts in (0, 1, 2):
        for rid in (0, 1):
            out.append(_lww_reg(ts, rid, device))
    return out


def small_lww_packed(device=None):
    from crdt_tpu_torch.models import lww

    return [lww.pack(s) for s in small_lww(device=device)]


def small_gset(capacity: int = 16, universe=(3, 7, 11), device=None):
    """Every subset of a tiny universe — the complete powerset lattice."""
    from crdt_tpu_torch.models import gset

    out = []
    for r in range(len(universe) + 1):
        for subset in itertools.combinations(universe, r):
            out.append(gset.GSet(elem=_sorted_pad(list(subset), capacity, device)))
    return out


def small_twopset(capacity: int = 16, universe=(3, 7), device=None):
    """Every element independently absent / present-live / present-removed."""
    from crdt_tpu_torch.models import gset

    out = []
    for states in itertools.product((0, 1, 2), repeat=len(universe)):
        elems = [e for e, s in zip(universe, states) if s]
        removed = [s == 2 for s in states if s]
        pad = [False] * (capacity - len(elems))
        out.append(gset.TwoPSet(elem=_sorted_pad(elems, capacity, device),
                                removed=_t(removed + pad, torch.bool, device)))
    return out


def rand_orset_bitmap(rng, universe: int = 64, device=None):
    """Random dense-layout OR-Set: ``removed`` is masked by ``present`` so
    every draw is reachable (a tombstone implies an observed tag)."""
    from crdt_tpu_torch.models import orset

    w = (universe + 31) // 32
    bits = rng.integers(0, 1 << 32, size=(2, w), dtype=np.uint64)
    present = bits[0].astype(np.uint32).view(np.int32)
    removed = (bits[1].astype(np.uint32).view(np.int32)) & present
    return orset.ORSetBitmap(present=_t(present, torch.int32, device),
                             removed=_t(removed, torch.int32, device))


def small_orset_bitmap(universe: int = 64, n_tags: int = 3, device=None):
    """Every (absent | live | tombstoned) state over the first ``n_tags``
    tags — 3^n_tags states."""
    from crdt_tpu_torch.models import orset

    out = []
    for code in itertools.product((0, 1, 2), repeat=n_tags):
        p = r = 0
        for t, st in enumerate(code):
            if st:
                p |= 1 << t
            if st == 2:
                r |= 1 << t
        base = orset.bitmap_empty(universe, device=device)
        base.present[0] = p
        base.removed[0] = r
        out.append(base)
    return out


def rand_orset_bucketed(rng, capacity: int = 32, n_buckets: int = 4, fill: int = 2,
                        key_bits: int = 8, device=None):
    """Random bucket-resident OR-Set: up to ``fill`` tags PER BUCKET, keys
    drawn within each bucket's range slice (per-bucket headroom)."""
    from crdt_tpu_torch.models import orset

    wb = capacity // n_buckets
    shift = key_bits - (n_buckets.bit_length() - 1)
    keys = np.full((capacity,), SENTINEL_PY, np.int32)
    removed = np.zeros((capacity,), np.int32)
    for b in range(n_buckets):
        n = int(rng.integers(0, fill + 1))
        lows = rng.choice(1 << shift, size=n, replace=False)
        ks = sorted((b << shift) | int(x) for x in lows)
        keys[b * wb: b * wb + n] = ks
        removed[b * wb: b * wb + n] = rng.integers(0, 2, size=n)
    return orset.ORSetBucketed(keys=_t(keys, torch.int32, device),
                               removed=_t(removed, torch.int32, device),
                               n_buckets=n_buckets, key_bits=key_bits)


def small_seeded(rand_fn, n: int = 5, seed: int = 0, device=None, **kw):
    """Fixed-seed draws from a ``rand_*`` generator — the seed domain for
    lattices too big to enumerate."""
    rng = np.random.default_rng(seed)
    return [rand_fn(rng, device=device, **kw) for _ in range(n)]


BUILTIN_RAND = {
    "gcounter": rand_gcounter,
    "pncounter": rand_pncounter,
    "vvclock": rand_vvclock,
    "lww": rand_lww,
    "lww_packed": rand_lww_packed,
    "mvregister": rand_mvregister,
    "token_plane": rand_token_plane,
    "ew_flag": rand_ew_flag,
    "dw_flag": rand_dw_flag,
    "gset": rand_gset,
    "twopset": rand_twopset,
    "orset": rand_orset,
    "orset_bitmap": rand_orset_bitmap,
    "orset_bucketed": rand_orset_bucketed,
    "rseq": rand_rseq,
    "oplog": rand_oplog,
    "compactlog": rand_compactlog,
}
