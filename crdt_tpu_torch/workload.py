"""Seeded workloads for driving the port: reference-shaped writes for the
OpLog swarm and for a LocalCluster of replica nodes, the OR-Set swarm of BASELINE.json's configs[3], the RSeq
swarm of a seeded collaborative-editing history, and the counter and
register banks of BASELINE.json's configs 0-2.

The reference's workload (its ``dummyInsertions``; the JAX package's
``harness/workload.py`` and ``utils/config.py`` defaults): single-key
commands, keys uniform over the 62-character alphabet, deltas uniform in
[-20, -11], each posted to a uniformly random replica, which becomes the
op's writer.  Writers number their ops contiguously from 0 (``seq``) and
stamp them with a millisecond ``ts`` that several writes share.  A share
of the writes carries a non-numeric string, exercising the LWW payload
path of the rebuild.

The writes, the editing history and the counter and register banks are
drawn from numpy generators seeded by the caller, the OR-Set and RSeq
swarms from a torch.Generator on the device they are built on.

``WorkloadGenerator`` also drives any server of the reference's HTTP
surface (the port's ``api.http_shim``, the JAX package's, or the Go
original): single-op ``POST /data``, op pages through ``/ingest/page``
(429 back-off and page retries), and the typed siblings' routes.
"""
from __future__ import annotations

import dataclasses
import json
import random
import string
import time
import urllib.error
import urllib.request
from typing import List, Tuple

import numpy as np
import torch

from crdt_tpu_torch import default_device
from crdt_tpu_torch.models import oplog, orset, rseq
from crdt_tpu_torch.utils.config import ALPHABET as ALPHABET_REFERENCE
from crdt_tpu_torch.utils.config import ClusterConfig
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


class WorkloadGenerator:
    """The reference's ``dummyInsertions`` (its main.go:273-314) as the JAX
    package's ``harness/workload.py`` draws it: one key of
    ``config.key_alphabet``, a delta in [delta_min, delta_max], a random
    target replica, from ``random.Random(seed)`` in the JAX sequence."""

    def __init__(self, config: ClusterConfig | None = None, seed: int | None = None):
        self.config = config or ClusterConfig()
        self._rng = random.Random(self.config.seed if seed is None else seed)

    def next_command(self) -> Tuple[dict, int]:
        """Returns ({key: delta}, target_replica_index)."""
        c = self.config
        key = c.key_alphabet[self._rng.randrange(len(c.key_alphabet))]
        delta = self._rng.randint(c.delta_min, c.delta_max)
        target = self._rng.randrange(c.n_replicas)
        return {key: str(delta)}, target

    def drive_cluster(self, cluster, n_writes: int, gossip_every: int = 0) -> int:
        """Apply n_writes commands to ``cluster`` (a LocalCluster), with a
        gossip tick every ``gossip_every`` writes when non-zero.  Returns
        the accepted write count."""
        accepted = 0
        for i in range(n_writes):
            cmd, target = self.next_command()
            accepted += bool(cluster.nodes[target].add_command(cmd))
            if gossip_every and (i + 1) % gossip_every == 0:
                cluster.tick()
        return accepted

    # ---- over HTTP (the port's HttpCluster, the JAX one, or a Go server) ----

    @staticmethod
    def _post(url: str, body: dict, timeout: float) -> bool:
        """POST ``body`` as JSON; True on a 200.  A dead replica's answer or
        a transport failure is skipped, like main.go:301-304."""
        req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                     headers={"Content-Type": "application/json"},
                                     method="POST")
        try:
            with urllib.request.urlopen(req, timeout=timeout) as res:
                return res.status == 200
        except (urllib.error.URLError, OSError):
            return False

    def drive_http(self, urls: List[str], n_writes: int, timeout: float = 5.0) -> int:
        """POST n_writes commands to ``/data`` of random replicas; returns
        the accepted count."""
        accepted = 0
        for _ in range(n_writes):
            cmd, target = self.next_command()
            accepted += self._post(urls[target % len(urls)] + "/data", cmd, timeout)
        return accepted

    def next_set_op(self) -> Tuple[str, str, int]:
        """Returns (op, elem, target): 65% adds, 35% observed-removes over
        the alphabet's elements."""
        c = self.config
        op = "add" if self._rng.random() < 0.65 else "remove"
        elem = "s" + c.key_alphabet[self._rng.randrange(len(c.key_alphabet))]
        return op, elem, self._rng.randrange(c.n_replicas)

    def drive_set_http(self, urls: List[str], n_ops: int, timeout: float = 5.0) -> int:
        """``/set/add`` and ``/set/remove`` on random replicas."""
        accepted = 0
        for _ in range(n_ops):
            op, elem, target = self.next_set_op()
            accepted += self._post(urls[target % len(urls)] + f"/set/{op}", {"elem": elem},
                                   timeout)
        return accepted

    def drive_seq_http(self, urls: List[str], n_ops: int, timeout: float = 5.0) -> int:
        """70% inserts at a random index (the node clamps), 30% removes."""
        accepted = 0
        for _ in range(n_ops):
            target = self._rng.randrange(self.config.n_replicas)
            if self._rng.random() < 0.7:
                body = {"elem": f"q{self._rng.randrange(1 << 20)}",
                        "index": self._rng.randint(0, 20)}
                path = "/seq/insert"
            else:
                body = {"index": self._rng.randint(0, 20)}
                path = "/seq/remove"
            accepted += self._post(urls[target % len(urls)] + path, body, timeout)
        return accepted

    def drive_map_http(self, urls: List[str], n_ops: int, timeout: float = 5.0) -> int:
        """75% signed-delta updates on 8 hot keys (the reference's per-key
        counter shape), 25% observed-removes."""
        accepted = 0
        c = self.config
        for _ in range(n_ops):
            target = self._rng.randrange(c.n_replicas)
            key = "m" + c.key_alphabet[self._rng.randrange(min(8, len(c.key_alphabet)))]
            if self._rng.random() < 0.75:
                body = {"key": key, "delta": self._rng.randrange(10) - 2 * 10}
                path = "/map/upd"
            else:
                body = {"key": key}
                path = "/map/rem"
            accepted += self._post(urls[target % len(urls)] + path, body, timeout)
        return accepted

    def drive_pages_http(self, urls: List[str], n_writes: int, page_size: int = 256,
                         timeout: float = 5.0, max_retries: int = 8) -> dict:
        """The command stream of drive_http batched into columnar op pages,
        one PageBuilder (writer stream) per replica.  A 429 backs off its
        Retry-After and resends the same page (the per-origin page_seq
        watermark makes the retry idempotent).  Returns {"admitted",
        "pages", "sheds", "lost"}."""
        from crdt_tpu_torch.ingest import PageBuilder

        builders = [PageBuilder(origin=1000 + i, page_size=page_size) for i in range(len(urls))]
        out = {"admitted": 0, "pages": 0, "sheds": 0, "lost": 0}

        def post(target: int, raw: bytes) -> None:
            out["pages"] += 1
            for _ in range(max_retries):
                verdict = self._post_page(urls[target], raw, timeout)
                if verdict.get("shed"):
                    out["sheds"] += 1
                    time.sleep(float(verdict.get("retry_after", 0.05)))
                    continue
                if verdict.get("ok"):
                    out["admitted"] += int(verdict.get("admitted", 0))
                return
            out["lost"] += 1  # gave up after max_retries sheds (counted)

        for _ in range(n_writes):
            cmd, target = self.next_command()
            ((key, value),) = cmd.items()
            raw = builders[target].add(key, value)
            if raw is not None:
                post(target, raw)
        for target, b in enumerate(builders):
            raw = b.flush()
            if raw is not None:
                post(target, raw)
        return out

    @staticmethod
    def _post_page(url: str, raw: bytes, timeout: float) -> dict:
        req = urllib.request.Request(url + "/ingest/page", data=raw,
                                     headers={"Content-Type": "application/octet-stream"},
                                     method="POST")
        try:
            with urllib.request.urlopen(req, timeout=timeout) as res:
                body = res.read()
        except urllib.error.HTTPError as e:
            if e.code == 429:
                retry = e.headers.get("Retry-After")
                return {"shed": True, "retry_after": float(retry) if retry else 0.05}
            return {}
        except (urllib.error.URLError, OSError):
            return {}  # dead replica: skipped, like main.go:301-304
        try:
            return {"ok": True, **json.loads(body)}
        except ValueError:
            return {}


ODD_NUMERALS = ("007", "+7", "-0", "+0", "000")


def mixed_command(rng: np.random.Generator) -> dict:
    """One command of the JAX package's parity mix (tests/test_parity.py's
    ``_rand_cmd``, drawn from ``rng`` in its sequence): a second key one
    time in five, a non-numeric value ("s<n>") 15% of the time, a numeral
    that Atoi accepts but Itoa would not print (kept verbatim while it is a
    key's only numeric op) 10% of the time, else a reference delta in
    [-20, -11]."""
    n_keys = 1 + int(rng.random() < 0.2)
    cmd = {}
    while len(cmd) < n_keys:
        k = ALPHABET_REFERENCE[rng.integers(0, len(ALPHABET_REFERENCE))]
        u = rng.random()
        if u < 0.15:
            cmd[k] = "s" + str(int(rng.integers(0, 100)))
        elif u < 0.25:
            cmd[k] = str(rng.choice(list(ODD_NUMERALS)))
        else:
            cmd[k] = str(int(rng.integers(0, 10)) - 20)
    return cmd


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


# ---- the OR-Set swarm ----
#
# BASELINE.json's configs[3], "OR-Set: 1M replicas x 1K elements": elements
# uniform over a 1,024-id universe, 64 writers (the packed tag's full 6-bit
# rid budget) with 20 add-tags each, seqs contiguous from 0.  A seeded
# quarter of the tags has been removed somewhere; a replica holds a seeded
# 40% of the tags and, of each removable tag it holds, has seen the remove
# with probability 1/2 — so a replica's tombstones are always among its
# tags.  A lane then holds ~512 tags and the union of two ~819, under the
# 1024-row capacity.
SET_ELEMS = 1024
SET_WRITERS = 64
SET_TAGS_PER_WRITER = 20
SET_REMOVABLE = 0.25
SET_HOLD = 0.4
SET_SEEN_REMOVE = 0.5
# lanes drawn per generator pass (bounds the draw's temporaries)
_SET_CHUNK = 1 << 16


@dataclasses.dataclass
class SetPool:
    """The add-tags every replica draws from, numpy columns sorted by
    (elem, rid, seq) — the table's own row order."""

    elem: np.ndarray
    rid: np.ndarray
    seq: np.ndarray
    removable: np.ndarray  # bool: the tag's remove happened somewhere

    def __len__(self) -> int:
        return len(self.elem)


@dataclasses.dataclass
class SetSwarm:
    """A batched [R, C] ORSet and, per replica, which pool tags it holds
    (``held[r, i]``) and which of those it has seen removed (``seen``)."""

    sets: orset.ORSet
    held: torch.Tensor
    seen: torch.Tensor


def set_pool(seed: int) -> SetPool:
    rng = np.random.default_rng(seed)
    n = SET_WRITERS * SET_TAGS_PER_WRITER
    rid = np.repeat(np.arange(SET_WRITERS, dtype=np.int32), SET_TAGS_PER_WRITER)
    seq = np.tile(np.arange(SET_TAGS_PER_WRITER, dtype=np.int32), SET_WRITERS)
    elem = rng.integers(0, SET_ELEMS, n).astype(np.int32)
    removable = np.zeros(n, bool)
    removable[rng.choice(n, int(round(SET_REMOVABLE * n)), replace=False)] = True
    order = np.lexsort((seq, rid, elem))
    return SetPool(elem=elem[order], rid=rid[order], seq=seq[order],
                   removable=removable[order])


def set_swarm(pool: SetPool, n_replicas: int, capacity: int, seed: int,
              device=None) -> SetSwarm:
    """R replicas' OR-Sets drawn from ``pool`` with a torch.Generator on
    ``device`` seeded by ``seed``, in bulk (lane blocks of 65,536, no loop
    over lanes).  A replica that draws more than ``capacity`` tags keeps
    its first ``capacity`` in key order; ``held`` says which it kept."""
    device = default_device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    p = len(pool)

    def col(x):
        return torch.as_tensor(x, device=device)[None].expand(_SET_CHUNK, p)

    elem, rid, seq = col(pool.elem), col(pool.rid), col(pool.seq)
    removable = col(pool.removable)
    s = torch.full((n_replicas, capacity), SENTINEL_PY, dtype=torch.int32, device=device)
    sets = orset.ORSet(elem=s, rid=s.clone(), seq=s.clone(),
                       removed=torch.zeros((n_replicas, capacity), dtype=torch.bool,
                                           device=device))
    held = torch.empty((n_replicas, p), dtype=torch.bool, device=device)
    seen = torch.empty((n_replicas, p), dtype=torch.bool, device=device)
    for start in range(0, n_replicas, _SET_CHUNK):
        n = min(_SET_CHUNK, n_replicas - start)
        h = torch.rand((n, p), generator=gen, device=device) < SET_HOLD
        row = torch.cumsum(h, dim=1, dtype=torch.int32) - 1
        h &= row < capacity
        sn = h & removable[:n] & (torch.rand((n, p), generator=gen, device=device)
                                  < SET_SEEN_REMOVE)
        # held tags to their row in pool (= key) order; the rest to a spare
        # column that is cut off
        dest = torch.where(h, row, capacity).long()
        for name, src, fill in (("elem", elem, SENTINEL_PY), ("rid", rid, SENTINEL_PY),
                                ("seq", seq, SENTINEL_PY), ("removed", sn, False)):
            out = getattr(sets, name)
            table = torch.full((n, capacity + 1), fill, dtype=out.dtype, device=device)
            out[start:start + n] = table.scatter_(1, dest, src[:n])[:, :capacity]
        held[start:start + n] = h
        seen[start:start + n] = sn
    return SetSwarm(sets=sets, held=held, seen=seen)


def set_view(pool: SetPool, held: np.ndarray, seen: np.ndarray):
    """Plain fold over replicas of the OR-Set join: ``held``/``seen`` are
    bool[P] for one replica or bool[k, P] for k replicas to join.  Returns
    ({(elem, rid, seq): tombstoned}, {live elements}) — an independent
    check of the device path."""
    tags: dict = {}
    for h_row, s_row in zip(np.atleast_2d(held), np.atleast_2d(seen)):
        for i in np.nonzero(h_row)[0]:
            tag = (int(pool.elem[i]), int(pool.rid[i]), int(pool.seq[i]))
            tags[tag] = tags.get(tag, False) or bool(s_row[i])
    members = {e for (e, _, _), dead in tags.items() if not dead}
    return tags, members


def strided_columns(capacity: int, lanes: int, fill: int, space: int, seed: int,
                    device=None):
    """Per-lane sorted unique keys with a SENTINEL tail (the JAX package's
    three-arm draw, ``benches/bench_orset.py`` ``make_columns`` with
    ``space``): the ``fill`` live rows are strided-jittered over
    [0, space), one key per ``space // fill`` stratum, so every lane is
    strictly ascending and the same draw is legal for the sorted,
    bucketed and bitmap layouts.  Values are key & 1 on live rows and 0 on
    padding, the contract's padding.  Returns (keys, vals) int32[C, L]."""
    device = default_device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    stride = max(space // max(fill, 1), 1)
    jitter = torch.randint(0, stride, (capacity, lanes), generator=gen,
                           dtype=torch.int32, device=device)
    ks = torch.arange(capacity, dtype=torch.int32, device=device)[:, None] * stride + jitter
    live = torch.arange(capacity, device=device)[:, None] < fill
    return torch.where(live, ks, SENTINEL_PY), torch.where(live, ks & 1, 0)


# ---- the RSeq swarm ----
#
# One shared document typed by 16 writers (rids 0-15, seqs contiguous from
# 0) in rounds: at the start of a round each writer takes a snapshot of the
# document, picks a seeded index of it and types a run of 1-32 elements
# there (each key allocated after the previous one, as SeqWriter.insert_run
# does).  Runs typed into one gap in the same round collide at their first
# element and descend under the left neighbour, so concurrent editing
# pushes keys to depth 2 and below.  The history stops at 1,000 elements
# (the OpLog phase's 1,000 writes; under C = 1024).  A seeded 25% of the
# elements are removable: their remove happened somewhere.  A replica
# holds a seeded 40% of the elements and, of each removable element it
# holds, has seen the remove with probability 1/2.
SEQ_WRITERS = 16
SEQ_RUN_MAX = 32
SEQ_ELEMENTS = 1000
SEQ_REMOVABLE = 0.25
SEQ_HOLD = 0.4
SEQ_SEEN_REMOVE = 0.5


@dataclasses.dataclass
class SeqPool:
    """The elements every replica draws from, numpy rows sorted by key —
    the table's own row order (the document order)."""

    keys: np.ndarray       # int32[P, 4*D]  flattened path keys
    elem: np.ndarray       # int32[P]       payload id (the creation index)
    removable: np.ndarray  # bool[P]        the element's remove happened somewhere

    def __len__(self) -> int:
        return len(self.elem)

    def depth_histogram(self) -> dict:
        """{real depth: elements} over the pool."""
        d = self.keys.shape[1] // 4
        depths = [rseq.real_depth(rseq._triples(row, d)) for row in self.keys.tolist()]
        return {k: depths.count(k) for k in sorted(set(depths))}


@dataclasses.dataclass
class SeqSwarm:
    """A batched [R, C, 4D] RSeq and, per replica, which pool elements it
    holds (``held[r, i]``) and which of those it has seen removed
    (``seen``)."""

    states: rseq.RSeq
    held: torch.Tensor
    seen: torch.Tensor


def seq_pool(seed: int, depth: int = rseq.DEPTH,
             n_elements: int = SEQ_ELEMENTS) -> SeqPool:
    """The seeded editing history of ``n_elements`` elements, made on the
    host with the port's own ``rseq.alloc_key``."""
    rng = np.random.default_rng(seed)
    doc: list = []                     # key rows, in document (= key) order
    elem: dict = {}                    # key row -> creation index
    next_seq = [0] * SEQ_WRITERS
    while len(doc) < n_elements:
        snapshot, typed = list(doc), []
        for w in range(SEQ_WRITERS):
            run = int(rng.integers(1, SEQ_RUN_MAX + 1))
            at = int(rng.integers(0, len(snapshot) + 1))
            run = min(run, n_elements - len(doc) - len(typed))
            left = snapshot[at - 1] if at > 0 else None
            right = snapshot[at] if at < len(snapshot) else None
            for _ in range(run):
                key = rseq.alloc_key(left, right, w, next_seq[w], depth)
                next_seq[w] += 1
                elem[key] = len(elem)
                typed.append(key)
                left = key
        doc = sorted(doc + typed)
    removable = np.zeros(len(doc), bool)
    removable[rng.choice(len(doc), int(round(SEQ_REMOVABLE * len(doc))),
                         replace=False)] = True
    return SeqPool(keys=np.asarray(doc, np.int32),
                   elem=np.asarray([elem[k] for k in doc], np.int32),
                   removable=removable)


def seq_swarm(pool: SeqPool, n_replicas: int, capacity: int, seed: int,
              device=None) -> SeqSwarm:
    """R replicas' RSeq tables drawn from ``pool`` with a torch.Generator on
    ``device`` seeded by ``seed``, in bulk.  A replica that draws more than
    ``capacity`` elements keeps its first ``capacity`` in key order;
    ``held`` says which it kept."""
    device = default_device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    p = len(pool)
    removable = torch.as_tensor(pool.removable, device=device)
    held = torch.rand((n_replicas, p), generator=gen, device=device) < SEQ_HOLD
    row = torch.cumsum(held, dim=1, dtype=torch.int32) - 1
    held &= row < capacity
    seen = held & removable & (torch.rand((n_replicas, p), generator=gen, device=device)
                               < SEQ_SEEN_REMOVE)
    # each held element's pool index to its row in key order; the rest to a
    # spare column that is cut off; an empty row points at the padding row
    # appended to the pool, index p
    dest = torch.where(held, row, capacity).long()
    idx = torch.full((n_replicas, capacity + 1), p, dtype=torch.long, device=device)
    idx.scatter_(1, dest, torch.arange(p, device=device).expand(n_replicas, p))
    idx = idx[:, :capacity]
    width = pool.keys.shape[1]
    keys = torch.cat([torch.as_tensor(pool.keys, device=device),
                      torch.full((1, width), SENTINEL_PY, dtype=torch.int32, device=device)])
    elem = torch.cat([torch.as_tensor(pool.elem, device=device),
                      torch.zeros(1, dtype=torch.int32, device=device)])
    removed = torch.zeros((n_replicas, capacity + 1), dtype=torch.bool, device=device)
    removed.scatter_(1, dest, seen)
    return SeqSwarm(states=rseq.RSeq(keys=keys[idx], elem=elem[idx],
                                     removed=removed[:, :capacity]),
                    held=held, seen=seen)


def seq_view(pool: SeqPool, held: np.ndarray, seen: np.ndarray):
    """Plain fold over replicas of the RSeq join: ``held``/``seen`` are
    bool[P] for one replica or bool[k, P] for k replicas to join.  Returns
    ({(rid, seq): tombstoned}, [live elem in key order]) — an independent
    check of the device path."""
    held = np.atleast_2d(held).any(axis=0)
    seen = np.atleast_2d(seen).any(axis=0)
    tombs, live = {}, []
    for i in np.nonzero(held)[0]:
        tombs[(int(pool.keys[i, -2]), int(pool.keys[i, -1]))] = bool(seen[i])
        if not seen[i]:
            live.append(int(pool.elem[i]))
    return tombs, live


# ---- the counter and register banks ----
#
# BASELINE.json's configs 0-2 as the JAX package's bench.py and
# benches/bench_baseline.py draw them: every counter slot, timestamp and
# payload uniform in [0, 2^20), LWW writer ids uniform in [0, 64).  The bits
# are numpy's, not jax.random's.
COUNTER_HIGH = 1 << 20
LWW_RIDS = 64
# the flag and MV-register op script: the share of replicas that applies
# each op
SCRIPT_SHARE = 0.25


def counter_bank(seed: int, shape: tuple) -> np.ndarray:
    """int32 counter planes uniform in [0, 2^20): a state, or a bank of
    peer states with the bank on the leading axis."""
    return np.random.default_rng(seed).integers(0, COUNTER_HIGH, shape, dtype=np.int32)


def lww_bank(seed: int, shape: tuple) -> dict:
    """LWW register planes ``{ts, rid, payload}``: ts and payload uniform in
    [0, 2^20), rid uniform in [0, 64)."""
    rng = np.random.default_rng(seed)
    return {"ts": rng.integers(0, COUNTER_HIGH, shape, dtype=np.int32),
            "rid": rng.integers(0, LWW_RIDS, shape, dtype=np.int32),
            "payload": rng.integers(0, COUNTER_HIGH, shape, dtype=np.int32)}


def register_script(seed: int, n_ops: int, n_replicas: int, n_writers: int) -> list:
    """A seeded op script for the flags and the MV-register: op i is made by
    ``writer`` at timestamp i on the replicas where ``mask`` holds (a seeded
    quarter of them); it enables or disables the flags (``enable``) and
    writes ``payload`` to the register.  Returns a list of dicts."""
    rng = np.random.default_rng(seed)
    return [{"writer": int(rng.integers(0, n_writers)), "ts": i,
             "payload": int(rng.integers(0, COUNTER_HIGH)),
             "enable": bool(rng.integers(0, 2)),
             "mask": rng.random(n_replicas) < SCRIPT_SHARE} for i in range(n_ops)]


def lexn_pair(n_keys: int, n_vals: int, capacity: int, lanes: int, seed: int, *,
              deep: int = 11, fill: float = 0.4, b_inside_a: bool = False,
              empty_lanes=(), device=None):
    """Two lexN operands for the kernel checks: (keys_a, vals_a, keys_b,
    vals_b), each a (P, capacity, lanes) int32 block, rows sorted per lane
    over the ``n_keys`` key words, SENTINEL/0 padded.  Each lane holds a
    seeded subset of one universe of 2·capacity distinct keys, whose words
    but the last ``deep`` are all equal (so every compare reads deep into
    the key; the last word is drawn wide, so the keys are distinct); with ``b_inside_a`` every row of B is also a row of A; the
    lanes of ``empty_lanes`` are all padding on both sides.  Value words are
    uniform int32 ≥ 0, drawn apart for the two sides, so that equal keys
    carry different values.  The universe comes from numpy seeded by
    ``seed``, the subsets from a torch.Generator on ``device``."""
    device = default_device(device)
    rng = np.random.default_rng(seed)
    u = 2 * capacity
    varied = min(deep, n_keys)
    words = np.full((8 * u, n_keys), 7, np.int64)
    words[:, n_keys - varied:] = rng.integers(0, 4, (8 * u, varied))
    words[:, -1] = rng.integers(0, 1 << 20, 8 * u)  # distinct at any width
    universe = np.unique(words, axis=0)
    universe = universe[np.sort(rng.choice(len(universe), min(u, len(universe)),
                                           replace=False))]
    universe = torch.as_tensor(universe.T.astype(np.int32), device=device)
    gen = torch.Generator(device=device).manual_seed(seed)
    n_u = universe.shape[1]

    def draw():
        return torch.rand((n_u, lanes), generator=gen, device=device) < fill

    def cut(held):  # a lane keeps its first `capacity` keys
        held[:, list(empty_lanes)] = False
        return held & (torch.cumsum(held, dim=0) <= capacity)

    held_a = cut(draw())
    held_b = cut(held_a & draw() if b_inside_a else draw())

    def side(held):
        row = torch.cumsum(held, dim=0) - 1
        src, lane = held.nonzero(as_tuple=True)
        keys = torch.full((n_keys, capacity, lanes), SENTINEL_PY, dtype=torch.int32,
                          device=device)
        keys[:, row[src, lane], lane] = universe[:, src]
        vals = torch.randint(0, 2**31 - 1, (n_vals, capacity, lanes), generator=gen,
                             dtype=torch.int32, device=device)
        return keys, vals.masked_fill(keys[0] == SENTINEL_PY, 0)

    return (*side(held_a), *side(held_b))
