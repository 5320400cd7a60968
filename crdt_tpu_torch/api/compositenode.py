"""CompositeNode: an algebra-derived lattice across the process boundary
(counterpart of ``crdt_tpu.api.compositenode``).

The node serves ``mapof(pncounter)``, the OR-Map-of-counters composite
registered by :mod:`crdt_tpu_torch.models.composite`, and its merge is
that registered join and nothing else: the join the law sweeps check is
the one that folds gossip payloads here.

Wire model: state-based, unlike the op-shipping siblings.  A gossip
payload is the full trimmed state dump (keys, writer rids, and the four
OR-Map planes).  Join idempotence makes a duplicated delivery a no-op and
monotonicity makes old-after-new a no-op, so the payload needs no version
vector, no delta negotiation and no floor or epoch: the algebra's laws are
the protocol.  The payload grows with the key and writer universe; the
composite is meant for small maps (feature flags, quota counters).

State: the four planes (``tok``, ``obs``, ``pos``, ``neg``, int32, padded
to a power-of-two capacity) live on the node's device.  Local writes index
them in place; reads and the wire dump copy them to the host once.

Dispatch discipline: :meth:`CompositeNode.merge_decoded` folds any number
of decoded peer payloads and the local state in ONE reduction of the
registered join (``ops.joins.tree_reduce_join`` by name: log-depth
halving over the stacked states), so a k-way fused pull round costs the
composite one merge, as a single-peer pull does (``merge_dispatches``
counts them).

Alignment: peers intern keys and writers independently, so decoded
payloads arrive in foreign coordinate spaces.  ``merge_decoded`` builds
the union key and writer space on the host, scatters each payload into
the capacity-padded planes, and stacks [own, peer1, ..., peerK] for the
fold, which pads the stack to a power of two with the join identity.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from crdt_tpu_torch import default_device
from crdt_tpu_torch.utils.intern import Interner
from crdt_tpu_torch.utils.metrics import Metrics

COMPOSITE_JOIN = "mapof(pncounter)"


@dataclasses.dataclass
class DecodedComposite:
    """One validated peer payload in its own (foreign) coordinate space."""

    keys: List[str]
    writers: List[int]  # wire rids, column order
    tok: np.ndarray     # int32[K, W]
    obs: np.ndarray     # int32[K, W, W]
    pos: np.ndarray     # int32[K, W]
    neg: np.ndarray     # int32[K, W]


def _plane(x: Any, shape: tuple, what: str) -> np.ndarray:
    """Validate one wire plane into int32 of exactly ``shape`` (empty
    lists are accepted for zero-sized planes)."""
    try:
        a = np.asarray(x, dtype=np.int32)
    except Exception as e:
        raise ValueError(f"composite payload plane {what!r} is not an "
                         f"integer array: {e}") from None
    if a.size == 0 and 0 in shape:
        return a.reshape(shape)
    if a.shape != shape:
        raise ValueError(f"composite payload plane {what!r} has shape "
                         f"{a.shape}, expected {shape}")
    return a


def _empty_planes(k: int, w: int, device) -> tuple:
    """The join identity at capacity (k, w): no tokens, no observations,
    zero counts."""
    return (torch.full((k, w), -1, dtype=torch.int32, device=device),
            torch.full((k, w, w), -1, dtype=torch.int32, device=device),
            torch.zeros((k, w), dtype=torch.int32, device=device),
            torch.zeros((k, w), dtype=torch.int32, device=device))


def _ormap(tok, obs, pos, neg):
    from crdt_tpu_torch.models import flags, ormap, pncounter

    return ormap.ORMap(presence=flags.TokenPlane(tok=tok, obs=obs),
                       values=pncounter.PNCounter(pos=pos, neg=neg))


class CompositeNode:
    """One replica of the served ``mapof(pncounter)`` composite.

    Thread-safe like the sibling lattices (one lock over mutation, read
    and serve); every merge goes through the registry's composite join."""

    def __init__(self, rid: int, n_keys: int = 8, n_writers: int = 8,
                 metrics: Optional[Metrics] = None, device=None):
        self.rid = rid
        self.device = default_device(device)
        self.metrics = metrics or Metrics()
        self.alive = True
        self.keys = Interner()
        self._lock = threading.Lock()
        self._writers: List[int] = []           # column -> wire rid
        self._wcol: Dict[int, int] = {}         # wire rid -> column
        self._k = n_keys
        self._w = n_writers
        self._tok, self._obs, self._pos, self._neg = _empty_planes(
            n_keys, n_writers, self.device)
        self.merge_dispatches = 0

    # ---- capacity / interning (all under self._lock) ----

    def _grow_locked(self, k2: int, w2: int) -> None:
        if (k2, w2) == (self._k, self._w):
            return
        planes = _empty_planes(k2, w2, self.device)
        k, w = self._k, self._w
        planes[0][:k, :w] = self._tok
        planes[1][:k, :w, :w] = self._obs
        planes[2][:k, :w] = self._pos
        planes[3][:k, :w] = self._neg
        self._tok, self._obs, self._pos, self._neg = planes
        self._k, self._w = k2, w2

    def _grow_keys_locked(self, k_needed: int) -> None:
        k2 = self._k
        while k_needed > k2:
            k2 *= 2
        self._grow_locked(k2, self._w)

    def _grow_writers_locked(self, w_needed: int) -> None:
        w2 = self._w
        while w_needed > w2:
            w2 *= 2
        self._grow_locked(self._k, w2)

    def _kid_locked(self, key: str) -> int:
        kid = self.keys.intern(key)
        self._grow_keys_locked(len(self.keys))
        return kid

    def _wcol_locked(self, rid: int) -> int:
        col = self._wcol.get(rid)
        if col is None:
            col = len(self._writers)
            self._writers.append(int(rid))
            self._wcol[int(rid)] = col
            self._grow_writers_locked(len(self._writers))
        return col

    # ---- write path (local ops) ----

    def _upd_locked(self, key: str, delta: int) -> int:
        kid = self._kid_locked(str(key))
        col = self._wcol_locked(self.rid)
        self._tok[kid, col] = self._tok[kid, col].clamp(min=-1) + 1
        d = int(delta)
        if d >= 0:
            self._pos[kid, col] += d
        else:
            self._neg[kid, col] += -d
        self.metrics.inc("composite_ops")
        return int(self._pos[kid].sum() - self._neg[kid].sum())

    def upd(self, key: str, delta: int) -> Optional[int]:
        """Apply a signed delta to ``key`` under this node's writer slot
        (a presence token and the PN split).  Returns the key's new value;
        None when down."""
        with self._lock:
            if not self.alive:
                return None
            return self._upd_locked(key, delta)

    def upd_many(self, pairs) -> Optional[list]:
        """Batched update (the ingest admission drain): every (key, delta)
        applies under ONE lock acquisition, in submission order, with the
        semantics of N ``upd`` calls.  Returns each key's value after its
        op; None when down (the whole drain 502s)."""
        with self._lock:
            if not self.alive:
                return None
            return [self._upd_locked(key, delta) for key, delta in pairs]

    def rem(self, key: str) -> Optional[bool]:
        """Observed-remove of ``key``: this node's observer row adopts the
        token vector it has seen.  Returns whether a remove was minted
        (False when the key is absent); None when down."""
        with self._lock:
            if not self.alive:
                return None
            k = str(key)
            if k not in self.keys:
                return False
            kid = self.keys.intern(k)
            if not bool(self._contained_locked()[kid]):
                return False
            col = self._wcol_locked(self.rid)
            self._obs[kid, col, :] = torch.maximum(self._obs[kid, col, :], self._tok[kid])
            self.metrics.inc("composite_ops")
            return True

    # ---- read path ----

    def _contained_locked(self) -> np.ndarray:
        """bool[K] on the host: a key is present while some writer's token
        is unobserved by every remove."""
        seen = self._obs.max(dim=1).values
        return ((self._tok >= 0) & (self._tok > seen)).any(dim=1).cpu().numpy()

    def _values_locked(self) -> np.ndarray:
        return (self._pos.sum(dim=1) - self._neg.sum(dim=1)).cpu().numpy()

    def value(self, key: str) -> Optional[int]:
        if not self.alive:
            return None
        with self._lock:
            k = str(key)
            if k not in self.keys:
                return None
            kid = self.keys.intern(k)
            if not self._contained_locked()[kid]:
                return None
            return int(self._values_locked()[kid])

    def items(self) -> Optional[Dict[str, int]]:
        """{key: value} over contained keys (None when down)."""
        if not self.alive:
            return None
        with self._lock:
            contained, values = self._contained_locked(), self._values_locked()
            return {k: int(values[kid]) for k, kid in self.keys.items() if contained[kid]}

    def fingerprint(self) -> Dict[str, Any]:
        """Canonical, intern-order-free rendering of the full state (keys
        with any history, their per-writer planes keyed by wire rid): two
        replicas are converged iff their fingerprints are equal."""
        with self._lock:
            tok, obs, pos, neg = (p.cpu().numpy() for p in
                                  (self._tok, self._obs, self._pos, self._neg))
            out: Dict[str, Any] = {}
            for k, kid in self.keys.items():
                ent: Dict[str, Any] = {}
                for col, rid in enumerate(self._writers):
                    r = str(rid)
                    if tok[kid, col] >= 0:
                        ent.setdefault("tok", {})[r] = int(tok[kid, col])
                    if pos[kid, col]:
                        ent.setdefault("pos", {})[r] = int(pos[kid, col])
                    if neg[kid, col]:
                        ent.setdefault("neg", {})[r] = int(neg[kid, col])
                    for col2, rid2 in enumerate(self._writers):
                        if obs[kid, col, col2] >= 0:
                            ent.setdefault("obs", {}).setdefault(r, {})[
                                str(rid2)] = int(obs[kid, col, col2])
                if ent:
                    out[k] = ent
            return out

    def ping(self) -> bool:
        return self.alive

    def set_alive(self, alive: bool) -> None:
        self.alive = bool(alive)

    # ---- wire ----

    def _dump_locked(self) -> Dict[str, Any]:
        ks = [k for k, _ in sorted(self.keys.items(), key=lambda e: e[1])]
        ku, wu = len(ks), len(self._writers)
        return {
            "keys": ks,
            "writers": list(self._writers),
            "tok": self._tok[:ku, :wu].cpu().tolist(),
            "obs": self._obs[:ku, :wu, :wu].cpu().tolist(),
            "pos": self._pos[:ku, :wu].cpu().tolist(),
            "neg": self._neg[:ku, :wu].cpu().tolist(),
        }

    def gossip_payload(self) -> Optional[Dict[str, Any]]:
        """GET /composite/gossip body: the full trimmed state dump (the
        module docstring says why a state-based wire needs no vv); None
        when down."""
        if not self.alive:
            return None
        with self._lock:
            return self._dump_locked()

    @staticmethod
    def decode(payload: Any) -> DecodedComposite:
        """Validate one wire payload (pure: no lock, no state).  Raises
        ValueError on anything malformed (the corruption marker, poisoned
        sections, ragged or mis-shaped planes, duplicate keys or writers),
        so the network agent quarantines a corrupt peer's payload instead
        of merging it."""
        if not isinstance(payload, dict):
            raise ValueError("composite payload is not a JSON object")
        if "__nemesis_corrupt__" in payload:
            raise ValueError("composite payload carries the nemesis "
                             "corruption marker")
        keys = payload.get("keys")
        writers = payload.get("writers")
        if (not isinstance(keys, list)
                or not all(isinstance(k, str) for k in keys)):
            raise ValueError("composite payload 'keys' is not a list of "
                             "strings")
        if (not isinstance(writers, list)
                or not all(isinstance(w, int) and not isinstance(w, bool)
                           for w in writers)):
            raise ValueError("composite payload 'writers' is not a list of "
                             "integer rids")
        if len(set(keys)) != len(keys):
            raise ValueError("composite payload has duplicate keys")
        if len(set(writers)) != len(writers):
            raise ValueError("composite payload has duplicate writers")
        ku, wu = len(keys), len(writers)
        return DecodedComposite(
            keys=list(keys), writers=[int(w) for w in writers],
            tok=_plane(payload.get("tok"), (ku, wu), "tok"),
            obs=_plane(payload.get("obs"), (ku, wu, wu), "obs"),
            pos=_plane(payload.get("pos"), (ku, wu), "pos"),
            neg=_plane(payload.get("neg"), (ku, wu), "neg"),
        )

    def _align_locked(self, d: DecodedComposite) -> tuple:
        """Scatter a decoded payload into THIS node's capacity-padded
        coordinate space, on the node's device (both writer axes of obs
        permute together)."""
        rows = np.asarray([self._kid_locked(k) for k in d.keys], np.int64)
        cols = np.asarray([self._wcol_locked(r) for r in d.writers], np.int64)
        tok = np.full((self._k, self._w), -1, np.int32)
        obs = np.full((self._k, self._w, self._w), -1, np.int32)
        pos = np.zeros((self._k, self._w), np.int32)
        neg = np.zeros((self._k, self._w), np.int32)
        if rows.size and cols.size:
            tok[np.ix_(rows, cols)] = d.tok
            obs[np.ix_(rows, cols, cols)] = d.obs
            pos[np.ix_(rows, cols)] = d.pos
            neg[np.ix_(rows, cols)] = d.neg
        return tuple(torch.from_numpy(p).to(self.device) for p in (tok, obs, pos, neg))

    def merge_decoded(self, decoded: List[DecodedComposite]) -> int:
        """Fold any number of decoded peer payloads into the local state
        in ONE reduction of the registered composite join.  Returns 1 when
        the local state changed, 0 on a no-op round."""
        if not decoded or not self.alive:
            return 0
        from crdt_tpu_torch.ops import joins

        with self._lock:
            # the union coordinate space first: alignment needs the final
            # capacity
            for d in decoded:
                for k in d.keys:
                    self._kid_locked(k)
                for r in d.writers:
                    self._wcol_locked(r)
            planes = [(self._tok, self._obs, self._pos, self._neg)]
            planes += [self._align_locked(d) for d in decoded]
            stacked = _ormap(*(torch.stack([p[i] for p in planes]) for i in range(4)))
            neutral = _ormap(*_empty_planes(self._k, self._w, self.device))
            out = joins.tree_reduce_join(COMPOSITE_JOIN, stacked, neutral)
            self.merge_dispatches += 1
            self.metrics.inc("composite_merge_dispatches")
            new = (out.presence.tok, out.presence.obs, out.values.pos, out.values.neg)
            changed = not all(torch.equal(a, b) for a, b in zip(
                new, (self._tok, self._obs, self._pos, self._neg)))
            # clones: the reduction's outputs may be views of the stack
            self._tok, self._obs, self._pos, self._neg = (p.clone() for p in new)
            return 1 if changed else 0

    def receive(self, payload: Any) -> int:
        """Decode and merge one peer payload (the single-peer pull path;
        raises ValueError on a malformed payload, see :meth:`decode`)."""
        return self.merge_decoded([self.decode(payload)])

    # ---- snapshot (crash-safe checkpoint sections) ----

    def to_snapshot(self) -> Dict[str, Any]:
        with self._lock:
            return self._dump_locked()

    def from_snapshot(self, snap: Dict[str, Any]) -> None:
        """Restore from a checkpoint section: validate like a wire payload
        (a corrupt composite.json raises, and the checkpoint loader
        quarantines the snapshot) and fold it into a reset state."""
        decoded = self.decode(snap)
        with self._lock:
            self.keys = Interner()
            self._writers = []
            self._wcol = {}
            self._tok, self._obs, self._pos, self._neg = _empty_planes(
                self._k, self._w, self.device)
        self.merge_decoded([decoded])
