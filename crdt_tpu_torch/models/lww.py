"""LWW-Register: last-writer-wins register lattice as tensors (counterpart
of ``crdt_tpu.models.lww``).

``ts, rid, payload: int32[...]`` — leading axes batch registers; ``payload``
is a host-interned value id.  join = the lexicographic (ts, rid) max, one
``torch.where`` per plane; ``join_local_wins`` is the reference's
local-wins tiebreak (not a lattice join).

The packed form puts (ts, rid) in one order-preserving int32 word,
``key = (ts << rid_bits) | (rid + 1)``, so its join is one compare and two
selects over two planes instead of three.  It holds only while every
register passes :func:`pack_budget_ok`, which callers check on the host.
"""
from __future__ import annotations

import dataclasses

import torch

from crdt_tpu_torch import default_device
from crdt_tpu_torch.utils.constants import TS_NULL

RID_BITS = 6  # up to 62 writer ids + the -1 sentinel; override per deployment


@dataclasses.dataclass
class LWWRegister:
    ts: torch.Tensor       # int32[...]  (ms offset from host epoch; -1 = unset)
    rid: torch.Tensor      # int32[...]  (writer replica id; tiebreak key)
    payload: torch.Tensor  # int32[...]  (interned value id)


def zero(batch: tuple = (), dtype=torch.int32, device=None) -> LWWRegister:
    device = default_device(device)
    return LWWRegister(
        ts=torch.full(batch, int(TS_NULL), dtype=dtype, device=device),
        rid=torch.full(batch, -1, dtype=dtype, device=device),
        payload=torch.zeros(batch, dtype=dtype, device=device),
    )


def write(reg: LWWRegister, ts, rid, payload) -> LWWRegister:
    """Local op: overwrite if (ts, rid) is newer than the stored pair (a
    stale local write loses, keeping ``write`` monotone in the lattice)."""
    def full(x, like):
        return torch.as_tensor(x, dtype=like.dtype, device=like.device).broadcast_to(like.shape)

    return join(reg, LWWRegister(ts=full(ts, reg.ts), rid=full(rid, reg.rid),
                                 payload=full(payload, reg.payload)))


def join(a: LWWRegister, b: LWWRegister) -> LWWRegister:
    """Lexicographic (ts, rid) max-select: commutative, associative and
    idempotent because (ts, rid) totally orders the writes."""
    b_newer = (b.ts > a.ts) | ((b.ts == a.ts) & (b.rid > a.rid))
    return LWWRegister(
        ts=torch.where(b_newer, b.ts, a.ts),
        rid=torch.where(b_newer, b.rid, a.rid),
        payload=torch.where(b_newer, b.payload, a.payload),
    )


def join_local_wins(local: LWWRegister, remote: LWWRegister) -> LWWRegister:
    """The reference's tiebreak: on an equal timestamp keep the local entry.
    Not a lattice join (not commutative)."""
    remote_newer = remote.ts > local.ts
    return LWWRegister(
        ts=torch.where(remote_newer, remote.ts, local.ts),
        rid=torch.where(remote_newer, remote.rid, local.rid),
        payload=torch.where(remote_newer, remote.payload, local.payload),
    )


def value(reg: LWWRegister) -> torch.Tensor:
    return reg.payload


def is_set(reg: LWWRegister) -> torch.Tensor:
    return reg.ts != int(TS_NULL)


# ---- the packed form ----


@dataclasses.dataclass
class PackedLWW:
    key: torch.Tensor      # int32[...]: (ts << rid_bits) | (rid + 1)
    payload: torch.Tensor  # int32[...]  (interned value id)
    rid_bits: int = RID_BITS


def pack_budget_ok(reg: LWWRegister, rid_bits: int = RID_BITS) -> torch.Tensor:
    """0-d bool: every (ts, rid) fits the order-preserving pack — rid in
    [-1, 2^rid_bits - 1) and |ts| < 2^(30 - rid_bits), so ``ts << rid_bits``
    does not overflow."""
    lim = 1 << (30 - rid_bits)
    rid_ok = (reg.rid >= -1) & (reg.rid < (1 << rid_bits) - 1)
    ts_ok = (reg.ts > -lim) & (reg.ts < lim)
    return (rid_ok & ts_ok).all()


def pack(reg: LWWRegister, rid_bits: int = RID_BITS) -> PackedLWW:
    key = (reg.ts << rid_bits) | (reg.rid + 1)
    return PackedLWW(key=key, payload=reg.payload, rid_bits=rid_bits)


def unpack(p: PackedLWW) -> LWWRegister:
    """Exact inverse of :func:`pack` (the arithmetic ``>>`` recovers a
    negative ts; the low field is non-negative by construction)."""
    return LWWRegister(ts=p.key >> p.rid_bits,
                       rid=(p.key & ((1 << p.rid_bits) - 1)) - 1,
                       payload=p.payload)


def join_packed(a: PackedLWW, b: PackedLWW) -> PackedLWW:
    """:func:`join` on the packed form: an equal key is the same write, so
    keeping ``a`` on ties resolves as the lexicographic join does."""
    if a.rid_bits != b.rid_bits:
        raise ValueError(f"pack layouts differ: rid_bits {a.rid_bits} != {b.rid_bits}")
    newer = b.key > a.key
    return PackedLWW(key=torch.where(newer, b.key, a.key),
                     payload=torch.where(newer, b.payload, a.payload),
                     rid_bits=a.rid_bits)
