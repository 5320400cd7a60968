"""Order-independent 128-bit state digest: the host half of the audit
plane's core (own copy of the numpy and pure-int part of
``crdt_tpu.ops.digest``).

A replica's auditable state is the set of canonical ``(key, winner-ts,
rid, seq)`` rows, one per key, the LWW winner.  Its digest is four
independent 32-bit lanes, each the sum mod 2**32 of a per-row mixed hash.
Addition commutes and inverts, which buys the audit plane's two
properties:

* **order independence**: replicas holding the same row set produce the
  same digest whatever order ops arrived in;
* **O(delta) maintenance**: when a key's winner changes, subtract the old
  row's lanes and add the new row's lanes; no rescan.

The KEY contributes 4 lanes of ``blake2b(key, 16)``, computed once per
distinct key (cached by the caller); the ``(ts, rid, seq)`` ident is
whitened into each lane with a splitmix-style uint32 finalizer.  The
lane functions (``mix32``, ``rotl32``, ``row_lanes``, ``lane_sum``) take
numpy uint32 arrays on the host and torch tensors on the device, where
torch has no uint32 arithmetic: a device lane is a uint32 value held in
int64 and masked with ``& 0xFFFFFFFF`` after each add, multiply and
shift, so both forms give the same bits (the mesh plane's fused fold,
:mod:`crdt_tpu_torch.parallel.meshplane`, sums its batch's lanes on the
card with ``lane_sum``).  The pure-int mirrors below are the ingest hot
path's form, pinned bit-equal to the arrays by the tests.  A digest
computed by either package matches the other's bit for bit.

128 bits (4 lanes x 32) keep accidental collisions far below anything a
soak can hit; the lanes use distinct salts, so they are independent hash
functions, not one hash truncated four ways.
"""
from __future__ import annotations

import hashlib
from typing import Iterable, Optional, Tuple

import numpy as np
import torch

LANES = 4

# per-lane whitening salts (distinct odd constants; any fixed values work,
# these are from the splitmix64 increment's 32-bit halves and friends)
LANE_SALTS = np.array(
    [0x9E3779B9, 0x85EBCA77, 0xC2B2AE3D, 0x27D4EB2F], dtype=np.uint32)

_MASK64 = (1 << 64) - 1

_M32 = 0xFFFFFFFF


def mix32(x):
    """splitmix32-style finalizer over uint32 lanes (xor, shift and
    wrap-around multiply): numpy uint32 arrays, or torch int64 tensors of
    uint32 values."""
    if isinstance(x, torch.Tensor):
        # int64 products of two uint32 values may wrap past 2**63; the low
        # 32 bits survive the wrap and the mask keeps just them
        x = x ^ (x >> 16)
        x = (x * 0x7FEB352D) & _M32
        x = x ^ (x >> 15)
        x = (x * 0x846CA68B) & _M32
        return x ^ (x >> 16)
    c1 = x.dtype.type(0x7FEB352D)
    c2 = x.dtype.type(0x846CA68B)
    x = x ^ (x >> 16)
    x = x * c1
    x = x ^ (x >> 15)
    x = x * c2
    x = x ^ (x >> 16)
    return x


def rotl32(x, r: int):
    """Rotate-left on uint32 lanes (numpy uint32 or torch int64); r must be
    1..31."""
    if isinstance(x, torch.Tensor):
        return ((x << r) & _M32) | (x >> (32 - r))
    return (x << r) | (x >> (32 - r))


def key_lanes(key: str) -> np.ndarray:
    """4 uint32 lanes of blake2b-128 over the key bytes (callers cache
    per distinct key)."""
    raw = hashlib.blake2b(key.encode("utf-8"), digest_size=16).digest()
    return np.frombuffer(raw, dtype="<u4").astype(np.uint32)


def fold_ts(ts: int) -> int:
    """Fold a (possibly 64-bit, possibly negative) timestamp into the
    uint32 domain: xor-fold the high half so absolute-ms clocks keep
    their entropy."""
    t = ts & _MASK64
    return (t ^ (t >> 32)) & 0xFFFFFFFF


def row_lanes(klanes, ts, rid, seq):
    """Per-row digest lanes over uint32 arrays.

    ``klanes``: uint32[..., 4] key lanes; ``ts``/``rid``/``seq``: uint32
    arrays broadcastable to ``klanes[..., 0]`` (fold 64-bit timestamps
    through ``fold_ts`` first; cast signed ids via ``.astype(uint32)`` —
    two's-complement reinterpretation is fine, it just has to be the
    same on every side).  Returns uint32[..., 4].  On torch every argument
    is an int64 tensor of uint32 values (``x & 0xFFFFFFFF`` of a signed
    id), and so is the result.
    """
    ident = ts ^ rotl32(rid, 7) ^ rotl32(seq, 13)
    salts = LANE_SALTS
    if isinstance(ident, torch.Tensor):
        salts = torch.as_tensor(LANE_SALTS.astype(np.int64), device=ident.device)
    lanes = mix32(ident[..., None] ^ salts)
    return mix32(klanes ^ lanes)


def lane_sum(rows):
    """Sum rows' lanes mod 2**32: uint32[..., n, 4] -> uint32[..., 4]
    (numpy: the explicit dtype pins the wrap-around sum, which numpy would
    otherwise widen to uint64; torch: the int64 sum, masked).  All-zero
    padding rows are the additive identity."""
    if isinstance(rows, torch.Tensor):
        return rows.sum(dim=-2) & _M32
    return rows.sum(axis=-2, dtype=rows.dtype)


def row_lanes_one(klanes: np.ndarray, ts: int, rid: int, seq: int
                  ) -> np.ndarray:
    """Host scalar-row convenience: one (key, ts, rid, seq) row's lanes."""
    u = np.array([fold_ts(ts), rid & 0xFFFFFFFF, seq & 0xFFFFFFFF],
                 dtype=np.uint32)
    return row_lanes(klanes, u[0], u[1], u[2])


# ---- pure-int host mirror of the row hash ----
#
# The incremental digest pays one row hash per accepted op on the ingest
# hot path, where a uint32 ndarray per row costs far more than the same
# math on plain ints.  These mirrors are pinned bit-equal to the array
# versions by the tests; lanes travel as 4-int tuples and re-enter numpy
# only at dig_column / digest_hex (both accept either form).

LANE_SALTS_INT: Tuple[int, int, int, int] = tuple(int(s) for s in LANE_SALTS)

ZERO_INTS: Tuple[int, int, int, int] = (0, 0, 0, 0)


def mix32_int(x: int) -> int:
    """``mix32`` on one plain int (callers pre-mask to 32 bits)."""
    x ^= x >> 16
    x = (x * 0x7FEB352D) & _M32
    x ^= x >> 15
    x = (x * 0x846CA68B) & _M32
    x ^= x >> 16
    return x


def key_lanes_ints(key: str) -> Tuple[int, int, int, int]:
    """``key_lanes`` as a 4-int tuple (host cache form)."""
    return tuple(int(v) for v in key_lanes(key))


def row_lanes_ints(klanes: Tuple[int, int, int, int], ts: int, rid: int,
                   seq: int) -> Tuple[int, int, int, int]:
    """``row_lanes_one`` on plain ints — same bits, no ndarray churn."""
    r = rid & _M32
    s = seq & _M32
    ident = (fold_ts(ts)
             ^ (((r << 7) | (r >> 25)) & _M32)
             ^ (((s << 13) | (s >> 19)) & _M32))
    return (
        mix32_int(klanes[0] ^ mix32_int(ident ^ LANE_SALTS_INT[0])),
        mix32_int(klanes[1] ^ mix32_int(ident ^ LANE_SALTS_INT[1])),
        mix32_int(klanes[2] ^ mix32_int(ident ^ LANE_SALTS_INT[2])),
        mix32_int(klanes[3] ^ mix32_int(ident ^ LANE_SALTS_INT[3])),
    )


def add_lanes_ints(acc, rows):
    """acc + rows (mod 2**32) on 4-int tuples."""
    return ((acc[0] + rows[0]) & _M32, (acc[1] + rows[1]) & _M32,
            (acc[2] + rows[2]) & _M32, (acc[3] + rows[3]) & _M32)


def sub_lanes_ints(acc, rows):
    """acc - rows (mod 2**32) on 4-int tuples (the supersede path)."""
    return ((acc[0] - rows[0]) & _M32, (acc[1] - rows[1]) & _M32,
            (acc[2] - rows[2]) & _M32, (acc[3] - rows[3]) & _M32)


def add_lanes(acc: np.ndarray, rows: np.ndarray) -> np.ndarray:
    """acc + rows (mod 2**32), host-side."""
    return (acc + rows).astype(np.uint32)


def sub_lanes(acc: np.ndarray, rows: np.ndarray) -> np.ndarray:
    """acc - rows (mod 2**32), host-side (the supersede path)."""
    return (acc - rows).astype(np.uint32)


def zero_lanes() -> np.ndarray:
    return np.zeros(LANES, dtype=np.uint32)


def digest_hex(acc) -> str:
    """Wire form: 32 lowercase hex chars, lane 0 first.  Accepts either
    lane form (uint32 ndarray or 4-int tuple)."""
    return "".join(f"{int(v) & 0xFFFFFFFF:08x}" for v in acc)


def parse_digest_hex(s: object) -> Optional[np.ndarray]:
    """Parse the wire form back to lanes; None on anything malformed
    (peer digests arrive over faultable transports: garbage is simply
    'no digest', never an exception on the audit path)."""
    if not isinstance(s, str) or len(s) != 8 * LANES:
        return None
    try:
        vals = [int(s[i * 8:(i + 1) * 8], 16) for i in range(LANES)]
    except ValueError:
        return None
    return np.array(vals, dtype=np.uint32)


def digest_rows(rows: Iterable[Tuple[np.ndarray, int, int, int]]
                ) -> np.ndarray:
    """From-scratch reference: fold (klanes, ts, rid, seq) rows (the
    tests pin the incremental accumulator against it)."""
    acc = zero_lanes()
    for klanes, ts, rid, seq in rows:
        acc = add_lanes(acc, row_lanes_one(klanes, ts, rid, seq))
    return acc
