"""Session tokens: version-vector watermarks for read-your-writes and
monotonic reads (own copy of ``crdt_tpu.consistency.session``).

A session token is a ``{rid: seq}`` watermark, the host-dict twin of the
``vvclock`` lattice.  The ingest front door mints one per acknowledged
write from the ticket's ``(rid, seq)`` ident; clients thread it back on
later requests and merge tokens from several writes with ``token_join``
(pointwise max: the lattice lub keeps both sessions' guarantees).

A session-level read is admitted by dominance: the serving node's vv must
dominate the token first.  ``wait_for_dominance`` is the waiting (or
proxying) loop, on an injectable clock.  Tokens ride the
``X-CRDT-Session-Token`` header both ways (minted after ``POST /data``;
required on a session read), so JSON bodies stay byte-compatible with the
reference's surface.
"""
from __future__ import annotations

import json
import time
from typing import Callable, Dict, Iterable, Optional, Tuple

SESSION_TOKEN_HEADER = "X-CRDT-Session-Token"


def mint_token(idents: Iterable[Tuple[int, int]]) -> Dict[int, int]:
    """Token covering the given write idents: {rid: max seq}."""
    token: Dict[int, int] = {}
    for rid, seq in idents:
        if seq > token.get(rid, -1):
            token[int(rid)] = int(seq)
    return token


def token_join(a: Dict[int, int], b: Dict[int, int]) -> Dict[int, int]:
    """Lattice lub of two tokens (pointwise max) — commutative,
    associative, idempotent; see consistency.vvclock.join."""
    out = dict(a)
    for r, s in b.items():
        if s > out.get(r, -1):
            out[r] = s
    return out


def vv_dominates(vv: Dict[int, int], token: Dict[int, int]) -> bool:
    """True when ``vv`` has absorbed every op under ``token``."""
    return all(vv.get(r, -1) >= s for r, s in token.items())


def encode_token(token: Dict[int, int]) -> str:
    return json.dumps({str(r): int(s) for r, s in token.items()},
                      separators=(",", ":"))


def decode_token(raw: Optional[str]) -> Optional[Dict[int, int]]:
    """Parse a token header; None for absent/garbage (the caller decides
    whether a missing token is an error — a session read without one is)."""
    if not raw:
        return None
    try:
        d = json.loads(raw)
        if not isinstance(d, dict):
            return None
        return {int(r): int(s) for r, s in d.items()}
    except (ValueError, TypeError):
        return None


def wait_for_dominance(node, token: Dict[int, int], *,
                       timeout: float, poll: float = 0.05,
                       clock: Optional[Callable[[], float]] = None,
                       sleep: Optional[Callable[[float], None]] = None,
                       proxy: Optional[Callable[[], None]] = None) -> bool:
    """Block until the node's vv dominates ``token`` or ``timeout`` lapses.

    ``proxy`` (optional) is invoked once per round BEFORE re-checking —
    the consistency plane passes a pull-from-peers closure so a node that
    missed the session's writes fetches them instead of just hoping
    gossip arrives (the "or-proxying" half of waiting-or-proxying).
    Returns True on dominance, False on deadline (caller fails loudly)."""
    clock = clock or time.monotonic
    sleep = sleep or time.sleep
    deadline = clock() + timeout
    vv, _ = node.vv_snapshot()
    if vv_dominates(vv, token):
        return True
    while True:
        if proxy is not None:
            proxy()
        vv, _ = node.vv_snapshot()
        if vv_dominates(vv, token):
            return True
        if clock() >= deadline:
            return False
        sleep(min(poll, max(0.0, deadline - clock())))
