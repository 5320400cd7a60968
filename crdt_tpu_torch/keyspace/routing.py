"""Rendezvous (HRW) routing: deterministic ``(tenant, key) -> member``
(own copy of ``crdt_tpu.keyspace.routing``, pure Python).

Highest-random-weight hashing over an explicit member list.  Every node
that holds the same member list computes the same owner for every key —
no coordination, no routing table to gossip.  The score is a keyed
cryptographic digest (``blake2b``), NOT Python's builtin ``hash()``
(which is salted per process and would route differently on every
boot); determinism across processes is pinned by
``tests/test_torch_keyspace.py``.

Minimal remap is the property the keyspace tier leans on: when a member
joins, the only keys that move are the ones the NEW member now wins
(≈ K/n of them); when a member leaves, only ITS keys move (they fall to
their second-ranked member).  No other key changes owner, because every
other key's argmax is untouched.

The module is deliberately member-string-shaped rather than
shard-shaped: the ``ShardedKeyspace`` routes over ``shard-<i>`` names,
and the coordinator leases (``consistency.leases``) rank node URLs
through the same ``ranked_members`` seam.
"""
from __future__ import annotations

import hashlib
from typing import Dict, List, Sequence

# separates tenant from key in the routing input; tenants are validated
# (validate_tenant below) to never contain it
ROUTE_SEP = "\x00"

# owner lookups a router memoizes before it starts over (a key's owner is
# a pure function of the member list, so the memo never changes an answer)
OWNER_MEMO_MAX = 1 << 22


def validate_tenant(tenant) -> str:
    """A tenant name must be a nonempty string free of ``:`` (the stored
    qualified-key separator), ``ROUTE_SEP``, and control characters —
    enforced at config construction AND at the admission door, with the
    offending name in the error."""
    if not isinstance(tenant, str) or not tenant:
        raise ValueError(
            f"tenant must be a nonempty string, got {tenant!r}")
    if ":" in tenant or any(ord(c) < 0x20 for c in tenant):
        raise ValueError(
            f"tenant {tenant!r} may not contain ':' or control "
            "characters (it prefixes the shard-local qualified key)")
    return tenant


def route_key(tenant: str, key: str) -> str:
    """The canonical routing input for a tenant-scoped key.  Unambiguous
    because tenants may not contain ``ROUTE_SEP`` — ``("ab", "c")`` and
    ``("a", "bc")`` can never collide."""
    return f"{tenant}{ROUTE_SEP}{key}"


def _score(member: str, key: str) -> int:
    """64-bit HRW weight of ``member`` for ``key``.  blake2b is keyed by
    concatenation with a separator so (member, key) pairs never alias."""
    h = hashlib.blake2b(
        member.encode("utf-8") + b"\x00" + key.encode("utf-8"),
        digest_size=8,
    )
    return int.from_bytes(h.digest(), "big")


def ranked_members(members: Sequence[str], key: str,
                   n: int = None, ident=None) -> List[str]:
    """Members by descending HRW weight for ``key`` — THE shared
    rendezvous seam.  ``ranked_members(ms, k)[0]`` is the owner;
    the full ranking is a deterministic failover order.

    This is the module-level twin of ``RendezvousRouter.ranked`` for
    callers whose member list changes per call (the consistency plane's
    coordinator-lease routing ranks LIVE NODE URLS, which shift with
    partitions, while the keyspace ranks a fixed ``shard-<i>`` list).
    Both paths share ``_score``, so cross-use determinism is one
    property: same members + same key → same ranking, whether the
    members are shard names or node URLs (pinned by
    tests/test_torch_keyspace.py).  Ties break on the member string.

    ``ident`` optionally maps a member to the STABLE identity string its
    weight is computed over, while the returned list keeps the member
    values themselves — for member strings that embed ephemeral detail
    (a URL with an OS-assigned port) the caller can rank over stable
    names so the routing replays across restarts."""
    name = (lambda m: m) if ident is None else ident
    order = sorted((str(m) for m in members),
                   key=lambda m: (_score(str(name(m)), key), m),
                   reverse=True)
    return order if n is None else order[:n]


class RendezvousRouter:
    """HRW router over a fixed member list.

    Members keep their GIVEN order (callers that need cross-process
    determinism must build the same list — the keyspace always builds
    ``shard-0 .. shard-(S-1)``).  Ties — astronomically unlikely with
    64-bit digests — break on the member string, so the owner is a pure
    function of (members, key) everywhere.

    ``owner`` scores every member with one ``blake2b`` each (the
    ``_score`` digest, the member's prefix bytes encoded once), and
    ``owner_index`` memoizes its answer per key: a reshard window asks
    for the owner of every live key under two routers, again on every
    streaming round.
    """

    def __init__(self, members: Sequence[str]):
        members = [str(m) for m in members]
        if not members:
            raise ValueError("RendezvousRouter needs at least one member")
        if len(set(members)) != len(members):
            raise ValueError(
                f"duplicate members in router list: {members!r}")
        self.members: List[str] = members
        self._index: Dict[str, int] = {m: i for i, m in enumerate(members)}
        self._prefixes = [(m.encode("utf-8") + b"\x00", m) for m in members]
        self._owners: Dict[str, int] = {}

    def owner(self, key: str) -> str:
        """The member with the highest weight for ``key`` (``_score``'s
        digest over each member, ties broken on the member string)."""
        kb = key.encode("utf-8")
        b2b, from_bytes = hashlib.blake2b, int.from_bytes
        return max((from_bytes(b2b(p + kb, digest_size=8).digest(), "big"), m)
                   for p, m in self._prefixes)[1]

    def owner_index(self, key: str) -> int:
        """Index of ``owner(key)`` in the member list (shard number)."""
        i = self._owners.get(key)
        if i is None:
            if len(self._owners) >= OWNER_MEMO_MAX:
                self._owners.clear()
            i = self._owners[key] = self._index[self.owner(key)]
        return i

    def ranked(self, key: str, n: int = None) -> List[str]:
        """Members by descending weight for ``key`` (top ``n`` or all).
        ``ranked(key)[0] == owner(key)``; delegates to the module-level
        :func:`ranked_members` seam so the keyspace and the consistency
        plane's lease routing can never fork."""
        return ranked_members(self.members, key, n)

    # ---- membership-change constructors (minimal remap by design) ----

    def with_member(self, member: str) -> "RendezvousRouter":
        return RendezvousRouter(self.members + [str(member)])

    def without_member(self, member: str) -> "RendezvousRouter":
        member = str(member)
        if member not in self._index:
            raise ValueError(f"{member!r} is not a router member")
        return RendezvousRouter(
            [m for m in self.members if m != member])
