"""The plain reference of the ``seq-swarm-10k`` cells, in plain PyTorch,
and the comparisons that decide ``correct``.

It imports nothing of the program.  A replica's state is masks over the
seeded pool (``portbench.gen_seq``), which is sorted by key: the elements
it holds, those it has seen removed, and its per-writer floor, the
highest seq of each tracked writer that a GC barrier collected there.  An
element is *covered* by a floor when its writer is tracked (rid < W) and
its seq is at or under the writer's floor.

* A join is the union of the two sides' elements, less each element only
  one side holds that the other side's floor covers (it was removed and
  collected there); the removes seen OR, the floors take their maximum,
  and a table keeps its first ``capacity`` elements in key order.
* A pull round joins each replica with its peer where both are up.
* A barrier reduces the up replicas to their least upper bound with the
  lane-halving tree of ``tomb_gc.gc_round`` (the largest union of any
  join is its unique count), takes the stable frontier (the bound's own
  per-writer watermark, if it is no lower than every replica's floor,
  else nothing), collects every removed element it covers, and gives the
  result to every up replica; a down replica keeps its state.

The comparisons count replicas (lanes) whose rows, or floors, differ;
every limit is 0.
"""
from __future__ import annotations

import dataclasses

import torch

from portbench import gen_seq


@dataclasses.dataclass
class State:
    held: torch.Tensor   # bool[n, P]
    seen: torch.Tensor   # bool[n, P]: seen removed, within held
    floor: torch.Tensor  # int32[n, W]

    def lanes(self, index) -> "State":
        return State(self.held[index], self.seen[index], self.floor[index])


@dataclasses.dataclass
class Ids:
    """The pool's identities on the device: each element's writer and seq."""

    rid: torch.Tensor  # long[P]
    seq: torch.Tensor  # long[P]

    @classmethod
    def of(cls, pool: gen_seq.SeqPool, device) -> "Ids":
        return cls(rid=torch.as_tensor(pool.rid, dtype=torch.long, device=device),
                   seq=torch.as_tensor(pool.seq, dtype=torch.long, device=device))


def cap(mask: torch.Tensor, capacity: int) -> torch.Tensor:
    """The first ``capacity`` held elements of each lane."""
    return mask & (torch.cumsum(mask, dim=1) <= capacity)


def covered(floor: torch.Tensor, ids: Ids) -> torch.Tensor:
    """bool[n, P]: the elements each lane's floor covers."""
    w = floor.shape[1]
    tracked = ids.rid < w
    return tracked[None] & (ids.seq[None] <= floor[:, ids.rid.clamp(max=w - 1)])


def join(a: State, b: State, ids: Ids, capacity: int):
    """Lane by lane: (the joined State, each lane's unique count before the
    capacity cut)."""
    only_a, only_b = a.held & ~b.held, b.held & ~a.held
    union = (a.held | b.held) & ~(only_a & covered(b.floor, ids)) \
        & ~(only_b & covered(a.floor, ids))
    held = cap(union, capacity)
    return (State(held, (a.seen | b.seen) & held, torch.maximum(a.floor, b.floor)),
            union.sum(dim=1))


def pull_round(st: State, peers: torch.Tensor, alive: torch.Tensor, ids: Ids, capacity: int):
    """Replica j joins replica peers[j] where both are up: (State, unique
    counts, 0 where the pull did not happen)."""
    ok = alive & alive[peers]
    joined, n = join(st, st.lanes(peers), ids, capacity)
    k = ok[:, None]
    return (State(torch.where(k, joined.held, st.held), torch.where(k, joined.seen, st.seen),
                  torch.where(k, joined.floor, st.floor)), torch.where(ok, n, 0))


def barrier(st: State, alive: torch.Tensor, ids: Ids, capacity: int):
    """The GC barrier: (State, the reduction's largest unique count, the
    elements collected over the up lanes)."""
    n, w = st.floor.shape
    p = 1
    while p < n:
        p *= 2
    up = alive[:, None]
    work = State(torch.zeros((p, st.held.shape[1]), dtype=torch.bool, device=st.held.device),
                 torch.zeros((p, st.held.shape[1]), dtype=torch.bool, device=st.held.device),
                 torch.full((p, w), -1, dtype=st.floor.dtype, device=st.floor.device))
    work.held[:n], work.seen[:n] = st.held & up, st.seen & up
    work.floor[:n] = torch.where(up, st.floor, -1)
    most = 0
    while p > 1:
        p //= 2
        work, nu = join(work.lanes(slice(0, p)), work.lanes(slice(p, 2 * p)), ids, capacity)
        most = max(most, int(nu.max()))
    top = work
    # the bound's watermark: the highest seq it holds of each tracked writer, or its floor
    tracked = ids.rid < w
    table = torch.full((w + 1,), -1, dtype=torch.long, device=st.floor.device)
    table.scatter_reduce_(0, torch.where(tracked, ids.rid, w),
                          torch.where(top.held[0] & tracked, ids.seq, -1), reduce="amax")
    received = torch.maximum(top.floor[0].long(), table[:w])
    floors_after = torch.where(up, top.floor, st.floor)
    stable = bool(alive.any()) and bool((received >= floors_after.amax(dim=0)).all())
    frontier = received if stable else torch.full_like(received, -1)
    floor = torch.maximum(top.floor[0].long(), torch.minimum(frontier, received)).to(st.floor.dtype)
    drop = top.held[0] & top.seen[0] & covered(floor[None], ids)[0]
    held, seen = top.held[0] & ~drop, top.seen[0] & ~drop
    out = State(torch.where(up, held[None], st.held), torch.where(up, seen[None], st.seen),
                torch.where(up, floor[None], st.floor))
    return out, most, int(drop.sum()) * int(alive.sum())


# ---- the comparisons ----


def lanes_wrong(got: dict, st: State, pool: gen_seq.SeqPool, capacity: int,
                lanes: torch.Tensor | None = None, floors: bool = True) -> int:
    """Lanes (of ``lanes``, default all) whose table rows (and, with
    ``floors``, floor) differ from the state's, the rows built in key
    order.  ``got``: {keys [R, C, 4D], elem [R, C], removed [R, C],
    floor [R, W]}."""
    want = gen_seq.tables(pool, st.held, st.seen, capacity)
    device = st.held.device
    bad = (got["keys"].to(device) != want["keys"]).any(dim=2).any(dim=1)
    bad |= (got["elem"].to(device) != want["elem"]).any(dim=1)
    bad |= (got["removed"].to(device).bool() != want["removed"]).any(dim=1)
    if floors:
        bad |= (got["floor"].to(device) != st.floor).any(dim=1)
    return int(bad.sum() if lanes is None else bad[lanes].sum())


def floor_lanes_wrong(got: torch.Tensor, st: State) -> int:
    """Lanes whose floor (``got``: int32[W, R], as read back) differs."""
    return int((got.to(st.floor.device).T != st.floor).any(dim=1).sum())
