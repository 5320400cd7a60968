"""The plain reference of every cell, in plain PyTorch, and the comparisons
that decide ``correct``.

It imports nothing of the program.  It works from the raw inputs the
benchmark drew (``portbench.gen``): which pool ops or tags each replica
holds, the down replica and the peer draws.  A replica's state is a bool
mask over the pool, held in the pool's own sorted order, so a log or a
tag table is the held rows in that order.  A capacity keeps the first
``capacity`` held rows, the rows a capacity-bounded sorted union keeps.

The comparisons count lanes (replicas) whose answer differs; every limit
is 0.
"""
from __future__ import annotations

import torch

from portbench import gen

# ---- the KV op-log swarm ----


def cap(mask: torch.Tensor, capacity: int) -> torch.Tensor:
    """The first ``capacity`` held rows of each lane."""
    return mask & (torch.cumsum(mask, dim=1) <= capacity)


def pull_round(held: torch.Tensor, peers: torch.Tensor, alive: torch.Tensor,
               capacity: int) -> torch.Tensor:
    """One pull round: replica j unions the log of replica peers[j] into
    its own when both are up; a down replica neither pulls nor serves."""
    ok = alive & alive[peers]
    return torch.where(ok[:, None], cap(held | held[peers], capacity), held)


def barrier(held: torch.Tensor, alive: torch.Tensor, capacity: int):
    """Every up replica to the least upper bound of the up replicas' logs;
    the down replica keeps its own.  Returns (masks, the bound's size
    before the capacity cut)."""
    lub = held[alive].any(dim=0, keepdim=True)
    top = cap(lub, capacity)
    return torch.where(alive[:, None], top, held), int(lub.sum())


def views(held: torch.Tensor, pool: gen.Pool, n_keys: int) -> dict:
    """Each replica's materialized view as the reference folds it
    (main.go:76-98): per key the newest held op (the last in pool order)
    seeds the value; the numeric ops' deltas add up.  Returns the fields
    {present, is_num, num, num_count, payload} of [R, K] tensors."""
    device = held.device
    r, p = held.shape
    ops = {f: torch.as_tensor(pool.ops[f], device=device) for f in
           ("key", "val", "payload", "is_num")}
    key = ops["key"].long()[None].expand(r, p)
    index = torch.arange(p, device=device)[None].expand(r, p)
    newest = torch.full((r, n_keys), -1, dtype=torch.long, device=device)
    newest.scatter_reduce_(1, key, torch.where(held, index, -1), reduce="amax")
    numeric = held & ops["is_num"][None]
    total = torch.zeros((r, n_keys), dtype=torch.long, device=device)
    total.scatter_add_(1, key, torch.where(numeric, ops["val"].long()[None], 0))
    count = torch.zeros((r, n_keys), dtype=torch.long, device=device)
    count.scatter_add_(1, key, numeric.long())
    present = newest >= 0
    last = newest.clamp(min=0)
    newest_is_num = ops["is_num"][last] & present
    return {"present": present, "is_num": newest_is_num,
            "num": torch.where(newest_is_num, total, 0), "num_count": count,
            "payload": torch.where(present, ops["payload"][last].long(), 0)}


def decoded(view: dict) -> tuple:
    """What a reader of the view sees, key by key: (present, summed,
    value), where a summed key reads as the sum of its deltas and any
    other present key as the raw string (by payload id) of its newest op."""
    present = view["present"].bool()
    summed = present & view["is_num"].bool() & (view["num_count"].long() > 1)
    value = torch.where(summed, view["num"].long(),
                        torch.where(present, view["payload"].long(), 0))
    return present, summed, value


def view_lanes_wrong(got: dict, want: dict, lanes: torch.Tensor | None = None) -> int:
    """Lanes (of ``lanes``, default all) whose decoded view differs."""
    bad = None
    for g, w in zip(decoded(got), decoded(want)):
        diff = (g.to(w.device) != w).any(dim=1)
        bad = diff if bad is None else bad | diff
    return int(bad.sum() if lanes is None else bad[lanes].sum())


def log_lanes_wrong(got: dict, held: torch.Tensor, pool: gen.Pool, capacity: int) -> int:
    """Lanes whose log rows differ from the held ops in pool order."""
    want, _ = gen.logs_from_held(pool, held, capacity)
    bad = torch.zeros(held.shape[0], dtype=torch.bool, device=held.device)
    for f in gen.LOG_FIELDS:
        bad |= (got[f].to(held.device) != want[f]).any(dim=1)
    return int(bad.sum())


# ---- the OR-Set swarm ----


def set_join_block(ha, sa, hb, sb, packed: torch.Tensor, elem: torch.Tensor,
                   capacity: int, n_elems: int) -> dict:
    """The OR-Set join of two blocks of replicas, lane by lane: the tags
    either side holds, in key order, the first ``capacity`` of them, each
    tombstoned when either side has seen its remove; the unique count
    before the cut; and which elements keep a live tag.  Returns
    {keys [n, C], removed [n, C], n_unique [n], member [n, E]}."""
    n = ha.shape[0]
    device = ha.device
    union = ha | hb
    n_unique = union.sum(dim=1)
    kept = cap(union, capacity)
    dead = (sa | sb) & kept
    dest = torch.where(kept, torch.cumsum(kept, dim=1) - 1, capacity)
    keys = torch.full((n, capacity + 1), gen.SENTINEL, dtype=torch.int32, device=device)
    keys.scatter_(1, dest, packed[None].expand(n, -1))
    removed = torch.zeros((n, capacity + 1), dtype=torch.int32, device=device)
    removed.scatter_(1, dest, dead.to(torch.int32))
    member = torch.zeros((n, n_elems), dtype=torch.int32, device=device)
    member.scatter_reduce_(1, elem[None].expand(n, -1), (kept & ~dead).to(torch.int32),
                           reduce="amax")
    return {"keys": keys[:, :capacity], "removed": removed[:, :capacity],
            "n_unique": n_unique, "member": member > 0}
