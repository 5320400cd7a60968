"""Cells on the OR-Set swarm: R replicas' OR-Sets as columnar planes on
one card (``models/orset``, ``ops/union_engine``, kernel 2).

Set-up draws ``snapshots`` swarms from the seed and stages each through
the program's ``orset.stack_to_columnar``.  An epoch joins snapshot i
with snapshot i + 1 (mod the count) through ``orset.columnar_join`` on
the ``sort`` engine, so that every replica merges the state that arrived
for it, then runs ``columnar_member_mask`` and reads back how many lanes
overflowed their capacity.

For the check it keeps the outputs of the last epoch of one pair, drawn
from the seed (of the first epoch until that pair has run); each pair's
overflow count is checked every epoch.
"""
from __future__ import annotations

import torch

from portbench import gen, reference


# the seed of the pool's shape, the same in every run
POOL_SEED = 0


class Port:
    """The program: the columnar OR-Set path of ``crdt_tpu_torch``."""

    def __init__(self):
        from crdt_tpu_torch.models import orset
        from crdt_tpu_torch.ops import hopper_union, union_engine

        self.orset, self.hopper_union, self.union_engine = orset, hopper_union, union_engine

    def stack(self, rows: dict, snap: dict):
        return self.orset.stack_to_columnar(self.orset.ORSet(**rows))

    def join(self, a, b):
        return self.orset.columnar_join(*a, *b, engine="sort")

    def member_mask(self, joined, n_elems: int):
        keys, removed, _ = joined
        return self.orset.columnar_member_mask(keys, removed, n_elems)

    def counters(self) -> dict:
        return {"launches": dict(self.hopper_union.LAUNCHES),
                "union_paths": self.union_engine.union_path_counts()}


class Control:
    """The plain reference in the program's place, with one guarantee of
    the configuration broken: a join keeps half the capacity, so tags are
    dropped.  ``correct`` must come out false."""

    def stack(self, rows: dict, snap: dict):
        return snap

    def join(self, a, b):
        args = a["args"]
        c = args["capacity"]
        blocks = [blk for _, blk in reference_blocks(a, b, c // 2)]
        out = {k: torch.cat([blk[k] for blk in blocks]) for k in blocks[0]}
        pad = lambda x, fill: torch.nn.functional.pad(x, (0, c - x.shape[1]), value=fill)
        self.member = out["member"].T.contiguous()
        return (pad(out["keys"], gen.SENTINEL).T.contiguous(),
                pad(out["removed"], 0).T.contiguous(), out["n_unique"].to(torch.int32))

    def member_mask(self, joined, n_elems: int):
        return self.member

    def counters(self) -> dict:
        return {}


def _draws(snap: dict):
    args = snap["args"]
    return gen.set_draws(args["pool"], args["replicas"], args["capacity"], snap["seed"],
                         hold=args["hold"], seen_remove=args["seen_remove"],
                         device=args["device"])


def reference_blocks(a: dict, b: dict, capacity: int):
    """The reference's join of snapshots ``a`` and ``b``, their draws made
    again from their seeds, lane block by lane block: yields (start,
    {keys, removed, n_unique, member}), lanes first."""
    args = a["args"]
    packed = torch.as_tensor(args["pool"].packed(), device=args["device"])
    elem = torch.as_tensor(args["pool"].elem, device=args["device"]).long()
    for (start, ha, sa), (_, hb, sb) in zip(_draws(a), _draws(b)):
        yield start, reference.set_join_block(ha, sa, hb, sb, packed, elem, capacity,
                                              args["elems"])


class Cell:
    def __init__(self, config: dict, traffic: dict, seed: int, device, system=None):
        self.device = torch.device(device)
        self.r, self.c, self.n_elems = config["replicas"], config["capacity"], config["elems"]
        # one pool shape for every seed, its elements relabelled by the
        # seed: the pool's element multiplicities set the member mask's
        # work, and a pool drawn from each seed moved the rate by 0.8%
        pool = gen.set_pool(POOL_SEED, elems=self.n_elems, writers=config["writers"],
                            tags_per_writer=config["tags_per_writer"],
                            removable=config["removable"])
        self.pool = gen.relabel_elems(pool, self.n_elems, gen.subseed(seed, 0))
        self.args = {"pool": self.pool, "replicas": self.r, "capacity": self.c,
                     "elems": self.n_elems, "hold": config["hold_fraction"],
                     "seen_remove": config["seen_remove"], "device": self.device}
        self.system = system or Port()
        self.snaps = [{"seed": gen.subseed(seed, 1, s), "args": self.args}
                      for s in range(traffic["snapshots"])]
        self.planes = []
        for snap in self.snaps:
            rows = gen.set_swarm(self.pool, self.r, self.c, snap["seed"], hold=self.args["hold"],
                                 seen_remove=self.args["seen_remove"], device=self.device)
            self.planes.append(self.system.stack(rows, snap))
            del rows
        self.keep_pair = gen.subseed(seed, 2) % len(self.snaps)
        self.epochs = []   # (epoch, pair, overflowed lanes read back)
        self.kept = None   # (epoch, pair, joined, member mask)
        self.paths_before = self.system.counters().get("union_paths", {})

    def epoch(self, e: int, span, keep: bool = True) -> None:
        i = e % len(self.snaps)
        j = (i + 1) % len(self.snaps)
        with span("portbench.join"):
            joined = self.system.join(self.planes[i], self.planes[j])
        with span("portbench.member_mask"):
            member = self.system.member_mask(joined, self.n_elems)
        with span("portbench.readback"):
            overflow = int((joined[2] > self.c).sum())
        if keep:
            self.epochs.append((e, i, overflow))
            # the first epoch's until the pair drawn from the seed has run, so
            # that a window of any length is checked
            if i == self.keep_pair or self.kept is None:
                self.kept = None   # free the last one first: each is 9 GiB at 2^20 lanes
                self.kept = (e, i, joined, member)

    def totals(self) -> dict:
        """A join counts one merge for each lane."""
        return {"merges": self.r * len(self.epochs), "epochs": len(self.epochs)}

    def check(self) -> tuple:
        """({name: (value, limit)}, epochs found wrong), against the plain
        reference.  Frees the staged inputs first."""
        self.planes = None
        nums = dict.fromkeys(("join_lanes_wrong", "n_unique_lanes_wrong",
                              "member_lanes_wrong", "overflow_wrong", "non_sort_joins"), 0)
        wrong = set()
        if self.kept is not None:
            e, i, (keys, removed, n_unique), member = self.kept
            j = (i + 1) % len(self.snaps)
            lanes = 0
            for start, want in reference_blocks(self.snaps[i], self.snaps[j], self.c):
                stop = start + want["n_unique"].shape[0]
                got_keys = keys[:, start:stop].T.to(self.device)
                got_removed = removed[:, start:stop].T.to(self.device)
                join_bad = ((got_keys != want["keys"]).any(dim=1)
                            | ((got_removed != 0) != want["removed"].bool()).any(dim=1))
                nu_bad = n_unique[start:stop].to(self.device).long() != want["n_unique"]
                mem_bad = (member[:, start:stop].T.to(self.device) != want["member"]).any(dim=1)
                nums["join_lanes_wrong"] += int(join_bad.sum())
                nums["n_unique_lanes_wrong"] += int(nu_bad.sum())
                nums["member_lanes_wrong"] += int(mem_bad.sum())
                lanes += int((join_bad | nu_bad | mem_bad).sum())
            if lanes:
                wrong.add(e)
        want_overflow = {}
        for e, i, overflow in self.epochs:
            if i not in want_overflow:
                j = (i + 1) % len(self.snaps)
                want_overflow[i] = sum(
                    int(((ha | hb).sum(dim=1) > self.c).sum())
                    for (_, ha, _), (_, hb, _) in zip(_draws(self.snaps[i]),
                                                      _draws(self.snaps[j])))
            if overflow != want_overflow[i]:
                nums["overflow_wrong"] += 1
                wrong.add(e)
        paths = self.system.counters().get("union_paths")
        if paths is not None:
            ran = {k: v - self.paths_before.get(k, 0) for k, v in paths.items()}
            nums["non_sort_joins"] = sum(v for k, v in ran.items() if k != "sort")
        return {k: (v, 0) for k, v in nums.items()}, len(wrong)

