"""Cells on the sequence CRDT under tombstone GC: R replicas of one RSeq
text document, each wrapped in ``tomb_gc``'s stable-floor GC, as one
columnar swarm on one card (``models/rseq_engine``'s ``plan_gc`` →
``GcSwarm``, kernel 1's wide body at 18 key words and three value planes).

Set-up draws the editing history (``gen_seq.seq_pool``) and ``snapshots``
swarms after an earlier GC barrier (``gen_seq.gc_snapshot``), each with
its own down replica, and plans each through the program; then a bank of
``peer_bank`` draws of ``rounds`` peer lists.  An epoch takes the next
snapshot and the next draw, runs the GC pull rounds queued with no sync,
then the GC barrier; the barrier's unique count, the pulls' largest, the
rows collected and every replica's floor come back to the host together,
the epoch's one wait (closed loop).

For the check it keeps, for each snapshot, its last epoch's swarm after
the rounds and after the barrier.
"""
from __future__ import annotations

import torch

from portbench import gen, gen_seq, reference_seq

READBACK = ("max_n_unique", "pull_n_unique", "collected")


def _pool(config: dict, seed: int) -> gen_seq.SeqPool:
    return gen_seq.seq_pool(gen.subseed(seed, 0), depth=config["depth"],
                            writers=config["writers"],
                            run_max=config["run_max"], elements=config["elements"],
                            removable=config["removable"])


def spread(config: dict, traffic: dict) -> float:
    """The share of the replicas that hold an element after an epoch's
    pull rounds: each round leaves a replica without it only where its
    peer lacks it too, so 1 - (1 - hold_fraction) ** 2 ** rounds."""
    return 1 - (1 - config["hold_fraction"]) ** 2 ** traffic["rounds"]


class Port:
    """The program: the GC swarm engine of ``crdt_tpu_torch``."""

    def __init__(self):
        from crdt_tpu_torch.models import rseq, tomb_gc
        from crdt_tpu_torch.models.rseq_engine import plan_gc
        from crdt_tpu_torch.ops import hopper_union

        self.rseq, self.tomb_gc, self.plan_gc = rseq, tomb_gc, plan_gc
        self.hopper_union = hopper_union
        self.row_counts = []  # the GcRowCounts of every swarm planned
        self.collected = None  # the barriers' collected rows, summed on the device

    def plan(self, pool, snap: gen_seq.GcSnapshot, capacity: int):
        t = gen_seq.tables(pool, snap.held, snap.seen, capacity)
        sw = self.plan_gc(self.tomb_gc.Gc(inner=self.rseq.RSeq(**t), floor=snap.floor),
                          snap.alive)
        if sw.engine != "columnar":
            raise RuntimeError(f"the swarm fell back to the generic engine: "
                               f"{sw.fallback_reason}")
        self.row_counts.append(sw.counts)
        return sw

    def gossip(self, sw, peers):
        return sw.gossip_round(peers)

    def barrier(self, sw):
        out, max_nu, collected = sw.gc_barrier_checked()
        self.collected = collected if self.collected is None else self.collected + collected
        return out, max_nu, collected

    def floors(self, sw) -> torch.Tensor:
        return sw.columnar.floor

    def tables(self, sw) -> dict:
        g = sw.rows()
        return {"keys": g.inner.keys, "elem": g.inner.elem, "removed": g.inner.removed,
                "floor": g.floor}

    def counters(self) -> dict:
        rows = {"suppressed": sum(c.read()["suppressed"] for c in self.row_counts),
                "collected": 0 if self.collected is None else int(self.collected)}
        return {"launches": dict(self.hopper_union.LAUNCHES), "gc_rows": rows}


class Control:
    """The plain reference in the program's place, with one guarantee of
    the configuration broken: every table holds half its capacity, so rows
    are dropped.  ``correct`` must come out false."""

    def plan(self, pool, snap: gen_seq.GcSnapshot, capacity: int):
        self.pool, self.capacity = pool, capacity // 2
        self.ids = reference_seq.Ids.of(pool, snap.held.device)
        held = reference_seq.cap(snap.held, self.capacity)
        return (reference_seq.State(held, snap.seen & held, snap.floor), snap.alive)

    def gossip(self, sw, peers):
        st, alive = sw
        st, n = reference_seq.pull_round(st, peers, alive, self.ids, self.capacity)
        return (st, alive), n

    def barrier(self, sw):
        st, alive = sw
        st, most, collected = reference_seq.barrier(st, alive, self.ids, self.capacity)
        return (st, alive), torch.tensor(most), torch.tensor(collected)

    def floors(self, sw) -> torch.Tensor:
        return sw[0].floor.T

    def tables(self, sw) -> dict:
        st = sw[0]
        return dict(gen_seq.tables(self.pool, st.held, st.seen, 2 * self.capacity),
                    floor=st.floor)

    def counters(self) -> dict:
        return {}


class Cell:
    def __init__(self, config: dict, traffic: dict, seed: int, device, system=None):
        self.device = torch.device(device)
        self.system = system or Port()
        self.r, self.c, self.w = config["replicas"], config["capacity"], config["writers"]
        self.pool = _pool(config, seed)
        self.ids = reference_seq.Ids.of(self.pool, self.device)
        self.snaps = [gen_seq.gc_snapshot(
            self.pool, self.r, self.c, gen.subseed(seed, 1, s), writers=self.w,
            prior_floor=config["prior_floor"], stale_fraction=config["stale_fraction"],
            hold=config["hold_fraction"], spread=spread(config, traffic),
            seen_remove=config["seen_remove"],
            down=config["down_per_snapshot"], device=self.device)
            for s in range(traffic["snapshots"])]
        self.states = [self.system.plan(self.pool, snap, self.c) for snap in self.snaps]
        gen_peers = gen.device_generator(self.device, gen.subseed(seed, 2))
        self.bank = [[gen.random_peers(gen_peers, self.r) for _ in range(traffic["rounds"])]
                     for _ in range(traffic["peer_bank"])]
        pin = self.device.type == "cuda"
        self.host_counts = torch.empty(len(READBACK), dtype=torch.int64, pin_memory=pin)
        self.host_floors = [torch.empty((self.w, self.r), dtype=torch.int32, pin_memory=pin)
                            for _ in self.snaps]
        self.epochs = []   # (epoch, snapshot, draw, {READBACK name: value})
        self.kept = {}     # snapshot -> (epoch, draw, swarm after the rounds, after the barrier)

    def epoch(self, e: int, span, keep: bool = True) -> None:
        s, b = e % len(self.snaps), e % len(self.bank)
        system, sw = self.system, self.states[s]
        pull_nu = torch.zeros((), dtype=torch.int32, device=self.device)
        for peers in self.bank[b]:
            with span("portbench.gc_gossip_round"):
                sw, n_unique = system.gossip(sw, peers)
                pull_nu = torch.maximum(pull_nu, n_unique.max().to(torch.int32))
        after_rounds = sw
        with span("portbench.gc_barrier"):
            sw, max_nu, collected = system.barrier(sw)
        with span("portbench.readback"):
            counts = torch.stack([x.to(device=self.device, dtype=torch.int64)
                                  for x in (max_nu, pull_nu, collected)])
            self.host_counts.copy_(counts, non_blocking=True)
            self.host_floors[s].copy_(system.floors(sw), non_blocking=True)
            if self.device.type == "cuda":
                torch.cuda.current_stream(self.device).synchronize()
        if keep:
            self.epochs.append((e, s, b, dict(zip(READBACK, self.host_counts.tolist()))))
            self.kept[s] = (e, b, after_rounds, sw)

    def totals(self) -> dict:
        """The work of the window's epochs: merges (a pull counts one for each
        up replica that joined an up peer, the barrier one for each up
        replica)."""
        pulls = {}
        merges = 0
        for _, s, b, _ in self.epochs:
            if (s, b) not in pulls:
                alive = self.snaps[s].alive
                pulls[s, b] = sum(int((alive & alive[p]).sum()) for p in self.bank[b]) \
                    + int(alive.sum())
            merges += pulls[s, b]
        return {"merges": merges, "epochs": len(self.epochs)}

    def _reference(self, s: int, b: int):
        """The reference's run of snapshot s under draw b: (state after the
        rounds, the pulls' largest unique count, state after the barrier,
        {READBACK name: value})."""
        snap = self.snaps[s]
        st = reference_seq.State(snap.held, snap.seen, snap.floor)
        pull_nu = 0
        for peers in self.bank[b]:
            st, n = reference_seq.pull_round(st, peers, snap.alive, self.ids, self.c)
            pull_nu = max(pull_nu, int(n.max()))
        final, most, collected = reference_seq.barrier(st, snap.alive, self.ids, self.c)
        return st, final, {"max_n_unique": most, "pull_n_unique": pull_nu,
                           "collected": collected}

    def check(self) -> tuple:
        """({name: (value, limit)}, epochs found wrong), against the plain
        reference.  Frees the staged inputs first."""
        self.states = None
        nums = dict.fromkeys(("pull_lanes_wrong", "gc_lanes_wrong", "floor_lanes_wrong",
                              "down_lane_wrong", "collected_wrong", "n_unique_wrong",
                              "overflow_epochs"), 0)
        wrong_epochs = set()
        for s, (e, b, after_rounds, after_barrier) in self.kept.items():
            snap = self.snaps[s]
            rounds, final, _ = self._reference(s, b)
            up = snap.alive.nonzero().squeeze(1)
            down = (~snap.alive).nonzero().squeeze(1)
            got = self.system.tables(after_rounds)
            pull_bad = reference_seq.lanes_wrong(got, rounds, self.pool, self.c)
            del got
            got = self.system.tables(after_barrier)
            gc_bad = reference_seq.lanes_wrong(got, final, self.pool, self.c, up, floors=False)
            down_bad = reference_seq.lanes_wrong(got, final, self.pool, self.c, down)
            del got
            floor_bad = reference_seq.floor_lanes_wrong(self.host_floors[s], final)
            nums["pull_lanes_wrong"] += pull_bad
            nums["gc_lanes_wrong"] += gc_bad
            nums["down_lane_wrong"] += down_bad
            nums["floor_lanes_wrong"] += floor_bad
            if pull_bad or gc_bad or down_bad or floor_bad:
                wrong_epochs.add(e)
        self.kept = {}
        want = {}
        failed = 0
        for e, s, b, got in self.epochs:
            if (s, b) not in want:
                want[s, b] = self._reference(s, b)[2]
            w = want[s, b]
            nu_bad = (got["max_n_unique"], got["pull_n_unique"]) != \
                (w["max_n_unique"], w["pull_n_unique"])
            over = max(got["max_n_unique"], got["pull_n_unique"]) > self.c
            coll_bad = got["collected"] != w["collected"]
            nums["n_unique_wrong"] += nu_bad
            nums["overflow_epochs"] += over
            nums["collected_wrong"] += coll_bad
            failed += nu_bad or over or coll_bad or e in wrong_epochs
        return {k: (v, 0) for k, v in nums.items()}, failed
