"""Cells on the KV op-log swarm: R replicas of the reference's key-value
counter store as one columnar swarm on one card (``models/oplog_engine``,
kernel 1 at two key words).

Set-up draws ``snapshots`` write bursts from the seed, each with its own
held masks and down replica, and plans each through the program's
``oplog_engine.plan``; then a bank of ``peer_bank`` draws of ``rounds``
peer lists.  An epoch takes the next burst and the next draw, runs the
pull rounds queued with no sync, then the barrier (``converge_checked``,
its ``max_n_unique``) and one ``rebuild``; the unique count and the
views come back to the host together, the epoch's one wait: the burst is
then visible at every replica.  With
``rebuild_every_round`` it also materializes the views after each round.

With ``epochs_ahead`` = 0 the loop is closed: an epoch is issued once the
last one has been read back.  With n > 0 up to n epochs are issued ahead
of the one waited for, so the card has work queued while the host stands
still; ``drain`` waits for every epoch issued.

For the check it keeps, for each burst, its last epoch's state after the
rounds (or the views after each round) and the views it read back.
"""
from __future__ import annotations

import collections
import dataclasses
from types import SimpleNamespace

import torch

from portbench import gen, reference

VIEW_FIELDS = ("present", "is_num", "num", "num_count", "payload")


@dataclasses.dataclass
class Snapshot:
    pool: gen.Pool
    held: torch.Tensor   # bool[R, P]: what each replica holds, after its capacity
    logs: dict           # {field: [R, C]}: the same as log rows
    alive: torch.Tensor  # bool[R]


class Port:
    """The program: the OpLog swarm engine of ``crdt_tpu_torch``."""

    def __init__(self):
        from crdt_tpu_torch.models import oplog, oplog_engine
        from crdt_tpu_torch.ops import hopper_union

        self.oplog, self.engine, self.hopper_union = oplog, oplog_engine, hopper_union

    def plan(self, snap: Snapshot, capacity: int):
        sw = self.engine.plan(self.oplog.OpLog(**snap.logs), alive=snap.alive)
        if sw.engine != "columnar":
            raise RuntimeError(f"the swarm fell back to the generic engine: "
                               f"{sw.fallback_reason}")
        return sw

    def gossip(self, sw, peers):
        return sw.gossip_round(peers)

    def barrier(self, sw):
        return sw.converge_checked()

    def views(self, sw, n_keys: int):
        return sw.rebuild(n_keys)

    def view_fields(self, kv) -> dict:
        return {f: getattr(kv, f) for f in VIEW_FIELDS}

    def log_fields(self, sw) -> dict:
        rows = sw.rows()
        return {f: getattr(rows, f) for f in gen.LOG_FIELDS}

    def counters(self) -> dict:
        return {"launches": dict(self.hopper_union.LAUNCHES)}


class Control:
    """The plain reference in the program's place, with one guarantee of
    the configuration broken: every log holds half its capacity, so ops
    are dropped.  ``correct`` must come out false."""

    def plan(self, snap: Snapshot, capacity: int):
        self.capacity = capacity // 2
        return SimpleNamespace(held=reference.cap(snap.held, self.capacity), snap=snap)

    def gossip(self, st, peers):
        held = reference.pull_round(st.held, peers, st.snap.alive, self.capacity)
        return SimpleNamespace(held=held, snap=st.snap)

    def barrier(self, st):
        held, n = reference.barrier(st.held, st.snap.alive, self.capacity)
        return SimpleNamespace(held=held, snap=st.snap), torch.tensor(n)

    def views(self, st, n_keys: int):
        return reference.views(st.held, st.snap.pool, n_keys)

    def view_fields(self, kv) -> dict:
        return kv

    def log_fields(self, st) -> dict:
        return gen.logs_from_held(st.snap.pool, st.held, 2 * self.capacity)[0]

    def counters(self) -> dict:
        return {}


class Cell:
    def __init__(self, config: dict, traffic: dict, seed: int, device, system=None):
        self.device = torch.device(device)
        self.system = system or Port()
        self.r, self.c, self.k = config["replicas"], config["capacity"], len(gen.ALPHABET)
        self.rounds = traffic["rounds"]
        self.rebuild_every_round = traffic["rebuild_every_round"]
        self.snaps = [self._snapshot(config, seed, s) for s in range(traffic["snapshots"])]
        self.states = [self.system.plan(snap, self.c) for snap in self.snaps]
        gen_peers = gen.device_generator(self.device, gen.subseed(seed, 1))
        self.bank = [[gen.random_peers(gen_peers, self.r) for _ in range(self.rounds)]
                     for _ in range(traffic["peer_bank"])]
        pin = self.device.type == "cuda"
        self.host = [{f: torch.empty((self.r, self.k), dtype=x.dtype, pin_memory=pin)
                      for f, x in self.system.view_fields(
                          self.system.views(self.states[0], self.k)).items()}
                     for _ in self.snaps]
        self.ahead = traffic.get("epochs_ahead", 0)
        # one slot for each epoch in flight: a later epoch of the same burst
        # may reach its copy before an earlier one has been read
        self.host_nu = torch.empty(self.ahead + 1, dtype=torch.int32, pin_memory=pin)
        self.pending = collections.deque()   # (epoch, snapshot, draw, event), in order
        self.epochs = []   # (epoch, snapshot, draw, max_n_unique read back)
        self.kept = {}     # snapshot -> (epoch, draw, state after the rounds, views a round)

    def _snapshot(self, config: dict, seed: int, s: int) -> Snapshot:
        pool = gen.reference_writes(
            config["burst_writes"], self.r, gen.subseed(seed, 0, s, 0),
            delta_min=config["delta_min"], delta_max=config["delta_max"],
            non_numeric=config["non_numeric"], writes_per_ms=config["writes_per_ms"])
        g = gen.device_generator(self.device, gen.subseed(seed, 0, s, 1))
        held = gen.draw_held(self.r, len(pool), config["hold_fraction"], g)
        logs, held = gen.logs_from_held(pool, held, self.c)
        alive = torch.ones(self.r, dtype=torch.bool, device=self.device)
        down = torch.randperm(self.r, generator=g, device=self.device)[:config["down_per_burst"]]
        alive[down] = False
        return Snapshot(pool=pool, held=held, logs=logs, alive=alive)

    def epoch(self, e: int, span, keep: bool = True) -> None:
        s, b = e % len(self.snaps), e % len(self.bank)
        system, sw = self.system, self.states[s]
        round_views = []
        for peers in self.bank[b]:
            with span("portbench.gossip_round"):
                sw = system.gossip(sw, peers)
            if self.rebuild_every_round:
                with span("portbench.rebuild"):
                    round_views.append(system.views(sw, self.k))
        after_rounds = sw
        with span("portbench.barrier"):
            sw, max_nu = system.barrier(sw)
        with span("portbench.rebuild"):
            kv = system.views(sw, self.k)
        with span("portbench.readback"):
            # the unique count comes back with the views: one wait an epoch
            self.host_nu[e % (self.ahead + 1)].copy_(max_nu, non_blocking=True)
            for f, x in system.view_fields(kv).items():
                self.host[s][f].copy_(x, non_blocking=True)
            done = None
            if self.device.type == "cuda":
                done = torch.cuda.Event()
                done.record()
            self.pending.append((e, s, b, done, keep))
            while len(self.pending) > self.ahead:
                self._retire()
        if keep:
            self.kept[s] = (e, b, None if self.rebuild_every_round else after_rounds,
                            round_views)

    def _retire(self) -> None:
        """Wait for the oldest epoch in flight and read its unique count."""
        e, s, b, done, keep = self.pending.popleft()
        if done is not None:
            done.synchronize()
        if keep:
            self.epochs.append((e, s, b, int(self.host_nu[e % (self.ahead + 1)])))

    def drain(self) -> None:
        """Wait for every epoch issued."""
        while self.pending:
            self._retire()

    def totals(self) -> dict:
        """The work of the window's epochs: merges (a pull counts one for each
        up replica that joined an up peer, the barrier one for each up
        replica) and materialized views."""
        pulls = {}
        merges = 0
        for _, s, b, _ in self.epochs:
            if (s, b) not in pulls:
                alive = self.snaps[s].alive
                pulls[s, b] = sum(int((alive & alive[p]).sum()) for p in self.bank[b]) \
                    + int(alive.sum())
            merges += pulls[s, b]
        n_views = (self.rounds * self.rebuild_every_round + 1) * self.r * len(self.epochs)
        return {"merges": merges, "views": n_views, "epochs": len(self.epochs)}

    def check(self) -> tuple:
        """({name: (value, limit)}, epochs found wrong), against the plain
        reference.  Frees the staged inputs first."""
        self.states = None
        nums = dict.fromkeys(("gossip_lanes_wrong", "view_lanes_wrong", "down_lane_wrong",
                              "n_unique_wrong", "overflow_epochs"), 0)
        wrong_epochs = set()
        want_nu = {}
        for s, (e, b, after_rounds, round_views) in self.kept.items():
            snap = self.snaps[s]
            held, bad = snap.held, 0
            for k, peers in enumerate(self.bank[b]):
                held = reference.pull_round(held, peers, snap.alive, self.c)
                if round_views:
                    bad += reference.view_lanes_wrong(
                        self.system.view_fields(round_views[k]),
                        reference.views(held, snap.pool, self.k))
            if after_rounds is not None:
                bad += reference.log_lanes_wrong(self.system.log_fields(after_rounds), held,
                                                 snap.pool, self.c)
            final, want_nu[s] = reference.barrier(held, snap.alive, self.c)
            want = reference.views(final, snap.pool, self.k)
            up = snap.alive.nonzero().squeeze(1)
            down = (~snap.alive).nonzero().squeeze(1)
            got = {f: x.to(self.device) for f, x in self.host[s].items()}
            view_bad = reference.view_lanes_wrong(got, want, up)
            down_bad = reference.view_lanes_wrong(got, want, down)
            nums["gossip_lanes_wrong"] += bad
            nums["view_lanes_wrong"] += view_bad
            nums["down_lane_wrong"] += down_bad
            if bad or view_bad or down_bad:
                wrong_epochs.add(e)
        failed = 0
        for e, s, _, max_nu in self.epochs:
            nu_bad = max_nu != want_nu[s]
            nums["n_unique_wrong"] += nu_bad
            nums["overflow_epochs"] += max_nu > self.c
            failed += nu_bad or max_nu > self.c or e in wrong_epochs
        return {k: (v, 0) for k, v in nums.items()}, failed
