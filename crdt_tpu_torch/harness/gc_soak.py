"""Set- and map-workload soaks of the GC'd lattices (counterpart of
``crdt_tpu.harness.gc_soak``), with the states on the card.

``SetSoakRunner`` drives a swarm of GC-wrapped OR-Sets
(``models.tomb_gc``) through a seeded random schedule of adds, removes,
pairwise gossip joins, kills/revivals and GC barriers
(``tomb_gc.gc_round`` on the batched swarm), checked after every action
against a GC-less Python mirror (a tag → removed dict per replica):

  S1  transparency — every replica's member set equals its mirror's after
      every action;
  S2  no resurrection / no lost removes — S1 across kill → barrier →
      revive → rejoin schedules;
  S3  reclamation  — barriers shrink tables (reported);
  S4  safety      — no step raises.

``MapSoakRunner`` drives the OR-Map's epoch-reset GC
(``models.ormap_gc``) under updates, removes, joins, kills and
stale-snapshot restores, checked after every action against a spec mirror
of reset-on-stable-remove (M1 transparency, M2 reset safety, M3
reclamation, M4 safety).

The schedules draw from ``random.Random(seed)`` in the JAX package's
order, so one seed gives both packages the same schedule and report.

CLI:  python -m crdt_tpu_torch.harness.gc_soak --steps 1000
"""
from __future__ import annotations

import dataclasses
import random
import sys
from typing import Dict, Tuple

import torch

from crdt_tpu_torch import default_device
from crdt_tpu_torch.models import orset, tomb_gc
from crdt_tpu_torch.parallel import swarm
from crdt_tpu_torch.utils.tree import tree_map

AD = orset.GC_ADAPTER


@dataclasses.dataclass
class GcSoakReport:
    steps: int = 0
    adds: int = 0
    removes: int = 0
    joins: int = 0
    kills: int = 0
    revivals: int = 0
    barriers: int = 0
    barriers_noop: int = 0
    max_rows_seen: int = 0
    rows_reclaimed: int = 0
    final_rows: int = 0
    final_members: int = 0

    def __str__(self) -> str:
        return (
            f"gc-soak: {self.steps} steps, {self.adds} adds / "
            f"{self.removes} removes, {self.joins} joins, {self.kills} kills"
            f" / {self.revivals} revivals, {self.barriers} barriers "
            f"({self.barriers_noop} no-op), rows peak {self.max_rows_seen} "
            f"reclaimed {self.rows_reclaimed} final {self.final_rows}, "
            f"{self.final_members} members"
        )


class _Mirror:
    """GC-less oracle replica: tag → (elem, removed)."""

    def __init__(self):
        self.tags: Dict[Tuple[int, int], Tuple[int, bool]] = {}

    def add(self, elem: int, rid: int, seq: int) -> None:
        self.tags[(rid, seq)] = (elem, False)

    def remove(self, elem: int) -> None:
        for t, (e, _) in list(self.tags.items()):
            if e == elem:
                self.tags[t] = (e, True)

    def join(self, other: "_Mirror") -> None:
        for t, (e, r) in other.tags.items():
            mine = self.tags.get(t)
            self.tags[t] = (e, r or (mine is not None and mine[1]))

    def members(self) -> set:
        return {e for e, r in self.tags.values() if not r}

    def copy(self) -> "_Mirror":
        m = _Mirror()
        m.tags = dict(self.tags)
        return m


class SetSoakRunner:
    """One seeded adversarial set-workload schedule.

    NOTE: the runner skeleton (report counters, kill/revive, probability-
    table step dispatch, barrier mirror-LUB broadcast) deliberately
    parallels harness/seq_soak.py's SeqSoakRunner — same invariant set,
    different lattice and mirror.  A change to the shared shape should be
    mirrored there, or the divergence justified, like soak.py's two
    runners."""

    def __init__(
        self,
        n: int = 4,
        seed: int = 0,
        capacity: int = 512,
        n_elems: int = 24,
        p_add: float = 0.3,
        p_remove: float = 0.2,
        p_join: float = 0.25,
        p_kill: float = 0.05,
        p_revive: float = 0.08,
        p_barrier: float = 0.12,
        device=None,
    ):
        self.rng = random.Random(seed)
        self.n = n
        self.capacity = capacity
        self.n_elems = n_elems
        self.device = default_device(device)
        self.states = [
            tomb_gc.wrap(orset.empty(capacity, device=self.device), n, device=self.device)
            for _ in range(n)
        ]
        self.mirrors = [_Mirror() for _ in range(n)]
        self.alive = [True] * n
        self.seqs = [0] * n
        self.p = (p_add, p_remove, p_join, p_kill, p_revive, p_barrier)
        self.report = GcSoakReport()

    # ---- helpers ----

    def _members(self, i: int) -> set:
        mask = orset.member_mask(self.states[i].inner, self.n_elems)
        return set(torch.nonzero(mask).flatten().tolist())

    def _rows(self, i: int) -> int:
        return int(orset.size(self.states[i].inner))

    def _note_rows(self, i: int) -> None:
        """Track the capacity-pressure peak for the one replica an action
        mutated (a per-step all-replica sweep would just be device-sync
        bookkeeping — only the mutated table can grow)."""
        self.report.max_rows_seen = max(self.report.max_rows_seen, self._rows(i))

    def _check(self, i: int, where: str) -> None:
        got, want = self._members(i), self.mirrors[i].members()
        assert got == want, (
            f"S1 transparency violated at replica {i} after {where}: "
            f"device {sorted(got)} != mirror {sorted(want)}"
        )

    def _stacked(self):
        return tree_map(lambda *xs: torch.stack(xs), *self.states)

    def _alive(self) -> torch.Tensor:
        return torch.tensor(self.alive, device=self.device)

    # ---- actions ----

    def _add(self) -> None:
        i = self.rng.randrange(self.n)
        if not self.alive[i]:
            return
        if self._rows(i) >= self.capacity:
            return  # table full; only a barrier can help
        e = self.rng.randrange(self.n_elems)
        s = self.seqs[i]
        self.seqs[i] += 1
        self.states[i] = tomb_gc.Gc(
            inner=orset.add(self.states[i].inner, e, i, s), floor=self.states[i].floor
        )
        self.mirrors[i].add(e, i, s)
        self.report.adds += 1
        self._note_rows(i)
        self._check(i, "add")

    def _remove(self) -> None:
        i = self.rng.randrange(self.n)
        if not self.alive[i]:
            return
        present = sorted(self._members(i))
        if not present:
            return
        e = self.rng.choice(present)
        self.states[i] = tomb_gc.Gc(
            inner=orset.remove(self.states[i].inner, e), floor=self.states[i].floor
        )
        self.mirrors[i].remove(e)
        self.report.removes += 1
        self._check(i, "remove")

    def _join(self) -> None:
        i = self.rng.randrange(self.n)
        j = self.rng.randrange(self.n)
        if i == j or not (self.alive[i] and self.alive[j]):
            return
        out, nu = tomb_gc.join_checked(self.states[i], self.states[j], AD)
        assert int(nu) <= self.capacity, "capacity overflow breaks GC (S4)"
        self.states[i] = out
        self.mirrors[i].join(self.mirrors[j])
        self.report.joins += 1
        self._note_rows(i)
        self._check(i, "join")

    def _kill(self) -> None:
        candidates = [i for i in range(self.n) if self.alive[i]]
        if len(candidates) <= 1:
            return
        self.alive[self.rng.choice(candidates)] = False
        self.report.kills += 1

    def _revive(self) -> None:
        dead = [i for i in range(self.n) if not self.alive[i]]
        if not dead:
            return
        self.alive[self.rng.choice(dead)] = True
        self.report.revivals += 1

    def _barrier(self) -> None:
        rows_before = sum(self._rows(i) for i in range(self.n))
        sw = tomb_gc.gc_round(
            swarm.make(self._stacked(), self._alive()), AD,
            orset.empty(self.capacity, device=self.device),
        )
        self.states = [
            tree_map(lambda x, _i=i: x[_i], sw.state) for i in range(self.n)
        ]
        # the barrier CONVERGES alive replicas before collecting — mirror it
        lub = None
        for i in range(self.n):
            if self.alive[i]:
                lub = self.mirrors[i].copy() if lub is None else lub
                lub.join(self.mirrors[i])
        for i in range(self.n):
            if self.alive[i] and lub is not None:
                self.mirrors[i] = lub.copy()
        rows_after = sum(self._rows(i) for i in range(self.n))
        self.report.barriers += 1  # every executed barrier counts
        if rows_after < rows_before:
            self.report.rows_reclaimed += rows_before - rows_after
        else:
            self.report.barriers_noop += 1  # ran but found nothing to drop
        for i in range(self.n):
            self._check(i, "barrier")

    # ---- run ----

    def step(self) -> None:
        p_add, p_remove, p_join, p_kill, p_revive, p_barrier = self.p
        x = self.rng.random()
        if x < p_add:
            self._add()
        elif x < p_add + p_remove:
            self._remove()
        elif x < p_add + p_remove + p_join:
            self._join()
        elif x < p_add + p_remove + p_join + p_kill:
            self._kill()
        elif x < p_add + p_remove + p_join + p_kill + p_revive:
            self._revive()
        elif x < p_add + p_remove + p_join + p_kill + p_revive + p_barrier:
            self._barrier()
        self.report.steps += 1

    def heal_and_check(self) -> GcSoakReport:
        """Revive everyone, converge via joins, final transparency check."""
        self.alive = [True] * self.n
        for _ in range(self.n):
            for i in range(self.n):
                j = (i + 1) % self.n
                self.states[i], _ = tomb_gc.join_checked(
                    self.states[i], self.states[j], AD
                )
                self.mirrors[i].join(self.mirrors[j])
        members = {frozenset(self._members(i)) for i in range(self.n)}
        assert len(members) == 1, "healed swarm did not converge"
        for i in range(self.n):
            self._check(i, "heal")
        self.report.final_rows = self._rows(0)
        self.report.final_members = len(self._members(0))
        return self.report

    def run(self, n_steps: int) -> GcSoakReport:
        for _ in range(n_steps):
            self.step()  # S4: no step may raise
        return self.heal_and_check()


@dataclasses.dataclass
class MapSoakReport:
    steps: int = 0
    updates: int = 0
    removes: int = 0
    joins: int = 0
    kills: int = 0
    revivals: int = 0
    snapshots: int = 0
    restores: int = 0
    barriers: int = 0
    barriers_noop: int = 0
    barriers_skipped: int = 0  # dead member -> full-fleet rule skipped it
    keys_reset: int = 0
    final_present: int = 0
    # churn gauges (round-5 task 6): how often the full-fleet rule lets a
    # barrier fire under this schedule, and how much reclaimable state
    # accumulates while it cannot
    peak_unreclaimed: int = 0      # max keys with history, removed, unreset
    unreclaimed_at_end: int = 0

    @property
    def barrier_fire_rate(self) -> float:
        """Fired barriers / attempts (fired + skipped-by-churn)."""
        att = self.barriers + self.barriers_skipped
        return self.barriers / att if att else 0.0

    def __str__(self) -> str:
        return (
            f"map-soak: {self.steps} steps, {self.updates} updates / "
            f"{self.removes} removes, {self.joins} joins, {self.kills} "
            f"kills / {self.revivals} revivals, {self.snapshots} snaps / "
            f"{self.restores} stale restores, fire-rate "
            f"{self.barrier_fire_rate:.2f}, peak-unreclaimed "
            f"{self.peak_unreclaimed}, {self.barriers} barriers "
            f"({self.barriers_noop} no-op, {self.barriers_skipped} "
            f"skipped), {self.keys_reset} keys reset, "
            f"final present {self.final_present}"
        )


class _MapMirror:
    """Spec oracle for the GC'd OR-Map: token/seen vectors per key (the
    observed-remove rule in plain python) + per-writer P/N cells + the
    per-key RESET EPOCH, with the reset-wins join rule (ormap_gc module
    docstring) written out the obvious scalar way — the device's
    vectorized select/reset/converge is checked against this after every
    action."""

    def __init__(self, k: int, w: int):
        self.k, self.w = k, w
        self.tok = [[-1] * w for _ in range(k)]
        self.seen = [[-1] * w for _ in range(k)]
        self.p = [[0] * w for _ in range(k)]
        self.n = [[0] * w for _ in range(k)]
        self.epoch = [0] * k

    def update(self, key: int, writer: int, delta: int) -> None:
        self.tok[key][writer] += 1
        if delta >= 0:
            self.p[key][writer] += delta
        else:
            self.n[key][writer] -= delta

    def remove(self, key: int) -> None:
        self.seen[key] = [
            max(s, t) for s, t in zip(self.seen[key], self.tok[key])
        ]

    def contains(self, key: int) -> bool:
        return any(
            t > -1 and t > s for t, s in zip(self.tok[key], self.seen[key])
        )

    def value(self, key: int) -> int:
        return sum(self.p[key]) - sum(self.n[key])

    def join(self, other: "_MapMirror") -> None:
        for k in range(self.k):
            if other.epoch[k] > self.epoch[k]:
                # reset-wins: the higher epoch takes the key wholesale
                self.tok[k] = list(other.tok[k])
                self.seen[k] = list(other.seen[k])
                self.p[k] = list(other.p[k])
                self.n[k] = list(other.n[k])
                self.epoch[k] = other.epoch[k]
            elif other.epoch[k] == self.epoch[k]:
                self.tok[k] = [max(a, b) for a, b in zip(self.tok[k], other.tok[k])]
                self.seen[k] = [max(a, b) for a, b in zip(self.seen[k], other.seen[k])]
                self.p[k] = [max(a, b) for a, b in zip(self.p[k], other.p[k])]
                self.n[k] = [max(a, b) for a, b in zip(self.n[k], other.n[k])]
            # else: ours is newer — ignore the stale row

    def reset(self, key: int) -> None:
        self.tok[key] = [-1] * self.w
        self.seen[key] = [-1] * self.w
        self.p[key] = [0] * self.w
        self.n[key] = [0] * self.w
        self.epoch[key] += 1

    def copy(self) -> "_MapMirror":
        import copy

        return copy.deepcopy(self)


class MapSoakRunner:
    """One seeded adversarial map-workload schedule (see module docstring
    round-4 section; skeleton parallels SetSoakRunner)."""

    def __init__(
        self,
        n: int = 4,
        seed: int = 0,
        n_keys: int = 12,
        p_update: float = 0.3,
        p_remove: float = 0.16,
        p_join: float = 0.22,
        p_kill: float = 0.04,
        p_revive: float = 0.06,
        p_snapshot: float = 0.05,
        p_restore: float = 0.05,
        p_barrier: float = 0.12,
        device=None,
    ):
        from crdt_tpu_torch.models import ormap, ormap_gc, pncounter

        self.rng = random.Random(seed)
        self.n = n
        self.n_keys = n_keys
        self.device = default_device(device)
        self.value_zero = pncounter.zero(n, device=self.device)
        # pncounter.join is elementwise: it joins the [K, W] value planes
        # as JAX's vmap of it does
        self.vjoin = pncounter.join
        self.states = [
            ormap_gc.wrap(ormap.empty(n_keys, n, self.value_zero, device=self.device),
                          device=self.device)
            for _ in range(n)
        ]
        self.mirrors = [_MapMirror(n_keys, n) for _ in range(n)]
        # stale-snapshot slots: (MapGc, _MapMirror) per replica, or None
        self.saved = [None] * n
        self.alive = [True] * n
        self.p = (p_update, p_remove, p_join, p_kill, p_revive,
                  p_snapshot, p_restore, p_barrier)
        self.report = MapSoakReport()

    # ---- helpers ----

    def _check(self, i: int, where: str) -> None:
        from crdt_tpu_torch.models import ormap_gc, pncounter

        got_c = ormap_gc.contains(self.states[i]).tolist()
        want_c = [self.mirrors[i].contains(k) for k in range(self.n_keys)]
        assert got_c == want_c, (
            f"M1 presence diverged at replica {i} after {where}: "
            f"device {got_c} != mirror {want_c}"
        )
        vals = pncounter.value(self.states[i].map.values).tolist()
        for k in range(self.n_keys):
            if want_c[k]:
                assert int(vals[k]) == self.mirrors[i].value(k), (
                    f"M1 value diverged at replica {i} key {k} after "
                    f"{where}: device {int(vals[k])} != mirror "
                    f"{self.mirrors[i].value(k)}"
                )

    # ---- actions ----

    def _update(self) -> None:
        from crdt_tpu_torch.models import ormap_gc, pncounter

        i = self.rng.randrange(self.n)
        if not self.alive[i]:
            return
        k = self.rng.randrange(self.n_keys)
        delta = self.rng.randint(-5, 5)
        self.states[i] = ormap_gc.update(
            self.states[i], k, i, lambda v: pncounter.add(v, i, delta)
        )
        self.mirrors[i].update(k, i, delta)
        self.report.updates += 1
        self._check(i, "update")

    def _remove(self) -> None:
        from crdt_tpu_torch.models import ormap_gc

        i = self.rng.randrange(self.n)
        if not self.alive[i]:
            return
        present = [
            k for k in range(self.n_keys) if self.mirrors[i].contains(k)
        ]
        if not present:
            return
        k = self.rng.choice(present)
        self.states[i] = ormap_gc.remove(self.states[i], k, i)
        self.mirrors[i].remove(k)
        self.report.removes += 1
        self._check(i, "remove")

    def _join(self) -> None:
        from crdt_tpu_torch.models import ormap_gc

        i = self.rng.randrange(self.n)
        j = self.rng.randrange(self.n)
        if i == j or not (self.alive[i] and self.alive[j]):
            return
        self.states[i] = ormap_gc.join(
            self.states[i], self.states[j], self.vjoin
        )
        self.mirrors[i].join(self.mirrors[j])
        self.report.joins += 1
        self._check(i, "join")

    def _kill(self) -> None:
        candidates = [i for i in range(self.n) if self.alive[i]]
        if len(candidates) <= 1:
            return
        self.alive[self.rng.choice(candidates)] = False
        self.report.kills += 1

    def _revive(self) -> None:
        dead = [i for i in range(self.n) if not self.alive[i]]
        if not dead:
            return
        self.alive[self.rng.choice(dead)] = True
        self.report.revivals += 1

    def _snapshot(self) -> None:
        i = self.rng.randrange(self.n)
        if not self.alive[i]:
            return
        self.saved[i] = (self.states[i], self.mirrors[i].copy())
        self.report.snapshots += 1

    def _restore(self) -> None:
        """Stale-snapshot revert: the crash model the per-key epochs
        absorb — a replica comes back holding PRE-BARRIER state and must
        be re-absorbed by epoch dominance at its next join."""
        i = self.rng.randrange(self.n)
        if not self.alive[i] or self.saved[i] is None:
            return
        self.states[i], mirror = self.saved[i]
        self.mirrors[i] = mirror.copy()
        self.report.restores += 1
        self._check(i, "restore")

    def _unreclaimed(self, i: int) -> int:
        """Keys with history whose removal is folded but not yet reset at
        replica i — the state a fired barrier would reclaim (mirror-side:
        no device roundtrip)."""
        m = self.mirrors[i]
        return sum(
            1 for k in range(self.n_keys)
            if any(t > -1 for t in m.tok[k]) and not m.contains(k)
        )

    def _sample_unreclaimed(self) -> None:
        for i in range(self.n):
            if self.alive[i]:
                self.report.peak_unreclaimed = max(
                    self.report.peak_unreclaimed, self._unreclaimed(i)
                )

    def _barrier(self) -> None:
        from crdt_tpu_torch.models import ormap_gc

        self._sample_unreclaimed()
        sw, n_reset = ormap_gc.reset_barrier(
            swarm.make(
                tree_map(lambda *xs: torch.stack(xs), *self.states),
                torch.tensor(self.alive, device=self.device),
            ),
            self.vjoin, self.value_zero,
        )
        if not all(self.alive):
            # full-fleet rule: a barrier with a dead member never executes
            # (counted apart from executed-but-nothing-to-reset no-ops)
            self.report.barriers_skipped += 1
            return
        self.states = [
            tree_map(lambda x, _i=i: x[_i], sw.state) for i in range(self.n)
        ]
        # mirror: LUB everyone, reset the stably-removed keys, broadcast
        lub = self.mirrors[0].copy()
        for i in range(1, self.n):
            lub.join(self.mirrors[i])
        for k in range(self.n_keys):
            had = any(t > -1 for t in lub.tok[k])
            if had and not lub.contains(k):
                lub.reset(k)
        self.mirrors = [lub.copy() for _ in range(self.n)]
        self.report.barriers += 1
        if n_reset:
            self.report.keys_reset += n_reset
        else:
            self.report.barriers_noop += 1
        for i in range(self.n):
            self._check(i, "barrier")

    # ---- run ----

    def step(self) -> None:
        x = self.rng.random()
        acc = 0.0
        for p, action in zip(self.p, (
            self._update, self._remove, self._join, self._kill,
            self._revive, self._snapshot, self._restore, self._barrier,
        )):
            acc += p
            if x < acc:
                action()
                break
        if self.report.steps % 8 == 0:
            self._sample_unreclaimed()
        self.report.steps += 1

    def heal_and_check(self) -> MapSoakReport:
        from crdt_tpu_torch.models import ormap_gc

        self._sample_unreclaimed()
        self.report.unreclaimed_at_end = max(
            (self._unreclaimed(i) for i in range(self.n) if self.alive[i]),
            default=0,
        )
        self.alive = [True] * self.n
        for _ in range(self.n):
            for i in range(self.n):
                j = (i + 1) % self.n
                self.states[i] = ormap_gc.join(
                    self.states[i], self.states[j], self.vjoin
                )
                self.mirrors[i].join(self.mirrors[j])
        present = {
            tuple(ormap_gc.contains(self.states[i]).tolist())
            for i in range(self.n)
        }
        assert len(present) == 1, "healed swarm did not converge"
        for i in range(self.n):
            self._check(i, "heal")
        self.report.final_present = int(ormap_gc.contains(self.states[0]).sum())
        return self.report

    def run(self, n_steps: int) -> MapSoakReport:
        for _ in range(n_steps):
            self.step()  # M4: no step may raise
        return self.heal_and_check()


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description="tombstone-GC set-workload soak")
    ap.add_argument("--steps", type=int, default=1000)
    ap.add_argument("--seeds", type=int, default=3)
    ap.add_argument("--replicas", type=int, default=4)
    ap.add_argument("--capacity", type=int, default=512)
    ap.add_argument("--device", default=None,
                    help="the states' device (default: the CUDA card)")
    ap.add_argument("--workload", choices=["set", "map", "both"],
                    default="both")
    args = ap.parse_args(argv)
    for seed in range(args.seeds):
        if args.workload in ("set", "both"):
            runner = SetSoakRunner(
                n=args.replicas, seed=seed, capacity=args.capacity,
                device=args.device,
            )
            print(f"seed {seed}: {runner.run(args.steps)}")
        if args.workload in ("map", "both"):
            mrunner = MapSoakRunner(n=args.replicas, seed=seed, device=args.device)
            print(f"seed {seed}: {mrunner.run(args.steps)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
