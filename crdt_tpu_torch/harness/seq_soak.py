"""Sequence-workload soak: the RSeq allocator and tombstone GC under an
adversarial concurrent-editing schedule (counterpart of
``crdt_tpu.harness.seq_soak``), with the states on the card.

N writer replicas (GC-wrapped RSeq states with live ``SeqWriter``
cursors) run a seeded random schedule of index-addressed inserts and
deletes, pairwise gossip joins, kills/revivals, writer restarts (the
cursor rebuilt with the floor-aware ``tomb_gc.next_seq``) and GC barriers,
checked after every action against a GC-less Python mirror:

  Q1 transparency  — each replica's visible list equals its mirror's;
  Q2 intention     — ``alloc_key``'s guard raises on any misorder;
  Q3 no lost/resurrected edits — Q1 across kill → barrier → restart →
                     rejoin schedules;
  Q4 reclamation   — barriers shrink tables (reported);
  Q5 safety        — no step raises.

``engine="auto"`` joins through ``rseq_engine.gc_join_checked_auto`` (the
lexN kernels on a CUDA state: kernel 1 at capacity <= 512, kernels 4 and
5 above) and barriers through ``tomb_gc.gc_round``'s columnar hook;
``"generic"`` pins the row-major joins.  The schedule draws from
``random.Random(seed)`` in the JAX package's order.

CLI:  python -m crdt_tpu_torch.harness.seq_soak --steps 1000
"""
from __future__ import annotations

import dataclasses
import random
import sys
from typing import Dict, List, Tuple

import torch

from crdt_tpu_torch import default_device
from crdt_tpu_torch.models import rseq, tomb_gc
from crdt_tpu_torch.parallel import swarm
from crdt_tpu_torch.utils.constants import SENTINEL_PY
from crdt_tpu_torch.utils.tree import tree_map

AD = rseq.GC_ADAPTER


@dataclasses.dataclass
class SeqSoakReport:
    steps: int = 0
    inserts: int = 0
    deletes: int = 0
    joins: int = 0
    kills: int = 0
    revivals: int = 0
    restarts: int = 0
    widens: int = 0
    barriers: int = 0
    barriers_noop: int = 0
    max_rows_seen: int = 0
    rows_reclaimed: int = 0
    final_rows: int = 0
    final_len: int = 0

    def __str__(self) -> str:
        return (
            f"seq-soak: {self.steps} steps, {self.inserts} ins / "
            f"{self.deletes} del, {self.joins} joins, {self.kills} kills / "
            f"{self.revivals} revivals, {self.restarts} restarts, "
            f"{self.widens} widens, "
            f"{self.barriers} barriers ({self.barriers_noop} no-op), rows "
            f"peak {self.max_rows_seen} reclaimed {self.rows_reclaimed} "
            f"final {self.final_rows}, len {self.final_len}"
        )


class _Mirror:
    """GC-less oracle replica: identity key-row → (elem, removed).
    The visible list is the live rows in key order — exactly what the
    sorted table renders."""

    def __init__(self):
        self.rows: Dict[Tuple[int, ...], Tuple[int, bool]] = {}

    def insert(self, key_row, elem: int) -> None:
        self.rows[tuple(key_row)] = (elem, False)

    def delete(self, key_row) -> None:
        e, _ = self.rows[tuple(key_row)]
        self.rows[tuple(key_row)] = (e, True)

    def join(self, other: "_Mirror") -> None:
        for k, (e, r) in other.rows.items():
            mine = self.rows.get(k)
            self.rows[k] = (e, r or (mine is not None and mine[1]))

    def live(self) -> List[Tuple[Tuple[int, ...], int]]:
        return sorted(
            (k, e) for k, (e, r) in self.rows.items() if not r
        )

    def to_list(self) -> List[int]:
        return [e for _, e in self.live()]

    def copy(self) -> "_Mirror":
        m = _Mirror()
        m.rows = dict(self.rows)
        return m


class SeqSoakRunner:
    """One seeded adversarial sequence-editing schedule.

    NOTE: the runner skeleton deliberately parallels
    harness/gc_soak.py's SetSoakRunner (see the note there): keep the
    shared shape in sync across both."""

    def __init__(
        self,
        n: int = 3,
        seed: int = 0,
        capacity: int = 512,
        p_insert: float = 0.28,
        p_run: float = 0.06,
        p_delete: float = 0.12,
        p_join: float = 0.22,
        p_kill: float = 0.04,
        p_revive: float = 0.06,
        p_restart: float = 0.06,
        p_barrier: float = 0.12,
        engine: str = "auto",
        device=None,
    ):
        self.rng = random.Random(seed)
        self.n = n
        self.capacity = capacity
        # "auto" = the columnar lexN engine whenever eligible (the
        # default — rseq_engine.gc_join_checked_auto / gc_round's adapter
        # hook, loud EngineFallback otherwise); "generic" pins the
        # row-major path (the A/B reference)
        self.engine = engine
        self.device = default_device(device)
        self.states = [
            tomb_gc.wrap(rseq.empty(capacity, device=self.device), n, device=self.device)
            for _ in range(n)
        ]
        # one live cursor per replica; writer rid == replica index
        self.writers = [
            rseq.SeqWriter(self.states[i].inner, rid=i) for i in range(n)
        ]
        self.mirrors = [_Mirror() for _ in range(n)]
        self.alive = [True] * n
        self.p = (p_insert, p_run, p_delete, p_join, p_kill, p_revive,
                  p_restart, p_barrier)
        self.report = SeqSoakReport()

    # ---- helpers ----

    def _sync_writer(self, i: int) -> None:
        """Push the Gc state's inner table into replica i's cursor."""
        self.writers[i].state = self.states[i].inner

    def _pull_writer(self, i: int) -> None:
        """Adopt the cursor's table back into the Gc wrapper."""
        self.states[i] = tomb_gc.Gc(inner=self.writers[i].state, floor=self.states[i].floor)

    def _rows(self, i: int) -> int:
        return int(rseq.n_rows(self.states[i].inner))

    def _check(self, i: int, where: str) -> None:
        got = rseq.to_list(self.states[i].inner)
        want = self.mirrors[i].to_list()
        assert got == want, (
            f"Q1 transparency violated at replica {i} after {where}: "
            f"device {got} != mirror {want}"
        )

    def _stacked(self):
        return tree_map(lambda *xs: torch.stack(xs), *self.states)

    # ---- actions ----

    def _widen_fleet(self, new_depth: int) -> None:
        """Depth migration (rseq.widen): the recovery path for collision
        twins identical through every level.  Host-coordinated — every
        replica AND every mirror rekeys together (joins reject mixed
        depths by design)."""
        mid_hi, mid_lo = rseq.split_pos(rseq.MID)
        self.states = [
            tomb_gc.Gc(inner=rseq.widen(g.inner, new_depth), floor=g.floor)
            for g in self.states
        ]
        for i in range(self.n):
            self._sync_writer(i)
            m = _Mirror()
            for k, v in self.mirrors[i].rows.items():
                levels = (4 * new_depth - len(k)) // 4
                m.rows[k + (mid_hi, mid_lo, k[-2], k[-1]) * levels] = v
            self.mirrors[i] = m
        self.report.widens += 1

    def _do_insert(self, length: int, where: str) -> None:
        """Shared insert scaffold: replica pick, capacity gate, the
        GapExhausted widen-and-retry recovery, mirror + report updates.
        length == 1 edits through insert_at; longer runs through the
        batched single-union insert_run — same invariants either way."""
        i = self.rng.randrange(self.n)
        if not self.alive[i]:
            return
        if self._rows(i) + length > self.capacity:
            return  # full; only a barrier can reclaim
        w = self.writers[i]
        live = w._rows()
        idx = self.rng.randint(0, len(live))
        elems = [self.report.inserts + 1 + k for k in range(length)]

        def edit(writer):
            if length == 1:
                writer.insert_at(idx, elems[0])  # Q2: alloc guard inside
            else:
                writer.insert_run(idx, elems)

        try:
            edit(w)
        except rseq.GapExhausted:
            # depth cap hit between deepest-level collision twins: widen
            # the fleet and retry (the documented recovery path)
            self._widen_fleet(self.states[i].inner.depth + 2)
            w = self.writers[i]
            edit(w)
        for e in elems:
            self.mirrors[i].insert(self._new_row_of(w, e), e)
        self._pull_writer(i)
        self.report.inserts += length
        self.report.max_rows_seen = max(
            self.report.max_rows_seen, self._rows(i)
        )
        self._check(i, where)

    def _insert(self) -> None:
        self._do_insert(1, "insert")

    def _insert_run(self) -> None:
        self._do_insert(self.rng.randint(2, 5), "insert_run")

    def _new_row_of(self, w: rseq.SeqWriter, elem: int):
        """The key row the cursor just allocated (by payload: elems are
        globally unique in this harness)."""
        keys = w.state.keys
        hits = torch.nonzero((keys[:, 0] != SENTINEL_PY) & (w.state.elem == elem)).flatten()
        assert len(hits) == 1
        return tuple(keys[int(hits[0])].tolist())

    def _delete(self) -> None:
        i = self.rng.randrange(self.n)
        if not self.alive[i]:
            return
        w = self.writers[i]
        live = w._rows()
        if not live:
            return
        idx = self.rng.randrange(len(live))
        key_row = live[idx]
        w.delete_at(idx)
        self.mirrors[i].delete(key_row)
        self._pull_writer(i)
        self.report.deletes += 1
        self._check(i, "delete")

    def _join(self) -> None:
        i = self.rng.randrange(self.n)
        j = self.rng.randrange(self.n)
        if i == j or not (self.alive[i] and self.alive[j]):
            return
        if self.engine == "generic":
            out, nu = tomb_gc.join_checked(self.states[i], self.states[j], AD)
        else:
            from crdt_tpu_torch.models import rseq_engine

            out, nu = rseq_engine.gc_join_checked_auto(
                self.states[i], self.states[j]
            )
        assert int(nu) <= self.capacity, "capacity overflow breaks GC (Q5)"
        self.states[i] = out
        self._sync_writer(i)
        self.mirrors[i].join(self.mirrors[j])
        self.report.joins += 1
        self.report.max_rows_seen = max(
            self.report.max_rows_seen, self._rows(i)
        )
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

    def _restart(self) -> None:
        """Writer-process restart: the cursor is rebuilt from the durable
        state with the floor-aware seq resume (the tomb_gc.next_seq
        contract under fire — a table-max resume would re-mint collected
        identities and get silently suppressed)."""
        i = self.rng.randrange(self.n)
        if not self.alive[i]:
            return  # dead processes don't restart cursors (fault model)
        self.writers[i] = rseq.SeqWriter(
            self.states[i].inner, rid=i,
            seq_start=tomb_gc.next_seq(self.states[i], AD, i),
        )
        self.report.restarts += 1
        self._check(i, "restart")

    def _barrier(self) -> None:
        rows_before = sum(self._rows(i) for i in range(self.n))
        sw = tomb_gc.gc_round(
            swarm.make(self._stacked(), torch.tensor(self.alive, device=self.device)),
            # the neutral must track the fleet's CURRENT depth (widening
            # migrations change the key width)
            AD, rseq.empty(self.capacity, depth=self.states[0].inner.depth,
                           device=self.device),
            engine=self.engine,
        )
        self.states = [
            tree_map(lambda x, _i=i: x[_i], sw.state) for i in range(self.n)
        ]
        lub = None
        for i in range(self.n):
            if self.alive[i]:
                lub = self.mirrors[i].copy() if lub is None else lub
                lub.join(self.mirrors[i])
        for i in range(self.n):
            if self.alive[i] and lub is not None:
                self.mirrors[i] = lub.copy()
            self._sync_writer(i)
        rows_after = sum(self._rows(i) for i in range(self.n))
        self.report.barriers += 1
        if rows_after < rows_before:
            self.report.rows_reclaimed += rows_before - rows_after
        else:
            self.report.barriers_noop += 1
        for i in range(self.n):
            self._check(i, "barrier")

    # ---- run ----

    def step(self) -> None:
        ps = self.p
        x = self.rng.random()
        acc = 0.0
        for p, action in zip(ps, (
            self._insert, self._insert_run, self._delete, self._join,
            self._kill, self._revive, self._restart, self._barrier,
        )):
            acc += p
            if x < acc:
                action()
                break
        self.report.steps += 1

    def heal_and_check(self) -> SeqSoakReport:
        self.alive = [True] * self.n
        for _ in range(self.n):
            for i in range(self.n):
                j = (i + 1) % self.n
                self.states[i], _ = tomb_gc.join_checked(
                    self.states[i], self.states[j], AD
                )
                self._sync_writer(i)
                self.mirrors[i].join(self.mirrors[j])
        lists = {tuple(rseq.to_list(self.states[i].inner))
                 for i in range(self.n)}
        assert len(lists) == 1, "healed swarm did not converge"
        for i in range(self.n):
            self._check(i, "heal")
        self.report.final_rows = self._rows(0)
        self.report.final_len = len(rseq.to_list(self.states[0].inner))
        return self.report

    def run(self, n_steps: int) -> SeqSoakReport:
        for _ in range(n_steps):
            self.step()  # Q5: no step may raise
        return self.heal_and_check()


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description="RSeq + GC sequence soak")
    ap.add_argument("--steps", type=int, default=600)
    ap.add_argument("--seeds", type=int, default=3)
    ap.add_argument("--replicas", type=int, default=3)
    ap.add_argument("--capacity", type=int, default=512)
    ap.add_argument("--device", default=None,
                    help="the states' device (default: the CUDA card)")
    ap.add_argument("--engine", choices=["auto", "generic"], default="auto",
                    help="auto = columnar lexN engine when eligible (the "
                         "default); generic pins the row-major A/B path")
    args = ap.parse_args(argv)
    for seed in range(args.seeds):
        runner = SeqSoakRunner(
            n=args.replicas, seed=seed, capacity=args.capacity,
            engine=args.engine, device=args.device,
        )
        print(f"seed {seed}: {runner.run(args.steps)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
