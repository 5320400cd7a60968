"""Jepsen-lite soak harness: a seeded adversarial schedule against the
in-process cluster, with oracle-checked invariants (own copy of
``crdt_tpu.harness.soak``'s ``SoakRunner``; the network soak over daemons
waits for the network daemon, ROADMAP Queue 1 item 2).

A seeded random schedule interleaves writes, gossip pulls, kill/revive
(the /condition capability) and compaction barriers, then heals the
cluster and checks:

  I1  durability   — every ACCEPTED write survives to the healed fixpoint
                     (state == the oracle fold of exactly the accepted
                     commands; nothing lost, nothing invented);
  I2  availability — a dead node rejects writes (the reference 502s);
  I3  liveness     — the healed cluster converges within a bounded number
                     of rounds;
  I4  safety       — no step ever raises.

Every replica shares one ``BirthLedger`` and the report's step clock, so
the registry holds propagation-steps histograms
(``obs.provenance.propagation_summary`` folds them).
"""
from __future__ import annotations

import dataclasses
import random
from typing import Dict, Optional

from crdt_tpu_torch.api.cluster import LocalCluster
from crdt_tpu_torch.obs.provenance import BirthLedger
from crdt_tpu_torch.oracle.replica import OracleReplica
from crdt_tpu_torch.utils.config import ClusterConfig


@dataclasses.dataclass
class SoakReport:
    steps: int
    writes_offered: int
    writes_accepted: int
    writes_rejected_dead: int
    gossip_rounds: int
    kills: int
    revivals: int
    barriers: int
    barriers_skipped: int
    rounds_to_converge: int
    final_state: Dict[str, str]
    pages_admitted: int = 0
    # end-of-run registry snapshot (counters + latency summaries): machine-
    # readable companion to __str__, carried into the CLI's JSON line
    metrics: Dict[str, float] = dataclasses.field(default_factory=dict)

    @classmethod
    def zero(cls) -> "SoakReport":
        return cls(
            steps=0, writes_offered=0, writes_accepted=0,
            writes_rejected_dead=0, gossip_rounds=0, kills=0, revivals=0,
            barriers=0, barriers_skipped=0, rounds_to_converge=-1,
            final_state={},
        )

    def __str__(self) -> str:
        paged = (f", {self.pages_admitted} op pages"
                 if self.pages_admitted else "")
        return (
            f"soak: {self.steps} steps, {self.writes_accepted}/"
            f"{self.writes_offered} writes accepted "
            f"({self.writes_rejected_dead} rejected dead{paged}), "
            f"{self.gossip_rounds} pulls, {self.kills} kills / "
            f"{self.revivals} revivals, {self.barriers} barriers "
            f"(+{self.barriers_skipped} skipped), converged in "
            f"{self.rounds_to_converge} rounds, "
            f"{len(self.final_state)} keys"
        )


class SoakRunner:
    """One seeded adversarial schedule against a LocalCluster + oracles."""

    def __init__(
        self,
        config: Optional[ClusterConfig] = None,
        seed: int = 0,
        p_write: float = 0.45,
        p_gossip: float = 0.35,
        p_kill: float = 0.06,
        p_revive: float = 0.09,
        p_compact: float = 0.05,
        n_keys: int = 8,
        max_dead: Optional[int] = None,
        device=None,
    ):
        self.config = config or ClusterConfig(n_replicas=5, compact_every=0)
        self.rng = random.Random(seed)
        self.cluster = LocalCluster(self.config, device=device)
        # one quirk-free oracle per node, mirroring ACCEPTED commands only
        self.oracles = [
            OracleReplica(rid=n.rid) for n in self.cluster.nodes
        ]
        self.p = (p_write, p_gossip, p_kill, p_revive, p_compact)
        self.keys = [f"k{i}" for i in range(n_keys)]
        # by default keep at least ONE node alive (max_dead = n-1) — the
        # harshest schedule where reads still have a server; barriers are
        # mostly skipped out there, and liveness/durability must hold for
        # ANY schedule regardless
        self.max_dead = (
            max_dead if max_dead is not None
            else len(self.cluster.nodes) - 1
        )
        self.report = SoakReport.zero()
        # convergence flight recorder: one fleet-shared birth ledger and
        # the report's step counter as the deterministic time base ->
        # live propagation-steps histograms
        self.ledger = BirthLedger()
        for node in self.cluster.nodes:
            node.recorder.install(ledger=self.ledger,
                                  step_clock=lambda: self.report.steps)
            node.events.step_clock = lambda: self.report.steps

    # ---- schedule actions ----

    def _write(self) -> None:
        r = self.report
        idx = self.rng.randrange(len(self.cluster.nodes))
        node = self.cluster.nodes[idx]
        cmd = {
            self.rng.choice(self.keys): str(self.rng.randint(-20, 20)),
        }
        if self.rng.random() < 0.1:  # occasional non-numeric (LWW mode)
            cmd[self.rng.choice(self.keys)] = f"s{self.rng.randrange(100)}"
        if self.rng.random() < 0.15:  # occasional multi-key command
            cmd[self.rng.choice(self.keys)] = str(self.rng.randint(-5, 5))
        ts = self.cluster.nodes[0].clock.now_ms()
        r.writes_offered += 1
        accepted = node.add_command(cmd, ts=ts)
        if accepted:
            # mirror into the oracle with the SAME identity the node used
            self.oracles[idx].add_command(cmd, ts=ts)
            r.writes_accepted += 1
        else:
            assert not node.alive, "alive node must accept writes (I2)"
            r.writes_rejected_dead += 1

    def _gossip(self) -> None:
        idx = self.rng.randrange(len(self.cluster.nodes))
        if self.cluster.gossip_once(idx):
            self.report.gossip_rounds += 1

    def _kill(self) -> None:
        alive = [n for n in self.cluster.nodes if n.alive]
        if len(self.cluster.nodes) - len(alive) >= self.max_dead:
            return
        if not alive:
            return
        self.rng.choice(alive).set_alive(False)
        self.report.kills += 1

    def _revive(self) -> None:
        dead = [n for n in self.cluster.nodes if not n.alive]
        if not dead:
            return
        self.rng.choice(dead).set_alive(True)
        self.report.revivals += 1

    def _compact(self) -> None:
        if self.cluster.compact():
            self.report.barriers += 1
        else:
            self.report.barriers_skipped += 1

    def _tick(self) -> None:
        """A full cluster tick: one pull per replica AND the tick-scheduled
        compaction path (config.compact_every) — so scheduled barriers race
        the fault schedule, not just the explicit p_compact barriers."""
        before = self.cluster.metrics.snapshot()
        self.report.gossip_rounds += self.cluster.tick()
        after = self.cluster.metrics.snapshot()
        self.report.barriers += (
            after.get("compactions", 0) > before.get("compactions", 0)
        )
        self.report.barriers_skipped += (
            after.get("compact_skipped", 0) - before.get("compact_skipped", 0)
        ) > 0

    # ---- run ----

    def step(self) -> None:
        p_write, p_gossip, p_kill, p_revive, p_compact = self.p
        x = self.rng.random()
        if x < p_write:
            self._write()
        elif x < p_write + p_gossip:
            self._gossip()
        elif x < p_write + p_gossip + p_kill:
            self._kill()
        elif x < p_write + p_gossip + p_kill + p_revive:
            self._revive()
        elif x < p_write + p_gossip + p_kill + p_revive + p_compact:
            self._compact()
        else:
            self._tick()  # full round incl. the SCHEDULED compaction path
        self.report.steps += 1

    def heal_and_check(self, max_rounds: int = 400) -> SoakReport:
        """Heal every node, drive to the fixpoint, assert I1/I3."""
        r = self.report
        for n in self.cluster.nodes:
            n.set_alive(True)  # I3 setup: heal
        rounds = 0
        while not self.cluster.converged():
            assert rounds < max_rounds, "liveness violated (I3)"
            self.cluster.tick()
            rounds += 1
        r.rounds_to_converge = rounds
        want = OracleReplica.converged_state(self.oracles)
        got = self.cluster.nodes[0].get_state()
        assert got == want, (
            f"durability violated (I1): accepted-writes fold has "
            f"{len(want)} keys, cluster has {len(got)}; "
            f"diff={ {k: (want.get(k), got.get(k)) for k in set(want) | set(got) if want.get(k) != got.get(k)} }"
        )
        r.final_state = got
        r.metrics = self.cluster.metrics.snapshot()
        return r

    def run(self, n_steps: int) -> SoakReport:
        for _ in range(n_steps):
            self.step()  # I4: no step may raise
        return self.heal_and_check()
